"""Attention kernels of the K1 layout and tuning studies (K6-K9).

Four hand-written Hopper kernels and their plain PyTorch versions, at head
dim 64, all instantiations of one wgmma + TMA kernel template
(``csrc/attn_studies_sm90.cu``). They are what the study modules of
``tpdm_tpu_torch.experiments`` run; no path of the pipeline calls them.

- K6 ``attention_strided``: online-softmax attention over q, k, v and the
  output in any of the studies' layouts;
- K7 ``attention_maxfree``: p = exp2(s - rb) against a given bound rb per
  query row, with no running max;
- K8 ``attention_int8qk``: QK^T of per-row int8 q and k on the int8 tensor
  cores, then as K6;
- K9 ``attention_probe``: the studies' floor probes ("qk_only", "noexp").

Every operand is a 4-D view (b, h, token, dim) whose dim axis or token axis
is contiguous, so one description covers the studies' natural (bh, n, 64),
transposed (bh, 64, n), packed (b, n, h*64) and K^T layouts: pass the view,
e.g. ``qt.transpose(-1, -2)`` for a (b, h, 64, n) q^T. An output layout is
chosen by passing ``out``, a view of the same kind. Scores are in the exp2
domain: q already carries log2(e)/sqrt(64), as the studies scale it outside
their kernels, so softmax is by exp2 of q.k. V is (b, h, n_kv, 64),
and the denominator is then the fp32 row sum of p, or wider with its
column 64 the denominator (the studies' ones column, zeroed where they
mask); V's columns past 64 are not read.

The wrappers dispatch on the tensor's device: a CUDA tensor launches the
kernel (or the wrapper raises on what the kernel does not take, operands
that require grad included: no kernel has a backward), a CPU tensor runs
the plain version. There is no flag that picks the plain
version on CUDA. The plain versions compute the same functions in fp32,
with p rounded to v's dtype before PV (bf16 on the card) and, in the bf16
softmax modes, the scores and the softmax's steps rounded to bf16 where
the studies round them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tpdm_tpu_torch.ops import _build

_NEG_INF = -1e30
_D = 64
# the studies time forwards; no queue item brings them a backward
STUDIES_GRAD_ITEM = "none: the K1 studies (K6-K9, ROADMAP queue 2) measure forwards only"
_LN2_BF16 = 0.69140625  # log(2) rounded to bf16
_PROBE_MODES = {"qk_only": 0, "noexp": 1}


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _exp2_bf16(x: torch.Tensor) -> torch.Tensor:
    """exp2 of a bf16 value as the studies' bf16 softmax computes it:
    exp(x * log(2)), the constant and the product rounded to bf16, the
    result rounded to bf16."""
    return _round_bf16(torch.exp(_round_bf16(x * _LN2_BF16)))


def _scores(q, k) -> torch.Tensor:
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def _mask(s: torch.Tensor, kv_len: Optional[int]) -> torch.Tensor:
    if kv_len is not None and kv_len < s.shape[-1]:
        valid = torch.arange(s.shape[-1], device=s.device) < kv_len
        s = s.masked_fill(~valid, _NEG_INF)
    return s


def _emit(o: torch.Tensor, out: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    if out is None:
        return o.to(dtype)
    out.copy_(o)
    return out


def _normalise(p, v, out, dtype):
    """p (b, h, n_q, n_kv) fp32 -> the output: (p in v's dtype) . V over
    V's column 64 when V carries it, else over the fp32 row sum of p."""
    pv = torch.matmul(p.to(v.dtype).float(), v[..., : _D + 1].float())
    if v.shape[-1] > _D:
        o = pv[..., :_D] / pv[..., _D:]
    else:
        o = pv / p.sum(dim=-1, keepdim=True)
    return _emit(o, out, dtype)


def attention_strided_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[int] = None,
    *,
    score_bf16: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain K6: softmax over the exp2-domain scores (columns >= kv_len
    set to -1e30) against V. With ``score_bf16`` the scores and s - m are
    each rounded to bf16 and exp2 is taken in bf16 (``_exp2_bf16``), as the
    studies' bf16 score and softmax dtypes (``attn_round3.py`` vTb,
    ``attn_round3b.py`` vTc) do.
    Returns ``out`` filled, or a new (b, h, n_q, 64) tensor in q's dtype."""
    s = _mask(_scores(q, k), kv_len)
    if score_bf16:
        s = _round_bf16(s)
        p = _exp2_bf16(_round_bf16(s - s.amax(dim=-1, keepdim=True)))
    else:
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return _normalise(p, v, out, q.dtype)


def attention_maxfree_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rb: torch.Tensor,
    kv_len: Optional[int] = None,
    *,
    soft_bf16: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain K7: p = exp2(s - rb) with rb (b, h, n_q) fp32, no max taken,
    then as K6. If rb lies below a row's max, p overflows as the studies'
    kernels do. ``soft_bf16`` rounds s, rb and s - rb to bf16 and takes
    exp2 in bf16 (``_exp2_bf16``)."""
    s = _mask(_scores(q, k), kv_len)
    bound = rb.float()[..., None]
    if soft_bf16:
        p = _exp2_bf16(_round_bf16(_round_bf16(s) - _round_bf16(bound)))
    else:
        p = torch.exp2(s - bound)
    return _normalise(p, v, out, q.dtype)


def int8_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The exact int32 product q k^T of int8 (b, h, n, 64) operands: on
    the CPU an int32 matmul; on CUDA, which has no integer matmul outside a
    library, an fp64 product, exact since |s| <= 127^2 * 64 < 2^53."""
    if q.device.type == "cpu":
        return torch.matmul(q.to(torch.int32), k.to(torch.int32).transpose(-1, -2))
    return torch.matmul(q.double(), k.double().transpose(-1, -2)).to(torch.int32)


def attention_int8qk_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sq: torch.Tensor,
    sk: torch.Tensor,
    kv_len: Optional[int] = None,
    *,
    k_scale_first: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain K8: s = (float(q k^T) * sq[row]) * sk[col] in fp32, each
    product rounded alone (``attn_round3.py`` ``_kernel_I``'s order;
    ``k_scale_first`` takes sk first, ``_kernel_TI``'s), then as K6 on
    exp2-domain scores. q, k int8; sq (b, h, n_q), sk (b, h, n_kv) fp32.
    Output in v's dtype."""
    x = int8_scores(q, k).float()
    if k_scale_first:
        s = x * sk[..., None, :] * sq[..., None]
    else:
        s = x * sq[..., None] * sk[..., None, :]
    s = _mask(s, kv_len)
    return _normalise(torch.exp2(s - s.amax(dim=-1, keepdim=True)), v, out, v.dtype)


def attention_probe_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mode: str,
    chunk: int = 640,
    *,
    out: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain K9, the functions of ``attn_overlap.py``'s floor probes over
    kv chunks of ``chunk`` rows (no mask), computed in ``dtype`` (fp32, or
    fp64 to hold the ill-conditioned noexp division to the function itself):

    - "qk_only": sum over chunks c0 of S[:, c0:c0+64] (in v's dtype)
      . V[c0:c0+64, :64], undivided;
    - "noexp": the online walk with exp2(s - m) replaced by s - m and the
      rescale alpha by m_old - m_new, m updated once a chunk, V carrying
      its ones column: acc[:, :64] / (acc[:, 64] + 1), with s - m in v's
      dtype for the PV product.
    """
    s_all = torch.matmul(q.to(dtype), k.to(dtype).transpose(-1, -2))
    n_kv = k.shape[2]
    acc = m = None
    for lo in range(0, n_kv, chunk):
        if mode == "qk_only":
            pv = torch.matmul(s_all[..., lo:lo + _D].to(v.dtype).to(dtype),
                              v[:, :, lo:lo + _D, :_D].to(dtype))
            acc = pv if acc is None else acc + pv
            continue
        s = s_all[..., lo:min(lo + chunk, n_kv)]
        vv = v[:, :, lo:lo + s.shape[-1], : _D + 1].to(dtype)
        m_new = s.amax(dim=-1, keepdim=True) if m is None else torch.maximum(
            m, s.amax(dim=-1, keepdim=True))
        pv = torch.matmul((s - m_new).to(v.dtype).to(dtype), vv)
        acc = pv if m is None else acc * (m - m_new) + pv
        m = m_new
    o = acc if mode == "qk_only" else acc[..., :_D] / (acc[..., _D:] + 1.0)
    return _emit(o, out, q.dtype)


# ---------------------------------------------------------------- kernels


def _check_view(name: str, label: str, t: torch.Tensor, dtype, dims=(_D,)) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: {label} is on {t.device}, expected cuda")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {label} is {t.dtype}, the kernel takes {dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name}: {label} must be a (b, h, n, d) view, got {tuple(t.shape)}")
    if t.shape[-1] not in dims:
        raise ValueError(f"{name}: {label} has last dim {t.shape[-1]}, the kernel takes "
                         f"{dims[0]}" + (f"..{dims[-1]}" if len(dims) > 1 else ""))
    if t.stride(-1) != 1 and t.stride(2) != 1:
        raise ValueError(f"{name}: {label} has strides {t.stride()}: neither its dim nor its "
                         "token axis is contiguous")


def _check_operands(name, q, k, v, out, kv_len, qk_dtype=torch.bfloat16,
                    v_dims=tuple(range(_D, _D + 17))):
    """Validate CUDA views; returns (kv_len, the output view)."""
    _build.refuse_grad(name, STUDIES_GRAD_ITEM, q, k, v, out)
    _check_view(name, "q", q, qk_dtype)
    _check_view(name, "k", k, qk_dtype)
    _check_view(name, "v", v, torch.bfloat16, v_dims)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must be on one device")
    b, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    if k.shape[:2] != (b, h) or v.shape[:3] != (b, h, n_kv):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if min(n_q, n_kv) < 1:
        raise ValueError(f"{name}: empty attention {n_q} x {n_kv}")
    kv_len = n_kv if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= n_kv:
        raise ValueError(f"{name}: kv_len {kv_len} outside [1, {n_kv}]")
    if b * h > 65535:
        raise ValueError(f"{name}: b*h = {b * h} exceeds the grid's 65535")
    if out is None:
        out = torch.empty((b, h, n_q, _D), dtype=torch.bfloat16, device=q.device)
    else:
        _check_view(name, "out", out, torch.bfloat16)
        if out.device != q.device or out.shape != (b, h, n_q, _D) or 0 in out.stride():
            raise ValueError(f"{name}: out must be a ({b}, {h}, {n_q}, {_D}) view on "
                             f"{q.device} without broadcast axes, got {tuple(out.shape)} "
                             f"strides {out.stride()}")
    return kv_len, out


@functools.lru_cache(maxsize=None)
def _instantiated(kind: int) -> tuple:
    """The (q^T, k^T, v^T) orientations the kernel template is instantiated
    for with ``kind`` (its Kind: 2 K7, 3 K9 qk_only, 4 noexp), as the
    library reports them."""
    bits = _build.load_library().tpdm_attention_studies_layouts(kind)
    return tuple(tuple(bool(i >> (2 - j) & 1) for j in range(3))
                 for i in range(8) if bits >> i & 1)


def _check_layouts(name: str, kind: int, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """Raise unless the orientations of q, k and v (transposed: the token
    axis contiguous) are instantiated for ``kind``."""
    views = {"q": q, "k": k, "v": v}
    allowed = _instantiated(kind)
    got = tuple(t.stride(-1) != 1 for t in views.values())
    if got not in allowed:
        label = lambda flags: ", ".join(
            f"{n}^T" if f else n for n, f in zip(views, flags))
        raise ValueError(f"{name}: views ({label(got)}) are not instantiated; the kernel takes "
                         + " or ".join(f"({label(a)})" for a in allowed))


def _strides(*views: torch.Tensor, extra=()) -> ctypes.Array:
    vals = [s for t in views for s in t.stride()] + list(extra)
    return (ctypes.c_longlong * len(vals))(*vals)


def studies_routes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor) -> dict:
    """{"q", "k", "v", "o": "tma", "staged" or "plain"}: the load (o:
    store) route that K6, K7 and K9 (bf16 q, k) or K8 (int8 q, k) take for
    these CUDA views, as the launch fixes it: TMA where the view's base is
    16-byte aligned and every stride but the contiguous one a multiple of
    16 bytes; "staged" for a natural V 65..80 wide whose rows are not
    (V_ext 65): its raw rows through TMA into a staging buffer, reformatted
    in shared memory (n_kv a multiple of 8); else the producer's plain
    loads (K8's q^T always, to transpose it)."""
    b, h, n_q, _ = q.shape
    bits = _build.load_library().tpdm_attention_studies_routes(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _strides(q, k, v, out), b, h,
        n_q, k.shape[2], int(q.dtype == torch.int8))
    routes = {name: "tma" if bits >> i & 1 else "plain" for i, name in enumerate("qkvo")}
    if bits >> 4 & 1:
        routes["v"] = "staged"
    return routes


def _launch(entry: str, q: torch.Tensor, *args) -> None:
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.tpdm_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")


def attention_strided(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[int] = None,
    *,
    score_bf16: bool = False,
    streams: int = 1,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K6: attention over strided (b, h, token, 64) views.

    Replaces the kernels of the K1 layout studies that compute attention
    itself: ``experiments/attn_variants.py`` ``_kernel_v1``, ``_kernel_v2``,
    ``_kernel_v4``; ``attn_overlap.py`` ``_kernel_prefetch``;
    ``attn_layout.py`` ``_kernel_kt``; ``attn_nocopy.py`` ``_kernel_vsum``,
    ``_kernel_packed2``; ``attn_round3.py`` and ``attn_round3b.py``
    ``_kernel_T``; ``attn_natural_operands.py`` ``_kernel_nat``;
    ``attn_kernel_floor.py`` ``_kernel_inT``; ``attn_round4.py``
    ``_split_kernel`` (``streams=2``: even and odd kv tiles in two
    online-softmax streams, merged exactly at the end); and
    ``tpdm_tpu/ops/attention.py`` ``_flash_kernel`` as ``attn_round4.py``,
    ``attn_block_layout.py``, ``attn_transpose_cost.py`` and
    ``attn_kernel_floor.py`` call it on pre-transposed operands. Compute
    bound at the study shape; ``csrc/attn_studies_sm90.cu`` holds the
    design note. kv columns >= kv_len get a -1e30 bias. ``score_bf16`` rounds
    the softmax's values to bf16 as ``attn_round3.py`` vTb and
    ``attn_round3b.py`` vTc do.

    CUDA: bf16 views (v 64..80 wide), or it raises. CPU: the plain version
    ``attention_strided_reference``, which ``streams`` does not change.
    """
    if q.device.type == "cpu":
        return attention_strided_reference(q, k, v, kv_len, score_bf16=score_bf16, out=out)
    name = "attention_strided"
    if streams not in (1, 2):
        raise ValueError(f"{name}: streams {streams}, the kernel takes 1 or 2")
    kv_len, out = _check_operands(name, q, k, v, out, kv_len)
    b, h, n_q, _ = q.shape
    _launch("tpdm_attention_strided_d64", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), _strides(q, k, v, out), b, h, n_q, k.shape[2], kv_len,
            v.shape[-1], int(score_bf16), streams)
    attention_strided.launches += 1
    return out


attention_strided.launches = 0


def attention_maxfree(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rb: torch.Tensor,
    kv_len: Optional[int] = None,
    *,
    soft_bf16: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K7: max-free attention, p = exp2(s - rb) with a bound rb (b, h, n_q)
    fp32 on each query row's exp2-domain scores, plain accumulation of PV
    and the denominator, no running max and no rescale.

    Replaces ``experiments/attn_variants.py`` ``_kernel_v3`` and
    ``attn_round3b.py`` ``_kernel_Tm`` (``soft_bf16``: the bf16 softmax).
    The studies' rb is a per-row Cauchy-Schwarz bound, |q_i| max_j |k_j|;
    an rb below a row's max overflows, as theirs does.

    CUDA: bf16 views as ``attention_strided`` takes them, q, k and v with
    their dim axes contiguous, or with V^T, or with q^T and V^T (the
    layouts the studies pass), the output either way; rb any fp32
    (b, h, n_q) view; or it raises. CPU: the plain version
    ``attention_maxfree_reference``.
    """
    if q.device.type == "cpu":
        return attention_maxfree_reference(q, k, v, rb, kv_len, soft_bf16=soft_bf16, out=out)
    name = "attention_maxfree"
    kv_len, out = _check_operands(name, q, k, v, out, kv_len)
    _check_layouts(name, 2, q, k, v)
    b, h, n_q, _ = q.shape
    _build.refuse_grad(name, STUDIES_GRAD_ITEM, rb)
    if rb.device != q.device or rb.dtype != torch.float32 or rb.shape != (b, h, n_q):
        raise ValueError(f"{name}: rb must be a ({b}, {h}, {n_q}) float32 tensor on "
                         f"{q.device}, got {tuple(rb.shape)} {rb.dtype} on {rb.device}")
    _launch("tpdm_attention_maxfree_d64", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), rb.data_ptr(), _strides(q, k, v, out, extra=rb.stride()), b, h,
            n_q, k.shape[2], kv_len, v.shape[-1], int(soft_bf16))
    attention_maxfree.launches += 1
    return out


attention_maxfree.launches = 0


def attention_int8qk(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sq: torch.Tensor,
    sk: torch.Tensor,
    kv_len: Optional[int] = None,
    *,
    k_scale_first: bool = False,
    out: Optional[torch.Tensor] = None,
    scores_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K8: attention with an int8 QK^T. q, k int8 (b, h, n, 64), the rows
    quantised symmetrically with scales sq (b, h, n_q) and sk (b, h, n_kv)
    fp32; S = q k^T on the int8 tensor cores into int32 (exact), the
    exp2-domain scores s = (float(S) * sq) * sk with each product rounded
    alone (``k_scale_first``: sk first), then K6's online softmax and a
    bf16 PV.

    Replaces ``experiments/attn_round3.py`` ``_kernel_I`` and, with a q^T
    view, ``_kernel_TI`` (whose order is ``k_scale_first``). The
    quantisation itself stays outside, in plain torch, as in the study.
    ``scores_out``, a contiguous (b, h, n_q, n_kv) int32 tensor, receives
    the raw int32 S (for checking the kernel's products).

    CUDA: int8 q (any view) and k (dim axis contiguous), bf16 v, contiguous
    scales, or it raises. CPU: the plain version
    ``attention_int8qk_reference`` (``scores_out`` gets ``int8_scores``).
    """
    if q.device.type == "cpu":
        if scores_out is not None:
            scores_out.copy_(int8_scores(q, k))
        return attention_int8qk_reference(q, k, v, sq, sk, kv_len, k_scale_first=k_scale_first,
                                          out=out)
    name = "attention_int8qk"
    kv_len, out = _check_operands(name, q, k, v, out, kv_len, qk_dtype=torch.int8)
    if k.stride(-1) != 1:
        raise ValueError(f"{name}: k's dim axis must be contiguous (the s8 mma is K-major)")
    b, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    _build.refuse_grad(name, STUDIES_GRAD_ITEM, sq, sk)
    for label, s, n in (("sq", sq, n_q), ("sk", sk, n_kv)):
        if (s.device != q.device or s.dtype != torch.float32 or s.shape != (b, h, n)
                or not s.is_contiguous()):
            raise ValueError(f"{name}: {label} must be a contiguous ({b}, {h}, {n}) float32 "
                             f"tensor on {q.device}, got {tuple(s.shape)} {s.dtype}")
    if scores_out is not None and (scores_out.dtype != torch.int32
                                   or scores_out.shape != (b, h, n_q, n_kv)
                                   or not scores_out.is_contiguous()
                                   or scores_out.device != q.device):
        raise ValueError(f"{name}: scores_out must be a contiguous ({b}, {h}, {n_q}, {n_kv}) "
                         f"int32 tensor on {q.device}")
    _launch("tpdm_attention_int8qk_d64", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), sq.data_ptr(), sk.data_ptr(),
            None if scores_out is None else scores_out.data_ptr(), _strides(q, k, v, out), b,
            h, n_q, n_kv, kv_len, v.shape[-1], int(k_scale_first))
    attention_int8qk.launches += 1
    return out


attention_int8qk.launches = 0


def attention_probe(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mode: str,
    chunk: int = 640,
    *,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K9: the floor probes of the K1 studies, computing exactly their
    functions (see ``attention_probe_reference``): ``mode`` "qk_only"
    replaces ``experiments/attn_overlap.py`` ``_kernel_qk_only`` and, with
    a K^T view, ``attn_layout.py`` ``_kernel_kt_qkonly``; "noexp" replaces
    ``attn_overlap.py`` ``_kernel_noexp``. ``chunk`` is part of their
    function (where the walk takes its columns and updates its max), so it
    is carried over. qk_only runs every chunk's whole QK^T, as the probe
    did; noexp runs QK^T twice a chunk (its chunk max, then its PV).

    CUDA: bf16 views as ``attention_strided`` takes them, q and v with
    their dim axes contiguous, k or k^T, the output either way; chunk a
    positive multiple of 64; v with its ones column (at least 65 wide) for
    noexp; or it raises.
    CPU: the plain version ``attention_probe_reference``.
    """
    if mode not in _PROBE_MODES:
        raise ValueError(f"attention_probe: mode {mode!r}, expected one of {list(_PROBE_MODES)}")
    if q.device.type == "cpu":
        return attention_probe_reference(q, k, v, mode, chunk, out=out)
    name = "attention_probe"
    if chunk <= 0 or chunk % 64:
        raise ValueError(f"{name}: chunk {chunk} is not a positive multiple of 64")
    _, out = _check_operands(name, q, k, v, out, None)
    _check_layouts(name, 3 + _PROBE_MODES[mode], q, k, v)
    if mode == "noexp" and v.shape[-1] == _D:
        raise ValueError(f"{name}: noexp divides by V's ones column: v must be at least 65 wide")
    b, h, n_q, _ = q.shape
    _launch("tpdm_attention_probe_d64", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), _strides(q, k, v, out), b, h, n_q, k.shape[2], v.shape[-1],
            _PROBE_MODES[mode], chunk)
    attention_probe.launches += 1
    return out


attention_probe.launches = 0
