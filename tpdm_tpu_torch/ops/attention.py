"""Attention for the joint image+text sequence and the VAE mid block.

Three hand-written Hopper kernels (K1 and K3, two instantiations of the
wgmma + TMA kernel of ``csrc/attn_sm90.cu``; K2, a wgmma + TMA kernel of
its own in ``csrc/attn_d512_sm90.cu``) and their plain PyTorch versions,
``attention_reference`` and ``attention_reference_stats``. The wrappers
dispatch on the tensor's device: a CUDA tensor launches the kernel (or the
wrapper raises on what the kernel does not take), a CPU tensor runs the
plain version. There is no flag that picks the plain version on CUDA.

Gradients, as the JAX package's custom VJPs give them:
- K1 at head dim 64 and below: ``flash_attention`` under autograd runs
  K3's statistics instantiation forward and K1's backward,
  ``flash_attention_backward`` (``csrc/attn_bwd_sm90.cu``, hand-written;
  JAX's backward is a dense recompute through ``attention_reference``).
  On the CPU autograd runs through ``attention_reference``, the plain
  version of both.
- K2: ``flash_attention_streaming`` under autograd keeps its forward and
  backpropagates by ``attention_backward_chunked``, plain tensor code as
  the JAX package's is XLA, on the card and on the CPU.
- K1 at its other head dims and K3 raise under grad (``_build.refuse_grad``).

Layouts follow the JAX package: q, k, v and the output are (b, h, n, d).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpdm_tpu_torch.ops import _build

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain attention with an fp32 softmax. q, k, v: (b, h, n, d).

    As ``tpdm_tpu/ops/attention.py:attention_reference``: fp32 scores,
    kv positions >= kv_len set to -1e30, probabilities cast to v's dtype
    before the PV product, output in q's dtype.
    """
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / d**0.5)
    if kv_len is not None and kv_len < k.shape[2]:
        valid = torch.arange(k.shape[2], device=k.device) < kv_len
        s = s.masked_fill(~valid, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _check_kernel_operands(name: str, q, k, v, head_dim: int, kv_len, refuse: str = "") -> int:
    """Validate CUDA operands for a kernel; returns the effective kv_len.
    ``refuse`` (the queue item that brings a backward) makes operands that
    require grad raise; without it the caller takes the gradient."""
    if refuse:
        _build.refuse_grad(name, refuse, q, k, v)
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {label} is on {t.device}, expected cuda")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {label} is {t.dtype}, the kernel takes bfloat16")
        if t.dim() != 4:
            raise ValueError(f"{name}: {label} must be (b, h, n, d), got {tuple(t.shape)}")
        if t.shape[-1] != head_dim:
            raise ValueError(
                f"{name}: {label} has head_dim {t.shape[-1]}, the kernel takes {head_dim}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must be on one device")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2]:
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )
    n_kv = k.shape[2]
    kv_len = n_kv if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= n_kv:
        raise ValueError(f"{name}: kv_len {kv_len} outside [1, {n_kv}]")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"{name}: b*h = {q.shape[0] * q.shape[1]} exceeds the grid's 65535")
    return kv_len


def _launch(entry: str, q, k, v, kv_len: int, *stats: torch.Tensor,
            head_dim: Optional[int] = None) -> torch.Tensor:
    """Launch ``entry`` on q's current stream; ``stats`` are K3's (m, l)
    outputs, passed after o; ``head_dim`` the true head dim of the padded
    d-64 entry."""
    lib = _build.load_library()
    out = torch.empty_like(q)
    b, h, n_q, _ = q.shape
    extra = () if head_dim is None else (head_dim,)
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in stats),
            b * h, n_q, k.shape[2], kv_len, *extra,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = lib.tpdm_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")
    return out


# K1's head dims: 64 (the MMDiT), the SD1.5 UNet's 40, 80 and 160 and
# FLUX's 128; any other head dim below 64 runs the d-64 entry on operands
# padded to 64
K1_HEAD_DIMS = (40, 64, 80, 128, 160)
# where the backward of K1 at its other head dims is queued
K1_GRAD_ITEM = ("ROADMAP queue 1, item 9(g): K1's backward at head dims 40, 80, 128 and 160, "
                "for the UNet and FLUX trainers")


def _pad_to_64(t: torch.Tensor) -> torch.Tensor:
    """(b, h, n, d) -> (b, h, n, 64) with zero columns past d, contiguous."""
    return torch.nn.functional.pad(t, (0, 64 - t.shape[-1])).contiguous()


def _wants_grad(*operands) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in operands)


class _K1Grad(torch.autograd.Function):
    """K1 at head dim <= 64 under autograd, on operands padded to 64
    columns: the forward is K3's statistics instantiation at the true head
    dim's scale (the output K1 gives, plus each row's m and l), the
    backward ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len: int, head_dim: int):
        m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        out = _launch("tpdm_flash_attention_stats_d64_padded", q, k, v, kv_len, m, l,
                      head_dim=head_dim)
        ctx.save_for_backward(q, k, v, out, m + torch.log2(l))
        ctx.kv_len, ctx.head_dim = kv_len, head_dim
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_backward(q, k, v, out, do, lse, ctx.kv_len, ctx.head_dim)
        return (*grads, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """K1: fused non-causal attention at head_dim 64 (MMDiT joint attention),
    40, 80, 160 (the SD1.5 UNet's 8 heads of 320, 640 and 1280) and 128
    (FLUX's 24 heads of 3072).

    Replaces ``tpdm_tpu/ops/attention.py:_flash_kernel`` (driven by
    ``_flash_attention_fwd_impl``): softmax(QK^T/sqrt(d))V per batch*head
    with an fp32 exp2-domain online softmax and kv positions >= kv_len
    masked by a -1e30 bias. On the H100 the SD3 1024 px shape
    (2, 24, 4480, 64) is compute bound; the kernel runs its two products as
    wgmma (bf16, fp32 accumulate) on K and V tiles that a producer warp
    brings by TMA through a shared-memory ring, 192 query rows a block.
    The other head dims are the same kernel on rows of whole 64-column TMA
    boxes (d 128 two of them; TMA zero-fills the padding of the others, the
    store clips it),
    with the softmax scale of the true head dim. A head dim below 64 with
    no entry of its own (the toy UNets' 4, 6 and 8) is zero-padded to 64
    columns here and runs the d-64 kernel at its own scale: zero q and k
    columns add nothing to a score, and the output's extra columns are cut
    off. ``csrc/attn_sm90.cu`` holds the design note.

    Under autograd (grad mode on and an operand requiring grad) at head dim
    64 or below, the call is differentiable: ``_K1Grad`` (forward with the
    row statistics, backward ``flash_attention_backward``), one launch of
    this wrapper's count a forward, on the same padding. At the other head
    dims it raises under autograd.

    CUDA: bf16, contiguous (b, h, n, d) tensors with d in ``K1_HEAD_DIMS``
    or below 64, or it raises. CPU: the plain version
    ``attention_reference``, differentiable by autograd.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_len)
    d = q.shape[-1]
    if 1 <= d <= 64 and _wants_grad(q, k, v):
        kv_len = _check_kernel_operands("flash_attention", q, k, v, d, kv_len)
        pad = (lambda t: t) if d == 64 else _pad_to_64
        out = _K1Grad.apply(pad(q), pad(k), pad(v), kv_len, d)[..., :d]
    elif d in K1_HEAD_DIMS:
        kv_len = _check_kernel_operands("flash_attention", q, k, v, d, kv_len, K1_GRAD_ITEM)
        out = _launch(f"tpdm_flash_attention_d{d}", q, k, v, kv_len)
    elif 1 <= d < 64:
        kv_len = _check_kernel_operands("flash_attention", q, k, v, d, kv_len, K1_GRAD_ITEM)
        out = _launch("tpdm_flash_attention_d64_padded", _pad_to_64(q), _pad_to_64(k),
                      _pad_to_64(v), kv_len, head_dim=d)[..., :d]
    else:
        raise ValueError(f"flash_attention: head_dim {d}; the kernel takes {K1_HEAD_DIMS} "
                         "or any head_dim below 64")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention_backward_reference(q, k, v, do, kv_len: Optional[int] = None,
                                 head_dim: Optional[int] = None):
    """The plain version of ``flash_attention_backward``: (dq, dk, dv) by
    autograd through ``attention_reference`` on the first ``head_dim``
    columns (all by default), in the operands' dtype, zero past them."""
    d = head_dim or q.shape[-1]
    with torch.enable_grad():
        leaves = [t[..., :d].detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_reference(*leaves, kv_len)
        grads = torch.autograd.grad(out, leaves, do[..., :d])
    pad = q.shape[-1] - d
    return tuple(torch.nn.functional.pad(g, (0, pad)) for g in grads)


def flash_attention_backward(q, k, v, o, do, lse, kv_len: Optional[int] = None,
                             head_dim: Optional[int] = None):
    """K1's backward: (dq, dk, dv) of ``flash_attention`` at (b, h, n, 64)
    operands (zero-padded past ``head_dim`` where it is below 64), given
    the forward's output ``o``, the output's gradient ``do`` and each query
    row's ``lse`` = m + log2(l) (K3's statistics, (b, h, n_q) fp32).

    Replaces no Pallas kernel: JAX's K1 backpropagates by a dense recompute
    through ``attention_reference`` (``tpdm_tpu/ops/attention.py:_bwd``,
    :449), an XLA program. ``csrc/attn_bwd_sm90.cu`` recomputes the
    probabilities tile by tile instead: one kernel walks each 64-row kv
    tile over the q tiles and writes dK and dV, one walks each q tile over
    the kv tiles and writes dQ (no atomics: the result does not depend on
    the order blocks run in). D = rowsum(do * o) is formed here in fp32.
    Rows of k and v at or past kv_len get zero gradients. The design note
    is in the source.

    CUDA: bf16, contiguous (b, h, n, 64) q, k, v, o, do, or it raises.
    CPU: the plain version ``attention_backward_reference`` (``o`` and
    ``lse`` unused).
    """
    head_dim = head_dim or q.shape[-1]
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, do, kv_len, head_dim)
    do = do.contiguous()
    kv_len = _check_kernel_operands("flash_attention_backward", q, k, v, 64, kv_len)
    for label, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"flash_attention_backward: {label} must be a contiguous "
                             f"{q.dtype} tensor of q's shape {tuple(q.shape)}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_backward: lse must be contiguous fp32 (b, h, n_q)")
    if not 1 <= head_dim <= 64:
        raise ValueError(f"flash_attention_backward: head_dim {head_dim} outside [1, 64]")
    delta = (do.float() * o.float()).sum(dim=-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load_library()
    b, h, n_q, _ = q.shape
    with torch.cuda.device(q.device):
        err = lib.tpdm_flash_attention_bwd_d64(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, n_q, k.shape[2], kv_len, head_dim,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.tpdm_cuda_error_string(err).decode()
        raise RuntimeError(f"tpdm_flash_attention_bwd_d64 launch failed: CUDA error {err} ({msg})")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def streaming_block_kv(d: int, itemsize: int) -> int:
    """The kv block of the JAX streaming kernel at head dim ``d`` and
    operand ``itemsize`` (``tpdm_tpu/ops/attention.py:_streaming_blocks``,
    sized by its 8 MiB VMEM model): the chunk its backward walks (128 at
    the VAE's d 512, bf16 or fp32)."""
    dv = _round_up(d + 1, 16)
    for bq in (1536, 1024, 512, 256, 128):
        for bkv in (512, 256, 128):
            use = (4 * bkv * bq + 4 * dv * bq
                   + 2 * itemsize * ((d + 1) * bq + bkv * (d + 1) + dv * bkv))
            if use <= 8 * 1024 * 1024:
                return bkv
    return 128


def attention_backward_chunked(q, k, v, o, do, kv_len: Optional[int] = None,
                               chunk: int = 1024):
    """Flash-attention backward that never forms the (n, n) scores: the
    port of ``tpdm_tpu/ops/attention.py:attention_backward_chunked``.

    Pass 1 rebuilds each query row's softmax statistics (m, l) online over
    kv chunks; pass 2 walks the chunks again: dv_c = p_c^T do, ds_c =
    p_c (do v_c^T - D) scale, dq += ds_c k_c, dk_c = ds_c^T q, with D =
    rowsum(do o), all in fp32 (a Python loop where JAX scans). Memory is
    O(n_q chunk) a (batch, head). Returns (dq, dk, dv) in the operands'
    dtypes."""
    n_kv = k.shape[2]
    kv_len = n_kv if kv_len is None else kv_len
    d = q.shape[-1]
    scale = 1.0 / d**0.5
    n_chunks = _round_up(n_kv, chunk) // chunk
    qf, dof = q.float(), do.float()

    def chunk_of(t, c):
        return t[:, :, c * chunk:(c + 1) * chunk].float()

    def scores(c):
        kc = chunk_of(k, c)
        s = torch.matmul(qf, kc.transpose(-1, -2)) * scale
        col = c * chunk + torch.arange(kc.shape[2], device=q.device)
        return s.masked_fill(col >= kv_len, _NEG_INF), kc

    m = torch.full(q.shape[:3], _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for c in range(n_chunks):
        s, _ = scores(c)
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(dim=-1)
        m = m_new
    delta = (dof * o.float()).sum(dim=-1)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for c in range(n_chunks):
        s, kc = scores(c)
        p = torch.exp(s - m[..., None]) / l[..., None]
        dvs.append(torch.matmul(p.transpose(-1, -2), dof))
        dp = torch.matmul(dof, chunk_of(v, c).transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.matmul(ds, kc)
        dks.append(torch.matmul(ds.transpose(-1, -2), qf))
    return dq.to(q.dtype), torch.cat(dks, dim=2).to(k.dtype), torch.cat(dvs, dim=2).to(v.dtype)


class _K2Grad(torch.autograd.Function):
    """K2 (or its plain version on the CPU) forward, saving its output;
    backward ``attention_backward_chunked`` at the JAX forward's kv block,
    as ``tpdm_tpu/ops/attention.py:_sbwd`` differentiates
    ``_streaming_flash_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len: Optional[int]):
        out = _streaming_forward(q, k, v, kv_len)
        ctx.save_for_backward(q, k, v, out)
        ctx.kv_len = kv_len
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        chunk = streaming_block_kv(q.shape[-1], q.element_size())
        return (*attention_backward_chunked(q, k, v, out, do, ctx.kv_len, chunk), None)


def _streaming_forward(q, k, v, kv_len):
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_len)
    kv_len = _check_kernel_operands("flash_attention_streaming", q, k, v, 512, kv_len)
    out = _launch("tpdm_flash_attention_d512", q, k, v, kv_len)
    flash_attention_streaming.launches += 1
    return out


def flash_attention_streaming(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """K2: fused non-causal attention at head_dim 512 (VAE mid block).

    Replaces ``tpdm_tpu/ops/attention.py:_flash_kernel_streaming`` (driven
    by ``_flash_attention_streaming_impl``), which streamed kv blocks over a
    sequential grid axis with (m, acc) in VMEM scratch. On the H100 a block
    of 64 query rows walks kv in tiles that a producer warp brings by TMA,
    and runs both products as wgmma; the 512-wide fp32 accumulator does not
    fit one warp group's registers, so two consumer warp groups own 256
    columns each. ``csrc/attn_d512_sm90.cu`` holds the design note.

    Under autograd (grad mode on and an operand requiring grad) the same
    forward runs inside ``_K2Grad``, which backpropagates by
    ``attention_backward_chunked`` (plain tensor code, on the card and on
    the CPU).

    CUDA: bf16, contiguous (b, h, n, 512) tensors, 16-byte aligned, or it
    raises. CPU: the plain version ``attention_reference``.
    """
    if _wants_grad(q, k, v):
        return _K2Grad.apply(q, k, v, kv_len)
    return _streaming_forward(q, k, v, kv_len)


flash_attention_streaming.launches = 0


def attention_reference_stats(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[int] = None,
):
    """Plain attention returning (o, m, l), K3's plain version.

    As ``tpdm_tpu/ops/attention.py:attention_reference_stats``: with the
    exp2-domain scores s2 = q.k / sqrt(d) * log2(e) in fp32 and kv positions
    >= kv_len set to -1e30, m = max s2 and l = sum exp2(s2 - m) per query
    row (fp32, shape (b, h, n_q)), and o = exp2(s2 - m) V / l with the
    probabilities cast to v's dtype before the product, in q's dtype.
    """
    d = q.shape[-1]
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (_LOG2E / d**0.5)
    if kv_len is not None and kv_len < k.shape[2]:
        valid = torch.arange(k.shape[2], device=k.device) < kv_len
        s2 = s2.masked_fill(~valid, _NEG_INF)
    m = s2.amax(dim=-1)
    p = torch.exp2(s2 - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l[..., None]
    return o.to(q.dtype), m, l


def merge_attention_shards(
    o_parts: torch.Tensor, m_parts: torch.Tensor, l_parts: torch.Tensor
) -> torch.Tensor:
    """Combine per-shard partial attentions into the global softmax result.

    As ``tpdm_tpu/ops/attention.py:merge_attention_shards``: with per-shard
    (o_i, m_i, l_i) over disjoint kv shards, the global output is
    sum_i w_i o_i / sum_i w_i, w_i = exp2(m_i - m*) l_i, m* = max_i m_i.
    Stacked inputs: o (p, b, h, n, d); m, l (p, b, h, n). Output in o's dtype.
    """
    m_star = m_parts.amax(dim=0)
    w = torch.exp2(m_parts - m_star[None]) * l_parts
    num = (w[..., None] * o_parts.float()).sum(dim=0)
    return (num / w.sum(dim=0)[..., None]).to(o_parts.dtype)


def flash_attention_with_stats(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[int] = None,
):
    """K3: K1 plus each query row's softmax statistics, for merging across
    kv shards (the local step of ``parallel/sp_attention.py``'s ring).

    Replaces ``tpdm_tpu/ops/attention.py:_flash_kernel_stats`` (driven by
    ``flash_attention_with_stats``). Returns (o, m, l): o (b, h, n_q, d) in
    q's dtype; m, l (b, h, n_q) fp32, in the exp2 domain of the scores
    s2 = q.k / sqrt(d) * log2(e) over the kv columns < kv_len (see
    ``attention_reference_stats``). q and kv may differ in length. The JAX
    version refuses kv longer than 8192, a bound set by the TPU's VMEM; the
    CUDA kernel walks kv in tiles through shared memory and has no such
    limit. The kernel is K1's wgmma + TMA kernel (``csrc/attn_sm90.cu``)
    with a statistics epilogue: m is the running max, l the denominator
    summed from the fp32 probabilities and reduced over the threads that
    share a row, both written once per row.

    CUDA: bf16, contiguous (b, h, n, 64) tensors, none requiring grad while
    grad mode is on, and 1 <= kv_len <= n_kv, or it raises. CPU: the plain
    version ``attention_reference_stats``.
    """
    if q.device.type == "cpu":
        return attention_reference_stats(q, k, v, kv_len)
    kv_len = _check_kernel_operands(
        "flash_attention_with_stats", q, k, v, 64, kv_len,
        "ROADMAP queue 1, item 14(b): the ring's backward")
    m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    out = _launch("tpdm_flash_attention_stats_d64", q, k, v, kv_len, m, l)
    flash_attention_with_stats.launches += 1
    return out, m, l


flash_attention_with_stats.launches = 0


def joint_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention routed by head width: 512 (the VAE's single wide head) to
    K2, anything else to K1, which on CUDA takes the head dims of
    ``K1_HEAD_DIMS`` and any below 64. On CPU tensors both run the plain
    version."""
    if q.shape[-1] == 512:
        return flash_attention_streaming(q, k, v, kv_len)
    return flash_attention(q, k, v, kv_len)
