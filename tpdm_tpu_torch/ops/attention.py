"""Attention for the joint image+text sequence and the VAE mid block.

Three hand-written Hopper kernels (K1 and K3, two instantiations of the
wgmma + TMA kernel of ``csrc/attn_sm90.cu``; K2, a wgmma + TMA kernel of
its own in ``csrc/attn_d512_sm90.cu``) and their plain PyTorch versions,
``attention_reference`` and ``attention_reference_stats``. The wrappers
dispatch on the tensor's device: a CUDA tensor launches the kernel (or the
wrapper raises on what the kernel does not take, operands that require
grad included: no kernel has a backward), a CPU tensor runs the plain
version. There is no flag that picks the plain version on CUDA.

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


def _check_kernel_operands(name: str, q, k, v, head_dim: int, kv_len) -> int:
    """Validate CUDA operands for a kernel; returns the effective kv_len."""
    _build.refuse_grad(name, q, k, v)
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


def _pad_to_64(t: torch.Tensor) -> torch.Tensor:
    """(b, h, n, d) -> (b, h, n, 64) with zero columns past d, contiguous."""
    return torch.nn.functional.pad(t, (0, 64 - t.shape[-1])).contiguous()


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

    CUDA: bf16, contiguous (b, h, n, d) tensors with d in ``K1_HEAD_DIMS``
    or below 64, none requiring grad while grad mode is on, or it raises.
    CPU: the plain version ``attention_reference``.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_len)
    d = q.shape[-1]
    if d in K1_HEAD_DIMS:
        kv_len = _check_kernel_operands("flash_attention", q, k, v, d, kv_len)
        out = _launch(f"tpdm_flash_attention_d{d}", q, k, v, kv_len)
    elif 1 <= d < 64:
        kv_len = _check_kernel_operands("flash_attention", q, k, v, d, kv_len)
        out = _launch("tpdm_flash_attention_d64_padded", _pad_to_64(q), _pad_to_64(k),
                      _pad_to_64(v), kv_len, head_dim=d)[..., :d]
    else:
        raise ValueError(f"flash_attention: head_dim {d}; the kernel takes {K1_HEAD_DIMS} "
                         "or any head_dim below 64")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


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

    CUDA: bf16, contiguous (b, h, n, 512) tensors, 16-byte aligned, none
    requiring grad while grad mode is on, or it raises. CPU: the plain
    version ``attention_reference``.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_len)
    kv_len = _check_kernel_operands("flash_attention_streaming", q, k, v, 512, kv_len)
    out = _launch("tpdm_flash_attention_d512", q, k, v, kv_len)
    flash_attention_streaming.launches += 1
    return out


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
    kv_len = _check_kernel_operands("flash_attention_with_stats", q, k, v, 64, kv_len)
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
