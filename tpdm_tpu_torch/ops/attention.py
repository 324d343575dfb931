"""Attention for the joint image+text sequence and the VAE mid block.

Two hand-written Hopper kernels (``csrc/flash_attn_fwd.cu``) and their plain
PyTorch version, ``attention_reference``. The wrappers dispatch on the
tensor's device: a CUDA tensor launches the kernel (or the wrapper raises on
what the kernel does not take), a CPU tensor runs the plain version. There is
no flag that picks the plain version on CUDA.

Layouts follow the JAX package: q, k, v and the output are (b, h, n, d).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpdm_tpu_torch.ops import _build

_NEG_INF = -1e30


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


def _launch(entry: str, q, k, v, kv_len: int) -> torch.Tensor:
    lib = _build.load_library()
    out = torch.empty_like(q)
    b, h, n_q, _ = q.shape
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, n_q, k.shape[2], kv_len,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = lib.tpdm_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """K1: fused non-causal attention at head_dim 64 (MMDiT joint attention).

    Replaces ``tpdm_tpu/ops/attention.py:_flash_kernel`` (driven by
    ``_flash_attention_fwd_impl``): softmax(QK^T/sqrt(d))V per batch*head
    with an fp32 exp2-domain online softmax and kv positions >= kv_len
    masked by a -1e30 bias. On the H100 the SD3 1024 px shape
    (2, 24, 4480, 64) is compute bound; the kernel runs its two products on
    the tensor cores (mma.sync bf16, fp32 accumulate) over 64-row kv tiles
    in shared memory, 64 query rows a block. ``csrc/flash_attn_fwd.cu``
    holds the design note.

    CUDA: bf16, contiguous (b, h, n, 64) tensors, or it raises. CPU: the
    plain version ``attention_reference``.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_len)
    kv_len = _check_kernel_operands("flash_attention", q, k, v, 64, kv_len)
    out = _launch("tpdm_flash_attention_d64", q, k, v, kv_len)
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
    sequential grid axis with (m, acc) in VMEM scratch. On the H100 the
    1024 px shape (b, 1, 16384, 512) is compute bound; the same kernel
    template as K1 walks kv in 32-row tiles inside each block, and splits
    the 512-wide accumulator across four warp columns (it cannot fit one
    warp group's registers) that share one set of row statistics.

    CUDA: bf16, contiguous (b, h, n, 512) tensors, or it raises. CPU: the
    plain version ``attention_reference``.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_len)
    kv_len = _check_kernel_operands("flash_attention_streaming", q, k, v, 512, kv_len)
    out = _launch("tpdm_flash_attention_d512", q, k, v, kv_len)
    flash_attention_streaming.launches += 1
    return out


flash_attention_streaming.launches = 0


def joint_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention routed by head width: 512 (the VAE's single wide head) to
    K2, anything else to K1, which on CUDA takes head_dim 64 only. On CPU
    tensors both run the plain version."""
    if q.shape[-1] == 512:
        return flash_attention_streaming(q, k, v, kv_len)
    return flash_attention(q, k, v, kv_len)
