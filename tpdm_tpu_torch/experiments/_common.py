"""What the study modules share: the SD3-medium 1024 px study shape, inputs
from a seed, operand preparation, the attention blocks, and timing on the
card (CUDA events).

The study shape is the MMDiT's joint attention at 1024 px: b 2, h 24,
4096 image + 333 text tokens padded to 4480, d 64, width 1536.
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, Optional

import torch

from tpdm_tpu_torch.ops.attention import flash_attention
from tpdm_tpu_torch.ops.attention_studies import attention_strided

LOG2E = 1.4426950408889634
B, H, D = 2, 24, 64
N, N_REAL = 4480, 4429  # joint tokens padded to a multiple of 128, and valid
C = H * D  # 1536
DV = 80  # rows of V^T (or columns of V) with the ones row at D, zeros after


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def prescale(q: torch.Tensor) -> torch.Tensor:
    """q * log2(e)/sqrt(d) in fp32, back in q's dtype (the studies' exp2 domain)."""
    return (q.float() * (LOG2E / q.shape[-1] ** 0.5)).to(q.dtype)


def ones_rows(bh: int, n: int, like: torch.Tensor, dv: int = DV) -> torch.Tensor:
    """(bh, dv - d, n): the ones row of V^T, then zero rows up to dv."""
    extra = torch.zeros(bh, dv - D, n, dtype=like.dtype, device=like.device)
    extra[:, 0] = 1
    return extra


def transposed_call(qt, k3, vt_ext, streams: int = 1) -> torch.Tensor:
    """K6 on the transposed operands of ``tpdm_tpu/ops/attention.py``
    ``_flash_kernel``: qt (bh, d, n_q) prescaled, k3 (bh, n_kv, d), vt_ext
    (bh, dv, n_kv) with the ones row at d; returns o^T (bh, d, n_q). A
    64-row vt (no ones row) takes the row-sum denominator instead."""
    bh, d, n_q = qt.shape
    ot = torch.empty(bh, d, n_q, dtype=qt.dtype, device=qt.device)
    attention_strided(qt.transpose(1, 2)[None], k3[None], vt_ext.transpose(1, 2)[None],
                      streams=streams, out=ot.transpose(1, 2)[None])
    return ot


def block_shapes(x: torch.Tensor):
    b, n, c = x.shape
    return b, n, c // D, c


def block_standard(x, wq, wk, wv, wo):
    """A full attention block, x (b, n, c) -> (b, n, c): the q, k, v
    projections, (b, h, n, d) copies, K1, the out projection. The
    projections are plain matmuls (``torch.matmul``) in x's dtype."""
    b, n, h, c = block_shapes(x)
    q, k, v = ((x @ w).reshape(b, n, h, D).transpose(1, 2).contiguous() for w in (wq, wk, wv))
    o = flash_attention(q, k, v)
    return o.transpose(1, 2).reshape(b, n, c) @ wo


def out_projection(ot, wo):
    """o^T (b, h, d, n) against wo (c, c), contracting (h, d): (b, n, c)."""
    h = ot.shape[1]
    return torch.einsum("bhdn,hdc->bnc", ot, wo.reshape(h, D, -1))


def make_inputs(seed: int, *shapes, device="cuda", dtype=torch.bfloat16, scale=1.0):
    """N(0, scale^2) tensors of the given shapes from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(s, generator=g, device=device) * scale).to(dtype) for s in shapes]


def require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the studies time hand-written CUDA kernels: they need a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def median_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2,
              calls: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after ``warmup`` calls;
    each timing brackets ``calls`` back-to-back calls and is divided by
    them."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def run_study(title: str, variants: Dict[str, Callable[[], torch.Tensor]], flops: float,
              ref: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Time each variant on the card and print its ms, TFLOP/s and (with
    ``ref``) its max abs error against ref; returns the ms by name."""
    print(f"== {title} on {torch.cuda.get_device_name(0)} ==", flush=True)
    times = {}
    for name, fn in variants.items():
        out = fn()
        err = ("" if ref is None
               else f"  maxerr {(out.float() - ref.float()).abs().max().item():.2e}")
        times[name] = ms = median_ms(fn)
        print(f"{name:40s} {ms:8.3f} ms {flops / ms / 1e9:7.1f} TF/s{err}", flush=True)
    return times


def natural_qkv(seed: int = 0, n: int = N):
    """q, k, v (B, H, n, D) bf16 on the card, N(0, 1) from ``seed``."""
    return make_inputs(seed, *[(B, H, n, D)] * 3)


def yardsticks(q, k, v, kv_len=None) -> Dict[str, Callable[[], torch.Tensor]]:
    """K1 and PyTorch's scaled_dot_product_attention on natural (b, h, n, d)
    operands, the studies' yardsticks (SDPA on the valid kv rows)."""
    from torch.nn.functional import scaled_dot_product_attention

    n_kv = k.shape[2] if kv_len is None else kv_len
    return {
        "K1 flash_attention": lambda: flash_attention(q, k, v, kv_len),
        "scaled_dot_product_attention": lambda: scaled_dot_product_attention(
            q, k[:, :, :n_kv], v[:, :, :n_kv]),
    }
