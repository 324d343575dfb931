"""Round 3 of the attention studies (``experiments/attn_round3.py``) on the
card.

- vT / vTb ``attn_T``: transposed operands, S^T = K Q^T and acc^T = V^T P^T
  on the TPU; here K6 on q^T, k, V^T_ext (80 rows, the ones row at 64)
  and o^T views. ``score_dtype`` bf16 (vTb) rounds the scores and the
  softmax's steps to bf16.
- vI ``attn_I`` and vTI ``attn_TI``: QK^T in int8 after a per-row
  symmetric quantisation of q and k in plain torch (``_quant_rows``), on
  the int8 tensor cores (K8); vTI takes q^T.
- ``raw_mm`` / ``raw_mm_i8``: the matmul microbenchmarks, on K5 (bf16) and
  K4 (int8, int32 out), the kernels that replace ``_mm_kernel`` and
  ``_mm_kernel_i8``.

The TPU tiling arguments (``block_q``, ``n_block``, ``chunk``) are not
carried over. Run ``python -m tpdm_tpu_torch.experiments.attn_round3`` on a
card to time them at the SD3 shape beside K1 and
scaled_dot_product_attention.
"""

from __future__ import annotations

import torch

from tpdm_tpu_torch.experiments import _common
from tpdm_tpu_torch.ops.attention import attention_reference
from tpdm_tpu_torch.ops.attention_studies import attention_int8qk, attention_strided
from tpdm_tpu_torch.ops.gemm import bf16_gemm, int8_gemm

LOG2E = _common.LOG2E


def _transposed(q, v):
    """q prescaled as q^T (bh, d, n) and V^T_ext (bh, 80, n), materialised."""
    b, h, n, d = q.shape
    bh = b * h
    qt = _common.prescale(q).transpose(-1, -2).reshape(bh, d, n)
    vt = v.transpose(-1, -2).reshape(bh, d, n)
    return qt, torch.cat([vt, _common.ones_rows(bh, n, v)], dim=1)


def attn_T(q, k, v, score_dtype=torch.float32):
    """Transposed layout (K6 on q^T, k, V^T_ext, o^T); returns (b, h, n, d)."""
    b, h, n, d = q.shape
    qt, vt_ext = _transposed(q, v)
    ot = torch.empty_like(qt)
    attention_strided(qt.transpose(1, 2)[None], k.reshape(1, b * h, n, d),
                      vt_ext.transpose(1, 2)[None], score_bf16=score_dtype == torch.bfloat16,
                      out=ot.transpose(1, 2)[None])
    return ot.reshape(b, h, d, n).transpose(-1, -2)


def _quant_rows(x):
    """(bh, n, d) -> int8 values and (bh, n, 1) fp32 scales, symmetric per
    row: round(x / (max|x| / 127)), half to even, clipped to +-127."""
    a = x.float().abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(a, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _int8_operands(q, k):
    b, h, n, d = q.shape
    bh = b * h
    qi, sq = _quant_rows((q.float() * (LOG2E / d**0.5)).reshape(bh, n, d))
    ki, sk = _quant_rows(k.reshape(bh, n, d))
    return qi, sq.reshape(1, bh, n), ki, sk.reshape(1, bh, n)


def attn_I(q, k, v):
    """int8 QK^T in the natural layout with V_ext = [v, ones] (K8)."""
    b, h, n, d = q.shape
    qi, sq, ki, sk = _int8_operands(q, k)
    v_ext = torch.cat([v.reshape(1, b * h, n, d),
                       torch.ones(1, b * h, n, 1, dtype=v.dtype, device=v.device)], dim=-1)
    o = attention_int8qk(qi[None], ki[None], v_ext, sq, sk)
    return o.reshape(b, h, n, d)


def attn_TI(q, k, v):
    """int8 QK^T with q^T (bh, d, n) int8, V^T_ext and o^T (K8, scaled
    sk first as ``_kernel_TI`` scales)."""
    b, h, n, d = q.shape
    bh = b * h
    qi, sq, ki, sk = _int8_operands(q, k)
    qt = qi.transpose(-1, -2).contiguous()  # (bh, d, n) int8
    vt = v.reshape(bh, n, d).transpose(-1, -2)
    vt_ext = torch.cat([vt, _common.ones_rows(bh, n, v)], dim=1)
    ot = torch.empty(bh, d, n, dtype=v.dtype, device=v.device)
    attention_int8qk(qt.transpose(1, 2)[None], ki[None], vt_ext.transpose(1, 2)[None], sq, sk,
                     k_scale_first=True, out=ot.transpose(1, 2)[None])
    return ot.reshape(b, h, d, n).transpose(-1, -2)


def raw_mm(m, kdim, n, dtype=torch.bfloat16, reps=50, device="cuda"):
    """(m, kdim) x (kdim, n) of ones on K5; prints and returns its median ms."""
    a = torch.ones(m, kdim, dtype=dtype, device=device)
    b_t = torch.ones(n, kdim, dtype=dtype, device=device)  # K5 takes (N, K)
    ms = _common.median_ms(lambda: bf16_gemm(a, b_t), reps=reps)
    print(f"raw mm ({m},{kdim})x({kdim},{n}) {str(dtype).split('.')[-1]:9s} "
          f"{ms:7.3f} ms {2 * m * kdim * n / ms / 1e9:6.1f} TF/s", flush=True)
    return ms


def raw_mm_i8(m, kdim, n, reps=50, device="cuda"):
    """(m, kdim) x (kdim, n) int8 -> int32 on K4; prints and returns its median ms."""
    a = torch.ones(m, kdim, dtype=torch.int8, device=device)
    b_t = torch.ones(n, kdim, dtype=torch.int8, device=device)
    ms = _common.median_ms(lambda: int8_gemm(a, b_t), reps=reps)
    print(f"raw mm ({m},{kdim})x({kdim},{n}) int8      {ms:7.3f} ms "
          f"{2 * m * kdim * n / ms / 1e9:6.1f} TOP/s", flush=True)
    return ms


def main():
    _common.require_card()
    print("== raw matmul rates ==", flush=True)
    for shape in ((2240, 64, 640), (2240, 128, 640), (2240, 640, 128), (2240, 640, 64),
                  (640, 640, 4480), (128, 640, 4480), (640, 64, 640)):
        raw_mm(*shape)
    raw_mm_i8(2240, 64, 640)
    raw_mm_i8(640, 64, 640)
    q, k, v = _common.natural_qkv(0)
    n = _common.N
    _common.run_study(
        "attn_round3", {**_common.yardsticks(q, k, v),
                        "vT fp32 (K6)": lambda: attn_T(q, k, v),
                        "vTb bf16 (K6)": lambda: attn_T(q, k, v, torch.bfloat16),
                        "vI int8 qk (K8)": lambda: attn_I(q, k, v),
                        "vTI int8 qk, q^T (K8)": lambda: attn_TI(q, k, v)},
        4 * _common.B * _common.H * n * n * _common.D, attention_reference(q, k, v))


if __name__ == "__main__":
    main()
