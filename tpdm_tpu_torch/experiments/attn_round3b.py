"""Round 3b of the attention studies (``experiments/attn_round3b.py``) on
the card: the transposed layout refined.

- vT / vTc ``attn_T``: K6 on q^T, k, V^T_ext and o^T; ``soft_dtype`` bf16
  (vTc) casts s to bf16 before the max, the subtraction and exp2.
- vTm / vTmc ``attn_Tm``: max-free against the per-query Cauchy-Schwarz
  bound rb = |q_i| max_j |k_j| (K7), fp32 or bf16 softmax.

The TPU tiling arguments (``n_block``, ``chunk``) are not carried over.
Run ``python -m tpdm_tpu_torch.experiments.attn_round3b`` on a card to time
them at the SD3 shape beside K1 and scaled_dot_product_attention.
"""

from __future__ import annotations

import torch

from tpdm_tpu_torch.experiments import _common
from tpdm_tpu_torch.ops.attention import attention_reference
from tpdm_tpu_torch.ops.attention_studies import attention_maxfree, attention_strided


def _prep_T(q, k, v):
    """As the study's ``_prep_T``: qt (bh, d, n) prescaled, k3 (bh, n, d),
    vt_ext (bh, dv, n) with the ones row at d and zero rows to dv = 80."""
    b, h, n, d = q.shape
    bh = b * h
    qt = _common.prescale(q).transpose(-1, -2).reshape(bh, d, n)
    vt = v.transpose(-1, -2).reshape(bh, d, n)
    dv = _common.round_up(d + 1, 16)
    vt_ext = torch.cat([vt, _common.ones_rows(bh, n, v, dv)], dim=1)
    return qt, k.reshape(bh, n, d), vt_ext, bh, dv


def _views(qt, k3, vt_ext):
    ot = torch.empty_like(qt)
    return (qt.transpose(1, 2)[None], k3[None], vt_ext.transpose(1, 2)[None]), ot


def attn_T(q, k, v, soft_dtype=torch.float32):
    """Transposed layout, online softmax (K6); returns (b, h, n, d)."""
    b, h, n, d = q.shape
    qt, k3, vt_ext, bh, dv = _prep_T(q, k, v)
    args, ot = _views(qt, k3, vt_ext)
    attention_strided(*args, score_bf16=soft_dtype == torch.bfloat16,
                      out=ot.transpose(1, 2)[None])
    return ot.reshape(b, h, d, n).transpose(-1, -2)


def attn_Tm(q, k, v, soft_dtype=torch.float32):
    """Transposed layout, max-free against rb (bh, 1, n) (K7)."""
    b, h, n, d = q.shape
    qt, k3, vt_ext, bh, dv = _prep_T(q, k, v)
    qn = torch.linalg.vector_norm(qt.float(), dim=1, keepdim=True)  # (bh, 1, n)
    kn = torch.linalg.vector_norm(k3.float(), dim=-1).amax(dim=-1)  # (bh,)
    rb = qn * kn[:, None, None]
    args, ot = _views(qt, k3, vt_ext)
    attention_maxfree(*args, rb.reshape(1, bh, n),
                      soft_bf16=soft_dtype == torch.bfloat16, out=ot.transpose(1, 2)[None])
    return ot.reshape(b, h, d, n).transpose(-1, -2)


def main():
    _common.require_card()
    q, k, v = _common.natural_qkv(0)
    n = _common.N
    _common.run_study(
        "attn_round3b", {**_common.yardsticks(q, k, v),
                         "vT fp32 (K6)": lambda: attn_T(q, k, v),
                         "vTc bf16 soft (K6)": lambda: attn_T(q, k, v, torch.bfloat16),
                         "vTm max-free (K7)": lambda: attn_Tm(q, k, v),
                         "vTmc max-free bf16 (K7)": lambda: attn_Tm(q, k, v, torch.bfloat16)},
        4 * _common.B * _common.H * n * n * _common.D, attention_reference(q, k, v))


if __name__ == "__main__":
    main()
