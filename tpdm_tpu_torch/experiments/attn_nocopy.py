"""The copy-free study of ``experiments/attn_nocopy.py`` on the card.

- vsum: no ones column, the denominator is the fp32 row sum of p (K6 with
  a 64-wide V);
- packed2: q, k, v and o in the projections' layout (b, n, h*d), read and
  written in place through strided views, no transpose (K6). The study
  took two heads a program (128 lanes); the kernel takes one head a block.

The TPU tiling arguments (``block_q``, ``chunk``) are not carried over.
Run ``python -m tpdm_tpu_torch.experiments.attn_nocopy`` on a card to time
them at the SD3 shape, from the (b, n, h*d) layout as the study does,
beside K1 (with its transposes) and scaled_dot_product_attention.
"""

from __future__ import annotations

import torch

from tpdm_tpu_torch.experiments import _common
from tpdm_tpu_torch.ops.attention import attention_reference, flash_attention
from tpdm_tpu_torch.ops.attention_studies import attention_strided

B, H, D = _common.B, _common.H, _common.D
N_REAL, N_PAD = _common.N_REAL, _common.N


def _heads(t):  # (b, n, h*d) -> (b, h, n, d)
    b, n, _ = t.shape
    return t.reshape(b, n, H, D).transpose(1, 2)


def _unheads(t):  # (b, h, n, d) -> (b, n, h*d)
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def attn_vsum(q4, k4, v4, kv_len=N_REAL):
    """Natural (b, h, n, d) operands, no ones column (K6, row-sum l)."""
    return attention_strided(_common.prescale(q4), k4, v4, kv_len)


def attn_packed2(q2, k2, v2, kv_len=N_REAL):
    """q2, k2, v2 (b, n, h*d), the projection output layout; returns
    (b, n, h*d) written in place by the kernel."""
    b, n, hd = q2.shape
    q2 = (q2.float() * (_common.LOG2E / D**0.5)).to(q2.dtype)
    out = torch.empty(b, n, hd, dtype=q2.dtype, device=q2.device)
    attention_strided(_heads(q2), _heads(k2), _heads(v2), kv_len, out=_heads(out))
    return out


def main():
    _common.require_card()
    q2, k2, v2 = _common.make_inputs(0, *[(B, N_PAD, H * D)] * 3)
    zero_tail = (torch.arange(N_PAD, device=q2.device) < N_REAL)[None, :, None]
    q2, k2, v2 = (t * zero_tail for t in (q2, k2, v2))  # the model's zero tail rows
    ref = _unheads(attention_reference(_heads(q2), _heads(k2), _heads(v2), N_REAL))
    heads = lambda t: _heads(t).contiguous()
    _common.run_study(
        "attn_nocopy (from the (b, n, h*d) layout)",
        {"exact4480 K1 + transposes": lambda: _unheads(flash_attention(
            heads(q2), heads(k2), heads(v2), N_REAL)),
         "vsum (K6) + transposes": lambda: _unheads(attn_vsum(
             heads(q2), heads(k2), heads(v2), N_REAL)),
         "packed2 (K6), no transposes": lambda: attn_packed2(q2, k2, v2)},
        4 * B * H * N_REAL * N_REAL * D, ref)


if __name__ == "__main__":
    main()
