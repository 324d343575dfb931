"""Natural operands, transposed output (``experiments/attn_natural_operands.py``)
on the card.

``flash_nat`` takes q, k, v in the natural (b, h, n, d) layout, the ones
column riding V_ext (b, h, n, 80), and writes o^T (b, h, d, n), which the
out projection contracts over (h, d) with no epilogue copy: K6 with a
natural-in, transposed-out view. ``block_standard`` (K1 after (b, h, n, d)
copies) and ``block_nat`` are whole attention blocks at width h * 64; their
projections are plain matmuls in the input's dtype.

The TPU's ``chunk`` is not carried over. Run ``python -m
tpdm_tpu_torch.experiments.attn_natural_operands`` on a card to time both
blocks at the SD3 shape (width 1536).
"""

from __future__ import annotations

import torch

from tpdm_tpu_torch.experiments import _common
from tpdm_tpu_torch.experiments._common import block_standard, out_projection
from tpdm_tpu_torch.ops.attention_studies import attention_strided

__all__ = ["flash_nat", "block_standard", "block_nat", "main"]


def flash_nat(q, k, v):
    """(b, h, n, d) natural in; (b, h, d, n) transposed out."""
    b, h, n, d = q.shape
    extra = torch.zeros(b, h, n, _common.DV - d, dtype=v.dtype, device=v.device)
    extra[..., 0] = 1
    ve = torch.cat([v, extra], dim=-1)
    ot = torch.empty(b, h, d, n, dtype=q.dtype, device=q.device)
    attention_strided(_common.prescale(q), k, ve, out=ot.transpose(-1, -2))
    return ot


def block_nat(x, wq, wk, wv, wo):
    """The block with ``flash_nat``: o^T straight into the out projection."""
    b, n, h, c = _common.block_shapes(x)
    q, k, v = ((x @ w).reshape(b, n, h, _common.D).transpose(1, 2).contiguous()
               for w in (wq, wk, wv))
    return out_projection(flash_nat(q, k, v), wo)


def main():
    _common.require_card()
    B, N, C = _common.B, _common.N, _common.C
    x, *ws = _common.make_inputs(0, (B, N, C))[:1] + _common.make_inputs(
        1, *[(C, C)] * 4, scale=0.02)
    a, bn = block_standard(x, *ws), block_nat(x, *ws)
    print(f"A vs B maxerr: {(a.float() - bn.float()).abs().max().item():.2e} "
          f"(scale {a.float().abs().max().item():.2e})", flush=True)
    flops = 4 * B * _common.H * N * N * _common.D + 8 * B * N * C * C
    _common.run_study("attn_natural_operands (attention blocks)",
                      {"A current kernel block (K1)": lambda: block_standard(x, *ws),
                       "B natural-operand block (K6)": lambda: block_nat(x, *ws)}, flops)


if __name__ == "__main__":
    main()
