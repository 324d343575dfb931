"""Transposed q/v emission from the projections
(``experiments/attn_block_layout.py``) on the card: whole attention blocks
at width h * 64.

- ``block_standard``: dense q, k, v, (b, h, n, d) copies, K1, out
  projection.
- ``block_transposed``: q^T and v^T produced by the projections directly
  as (b, h, d, n), k natural (a strided view of the projection, no copy),
  the kernel on those views (``_kernel_call``: K6), the out projection
  contracting (h, d) straight from o^T. ``with_ones`` appends the ones row
  to V^T (the study's variant C); without it K6 takes the row sum of p
  (the study's kernel had no denominator without the ones row).

Projections are plain matmuls in the input's dtype. The TPU's ``chunk`` is
not carried over. Run ``python -m
tpdm_tpu_torch.experiments.attn_block_layout`` on a card to time the
blocks at the SD3 shape (width 1536).
"""

from __future__ import annotations

import torch

from tpdm_tpu_torch.experiments import _common
from tpdm_tpu_torch.experiments._common import block_standard, out_projection

__all__ = ["_kernel_call", "block_standard", "block_transposed", "main"]


def _kernel_call(qt, k3, vt_ext):
    """``_flash_kernel`` on qt (bh, d, n), k3 (bh, n, d), vt_ext (bh, dv, n):
    o^T (bh, d, n) (K6)."""
    return _common.transposed_call(qt, k3, vt_ext)


def block_transposed(x, wq, wk, wv, wo, with_ones=True):
    b, n, h, c = _common.block_shapes(x)
    d = _common.D
    qt = torch.einsum("chd,bnc->bhdn", wq.reshape(c, h, d), x)
    vt = torch.einsum("chd,bnc->bhdn", wv.reshape(c, h, d), x)
    k = (x @ wk).reshape(b, n, h, d).transpose(1, 2)  # (b, h, n, d), a view
    qt = (qt.float() * (_common.LOG2E / d**0.5)).to(qt.dtype)
    if with_ones:
        vt = torch.cat([vt, _common.ones_rows(b * h, n, vt).reshape(b, h, -1, n)], dim=2)
    o_t = _kernel_call(qt.reshape(b * h, d, n), k.reshape(b * h, n, d),
                       vt.reshape(b * h, -1, n)).reshape(b, h, d, n)
    return out_projection(o_t, wo)


def main():
    _common.require_card()
    B, N, C = _common.B, _common.N, _common.C
    x, *ws = _common.make_inputs(0, (B, N, C))[:1] + _common.make_inputs(
        1, *[(C, C)] * 4, scale=0.02)
    a, bt = block_standard(x, *ws), block_transposed(x, *ws)
    print(f"A vs B maxerr: {(a.float() - bt.float()).abs().max().item():.2e} "
          f"(scale {a.float().abs().max().item():.2e})", flush=True)
    flops = 4 * B * _common.H * N * N * _common.D + 8 * B * N * C * C
    _common.run_study("attn_block_layout (attention blocks)",
                      {"A standard block (K1)": lambda: block_standard(x, *ws),
                       "B transposed block (K6)": lambda: block_transposed(x, *ws),
                       "B without the ones row (K6)": lambda: block_transposed(
                           x, *ws, with_ones=False)}, flops)


if __name__ == "__main__":
    main()
