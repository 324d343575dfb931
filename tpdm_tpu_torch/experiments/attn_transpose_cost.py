"""What the layout changes around the kernel cost
(``experiments/attn_transpose_cost.py``), on the card.

``kernel_only`` is the bare kernel on pre-transposed operands (qt, k3,
vt_ext): what ``tpdm_tpu/ops/attention.py`` ``_flash_kernel`` computes, on
K6. ``main`` times it against the port's full path, K1 on the natural
(b, h, n, d) operands (K1 takes that layout and needs no prep), and
against the prep that would make the transposed operands. The TPU's
``chunk`` is not carried over. Run ``python -m
tpdm_tpu_torch.experiments.attn_transpose_cost`` on a card.
"""

from __future__ import annotations

import torch

from tpdm_tpu_torch.experiments import _common
from tpdm_tpu_torch.ops.attention import flash_attention


def kernel_only(qt, k3, vt_ext):
    """o^T (bh, d, n) of the transposed kernel (K6)."""
    return _common.transposed_call(qt, k3, vt_ext)


def prep_transposed(q, k, v):
    """qt (bh, d, n) prescaled, k3 (bh, n, d), vt_ext (bh, 80, n) with the
    ones row: the operands of the package's transposed kernel at kv_len =
    n (no mask row)."""
    b, h, n, d = q.shape
    bh = b * h
    qt = _common.prescale(q).transpose(-1, -2).reshape(bh, d, n)
    vt = v.transpose(-1, -2).reshape(bh, d, n)
    return qt, k.reshape(bh, n, d), torch.cat([vt, _common.ones_rows(bh, n, v)], dim=1)


def main():
    _common.require_card()
    q, k, v = _common.natural_qkv(0)
    n = _common.N
    qt, k3, vt_ext = prep_transposed(q, k, v)
    times = _common.run_study(
        "attn_transpose_cost",
        {"full path: K1 on natural operands": lambda: flash_attention(q, k, v),
         "prep + kernel_only (K6)": lambda: kernel_only(*prep_transposed(q, k, v)),
         "bare kernel_only on pre-transposed (K6)": lambda: kernel_only(qt, k3, vt_ext)},
        4 * _common.B * _common.H * n * n * _common.D)
    full, bare = times["prep + kernel_only (K6)"], times["bare kernel_only on pre-transposed (K6)"]
    print(f"layout-op overhead: {full - bare:.3f} ms ({(full - bare) / full * 100:.1f}%)",
          flush=True)


if __name__ == "__main__":
    main()
