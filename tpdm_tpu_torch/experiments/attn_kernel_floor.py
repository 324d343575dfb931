"""The bare kernel's floor (``experiments/attn_kernel_floor.py``) on the
card, timed hoist-free: the kernel's output feeds the next iteration's q.

- ``kernel_call``: ``_flash_kernel`` on transposed qt, k3, vt_ext; o^T (K6).
- ``kernel_call_inT``: q arrives natural (bh, N, D) and the kernel reads it
  in that layout (the study transposed it in VMEM); o^T (K6).

The TPU's ``chunk`` is not carried over. Run ``python -m
tpdm_tpu_torch.experiments.attn_kernel_floor`` on a card.
"""

from __future__ import annotations

import torch

from tpdm_tpu_torch.experiments import _common
from tpdm_tpu_torch.experiments.attn_round4 import transposed_inputs
from tpdm_tpu_torch.ops.attention_studies import attention_strided

LOG2E = _common.LOG2E
B, H, N, D = _common.B, _common.H, _common.N, _common.D
DV = _common.DV


def kernel_call(qt, k3, vt_ext):
    """o^T (bh, D, N) on transposed operands (K6)."""
    return _common.transposed_call(qt, k3, vt_ext)


def kernel_call_inT(qn, k3, vt_ext):
    """q natural (bh, N, D) prescaled; o^T (bh, D, N) (K6)."""
    bh, n, d = qn.shape
    ot = torch.empty(bh, d, n, dtype=qn.dtype, device=qn.device)
    attention_strided(qn[None], k3[None], vt_ext.transpose(1, 2)[None],
                      out=ot.transpose(1, 2)[None])
    return ot


def main():
    _common.require_card()
    qt, k3, vt_ext = transposed_inputs()
    qn = qt.transpose(1, 2).contiguous()

    def chained(call, q0, epilogue=lambda o: o):
        state = {"q": q0}

        def step():
            o = epilogue(call(state["q"], k3, vt_ext))
            state["q"] = state["q"] + (0.001 * o.float()).to(q0.dtype)
            return state["q"]
        return step

    _common.run_study("attn_kernel_floor (hoist-free chain)",
                      {"bare transposed-in kernel (K6)": chained(kernel_call, qt),
                       "inT kernel (+1 epilogue T) (K6)": chained(
                           kernel_call_inT, qn, lambda o: o.transpose(1, 2))},
                      4 * B * H * N * N * D)


if __name__ == "__main__":
    main()
