"""Round 4 of the attention studies (``experiments/attn_round4.py``) on the
card: the transposed kernel on pre-transposed operands, and the two-stream
split softmax.

- ``kernel_call``: what ``tpdm_tpu/ops/attention.py`` ``_flash_kernel``
  computes on qt (bh, D, N) prescaled, k3 (bh, N, D) and vt_ext (bh, DV, N):
  o^T (bh, D, N). K6 on those views.
- ``split_call``: even and odd kv tiles in two independent online-softmax
  streams, merged exactly at the end (K6, ``streams=2``).

The study swept ``chunk``, a TPU tiling argument that is not carried over.
Run ``python -m tpdm_tpu_torch.experiments.attn_round4`` on a card to time
both, hoist-free as the study does (the output feeds the next qt).
"""

from __future__ import annotations

import torch

from tpdm_tpu_torch.experiments import _common

LOG2E = _common.LOG2E
B, H, N, D = _common.B, _common.H, _common.N, _common.D
DV = _common.DV


def kernel_call(qt, k3, vt_ext):
    """o^T (bh, D, N) of ``_flash_kernel`` on transposed operands (K6)."""
    return _common.transposed_call(qt, k3, vt_ext)


def split_call(qt, k3, vt_ext):
    """The two-stream split softmax, merged exactly (K6, two streams)."""
    return _common.transposed_call(qt, k3, vt_ext, streams=2)


def transposed_inputs(seed: int = 0):
    """qt (bh, D, N) prescaled, k3 (bh, N, D) and vt_ext (bh, DV, N) with
    the ones row, as the study's ``main`` draws them (bf16, on the card)."""
    bh = B * H
    qt, k3, vt = _common.make_inputs(seed, (bh, D, N), (bh, N, D), (bh, D, N))
    qt = (qt.float() * (LOG2E / D**0.5)).to(qt.dtype)
    return qt, k3, torch.cat([vt, _common.ones_rows(bh, N, vt, DV)], dim=1)


def main():
    _common.require_card()
    qt, k3, vt_ext = transposed_inputs()
    ref = kernel_call(qt, k3, vt_ext)
    err = (split_call(qt, k3, vt_ext).float() - ref.float()).abs().max().item()
    print(f"correctness split vs chunk: maxerr {err:.2e}", flush=True)
    state = {"q": qt}

    def chained(call):
        def step():
            state["q"] = state["q"] + (0.001 * call(state["q"], k3, vt_ext).float()).to(qt.dtype)
            return state["q"]
        return step

    _common.run_study("attn_round4 (hoist-free chain)",
                      {"kernel_call (K6)": chained(kernel_call),
                       "split_call, two streams (K6)": chained(split_call)},
                      4 * B * H * N * N * D)


if __name__ == "__main__":
    main()
