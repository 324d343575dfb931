"""Per-sample-sigma Euler step for rectified flow, in fp32.

Counterpart of ``tpdm_tpu/ops/flow_euler.py``: x_next = x + (sigma_next −
sigma)·v per sample, computed in float32 and cast to the velocity's dtype.
"""

from __future__ import annotations

import torch


def flow_euler_step(
    model_output: torch.Tensor,
    sigma_next: torch.Tensor,
    sigma: torch.Tensor,
    sample: torch.Tensor,
) -> torch.Tensor:
    """One Euler flow step. model_output, sample: (b, ...); sigma_next,
    sigma: (b,). Returns the next latents in model_output's dtype."""
    delta = (sigma_next - sigma).to(torch.float32)
    delta = delta.reshape(delta.shape + (1,) * (sample.dim() - 1))
    prev = sample.to(torch.float32) + delta * model_output.to(torch.float32)
    return prev.to(model_output.dtype)
