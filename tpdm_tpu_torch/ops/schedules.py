"""The reference Beta schedule of the KL anchor.

Counterpart of ``tpdm_tpu/ops/schedules.py:get_ref_beta``. The fixed-step
sigma ladders of that module are not ported yet (ROADMAP queue 1, item 2).
"""

from __future__ import annotations

import math

import torch

EPSILON = 1e-3
CONCENTRATION = 20.0
_E = math.e


def get_ref_beta(sigmas: torch.Tensor, num_steps: int = 28) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sigma reference Beta(alpha, beta) for the KL penalty.

    The uniform ``num_steps`` flow schedule as a Beta prior over the decay
    ratio: sigma -> t = sigma / (e + (1 - e) sigma), t stepped down by
    1/num_steps (clamped at EPSILON), mapped back to sigma', and a
    concentration-20 Beta centred at the mode sigma' / sigma. Returns
    (alpha, beta) of ``sigmas``' shape.
    """
    t_1 = sigmas / (_E + (1.0 - _E) * sigmas)
    t_2 = torch.clamp(t_1 - 1.0 / num_steps, min=EPSILON)
    sigmas_2 = _E / (_E + 1.0 / t_2 - 1.0)
    mode = sigmas_2 / sigmas
    alpha = mode * (CONCENTRATION - 2.0) + 1.0
    beta = (1.0 - mode) * (CONCENTRATION - 2.0) + 1.0
    return alpha, beta
