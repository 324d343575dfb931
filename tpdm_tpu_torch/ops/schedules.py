"""The reference Beta schedule of the KL anchor and the fixed sigma ladder.

Counterpart of ``tpdm_tpu/ops/schedules.py``: ``get_ref_beta`` and
``uniform_flow_sigmas``. ``img2img_sigmas`` waits for the VAE encoder
(ROADMAP queue 1, item 4).
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


def uniform_flow_sigmas(num_steps: int = 28, shift: float = 3.0) -> torch.Tensor:
    """SD3's fixed ``num_steps`` flow-matching ladder, (num_steps,) float32
    on the CPU, descending from 1.0 (append the terminal 0 to integrate to
    the clean image): sigma_i = shift t_i / (1 + (shift - 1) t_i), t
    descending linearly from 1 to 1/1000.

    Built on the host in float32 with the operations that XLA runs for
    ``jnp.linspace`` (t_i = 1 (1 - s_i) + 0.001 s_i with s_i = i times the
    float32 reciprocal of T - 1, the last t exactly 1/1000), so the ladder
    equals the JAX package's bit for bit; a true division would differ in
    the last bit at some steps (T = 28: step 20). The samplers read it on
    the host, where their branches are decided.
    """
    f32 = dict(dtype=torch.float32)
    start, stop = torch.tensor(1.0, **f32), torch.tensor(1.0 / 1000.0, **f32)
    if num_steps > 1:
        div = num_steps - 1
        step = torch.arange(div, **f32) * (1.0 / torch.tensor(float(div), **f32))
        t = torch.cat([start * (1 - step) + stop * step, stop[None]])
    else:
        t = start.reshape(num_steps)
    return shift * t / (1.0 + (shift - 1.0) * t)
