"""The reference Beta schedule of the KL anchor and the fixed sigma ladder.

Counterpart of ``tpdm_tpu/ops/schedules.py``: ``get_ref_beta``,
``uniform_flow_sigmas`` and its image-to-image companion ``img2img_sigmas``.
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


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """float32 ``jnp.linspace(start, stop, num)`` with the operations XLA
    runs for it: t_i = start (1 - s_i) + stop s_i with s_i = i times the
    float32 reciprocal of num - 1, the last t exactly ``stop``. A true
    division would differ in the last bit at some steps (num = 28: step 20)."""
    f32 = dict(dtype=torch.float32)
    start, stop = torch.tensor(start, **f32), torch.tensor(stop, **f32)
    if num > 1:
        div = num - 1
        step = torch.arange(div, **f32) * (1.0 / torch.tensor(float(div), **f32))
        return torch.cat([start * (1 - step) + stop * step, stop[None]])
    return start.reshape(num)


def uniform_flow_sigmas(num_steps: int = 28, shift: float = 3.0) -> torch.Tensor:
    """SD3's fixed ``num_steps`` flow-matching ladder, (num_steps,) float32
    on the CPU, descending from 1.0 (append the terminal 0 to integrate to
    the clean image): sigma_i = shift t_i / (1 + (shift - 1) t_i), t
    descending linearly from 1 to 1/1000.

    Built on the host in float32 as ``jnp.linspace`` builds it
    (``_linspace_f32``), so the ladder equals the JAX package's bit for
    bit. The samplers read it on the host, where their branches are decided.
    """
    t = _linspace_f32(1.0, 1.0 / 1000.0, num_steps)
    return shift * t / (1.0 + (shift - 1.0) * t)


def img2img_sigmas(num_steps: int, strength: float, shift: float = 3.0) -> torch.Tensor:
    """The fixed ladder that starts at noise level ``strength`` (SDEdit):
    the level the init latents were noised to by ``(1 - s) x0 + s eps``,
    then the shifted-t curve of ``uniform_flow_sigmas`` down to its last
    sigma; strength 1.0 gives that ladder. The starting t inverts
    sigma = shift t / (1 + (shift - 1) t). Raises unless 0 < strength <= 1.
    """
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    t0 = strength / (shift - (shift - 1.0) * strength)
    t = _linspace_f32(t0, 1.0 / 1000.0, num_steps)
    return shift * t / (1.0 + (shift - 1.0) * t)
