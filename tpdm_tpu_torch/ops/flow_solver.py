"""Second-order update rules for the rectified-flow ODE, in fp32.

Counterpart of ``tpdm_tpu/ops/flow_solver.py``: Heun's trapezoid corrector
and the two-step Adams–Bashforth rule, each with per-sample (b,) sigmas
like ``flow_euler_step``, so they compose with per-sample adaptive
schedules. The math runs in float32 and the result is cast back to the
sample's dtype.
"""

from __future__ import annotations

import torch


def _bshape(x: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).reshape(x.shape + (1,) * (sample.dim() - 1))


def flow_heun_combine(
    v0: torch.Tensor,
    v1: torch.Tensor,
    sigma_next: torch.Tensor,
    sigma: torch.Tensor,
    sample: torch.Tensor,
) -> torch.Tensor:
    """Heun's corrector: x' = x + h (v0 + v1) / 2 with h = sigma_next -
    sigma, ``v0`` the velocity at (sample, sigma) and ``v1`` at the Euler
    prediction (sample + h v0, sigma_next)."""
    h = _bshape(sigma_next - sigma, sample)
    avg = 0.5 * (v0.to(torch.float32) + v1.to(torch.float32))
    return (sample.to(torch.float32) + h * avg).to(sample.dtype)


def flow_ab2_step(
    v: torch.Tensor,
    v_prev: torch.Tensor,
    sigma_next: torch.Tensor,
    sigma: torch.Tensor,
    sigma_prev: torch.Tensor,
    sample: torch.Tensor,
) -> torch.Tensor:
    """Nonuniform-step AB2, one model evaluation a step:
    x' = x + h ((1 + w) v - w v_prev), w = h / (2 h_prev), with h =
    sigma_next - sigma and h_prev = sigma - sigma_prev. Where h_prev is 0
    (the first step, or a sample whose schedule stopped moving) w is 0 and
    the rule is Euler, with no division by zero."""
    h = (sigma_next - sigma).to(torch.float32)
    h_prev = (sigma - sigma_prev).to(torch.float32)
    first = h_prev == 0.0
    safe = torch.where(first, torch.ones_like(h_prev), h_prev)
    w = torch.where(first, torch.zeros_like(h), h / (2.0 * safe))
    h, w = _bshape(h, sample), _bshape(w, sample)
    vel = (1.0 + w) * v.to(torch.float32) - w * v_prev.to(torch.float32)
    return (sample.to(torch.float32) + h * vel).to(sample.dtype)
