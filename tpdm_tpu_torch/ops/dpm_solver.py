"""DPM-Solver++ (first and second order) with per-sample sigmas.

Counterpart of ``tpdm_tpu/ops/dpm_solver.py``, the SD1.5 family's solver:
every batch element sits at its own (sigma_t, sigma_s0, sigma_s1), and the
sampler picks the first- or second-order result per sample with
``torch.where``. Plain tensor arithmetic, in the dtype of its inputs (the
sampler passes fp32).

Math (https://arxiv.org/abs/2211.01095, VP parametrisation):
    alpha(sigma) = 1/sqrt(1+sigma^2),  sigma_t = sigma·alpha,
    lambda = log(alpha) − log(sigma_t) = −log(sigma).
"""

from __future__ import annotations

from typing import Optional

import torch


def sigma_to_alpha_sigma_t(sigma: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """diffusers ``_sigma_to_alpha_sigma_t``: the VP alpha_t and noise scale."""
    alpha_t = 1.0 / torch.sqrt(sigma**2 + 1.0)
    return alpha_t, sigma * alpha_t


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def epsilon_to_x0(model_output: torch.Tensor, sample: torch.Tensor,
                  sigma: torch.Tensor) -> torch.Tensor:
    """Epsilon prediction -> x0 (data) prediction, per-sample sigma."""
    alpha_t, sigma_t = sigma_to_alpha_sigma_t(sigma)
    return (sample - _bcast(sigma_t, sample) * model_output) / _bcast(alpha_t, sample)


def _lambda(sigma: torch.Tensor):
    a, s = sigma_to_alpha_sigma_t(sigma)
    return a, s, torch.log(a) - torch.log(s)


def dpm_first_order_update(
    x0: torch.Tensor,
    sample: torch.Tensor,
    sigma_t: torch.Tensor,
    sigma_s: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    sde: bool = False,
) -> torch.Tensor:
    """DPM-Solver++(1), i.e. DDIM in x0 form."""
    a_t, s_t, lam_t = _lambda(sigma_t)
    _, s_s, lam_s = _lambda(sigma_s)
    h = lam_t - lam_s
    if not sde:
        return _bcast(s_t / s_s, sample) * sample - _bcast(a_t * (torch.exp(-h) - 1.0), sample) * x0
    if noise is None:
        raise ValueError("sde=True needs noise")
    return (_bcast(s_t / s_s * torch.exp(-h), sample) * sample
            + _bcast(a_t * (1.0 - torch.exp(-2.0 * h)), sample) * x0
            + _bcast(s_t * torch.sqrt(1.0 - torch.exp(-2.0 * h)), sample) * noise)


def dpm_second_order_update(
    x0: torch.Tensor,
    x0_prev: torch.Tensor,
    sample: torch.Tensor,
    sigma_t: torch.Tensor,
    sigma_s0: torch.Tensor,
    sigma_s1: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    solver_type: str = "midpoint",
    sde: bool = False,
) -> torch.Tensor:
    """Multistep DPM-Solver++(2M): ``x0`` the current x0 prediction (m0),
    ``x0_prev`` the previous step's (m1)."""
    a_t, s_t, lam_t = _lambda(sigma_t)
    _, s_s0, lam_s0 = _lambda(sigma_s0)
    _, _, lam_s1 = _lambda(sigma_s1)
    h = lam_t - lam_s0
    r0 = (lam_s0 - lam_s1) / h
    d0 = x0
    d1 = (x0 - x0_prev) / _bcast(r0, sample)
    if not sde:
        base = _bcast(s_t / s_s0, sample) * sample - _bcast(a_t * (torch.exp(-h) - 1.0), sample) * d0
        if solver_type == "midpoint":
            return base - 0.5 * _bcast(a_t * (torch.exp(-h) - 1.0), sample) * d1
        if solver_type == "heun":
            return base + _bcast(a_t * ((torch.exp(-h) - 1.0) / h + 1.0), sample) * d1
        raise ValueError(solver_type)
    if noise is None:
        raise ValueError("sde=True needs noise")
    base = (_bcast(s_t / s_s0 * torch.exp(-h), sample) * sample
            + _bcast(a_t * (1.0 - torch.exp(-2.0 * h)), sample) * d0
            + _bcast(s_t * torch.sqrt(1.0 - torch.exp(-2.0 * h)), sample) * noise)
    if solver_type == "midpoint":
        return base + 0.5 * _bcast(a_t * (1.0 - torch.exp(-2.0 * h)), sample) * d1
    if solver_type == "heun":
        return base + _bcast(a_t * ((1.0 - torch.exp(-2.0 * h)) / (-2.0 * h) + 1.0), sample) * d1
    raise ValueError(solver_type)


def ddpm_sigmas_from_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    schedule: str = "scaled_linear",
    device=None,
) -> torch.Tensor:
    """The SD1.5 training-noise table sigma_i = sqrt((1-ᾱ_i)/ᾱ_i), (1000,)
    in fp32 as the JAX package computes it (not float64): the betas'
    linspace as ``jnp.linspace`` forms it (start·(1-s) + stop·s with
    s = i/(n-1), the last element stop itself), squared, and an fp32
    cumprod. XLA rounds the linspace and the cumprod in another order: the
    two tables agree within 3e-6 relative, not to the bit."""
    f32 = dict(dtype=torch.float32, device=device)
    if schedule == "scaled_linear":
        lo, hi = beta_start**0.5, beta_end**0.5
    elif schedule == "linear":
        lo, hi = beta_start, beta_end
    else:
        raise ValueError(schedule)
    n = num_train_timesteps
    lo_t, hi_t = torch.tensor(lo, **f32), torch.tensor(hi, **f32)
    step = torch.arange(n - 1, **f32) / torch.tensor(float(n - 1), **f32)
    lin = torch.cat([lo_t * (1 - step) + hi_t * step, hi_t[None]])
    betas = lin**2 if schedule == "scaled_linear" else lin
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
    return torch.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)


def sigma_of_timestep(sigmas_table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """sigma at a (possibly fractional) timestep t, by linear interpolation
    of the table."""
    n = sigmas_table.shape[0]
    t = torch.clamp(t.to(sigmas_table.dtype), 0.0, n - 1.0)
    lo = torch.floor(t).long()
    hi = torch.clamp(lo + 1, max=n - 1)
    frac = t - lo.to(t.dtype)
    return sigmas_table[lo] * (1.0 - frac) + sigmas_table[hi] * frac
