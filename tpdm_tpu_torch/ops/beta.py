"""Beta-distribution math for the TPM policy head, elementwise over any shape.

Counterpart of ``tpdm_tpu/ops/beta.py``. ``beta_sample`` draws from an
explicit ``torch.Generator`` (``torch.distributions.Beta`` cannot take one),
so its bits differ from the JAX package's threefry draws: compare the two by
their statistics.
"""

from __future__ import annotations

import torch


def _betaln(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """log B(alpha, beta) = log Γ(a) + log Γ(b) − log Γ(a+b)."""
    return torch.lgamma(alpha) + torch.lgamma(beta) - torch.lgamma(alpha + beta)


def beta_log_prob(alpha: torch.Tensor, beta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Log-density of Beta(alpha, beta) at x in (0, 1)."""
    return (alpha - 1.0) * torch.log(x) + (beta - 1.0) * torch.log1p(-x) - _betaln(alpha, beta)


def beta_mode(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Mode (a−1)/(a+b−2), valid for alpha, beta > 1 (the TPM head's range)."""
    return (alpha - 1.0) / (alpha + beta - 2.0)


def beta_mean(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Mean a/(a+b)."""
    return alpha / (alpha + beta)


def beta_entropy(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Differential entropy of Beta(alpha, beta)."""
    total = alpha + beta
    return (
        _betaln(alpha, beta)
        - (alpha - 1.0) * torch.digamma(alpha)
        - (beta - 1.0) * torch.digamma(beta)
        + (total - 2.0) * torch.digamma(total)
    )


def beta_kl(
    alpha1: torch.Tensor, beta1: torch.Tensor, alpha2: torch.Tensor, beta2: torch.Tensor
) -> torch.Tensor:
    """Closed-form KL(Beta(a1, b1) || Beta(a2, b2))."""
    return (
        (_betaln(alpha2, beta2) - _betaln(alpha1, beta1))
        + (alpha1 - alpha2) * torch.digamma(alpha1)
        + (beta1 - beta2) * torch.digamma(beta1)
        - (alpha1 - alpha2 + beta1 - beta2) * torch.digamma(alpha1 + beta1)
    )


# Marsaglia–Tsang accepts a candidate with probability >= 0.95 for shape >= 1,
# so 16 candidates all fail with probability below 0.05**16 ~ 2e-21.
_GAMMA_CANDIDATES = 16


def _standard_gamma(generator: torch.Generator, shape: torch.Tensor) -> torch.Tensor:
    """Gamma(shape, 1) draws by Marsaglia–Tsang (2000), vectorised.

    Shapes below 1 draw Gamma(shape + 1) and scale by U^(1/shape). Each
    element takes the first of ``_GAMMA_CANDIDATES`` candidates that is
    accepted; all are drawn at once, so the draw needs no host sync. An
    element whose candidates all fail (probability < 2e-21) keeps its last
    candidate.
    """
    a = shape.to(torch.float32)
    boosted = a < 1.0
    d = torch.where(boosted, a + 1.0, a) - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    size = (_GAMMA_CANDIDATES,) + tuple(a.shape)
    x = torch.randn(size, generator=generator, device=a.device)
    u = torch.rand(size, generator=generator, device=a.device)
    v = (1.0 + c * x) ** 3
    log_v = torch.log(torch.clamp(v, min=torch.finfo(torch.float32).tiny))
    accept = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
    accept[-1] = True
    first = torch.argmax(accept.to(torch.uint8), dim=0, keepdim=True)
    g = d * torch.gather(torch.clamp(v, min=0.0), 0, first)[0]
    u_boost = torch.rand(a.shape, generator=generator, device=a.device)
    return torch.where(boosted, g * u_boost ** (1.0 / a), g)


def beta_sample(
    generator: torch.Generator, alpha: torch.Tensor, beta: torch.Tensor
) -> torch.Tensor:
    """Beta(alpha, beta) draws as X / (X + Y) with X ~ Gamma(alpha),
    Y ~ Gamma(beta), from ``generator`` (on alpha's device). fp32."""
    x = _standard_gamma(generator, alpha)
    y = _standard_gamma(generator, beta)
    return x / (x + y)


def mode_concentration_to_alpha_beta(
    mode: torch.Tensor, concentration: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mode, concentration) -> (alpha, beta): mode·(c−2)+1, (1−mode)·(c−2)+1."""
    alpha = mode * (concentration - 2.0) + 1.0
    beta = (1.0 - mode) * (concentration - 2.0) + 1.0
    return alpha, beta
