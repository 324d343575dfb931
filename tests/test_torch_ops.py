"""tpdm_tpu_torch Beta math and Euler step against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, t
from tpdm_tpu.ops import beta as jbeta
from tpdm_tpu.ops.flow_euler import flow_euler_step as jax_flow_euler_step
from tpdm_tpu_torch.ops import beta as tbeta
from tpdm_tpu_torch.ops.flow_euler import flow_euler_step

# log Γ of arguments up to ~16 is ~30 in magnitude, so each lgamma/digamma
# term carries ~4e-6 absolute fp32 rounding; the entropy and KL sum and
# cancel several such terms: atol 1e-4 there
SUM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def params():
    rng = np.random.default_rng(0)
    a1, b1, a2, b2 = (rng.uniform(1.1, 8.0, 64).astype(np.float32) for _ in range(4))
    x = rng.uniform(0.01, 0.99, 64).astype(np.float32)
    return a1, b1, a2, b2, x


def test_log_prob_mode_mean(params):
    a, b, _, _, x = params
    close(tbeta.beta_log_prob(t(a), t(b), t(x)), jbeta.beta_log_prob(a, b, x), **SUM_TOL)
    close(tbeta.beta_mode(t(a), t(b)), jbeta.beta_mode(a, b))
    close(tbeta.beta_mean(t(a), t(b)), jbeta.beta_mean(a, b))


def test_entropy_and_kl(params):
    a1, b1, a2, b2, _ = params
    close(tbeta.beta_entropy(t(a1), t(b1)), jbeta.beta_entropy(a1, b1), **SUM_TOL)
    close(
        tbeta.beta_kl(t(a1), t(b1), t(a2), t(b2)), jbeta.beta_kl(a1, b1, a2, b2), **SUM_TOL
    )


def test_mode_concentration(params):
    _, _, _, c, x = params
    c = c + 2.0
    for ours, ref in zip(
        tbeta.mode_concentration_to_alpha_beta(t(x), t(c)),
        jbeta.mode_concentration_to_alpha_beta(x, c),
    ):
        close(ours, ref)


@pytest.mark.parametrize("alpha,beta", [(2.5, 1.7), (1.2, 5.0), (0.6, 0.8)])
def test_beta_sample_moments(alpha, beta):
    """Threefry and Philox give different bits, so the draw is held to the
    analytic mean and variance: 60k draws, within 5 standard errors."""
    n = 60_000
    g = torch.Generator(device="cpu").manual_seed(7)
    draws = tbeta.beta_sample(
        g, torch.full((n,), alpha), torch.full((n,), beta)
    ).double()
    assert ((draws > 0) & (draws < 1)).all()
    s = alpha + beta
    mean = alpha / s
    var = alpha * beta / (s * s * (s + 1))
    assert abs(draws.mean().item() - mean) < 5 * (var / n) ** 0.5
    # the sample variance's standard error, from the fourth central moment
    m4 = ((draws - mean) ** 4).mean().item()
    assert abs(draws.var().item() - var) < 5 * ((m4 - var * var) / n) ** 0.5


def test_beta_sample_follows_its_generator():
    a, b = torch.full((16,), 2.0), torch.full((16,), 3.0)
    draw = lambda seed: tbeta.beta_sample(torch.Generator().manual_seed(seed), a, b)
    torch.testing.assert_close(draw(3), draw(3), rtol=0, atol=0)
    assert not torch.equal(draw(3), draw(4))


def test_flow_euler_step_fp32():
    rng = np.random.default_rng(1)
    v, x = (rng.standard_normal((3, 4, 8, 8), np.float32) for _ in range(2))
    s = rng.uniform(0.2, 1.0, 3).astype(np.float32)
    sn = (s * rng.uniform(0.3, 0.9, 3)).astype(np.float32)
    out = flow_euler_step(t(v), t(sn), t(s), t(x))
    assert out.dtype == torch.float32
    close(out, jax_flow_euler_step(v, sn, s, x))


def test_flow_euler_step_returns_velocity_dtype():
    rng = np.random.default_rng(2)
    v, x = (rng.standard_normal((2, 4, 4, 4), np.float32) for _ in range(2))
    s, sn = np.array([1.0, 0.5], np.float32), np.array([0.6, 0.1], np.float32)
    out = flow_euler_step(t(v).bfloat16(), t(sn), t(s), t(x).bfloat16())
    ref = jax_flow_euler_step(jnp.asarray(v, jnp.bfloat16), sn, s, jnp.asarray(x, jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    # both compute in fp32 and round once to bf16 (a relative step of 2^-8)
    close(out.float(), np.asarray(ref, np.float32), rtol=8e-3, atol=1e-5)
