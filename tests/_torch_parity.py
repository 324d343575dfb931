"""Shared set-up for the tpdm_tpu_torch parity tests.

Builds toy JAX models, perturbs their parameters with seeded numpy noise
(so zero-initialised biases and unit norm scales are exercised too),
carries the parameters over with ``tpdm_tpu_torch.utils.convert`` and
returns both sides. Everything torch is pinned to the CPU in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpdm_tpu.models.mmdit import MMDiT as JMMDiT, MMDiTConfig as JMMDiTConfig
from tpdm_tpu.models.tpm import TimePredictor as JTimePredictor
from tpdm_tpu.models.vae import VAE as JVAE, VAEConfig as JVAEConfig
from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from tpdm_tpu_torch.models.tpm import TimePredictor
from tpdm_tpu_torch.models.vae import VAE, VAEConfig
from tpdm_tpu_torch.utils.convert import mmdit_from_jax, tpm_from_jax, vae_from_jax

CPU = torch.device("cpu")
# the repo's cross-program fp32 bound (tests/test_guidance_interval.py:333)
RTOL, ATOL = 1e-4, 1e-5

TPM_KW = dict(conv_out_channels=8, init_alpha=0.5, init_beta=2.0)


def t(a) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor."""
    return torch.from_numpy(np.array(a)).to(CPU)


def close(ours, ref, rtol=RTOL, atol=ATOL):
    """assert_allclose with atol scaled by the reference's largest magnitude
    when that exceeds 1: the fp32 bound is stated for outputs of order one,
    and the toy MMDiT's outputs reach ~6, where summation-order rounding
    alone is ~3e-5."""
    ours = ours.detach().cpu().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=rtol, atol=atol * scale)


def perturb(variables, seed: int, scale: float = 0.05):
    """Add N(0, scale²) noise to every leaf of the "params" collection."""
    rng = np.random.default_rng(seed)
    noisy = jax.tree.map(
        lambda a: np.asarray(a, np.float32) + scale * rng.standard_normal(a.shape, np.float32),
        variables["params"],
    )
    return {**variables, "params": noisy}


def toy_mmdit(seed: int = 0):
    jm = JMMDiT(JMMDiTConfig.toy())
    c = jm.config
    variables = jm.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, c.in_channels, c.sample_size, c.sample_size)),
        jnp.ones((1,)),
        jnp.zeros((1, 5, c.joint_attention_dim)),
        jnp.zeros((1, c.pooled_projection_dim)),
    )
    variables = perturb(variables, seed)
    cfg = MMDiTConfig.toy()
    tm = MMDiT(cfg)
    tm.load_state_dict(mmdit_from_jax(variables, cfg))
    return jm, variables, tm.eval()


def toy_tpm(in_channels: int, temb_dim: int, seed: int = 1):
    jt = JTimePredictor(in_channels=in_channels, temb_dim=temb_dim, **TPM_KW)
    variables = jt.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, in_channels, 8, 8)),
        jnp.zeros((1, temb_dim)),
    )
    variables = perturb(variables, seed)
    tt = TimePredictor(in_channels=in_channels, temb_dim=temb_dim, **TPM_KW)
    tt.load_state_dict(tpm_from_jax(variables))
    return jt, variables, tt.eval()


def toy_vae(latent_channels: int, seed: int = 2):
    jv = JVAE(JVAEConfig.toy(latent_channels=latent_channels))
    variables = jv.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, latent_channels, 8, 8)),
        jnp.zeros((1, 3, 16, 16)),
    )
    variables = perturb(variables, seed)
    tv = VAE(VAEConfig.toy(latent_channels=latent_channels))
    tv.load_state_dict(vae_from_jax(variables))
    return jv, variables, tv.eval()
