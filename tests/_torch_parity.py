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


def random_variables(init, seed: int, *args, scale: float = 0.05, kernel_std=None):
    """Variables of the tree that a Flax ``init(key, *args)`` returns, drawn
    from seeded numpy without compiling the init (``jax.eval_shape`` only
    traces it): every norm "scale" 1 and every "bias" 0, each plus N(0,
    scale²) noise as ``perturb`` adds, and every other leaf N(0,
    kernel_std²), by default N(0, 1/fan_in) with fan_in the product of all
    but its last dimension (the input side of a Dense or Conv kernel)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("scale", "bias"):
            return float(name == "scale") + scale * rng.standard_normal(leaf.shape, np.float32)
        std = kernel_std or 1.0 / np.sqrt(max(1, int(np.prod(leaf.shape[:-1]))))
        return np.float32(std) * rng.standard_normal(leaf.shape, np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init, jax.random.PRNGKey(0), *args))


def toy_mmdit(seed: int = 0, **cfg_kw):
    """Toy JAX MMDiT, its perturbed variables and the port's copy;
    ``cfg_kw`` overrides fields of both toy configs."""
    jm = JMMDiT(JMMDiTConfig.toy(**cfg_kw))
    c = jm.config
    variables = jm.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, c.in_channels, c.sample_size, c.sample_size)),
        jnp.ones((1,)),
        jnp.zeros((1, 5, c.joint_attention_dim)),
        jnp.zeros((1, c.pooled_projection_dim)),
    )
    variables = perturb(variables, seed)
    cfg = MMDiTConfig.toy(**cfg_kw)
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


def drawn_models(seed: int = 0, vae: bool = True, tpm: bool = True, **cfg_kw):
    """The toy JAX MMDiT (``cfg_kw`` overrides fields of both toy configs),
    TPM and VAE with parameters drawn by ``random_variables`` (no init
    compile), and the port's copies: a dict of (JAX module, variables,
    torch module) triples under "mmdit", "tpm" and "vae"."""
    jm = JMMDiT(JMMDiTConfig.toy(**cfg_kw))
    c = jm.config
    mvars = random_variables(
        jm.init, seed, jnp.zeros((1, c.in_channels, c.sample_size, c.sample_size)),
        jnp.ones((1,)), jnp.zeros((1, 5, c.joint_attention_dim)),
        jnp.zeros((1, c.pooled_projection_dim)))
    cfg = MMDiTConfig.toy(**cfg_kw)
    tm = MMDiT(cfg)
    tm.load_state_dict(mmdit_from_jax(mvars, cfg))
    # the sincos table is a constant, not a parameter: the port's own copy
    mvars["constants"]["pos_embed"]["pos_embed"] = tm.pos_embed.pos_embed.numpy()
    out = {"mmdit": (jm, mvars, tm.eval())}
    if tpm:
        kw = dict(in_channels=2 * c.inner_dim, temb_dim=c.inner_dim, **TPM_KW)
        jt = JTimePredictor(**kw)
        tvars = random_variables(jt.init, seed + 1, jnp.zeros((1, 2 * c.inner_dim, 8, 8)),
                                 jnp.zeros((1, c.inner_dim)))
        tt = TimePredictor(**kw)
        tt.load_state_dict(tpm_from_jax(tvars))
        out["tpm"] = (jt, tvars, tt.eval())
    if vae:
        jv = JVAE(JVAEConfig.toy(latent_channels=c.in_channels))
        vvars = random_variables(jv.init, seed + 2, jnp.zeros((1, c.in_channels, 8, 8)),
                                 jnp.zeros((1, 3, 16, 16)))
        tv = VAE(VAEConfig.toy(latent_channels=c.in_channels))
        tv.load_state_dict(vae_from_jax(vvars))
        out["vae"] = (jv, vvars, tv.eval())
    return out
