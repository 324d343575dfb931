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

# One intra-op thread a test process. The suite runs several xdist workers
# on a few cores; at torch's default of a thread a core in every worker the
# toy-size ops of these tests spend their time handing work between
# oversubscribed threads (the port's files summed 2826.6 s of case time
# under six workers at the default, 344.2 s with one thread each).
torch.set_num_threads(1)

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


def noisy_jax_lora(params, seed: int, rank: int = 2, keep=None):
    """A JAX LoRA tree over ``params``: the keys and shapes of JAX's
    ``init_lora`` (traced, not compiled), ``a`` ~ N(0, 1/d_in) and ``b`` ~
    N(0, 0.05²) from seeded numpy (a zero ``b``, ``init_lora``'s, would be
    an identity and tell no adapter apart); ``keep`` filters the keys."""
    from tpdm_tpu.models.lora import init_lora

    fresh = jax.eval_shape(lambda p: init_lora(p, rank, jax.random.PRNGKey(seed)), params)
    rng = np.random.default_rng(seed)
    out = {}
    for k, f in sorted(fresh.items()):
        if keep is None or keep(k):
            d_in = f["a"].shape[0]
            out[k] = {"a": (rng.standard_normal(f["a"].shape) / np.sqrt(d_in)).astype(np.float32),
                      "b": 0.05 * rng.standard_normal(f["b"].shape).astype(np.float32)}
    return out


def kernel_tree(module) -> dict:
    """A Flax-shaped tree of zero (d_in, d_out) kernels, one at the JAX path
    of each dense layer of a port ``module`` (``utils/convert.py:
    lora_key_to_jax``): what JAX's ``init_lora`` reads of a model."""
    from tpdm_tpu_torch.models.lora import lora_targets
    from tpdm_tpu_torch.utils.convert import lora_key_to_jax

    tree = {}
    for name, m in lora_targets(module).items():
        *mods, leaf = lora_key_to_jax(name).split("/")
        node = tree
        for part in mods:
            node = node.setdefault(part, {})
        node[leaf] = np.zeros((m.in_features, m.out_features), np.float32)
    return tree


def noisy_lora(module, seed: int, rank: int = 2) -> dict:
    """The port's LoRA dict over a port ``module``, made on the JAX side
    (``noisy_jax_lora`` of its ``kernel_tree``) and carried across with
    ``lora_from_jax``."""
    from tpdm_tpu_torch.utils.convert import lora_from_jax

    return lora_from_jax(noisy_jax_lora(kernel_tree(module), seed, rank))


N_TXT = 5


def lora_world(seed: int = 0, guidance_scale=7.0):
    """The JAX LoRA trainers' toy world (``tests/test_rloo.py:_toy_world``:
    the toy MMDiT, its RLOOConfig with guidance 7.0, a 4-channel TPM, four
    rows of 5 numpy prompt embeds and zero negatives from
    ``np.random.default_rng(seed)``) with the MMDiT drawn by
    ``drawn_models`` (no init compile), and the port's copy: (JAX
    TPDMAgent, port TPDMAgent on the CPU, the rows)."""
    from tpdm_tpu.models import TimePredictor as JTimePredictor
    from tpdm_tpu.train import RLOOConfig as JRLOOConfig
    from tpdm_tpu.train import TPDMAgent as JTPDMAgent
    from tpdm_tpu_torch.train import RLOOConfig, TPDMAgent

    jm, jvars, tm = drawn_models(seed, vae=False, tpm=False)["mmdit"]
    c = jm.config
    kw = dict(per_device_train_batch_size=4, rloo_k=2, max_inference_steps=3,
              total_episodes=12, kl_coef=0.01, learning_rate=1e-3,
              guidance_scale=guidance_scale)
    jagent = JTPDMAgent(jm, jvars, JRLOOConfig(**kw), tpm=JTimePredictor(
        conv_out_channels=4, in_channels=2 * c.inner_dim, temb_dim=c.inner_dim))
    tpm = lambda: TimePredictor(conv_out_channels=4, in_channels=2 * c.inner_dim,
                                temb_dim=c.inner_dim)
    agent = TPDMAgent(tm, RLOOConfig(**kw), tpm=tpm)
    rng = np.random.default_rng(seed)
    rows = [{"prompt": f"prompt {i}",
             "prompt_embeds": rng.normal(size=(N_TXT, c.joint_attention_dim)).astype(np.float32),
             "pooled_prompt_embeds": rng.normal(size=(c.pooled_projection_dim,)).astype(np.float32),
             "negative_prompt_embeds": np.zeros((N_TXT, c.joint_attention_dim), np.float32),
             "negative_pooled_prompt_embeds": np.zeros((c.pooled_projection_dim,), np.float32)}
            for i in range(4)]
    return jagent, agent, rows


def jax_arrays(batch: dict) -> dict:
    """The array fields of a JAX trainer's collated batch."""
    return {k: v for k, v in batch.items() if isinstance(v, (jax.Array, np.ndarray))}


def close_lora(ours: dict, ref: dict, **kw):
    """The port's LoRA dict against a JAX LoRA tree, factor by factor."""
    from tpdm_tpu_torch.utils.convert import lora_key_to_jax

    assert {lora_key_to_jax(k) for k in ours} == set(ref)
    for k, fac in ours.items():
        for w in ("a", "b"):
            close(fac[w], np.asarray(ref[lora_key_to_jax(k)][w]), **kw)


def state_checksum(module) -> list:
    """Every parameter and buffer of ``module``, copied: base weights that
    must stay the same to the bit."""
    return [t.detach().clone() for t in module.state_dict().values()]
