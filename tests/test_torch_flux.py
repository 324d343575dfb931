"""FLUX in tpdm_tpu_torch against the JAX package, on the CPU at toy size.

Covers ``models/flux.py`` (``pack_latents`` / ``unpack_latents``,
``rope_freqs`` / ``apply_rope``, the ``Flux`` forward of the dev and
schnell configs, the Δ-cache's record and reuse forwards and their
errors, the W8A8 / weight-only int8 modulation / int4 forwards and
``prequantize_``), ``utils/convert.py`` (``flux_from_jax``,
``convert_flux`` / ``export_flux`` against JAX's converters),
``train/flux_agent.py`` (``FluxAgent.sample`` with step caps and starting
sigmas, ``replay`` / ``logprobs`` / ``kl_divergence``),
``pipeline/variants.py:FluxPipeline`` (text-to-image, image-to-image, the
Δ-cache with AB2, ``generate_fixed`` with each solver),
``serving_families.make_flux_runner`` and ``ContinuousFluxEngine``.

Two toy worlds, built once (module fixtures): ``FluxConfig.toy`` (2 double
and 2 single blocks) for the forwards, and a 1 + 1 block toy caching its
one front double block behind the agents, pipelines, runners and engines,
with the toy VAE at 4 latent channels; weights drawn by
``_torch_parity.random_variables`` and carried over with
``flux_from_jax`` / ``vae_from_jax``, a closed-form TPM on both sides
(``tpm_fn`` replaced, as ``test_torch_sdxl.py`` does), and the port's
latents and noise given to JAX (``prepare_latents``, ``jax.random.normal``
and ``serving_families._per_seed_latents`` patched). The float forwards
and the fixed-schedule runs execute JAX eagerly (``jax.disable_jit``: the
ops' kernels are compiled once and shared), the quantised forwards
compiled; the adaptive rollouts share one
compiled loop (step caps and starting sigmas always passed: the JAX agent's
``sample`` is wrapped to fill the defaults, T and 1.0), and the Δ-cache
with AB2 compiles one more.

Tolerances: the fp32 bound (rtol 1e-4 / atol 1e-5 scaled by the
magnitude, ``_torch_parity.close``); step counts, masks and last valid
indices exactly; decoded images within one uint8 level, at under 1 % of
pixels. W8A8 rounds activations: under an fp32 drift of ~1e-6 one
activation of the first block's MLP crosses an int8 rounding boundary (one
level, 1/127 of its row's absmax; ``test_torch_quant.py``), and the later
blocks' attention spreads it to every token, so the W8A8 forwards are held
to 2e-2 of each output's range; int4 is weight-only (no activation
rounding) and held to the fp32 bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, random_variables, t
from tpdm_tpu import serving_families as jfam
from tpdm_tpu.models.flux import (
    Flux as JFlux,
    FluxConfig as JFluxConfig,
    apply_rope as j_apply_rope,
    pack_latents as j_pack,
    rope_freqs as j_rope_freqs,
    unpack_latents as j_unpack,
)
from tpdm_tpu.models.tpm import TimePredictor as JTimePredictor
from tpdm_tpu.models.vae import VAE as JVAE, VAEConfig as JVAEConfig
from tpdm_tpu.ops.quant import prequantize_params
from tpdm_tpu.pipeline.variants import FluxPipeline as JFluxPipeline
from tpdm_tpu.train import RLOOConfig as JRLOOConfig
from tpdm_tpu.train.flux_agent import FluxAgent as JFluxAgent
from tpdm_tpu.utils.convert import convert_flux as j_convert_flux, export_flux as j_export_flux
from tpdm_tpu_torch import serving_families
from tpdm_tpu_torch.models.flux import (
    Flux,
    FluxConfig,
    Modulation,
    apply_rope,
    pack_latents,
    rope_freqs,
    unpack_latents,
)
from tpdm_tpu_torch.models.vae import VAE, VAEConfig
from tpdm_tpu_torch.ops.quant import DenseMaybeQuant, prequantize_
from tpdm_tpu_torch.pipeline.variants import FluxPipeline
from tpdm_tpu_torch.serving_continuous import ContinuousFluxEngine
from tpdm_tpu_torch.train import RLOOConfig
from tpdm_tpu_torch.train.flux_agent import FluxAgent
from tpdm_tpu_torch.utils.convert import (
    convert_flux,
    export_flux,
    flux_from_jax,
    vae_from_jax,
)

T, B, N_TXT = 6, 2, 5
W8A8_REL_TOL = 2e-2
AGENT_KW = dict(depth_double=1, depth_single=1, cache_front_blocks=1)
PROMPTS = ["a red cat", "a blue dog on grass"]
# (prompt, seed, cap): staggered joins and mixed caps through 2 slots
REQUESTS = [("a cat", 3, None), ("a dog on a hill", 7, 2), ("blue bird", 11, None),
            ("a cat", 5, 3), ("red square", 23, 1)]


def _j_tpm(h, temb):
    return jnp.stack([3.0 + 0.1 * jnp.tanh(jnp.mean(h, axis=(1, 2, 3))),
                      2.0 + 0.1 * jnp.tanh(jnp.mean(temb, axis=1))], axis=1)


def _t_tpm(h, temb):
    return torch.stack([3.0 + 0.1 * torch.tanh(h.mean(dim=(1, 2, 3))),
                        2.0 + 0.1 * torch.tanh(temb.mean(dim=1))], dim=1)


def _encode(prompts):
    """Closed-form T5 rows and pooled vectors, fixed per prompt (numpy)."""
    rows = [np.random.default_rng([ord(c) for c in p]) for p in prompts]
    txt = np.stack([r.standard_normal((N_TXT, 32)) for r in rows]).astype(np.float32)
    pooled = np.stack([r.standard_normal(24) for r in rows]).astype(np.float32)
    return txt, pooled


def _t_encode(prompts):
    return tuple(torch.from_numpy(a) for a in _encode(prompts))


def _forward_inputs(seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, 4, 8, 8)).astype(np.float32)
    txt = rng.standard_normal((B, N_TXT, 32)).astype(np.float32)
    txt_ids = np.zeros((B, N_TXT, 3), np.float32)
    ts = np.array([0.7, 0.25], np.float32)
    pooled = rng.standard_normal((B, 24)).astype(np.float32)
    guidance = np.array([3.5, 2.0], np.float32)
    return lat, txt, txt_ids, ts, pooled, guidance


def _flux_pair(seed=0, **kw):
    """A JAX toy Flux, its drawn variables (numpy) and the port's copy."""
    jm = JFlux(JFluxConfig.toy(**kw))
    lat, txt, txt_ids, ts, pooled, g = _forward_inputs()
    tok, ids = j_pack(jnp.asarray(lat))
    v = random_variables(jm.init, seed, tok, ids, txt, txt_ids, ts, pooled, g)
    v = jax.tree.map(np.asarray, v)
    cfg = FluxConfig.toy(**kw)
    tm = Flux(cfg)
    tm.load_state_dict(flux_from_jax(v, cfg))
    return jm, v, tm.eval()


def _j_apply(jm, v, lat, *rest, **kw):
    tok, ids = j_pack(jnp.asarray(lat))
    with jax.disable_jit():
        return jm.apply(v, tok, ids, *rest, **kw)


def _t_apply(tm, lat, *rest, delta=None, **kw):
    tok, ids = pack_latents(t(lat))
    as_t = lambda a: None if a is None else t(a)
    with torch.no_grad():
        return tm(tok, ids, *map(as_t, rest), delta=as_t(delta), **kw)


@pytest.fixture(scope="module")
def forwards():
    """The 2 + 2 block toy, dev and schnell (one draw each)."""
    return {name: _flux_pair(seed=i, guidance_embed=ge, cache_front_blocks=1)
            for i, (name, ge) in enumerate((("dev", True), ("schnell", False)))}


def test_pack_unpack_and_rope_match_jax():
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 3, 8, 12)).astype(np.float32)
    tok, ids = pack_latents(t(lat))
    jtok, jids = j_pack(jnp.asarray(lat))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(unpack_latents(tok, 8, 12).numpy(), lat)
    np.testing.assert_array_equal(np.asarray(j_unpack(jtok, 8, 12)), lat)
    for axes in ((4, 4, 4), (16, 56, 56)):
        pos = rng.integers(0, 64, (2, 7, 3)).astype(np.float32)
        cos, sin = rope_freqs(t(pos), axes, 10000)
        jcos, jsin = j_rope_freqs(jnp.asarray(pos), axes, 10000)
        close(cos, jcos)
        close(sin, jsin)
        x = rng.standard_normal((2, 3, 7, sum(axes))).astype(np.float32)
        close(apply_rope(t(x), cos, sin), j_apply_rope(jnp.asarray(x), jcos, jsin))
        # bf16 in, bf16 out: the rotation runs in fp32
        xb = apply_rope(t(x).bfloat16(), cos, sin)
        assert xb.dtype == torch.bfloat16
        close(xb.float(), np.asarray(j_apply_rope(jnp.asarray(x), jcos, jsin)), rtol=1e-2,
              atol=1e-2)


@pytest.mark.parametrize("name", ["dev", "schnell"])
def test_flux_forward_matches_jax(forwards, name):
    """(velocity tokens, vec, h1, h2) of the dev config (guidance embedded,
    explicit and the 3.5 default) and of schnell (no guidance_in)."""
    jm, v, tm = forwards[name]
    lat, txt, txt_ids, ts, pooled, g = _forward_inputs(seed=3)
    g = g if name == "dev" else None
    ref = _j_apply(jm, v, lat, txt, txt_ids, ts, pooled, g)
    out = _t_apply(tm, lat, txt, txt_ids, ts, pooled, g)
    assert len(out) == 4 and out[0].shape == (B, 16, 16)
    for o, r in zip(out, ref):
        close(o, r)
    assert hasattr(tm, "guidance_in") == (name == "dev")
    if name == "dev":
        default = _t_apply(tm, lat, txt, txt_ids, ts, pooled)
        explicit = _t_apply(tm, lat, txt, txt_ids, ts, pooled, np.full(B, 3.5, np.float32))
        for a, b in zip(default, explicit):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flux_cache_modes_match_jax(forwards):
    """record returns Δ over the back blocks; reuse runs the first double
    block and adds it: both against JAX, and reuse at the recorded Δ
    equals the plain forward."""
    jm, v, tm = forwards["dev"]
    args = _forward_inputs(seed=4)
    ref_rec = _j_apply(jm, v, *args, cache_mode="record")
    rec = _t_apply(tm, *args, cache_mode="record")
    for o, r in zip(rec, ref_rec):
        close(o, r)
    ref_reuse = _j_apply(jm, v, *args, delta=ref_rec[-1], cache_mode="reuse")
    reuse = _t_apply(tm, *args, delta=rec[-1].numpy(), cache_mode="reuse")
    for o, r in zip(reuse, ref_reuse):
        close(o, r)
    plain = _t_apply(tm, *args)
    close(reuse[0], plain[0].numpy())


def test_flux_cache_mode_errors(forwards):
    jm, v, tm = forwards["dev"]
    args = _forward_inputs()
    with pytest.raises(ValueError, match="needs a delta"):
        _t_apply(tm, *args, cache_mode="reuse")
    with pytest.raises(ValueError, match="cache_mode must be"):
        _t_apply(tm, *args, cache_mode="replay")
    for front in (0, 3):
        bad = Flux(FluxConfig.toy(cache_front_blocks=front))
        bad.load_state_dict(tm.state_dict())
        with pytest.raises(ValueError, match=r"cache_front_blocks must be in \[1, depth_double\]"):
            _t_apply(bad, *args, cache_mode="record")
        jbad = JFlux(JFluxConfig.toy(cache_front_blocks=front))
        with pytest.raises(ValueError, match=r"cache_front_blocks must be in \[1, depth_double\]"):
            _j_apply(jbad, v, *args, cache_mode="record")


@pytest.mark.parametrize("bits", [8, 4])
def test_flux_quant_forward_matches_jax(bits):
    """The quantised toy: the blocks' matmuls W8A8 (bits 8) or int4, the
    modulations weight-only int8 (bits 8) or int4. The float tree loaded
    and ``prequantize_``d equals JAX's prequantised tree converted, to the
    bit; both forwards follow JAX's on that tree."""
    kw = dict(quant_matmuls=True, quant_bits=bits)
    jm, v, tm = _flux_pair(seed=5, **kw)
    qv = prequantize_params(v)
    cfg = FluxConfig.toy(**kw)
    pre = Flux(cfg)
    pre.load_state_dict(flux_from_jax(qv, cfg))
    ingraph = tm
    ours = Flux(cfg)
    ours.load_state_dict(ingraph.state_dict())
    prequantize_(ours)
    int_dtype = torch.int8 if bits == 8 else torch.uint8
    sd_pre, sd_ours = pre.state_dict(), ours.state_dict()
    assert sd_pre.keys() == sd_ours.keys()
    for name, w in sd_pre.items():
        assert torch.equal(sd_ours[name], w), name
    # per double block 2 x (q, k, v, proj, mlp 0, mlp 2) + 2 modulations; per
    # single block linear1, linear2 + 1 modulation; the final modulation
    assert sum(w.dtype == int_dtype for w in sd_pre.values()) == 2 * 14 + 2 * 3 + 1
    mods = [m.lin for m in ours.modules() if isinstance(m, Modulation)]
    assert len(mods) == 2 * 2 + 2 + 1
    assert all(isinstance(m, DenseMaybeQuant) and not m.act_quant for m in mods)
    assert all(m.act_quant for m in ours.modules()
               if isinstance(m, DenseMaybeQuant) and m not in mods)
    args = _forward_inputs(seed=6)
    tok, ids = j_pack(jnp.asarray(args[0]))
    ref = jax.jit(jm.apply)(qv, tok, ids, *args[1:])  # compiled: faster than eager here
    for model in (pre, ingraph):
        out = _t_apply(model, *args)
        for o, r in zip(out, ref):
            r = np.asarray(r)
            if bits == 4:
                close(o, r)
            else:
                rel = float(np.abs(o.numpy() - r).max() / np.abs(r).max())
                assert rel <= W8A8_REL_TOL, rel


@pytest.mark.parametrize("name", ["dev", "schnell"])
def test_convert_flux_matches_jax(forwards, name):
    """convert_flux of a BFL state dict equals JAX's convert_flux carried
    over by flux_from_jax, and export_flux equals JAX's export_flux, each
    to the bit; a missing key and an unmapped module raise."""
    _, v, tm = forwards[name]
    bfl = j_export_flux(v)
    ours = convert_flux({k: torch.from_numpy(np.asarray(a)) for k, a in bfl.items()}, 2, 2)
    ref = flux_from_jax(j_convert_flux(bfl, 2, 2))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    assert ("guidance_in.in_layer.weight" in ours) == (name == "dev")
    out = export_flux(tm.state_dict())
    assert out.keys() == bfl.keys()
    for k in bfl:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(bfl[k]), err_msg=k)
    tm2 = Flux(tm.config)
    tm2.load_state_dict(ours)
    with pytest.raises(KeyError, match="single_blocks.1.linear1.weight"):
        convert_flux({k: a for k, a in bfl.items() if k != "single_blocks.1.linear1.weight"},
                     2, 2)
    with pytest.raises(ValueError, match="unmapped Flux module: extra"):
        export_flux({**tm.state_dict(), "extra.weight": torch.zeros(1)})


def test_flux_from_jax_checks_block_counts(forwards):
    _, v, _ = forwards["dev"]
    with pytest.raises(ValueError, match="2 single blocks, config has 3"):
        flux_from_jax(v, FluxConfig.toy(depth_single=3))


# -- the agent world ---------------------------------------------------------


def _fill_defaults(jag):
    """The JAX agent's ``sample`` with step caps and starting sigmas always
    passed (T and 1.0 where the caller gives none: the same rollout), so
    every rollout of one sampler config runs one compiled loop."""
    sample = jag.sample

    def wrapped(tpm_params, batch, key, predict=False, sampler_cfg=None, step_caps=None):
        b = np.asarray(batch["prompt_embeds"]).shape[0]
        batch = dict(batch)
        if batch.get("init_sigma") is None:
            batch["init_sigma"] = np.ones(b, np.float32)
        if step_caps is None:
            step_caps = np.full(b, T, np.int32)
        return sample(tpm_params, batch, key, predict=predict, sampler_cfg=sampler_cfg,
                      step_caps=step_caps)

    jag.sample = wrapped


@pytest.fixture(scope="module")
def world():
    """Both sides' agents (1 + 1 block toy caching one front block, the
    closed-form TPM), the toy VAE and pipelines with and without it."""
    jm, v, tm = _flux_pair(seed=10, **AGENT_KW)
    jtpm = JTimePredictor(conv_out_channels=4, in_channels=96, temb_dim=48)
    jag = JFluxAgent(jm, v, JRLOOConfig(max_inference_steps=T), tpm=jtpm, latent_size=8,
                     latent_channels=4)
    tag = FluxAgent(tm, RLOOConfig(max_inference_steps=T), latent_size=8, latent_channels=4)
    jag.tpm_fn = lambda params: _j_tpm
    tag.tpm_fn = lambda tpm: _t_tpm
    _fill_defaults(jag)
    jv = JVAE(JVAEConfig.toy(latent_channels=4))
    vvars = random_variables(jv.init, 11, jnp.zeros((1, 4, 8, 8)), jnp.zeros((1, 3, 16, 16)))
    tv = VAE(VAEConfig.toy(latent_channels=4))
    tv.load_state_dict(vae_from_jax(vvars))
    return dict(jag=jag, tag=tag, jm=jm, v=v, jpipe=JFluxPipeline(jag, jv, vvars),
                tpipe=FluxPipeline(tag, tv.eval()), jbare=JFluxPipeline(jag),
                tbare=FluxPipeline(tag))


def _seed_latents(seed, b=B):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, 4, 8, 8), generator=g)


def _assert_rollouts_match(out, ref, images=None):
    assert out.num_steps == int(ref.num_steps)
    np.testing.assert_array_equal(out.prob_masks.numpy(), np.asarray(ref.prob_masks))
    np.testing.assert_array_equal(out.last_valid_index.numpy(), np.asarray(ref.last_valid_index))
    for name in ("sigmas", "alphas", "betas", "logprobs", "final_latents"):
        close(getattr(out, name), np.asarray(getattr(ref, name)))


def test_agent_sample_replay_and_kl_match_jax(world):
    """predict=True with per-sample step caps and starting sigmas: the
    recorded sigmas, Beta parameters, log-probs, masks and final latents,
    the cached activations, then replay / logprobs / kl_divergence."""
    jag, tag = world["jag"], world["tag"]
    txt, pooled = _encode(PROMPTS)
    lat = _seed_latents(20)
    batch = {"prompt_embeds": txt, "pooled_prompt_embeds": pooled, "latents": lat.numpy(),
             "init_sigma": np.array([1.0, 0.8], np.float32)}
    caps = [3, T]
    ref = jag.sample(None, batch, jax.random.PRNGKey(0), predict=True, step_caps=caps)
    out = tag.sample(None, {**batch, "latents": lat, "init_sigma": t(batch["init_sigma"])},
                     None, predict=True, step_caps=caps)
    _assert_rollouts_match(out, ref)
    assert out.last_valid_index.tolist() == [2, T - 1]
    close(out.h_cache, np.asarray(ref.h_cache))
    close(out.temb_cache, np.asarray(ref.temb_cache))
    assert out.h_cache.shape == (T, B, 96, 4, 4)
    close(tag.replay(None, out), np.asarray(jag.replay(None, ref)))
    close(tag.logprobs(None, out), np.asarray(jag.replay(None, ref)))
    close(tag.kl_divergence(out), np.asarray(jag.kl_divergence(ref)))


def test_agent_parts(world):
    """The default TPM's parameter shapes (JAX's init, traced only), the
    latents' draw, the denoise builder, and shard's refusal."""
    jag, tag = world["jag"], world["tag"]
    fresh = FluxAgent(tag.flux, RLOOConfig(max_inference_steps=T), latent_size=8,
                      latent_channels=4)
    tpm = fresh.init_tpm_params(torch.Generator().manual_seed(0))
    jtpm = JTimePredictor(conv_out_channels=128, in_channels=96, temb_dim=48)
    shapes = jax.eval_shape(jtpm.init, jax.random.PRNGKey(0), jnp.zeros((1, 96, 4, 4)),
                            jnp.zeros((1, 48)))
    assert sum(p.numel() for p in tpm.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    lat = tag.prepare_latents(torch.Generator().manual_seed(20), B)
    torch.testing.assert_close(lat, _seed_latents(20), rtol=0, atol=0)
    assert tag.backbone_params is tag.flux and fresh.guidance == 3.5
    txt, pooled = _t_encode(PROMPTS)
    vel, vec, h = tag.denoise_builder(tag.flux, {"prompt_embeds": txt,
                                                 "pooled_prompt_embeds": pooled})(
        lat, torch.full((B,), 0.5))
    assert vel.shape == lat.shape and vec.shape == (B, 48) and h.shape == (B, 96, 4, 4)
    with pytest.raises(NotImplementedError, match="item 14"):
        tag.shard(None)


IMAGE = np.random.default_rng(30).integers(0, 256, (B, 16, 16, 3)).astype(np.uint8)


@pytest.mark.parametrize("mode", ["t2i", "img2img", "cache_ab2"])
def test_pipeline_generate_matches_jax(world, mode, monkeypatch):
    """FluxPipeline.generate with the VAE: text-to-image, image-to-image at
    strength 0.6 (JAX's noise replaced by the port's draw for the seed), and
    the Δ-cache every 2 steps with AB2; the schedules, step counts and the
    decoded images."""
    jpipe, tpipe = world["jpipe"], world["tpipe"]
    txt, pooled = _encode(PROMPTS)
    seed = 40
    noise = _seed_latents(seed)
    monkeypatch.setattr(world["jag"], "prepare_latents",
                        lambda key, b: jnp.asarray(noise.numpy()[:b]), raising=False)
    kw = {"t2i": {}, "img2img": dict(init_image=IMAGE, strength=0.6),
          "cache_ab2": dict(cache_interval=2, solver="ab2")}[mode]
    if mode == "img2img":
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=jnp.float32: jnp.asarray(noise.numpy()))
    ref = jpipe.generate(txt, pooled, seed=seed, **kw)
    monkeypatch.undo()
    out = tpipe.generate(*_t_encode(PROMPTS), seed=seed, **kw)
    assert out.num_steps == ref.num_steps == T
    np.testing.assert_array_equal(out.last_valid_index, ref.last_valid_index)
    close(out.schedule, ref.schedule)
    if mode == "img2img":
        assert (out.schedule[:, 0] < 0.6).all()  # the loop started at sigma = strength
    assert out.images.dtype == np.uint8 and out.images.shape == (B, 16, 16, 3)
    diff = np.abs(out.images.astype(np.int16) - np.asarray(ref.images).astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_pipeline_img2img_at_strength_one_is_text_to_image(world):
    tpipe = world["tpipe"]
    a = tpipe.generate(*_t_encode(PROMPTS), seed=41)
    b = tpipe.generate(*_t_encode(PROMPTS), seed=41, init_image=IMAGE, strength=1.0)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.schedule, b.schedule)


@pytest.mark.parametrize("solver", ["euler", "heun", "midpoint", "ab2"])
def test_pipeline_generate_fixed_matches_jax(world, solver, monkeypatch):
    """generate_fixed down uniform_flow_sigmas(3) without a VAE (the final
    latents), the JAX run executed eagerly."""
    seed = 42
    noise = _seed_latents(seed)
    monkeypatch.setattr(world["jag"], "prepare_latents",
                        lambda key, b: jnp.asarray(noise.numpy()[:b]), raising=False)
    txt, pooled = _encode(PROMPTS)
    with jax.disable_jit():
        ref = world["jbare"].generate_fixed(txt, pooled, num_steps=3, seed=seed, solver=solver)
    out = world["tbare"].generate_fixed(*_t_encode(PROMPTS), num_steps=3, seed=seed,
                                        solver=solver)
    close(out, np.asarray(ref))


def test_pipeline_refusals(world):
    tpipe, tbare = world["tpipe"], world["tbare"]
    pe, pp = _t_encode(PROMPTS)
    with pytest.raises(ValueError, match="needs a VAE"):
        tbare.generate(pe, pp, init_image=IMAGE)
    with pytest.raises(ValueError, match="strength"):
        tpipe.generate(pe, pp, init_image=IMAGE, strength=0.0)
    with pytest.raises(ValueError, match="batch 1 != prompt batch 2"):
        tpipe.generate(pe, pp, init_image=IMAGE[:1])
    with pytest.raises(ValueError, match="encodes to latent 16, agent serves 8"):
        tpipe.generate(pe, pp, init_image=np.zeros((B, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="unknown solver"):
        tpipe.generate_fixed(pe, pp, solver="rk4")
    with pytest.raises(ValueError, match="solver"):
        tpipe.generate(pe, pp, solver="heun")


# -- serving -------------------------------------------------------------------


def _per_seed(seeds):
    return torch.cat([_seed_latents(int(s), 1) for s in seeds])


def test_runner_matches_jax(world, monkeypatch):
    """make_flux_runner against JAX's on the same world: each request's
    steps, sigmas and final latents; the refusals."""
    jag, tag = world["jag"], world["tag"]
    monkeypatch.setattr(jfam, "_per_seed_latents",
                        lambda agent, seeds: jnp.asarray(_per_seed(seeds).numpy()))
    jrun = jfam.make_flux_runner(jag, None, lambda p: tuple(map(jnp.asarray, _encode(p))))
    trun = serving_families.make_flux_runner(tag, None, _t_encode)
    prompts, seeds, caps = PROMPTS, [3, 9], [2, T]
    ref, out = jrun(prompts, seeds, caps), trun(prompts, seeds, caps)
    for o, r in zip(out, ref):
        assert o["inference_steps"] == r["inference_steps"]
        close(np.asarray(o["sigmas"]), np.asarray(r["sigmas"]))
        close(o["image"], np.asarray(r["image"]))
    assert [o["inference_steps"] for o in out] == [2, T]
    with pytest.raises(ValueError, match="guidance_interval does not apply to FLUX"):
        serving_families.make_flux_runner(tag, None, _t_encode, guidance_interval=(0.1, 0.9))
    with pytest.raises(ValueError, match="mutually exclusive"):
        serving_families.make_flux_runner(tag, None, _t_encode, cache_interval=2, cache_tau=0.1)


def _run(engine, jobs=REQUESTS):
    engine.start()
    try:
        reqs = [engine.submit(p, seed=s, steps=c) for p, s, c in jobs]
        return [r.result(timeout=120) for r in reqs]
    finally:
        engine.stop()


def test_continuous_engine_matches_the_runners(world, monkeypatch):
    """A burst through 2 slots (seg_steps 2): each request's steps, sigmas
    and final latents equal a direct port runner call at the engine's batch
    holding the engine's rows, to the bit, and follow the JAX runner within
    the fp32 bound."""
    jag, tag = world["jag"], world["tag"]
    eng = ContinuousFluxEngine(tag, _t_encode, tpm_params=0, slots=2, seg_steps=2)
    eng.warmup()
    got = _run(eng)
    monkeypatch.setattr(jfam, "_per_seed_latents",
                        lambda agent, seeds: jnp.asarray(_per_seed(seeds).numpy()))
    jrun = jfam.make_flux_runner(jag, None, lambda p: tuple(map(jnp.asarray, _encode(p))))
    for (p, s, c), out in zip(REQUESTS, got):
        txt_row, pooled_row = eng._prompt_embeds(p)
        encode = lambda prompts: (torch.stack([txt_row] * 2), torch.stack([pooled_row] * 2))
        cap = c or T
        want = serving_families.make_flux_runner(tag, 0, encode)([p, p], [s, s], [cap, cap])[0]
        assert out["inference_steps"] == want["inference_steps"]
        assert out["sigmas"] == want["sigmas"]
        np.testing.assert_array_equal(out["image"], want["image"])
        ref = jrun([p, p], [s, s], [cap, cap])[0]
        assert out["inference_steps"] == ref["inference_steps"]
        close(np.asarray(out["sigmas"]), np.asarray(ref["sigmas"]))
        close(out["image"], np.asarray(ref["image"]))
    nfes = [o["inference_steps"] for o in got]
    assert nfes == [T, 2, T, 3, 1]
    assert eng.stats()["slot_steps_active"] == sum(nfes)
    assert eng.segment_traces == 1


def test_continuous_engine_refusals(world):
    tag = world["tag"]
    for kw, match in ((dict(dp=2), r"9\(d\)"), (dict(mesh_shape=(1, 1, 1)), "14")):
        with pytest.raises(NotImplementedError, match=match):
            ContinuousFluxEngine(tag, _t_encode, tpm_params=0, **kw)
    eng = ContinuousFluxEngine(tag, _t_encode, tpm_params=0, slots=1)
    # adapters are ported, fused only on the family engines
    with pytest.raises(ValueError, match="fused-only"):
        eng.register_adapter("a", {"x": {"a": torch.zeros(2, 1), "b": torch.zeros(1, 2)}})
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit("a", lora="a")
    with pytest.raises(ValueError, match="SD3-only"):
        eng.submit("a", guidance_scale=3.0)
    with pytest.raises(ValueError, match="img2img"):
        eng.submit("a", init_image=np.zeros((16, 16, 3), np.uint8))
    assert eng.max_steps == T and eng.guidance_scale is None
