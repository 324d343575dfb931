"""SDXL in tpdm_tpu_torch against the JAX package, on the CPU.

Covers ``utils/convert.py:convert_unet_sdxl`` / ``export_unet_sdxl`` (both
the Linear and the 1 x 1 conv ``proj_in`` / ``proj_out``),
``SDXLTextEncoders`` (shared and per-tower ids, the refiner's bigG-only
path), ``SDXLAgent.sample`` and ``SDXLRefinerAgent.sample`` at
``predict=True``, ``SDXLPipeline`` and ``SDXLRefinerPipeline``,
``sdxl_ensemble_generate`` (the handoff), ``make_sdxl_runner`` and
``make_sdxl_ensemble_runner``, and the K1 wrapper's small head dims on the
CPU path.

One toy world a side, built once (module fixture): ``toy_xl`` and
``toy_refiner`` cut to two and three levels at an 8 x 8 latent grid (each
JAX loop then compiles in seconds), 2-layer CLIP towers, weights drawn by
``_torch_parity.random_variables`` and carried over with
``unet_sd15_from_jax`` / ``clip_text_from_jax``, and a closed-form TPM on
both sides (``tpm_fn`` replaced, as ``test_torch_sd15_serving.py`` does).
Latents are numpy arrays given to both sides. Integer schedules, step
counts, last valid indices and handoff times must equal JAX's exactly;
float outputs are held to the fp32 bound (rtol 1e-4 / atol 1e-5 scaled by
the magnitude, ``_torch_parity.close``). The JAX rollouts share compiled
loops: the base agent's with step caps, the refiner's with caps and
init_t.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, random_variables, t
from tpdm_tpu import serving_families as jfam
from tpdm_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig, CLIPTextModel as JCLIP
from tpdm_tpu.models.tpm import TimePredictor as JTimePredictor
from tpdm_tpu.models.unet_sd15 import UNetConfig as JUNetConfig, UNetSD15 as JUNetSD15
from tpdm_tpu.pipeline.text_encoding import SDXLTextEncoders as JSDXLTextEncoders
from tpdm_tpu.pipeline.variants import (
    SDXLPipeline as JSDXLPipeline,
    SDXLRefinerPipeline as JSDXLRefinerPipeline,
    sdxl_ensemble_generate as j_ensemble,
)
from tpdm_tpu.train import RLOOConfig as JRLOOConfig
from tpdm_tpu.train.sdxl_agent import SDXLAgent as JSDXLAgent
from tpdm_tpu.train.sdxl_agent import SDXLRefinerAgent as JSDXLRefinerAgent
from tpdm_tpu.utils.convert import (
    convert_unet_sdxl as j_convert_unet_sdxl,
    export_unet_sdxl as j_export_unet_sdxl,
)
from tpdm_tpu_torch import serving_families
from tpdm_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from tpdm_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from tpdm_tpu_torch.ops.attention import attention_reference, flash_attention
from tpdm_tpu_torch.pipeline.text_encoding import SDXLTextEncoders
from tpdm_tpu_torch.pipeline.variants import (
    SDXLPipeline,
    SDXLRefinerPipeline,
    sdxl_ensemble_generate,
)
from tpdm_tpu_torch.serve import toy_tokenize
from tpdm_tpu_torch.train import RLOOConfig
from tpdm_tpu_torch.train.sdxl_agent import SDXLAgent, SDXLRefinerAgent
from tpdm_tpu_torch.utils.convert import (
    clip_text_from_jax,
    convert_unet_sdxl,
    export_unet_sdxl,
    unet_sd15_from_jax,
)

T, B, GS = 6, 2, 5.0
L_W, G_W, POOL = 16, 24, 12  # CLIP-L and bigG widths, bigG's projection
# the base: two levels (attention-free, then one block) at an 8 x 8 grid;
# the refiner: attention-free first and last levels around one with a block
BASE_KW = dict(block_out_channels=(8, 16), transformer_layers_per_block=(0, 1),
               mid_transformer_layers=1, sample_size=8, cross_attention_dim=L_W + G_W,
               addition_pooled_dim=POOL)
REF_KW = dict(block_out_channels=(8, 16, 16), transformer_layers_per_block=(0, 1, 0),
              mid_transformer_layers=1, sample_size=8, cross_attention_dim=G_W,
              addition_pooled_dim=POOL)
PROMPTS = ["a red cat", "a blue dog on grass"]


def _j_tpm(h, temb):
    return jnp.stack([3.0 + 0.1 * jnp.tanh(jnp.mean(h, axis=(1, 2, 3))),
                      2.0 + 0.1 * jnp.tanh(jnp.mean(temb, axis=1))], axis=1)


def _t_tpm(h, temb):
    return torch.stack([3.0 + 0.1 * torch.tanh(h.mean(dim=(1, 2, 3))),
                        2.0 + 0.1 * torch.tanh(temb.mean(dim=1))], dim=1)


def _ids(prompts):
    return np.concatenate([toy_tokenize(p)[0] for p in prompts])


def _unet_pair(name, kw, seed):
    jcfg = getattr(JUNetConfig, name)(**kw)
    ju = JUNetSD15(jcfg)
    s = jcfg.sample_size
    added = {"text_embeds": jnp.zeros((1, POOL)), "time_ids": jnp.zeros((1, jcfg.num_time_ids))}
    uvars = random_variables(ju.init, seed, jnp.zeros((1, 4, s, s)), jnp.ones((1,)),
                             jnp.zeros((1, 8, jcfg.cross_attention_dim)), added)
    tu = UNetSD15(getattr(UNetConfig, name)(**kw))
    tu.load_state_dict(unet_sd15_from_jax(uvars))
    return ju, uvars, tu.eval()


def _tower_pair(width, seed):
    cfg = dict(hidden_size=width, projection_dim=POOL if width == G_W else 8,
               max_position_embeddings=8)
    jm = JCLIP(JCLIPConfig.toy(**cfg))
    v = random_variables(jm.init, seed, jnp.zeros((1, 8), jnp.int32))
    tm = CLIPTextModel(CLIPTextConfig.toy(**cfg))
    tm.load_state_dict(clip_text_from_jax(v))
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def world():
    """Both sides' base and refiner agents and pipelines (no VAE: the
    pipelines return final latents), the text encoders, and the latents."""
    ju, uvars, tu = _unet_pair("toy_xl", BASE_KW, 50)
    jr, rvars, tr = _unet_pair("toy_refiner", REF_KW, 51)
    (jl, lv, tl), (jg, gv, tg) = _tower_pair(L_W, 52), _tower_pair(G_W, 53)
    jte, tte = JSDXLTextEncoders(jl, lv, jg, gv), SDXLTextEncoders(tl, tg)
    jtpm = lambda ch: JTimePredictor(conv_out_channels=4, in_channels=2 * ch, temb_dim=ch)
    jag = JSDXLAgent(ju, uvars, JRLOOConfig(max_inference_steps=T), tpm=jtpm(8),
                     guidance_scale=GS)
    jrag = JSDXLRefinerAgent(jr, rvars, JRLOOConfig(max_inference_steps=T), tpm=jtpm(8),
                             guidance_scale=GS)
    tag = SDXLAgent(tu, RLOOConfig(max_inference_steps=T), guidance_scale=GS)
    trag = SDXLRefinerAgent(tr, RLOOConfig(max_inference_steps=T), guidance_scale=GS)
    for agent in (jag, jrag):
        agent.tpm_fn = lambda params: _j_tpm
    for agent in (tag, trag):
        agent.tpm_fn = lambda tpm: _t_tpm
    lat = np.random.default_rng(54).standard_normal((B, 4, 8, 8)).astype(np.float32)
    return dict(jag=jag, jrag=jrag, tag=tag, trag=trag, jte=jte, tte=tte, lat=lat,
                jbase=JSDXLPipeline(jag, text_encoders=jte),
                jref=JSDXLRefinerPipeline(jrag, text_encoders=jte),
                tbase=SDXLPipeline(tag, text_encoders=tte),
                tref=SDXLRefinerPipeline(trag, text_encoders=tte))


def _encoders(world):
    """The runners' encode functions ((JAX, port) for the base, then for the
    refiner), from the same ids; the negative pair is the towers on zero ids."""
    def encode_with(fn):
        def encode(prompts):
            ids = _ids(prompts)
            pos, neg = fn(ids), fn(np.zeros_like(ids))
            return pos[0], pos[1], neg[0], neg[1]

        return encode

    jte, tte = world["jte"], world["tte"]
    return ((encode_with(jte.encode), encode_with(tte.encode)),
            (encode_with(jte.encode_refiner), encode_with(tte.encode_refiner)))


def _same_rollout(ours, ref):
    np.testing.assert_array_equal(ours.times.numpy(), np.asarray(ref.times))
    np.testing.assert_array_equal(ours.last_valid_index.numpy(),
                                  np.asarray(ref.last_valid_index))
    np.testing.assert_array_equal(ours.prob_masks.numpy(), np.asarray(ref.prob_masks))
    assert ours.num_steps == int(ref.num_steps)
    close(ours.final_latents, ref.final_latents)
    close(ours.ratios, ref.ratios)


def _batch(encode_pair, prompts, latents, **extra):
    jenc, tenc = encode_pair
    keys = ("prompt_embeds", "pooled_prompt_embeds", "negative_prompt_embeds",
            "negative_pooled_prompt_embeds")
    jb = dict(zip(keys, jenc(prompts)), latents=jnp.asarray(latents),
              **{k: jnp.asarray(v) for k, v in extra.items()})
    tb = dict(zip(keys, tenc(prompts)), latents=t(latents), **{k: t(v) for k, v in extra.items()})
    return jb, tb


# ---------------------------------------------------------------- converters

@pytest.mark.parametrize("name", ["toy_xl", "toy_refiner"])
def test_unet_sdxl_converters_match_jax(name):
    """``convert_unet_sdxl`` of JAX's diffusers-layout export (Linear and 1 x
    1 conv projections) equals the port's state dict of the same weights,
    ``export_unet_sdxl`` gives JAX's export back, and JAX's converter of the
    port's export is the drawn tree (the full toy topologies: depth-2
    transformers, shortcut resnets)."""
    jcfg = getattr(JUNetConfig, name)(layers_per_block=2)
    ju = JUNetSD15(jcfg)
    s = jcfg.sample_size
    added = {"text_embeds": jnp.zeros((1, jcfg.addition_pooled_dim)),
             "time_ids": jnp.zeros((1, jcfg.num_time_ids))}
    variables = random_variables(ju.init, 55, jnp.zeros((1, 4, s, s)), jnp.ones((1,)),
                                 jnp.zeros((1, 8, jcfg.cross_attention_dim)), added)
    cfg = getattr(UNetConfig, name)(layers_per_block=2)
    want = unet_sd15_from_jax(variables)
    geometry = dict(block_out_channels=cfg.block_out_channels,
                    layers_per_block=cfg.layers_per_block,
                    transformer_layers_per_block=cfg.depths,
                    mid_transformer_layers=cfg.mid_transformer_layers)
    for linear in (True, False):
        diffusers = j_export_unet_sdxl(variables, linear_projection=linear)
        ours = convert_unet_sdxl(diffusers, **geometry)
        assert sorted(ours) == sorted(want)
        for k, v in want.items():
            assert torch.equal(ours[k], v), k
        back = export_unet_sdxl(want, cfg, linear_projection=linear)
        assert sorted(back) == sorted(diffusers)
        for k, v in diffusers.items():
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
        again = unet_sd15_from_jax(j_convert_unet_sdxl(
            {k: v.numpy() for k, v in back.items()}, **geometry))
        for k, v in want.items():
            assert torch.equal(again[k], v), k


# ---------------------------------------------------------------- text

def test_text_encoders_match_jax(world):
    """``encode`` (both towers on shared ids, and bigG on its own ids,
    padded with 0) and ``encode_refiner``: the 2048-style join of the
    penultimate states and bigG's projected EOS row."""
    ids = _ids(PROMPTS)
    g_ids = np.where(ids == 0, 0, ids[:, ::-1])  # other ids for bigG alone
    jte, tte = world["jte"], world["tte"]
    for args in ((ids,), (ids, g_ids)):
        ours, ref = tte.encode(*args), jte.encode(*args)
        assert ours.prompt_embeds.shape == (B, 8, L_W + G_W)
        assert ours.pooled_prompt_embeds.shape == (B, POOL)
        close(ours.prompt_embeds, ref.prompt_embeds)
        close(ours.pooled_prompt_embeds, ref.pooled_prompt_embeds)
    ours, ref = tte.encode_refiner(g_ids), jte.encode_refiner(g_ids)
    assert ours.prompt_embeds.shape == (B, 8, G_W)
    close(ours.prompt_embeds, ref.prompt_embeds)
    close(ours.pooled_prompt_embeds, ref.pooled_prompt_embeds)
    # the shared-ids path differs from bigG's own ids
    assert not torch.equal(tte.encode(ids).pooled_prompt_embeds,
                           tte.encode(ids, g_ids).pooled_prompt_embeds)


# ---------------------------------------------------------------- agents

def test_agent_sample_matches_jax(world):
    """``SDXLAgent.sample`` at predict=True with caps (3 and none) and the
    default time ids: schedule, masks, ratios and final latents."""
    base, _ = _encoders(world)
    jb, tb = _batch(base, PROMPTS, world["lat"])
    caps = np.array([3, T], np.int32)
    ref = world["jag"].sample(0, jb, jax.random.PRNGKey(0), predict=True, step_caps=caps)
    ours = world["tag"].sample(0, tb, None, predict=True, step_caps=caps)
    _same_rollout(ours, ref)
    assert int(ours.last_valid_index[0]) == 2
    np.testing.assert_array_equal(world["tag"].default_time_ids(2).numpy(),
                                  np.asarray(world["jag"].default_time_ids(2)))


def test_refiner_sample_matches_jax(world):
    """``SDXLRefinerAgent.sample`` from mid-denoise latents at per-sample
    init_t (the handoff's entry), its five time ids and the negative
    aesthetic score on the uncond rows."""
    _, ref_enc = _encoders(world)
    init_t = np.array([240, 150], np.int32)
    jb, tb = _batch(ref_enc, PROMPTS, world["lat"], init_t=init_t)
    caps = np.array([T, 2], np.int32)
    ref = world["jrag"].sample(0, jb, jax.random.PRNGKey(0), predict=True, step_caps=caps)
    ours = world["trag"].sample(0, tb, None, predict=True, step_caps=caps)
    _same_rollout(ours, ref)
    np.testing.assert_array_equal(ours.times[:, 0].numpy(), init_t)
    tid = world["trag"].default_time_ids(2)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(world["jrag"].default_time_ids(2)))
    np.testing.assert_array_equal(world["trag"].negative_time_ids(tid).numpy(),
                                  np.asarray(world["jrag"].negative_time_ids(jnp.asarray(tid))))
    with pytest.raises(ValueError, match="num_time_ids=5"):
        SDXLRefinerAgent(world["tag"].unet, RLOOConfig())
    with pytest.raises(ValueError, match="addition_embed"):
        SDXLAgent(UNetSD15(UNetConfig.toy()), RLOOConfig())


# ---------------------------------------------------------------- pipelines

def test_ensemble_handoff_matches_jax(world, monkeypatch):
    """``sdxl_ensemble_generate`` at denoising_end 0.8 from ids through
    both stages' encoders: the base stops below t_cut = 200, each sample's
    handoff t, the refiner's schedule from it and the final latents."""
    lat = world["lat"]
    monkeypatch.setattr(world["jag"], "prepare_latents", lambda key, b: jnp.asarray(lat))
    monkeypatch.setattr(world["tag"], "prepare_latents", lambda g, b: t(lat))
    ids = _ids(PROMPTS)
    kw = dict(denoising_end=0.8, seed=3, tpm_params=0, refiner_tpm_params=0, clip_ids=ids,
              negative_clip_ids=np.zeros_like(ids))
    ref = j_ensemble(world["jbase"], world["jref"], **kw)
    ours = sdxl_ensemble_generate(world["tbase"], world["tref"], **kw)
    for field in ("base_schedule", "refiner_schedule", "handoff_t", "last_valid_index"):
        np.testing.assert_array_equal(getattr(ours, field), np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert (ours.num_steps, ours.base_steps, ours.refiner_steps) == (
        ref.num_steps, ref.base_steps, ref.refiner_steps)
    assert (ours.handoff_t < 200).all() and (ours.refiner_schedule[:, 0] == ours.handoff_t).all()
    close(ours.images, ref.images)
    with pytest.raises(ValueError, match="denoising_end"):
        sdxl_ensemble_generate(world["tbase"], world["tref"], denoising_end=1.0)
    with pytest.raises(NotImplementedError, match="refine"):
        world["tref"].generate()
    with pytest.raises(ValueError, match="exactly one"):
        world["tref"].refine()


def test_base_pipeline_from_embeds_matches_the_agent(world):
    """``SDXLPipeline.generate`` from precomputed embeds with explicit
    time_ids equals the agent's rollout of the same batch (it is the agent
    plus the decode); without the pooled rows or the negatives it raises."""
    base, _ = _encoders(world)
    _, tb = _batch(base, PROMPTS, world["lat"])
    time_ids = np.array([[64, 64, 0, 0, 64, 64], [96, 64, 8, 0, 64, 64]], np.float32)
    agent = world["tag"]
    real = agent.prepare_latents
    agent.prepare_latents = lambda g, b: tb["latents"]
    try:
        res = world["tbase"].generate(**{k: v for k, v in tb.items() if k != "latents"},
                                      time_ids=time_ids, tpm_params=0)
    finally:
        agent.prepare_latents = real
    out = agent.sample(0, {**tb, "time_ids": time_ids}, None, predict=True)
    np.testing.assert_array_equal(res.schedule, out.times.numpy())
    np.testing.assert_array_equal(res.images, out.final_latents.numpy())
    with pytest.raises(ValueError, match="pooled_prompt_embeds"):
        world["tbase"].generate(prompt_embeds=tb["prompt_embeds"])
    with pytest.raises(ValueError, match="negative_prompt_embeds AND"):
        world["tbase"].generate(prompt_embeds=tb["prompt_embeds"],
                                pooled_prompt_embeds=tb["pooled_prompt_embeds"])


# ---------------------------------------------------------------- runners

def test_sdxl_runner_matches_jax(world, monkeypatch):
    """``make_sdxl_runner``: per-request caps and seeds (JAX's per-seed
    latents the port's), the same steps and integer schedules and final
    latents within the fp32 bound."""
    (jenc, tenc), _ = _encoders(world)
    seeds, caps = [0, 1], [2, T]
    lat = serving_families._per_seed_latents(world["tag"], seeds)
    monkeypatch.setattr(jfam, "_per_seed_latents", lambda agent, s: jnp.asarray(lat.numpy()))
    ref = jfam.make_sdxl_runner(world["jag"], 0, jenc)(PROMPTS, seeds, caps)
    ours = serving_families.make_sdxl_runner(world["tag"], 0, tenc)(PROMPTS, seeds, caps)
    assert [r["inference_steps"] for r in ours] == [r["inference_steps"] for r in ref]
    assert ours[0]["inference_steps"] == 2
    for a, b in zip(ours, ref):
        assert a["sigmas"] == [int(v) for v in b["sigmas"]]
        close(a["image"], b["image"])


def test_sdxl_ensemble_runner_matches_jax(world, monkeypatch):
    """``make_sdxl_ensemble_runner``: each cap split into the base's share
    and the refiner's, the base handing off at the cutoff when its share
    runs out (cap_floor_time), the whole integer trajectory and the final
    latents."""
    (jenc, tenc), (jrenc, trenc) = _encoders(world)
    seeds, caps = [2, 3], [3, T]
    lat = serving_families._per_seed_latents(world["tag"], seeds)
    monkeypatch.setattr(jfam, "_per_seed_latents", lambda agent, s: jnp.asarray(lat.numpy()))
    ref = jfam.make_sdxl_ensemble_runner(world["jag"], 0, world["jrag"], 0, jenc,
                                         jrenc)(PROMPTS, seeds, caps)
    ours = serving_families.make_sdxl_ensemble_runner(world["tag"], 0, world["trag"], 0, tenc,
                                                      trenc)(PROMPTS, seeds, caps)
    for a, b in zip(ours, ref):
        for key in ("inference_steps", "base_steps", "refiner_steps", "handoff_t"):
            assert a[key] == b[key], key
        assert a["sigmas"] == [int(v) for v in b["sigmas"]]
        close(a["image"], b["image"])
    # cap 3: the base takes round(3 x 0.8) = 2 and hands off at the cutoff
    assert (ours[0]["base_steps"], ours[0]["refiner_steps"]) == (2, 1)
    assert ours[0]["handoff_t"] == 199


# ---------------------------------------------------------------- K1's small head dims

@pytest.mark.parametrize("d", [4, 6, 8])
def test_k1_small_head_dims_run_the_plain_version_on_the_cpu(d):
    """On CPU tensors the wrapper runs the plain version at any head dim:
    the toy UNets' 4, 6 and 8 (on the card, the d-64 kernel on operands
    padded to 64 columns; ``tests/test_torch_cuda.py`` holds it)."""
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(2, 3, n, d, generator=g) for n in (5, 7, 7))
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, k, v), attention_reference(q, k, v),
                               rtol=0, atol=0)
    assert flash_attention.launches == before
