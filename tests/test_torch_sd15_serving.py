"""SD1.5 generation and serving in tpdm_tpu_torch against the JAX package.

``SD15Pipeline.generate`` (text-to-image from CLIP ids, integer-t img2img,
and DeepCache composed with the guidance window through the agent's real
builders), the SD1.5 runner (``serving_families.make_sd15_runner``), the
fixed-batch engine over it, and ``serve --family sd15``, on one toy world:
a two-level toy UNet, the toy CLIP tower and VAE drawn by ``_torch_parity.
random_variables`` (no init compile), a closed-form TPM on both sides
(``tpm_fn`` replaced: JAX's toy TPM compiles its adaptive pool slowly), and
the same numpy latents and noise on both sides (``jax.random`` and
``torch.Generator`` draw different numbers). Integer schedules, step
counts and last valid indices must equal JAX's exactly; images within one
uint8 level on under 1 % of pixels (fp32 on both sides, rounded once to
uint8). Unlike SD3, strength 1.0 is not text-to-image here (the latents
keep alpha_999·x0), so it is not asserted.
"""

import argparse
import base64
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_variables, t
from tpdm_tpu import serving as jserving
from tpdm_tpu import serving_families as jfam
from tpdm_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig, CLIPTextModel as JCLIP
from tpdm_tpu.models.tpm import TimePredictor as JTimePredictor
from tpdm_tpu.models.unet_sd15 import UNetConfig as JUNetConfig, UNetSD15 as JUNetSD15
from tpdm_tpu.models.vae import VAE as JVAE, VAEConfig as JVAEConfig
from tpdm_tpu.pipeline.variants import SD15Pipeline as JSD15Pipeline
from tpdm_tpu.train import RLOOConfig as JRLOOConfig
from tpdm_tpu.train.sd15_agent import SD15Agent as JSD15Agent
from tpdm_tpu_torch import serve, serving_families
from tpdm_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from tpdm_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from tpdm_tpu_torch.models.vae import VAE, VAEConfig
from tpdm_tpu_torch.pipeline.pipeline import seed_noise
from tpdm_tpu_torch.pipeline.variants import SD15Pipeline
from tpdm_tpu_torch.serving import BatchingEngine
from tpdm_tpu_torch.train import RLOOConfig
from tpdm_tpu_torch.train.sd15_agent import SD15Agent
from tpdm_tpu_torch.utils.convert import clip_text_from_jax, unet_sd15_from_jax, vae_from_jax

T, B, GS, CTX = 10, 2, 7.5, 32
# two levels (attention on the first and in the mid block): JAX compiles
# each loop of this file in a few seconds
UNET_KW = dict(cross_attention_dim=CTX, block_out_channels=(8, 16))
WINDOW = (300.0, 700.0)


def _j_tpm(h, temb):
    return jnp.stack([3.0 + 0.1 * jnp.tanh(jnp.mean(h, axis=(1, 2, 3))),
                      2.0 + 0.1 * jnp.tanh(jnp.mean(temb, axis=1))], axis=1)


def _t_tpm(h, temb):
    return torch.stack([3.0 + 0.1 * torch.tanh(h.mean(dim=(1, 2, 3))),
                        2.0 + 0.1 * torch.tanh(temb.mean(dim=1))], dim=1)


def _ids(prompt):
    return serve.toy_tokenize(prompt)[0]


@pytest.fixture(scope="module")
def world():
    """The toy SD1.5 world on both sides: (JAX pipeline, port pipeline,
    JAX encode, port encode, latents of seeds 0..3 as the port draws them)."""
    ucfg = JUNetConfig.toy(**UNET_KW)
    ju = JUNetSD15(ucfg)
    s = ucfg.sample_size
    uvars = random_variables(ju.init, 40, jnp.zeros((1, 4, s, s)), jnp.ones((1,)),
                             jnp.zeros((1, 8, CTX)))
    jtext = JCLIP(JCLIPConfig.toy(hidden_size=CTX, max_position_embeddings=8))
    tvars = random_variables(jtext.init, 41, jnp.zeros((1, 8), jnp.int32))
    jvae = JVAE(JVAEConfig.toy(latent_channels=4))
    vvars = random_variables(jvae.init, 42, jnp.zeros((1, 4, s, s)),
                             jnp.zeros((1, 3, 2 * s, 2 * s)))
    jag = JSD15Agent(ju, uvars, JRLOOConfig(max_inference_steps=T),
                     tpm=JTimePredictor(conv_out_channels=4, in_channels=16, temb_dim=8),
                     guidance_scale=GS)
    jag.tpm_fn = lambda params: _j_tpm

    tu = UNetSD15(UNetConfig.toy(**UNET_KW))
    tu.load_state_dict(unet_sd15_from_jax(uvars))
    ttext = CLIPTextModel(CLIPTextConfig.toy(hidden_size=CTX, max_position_embeddings=8))
    ttext.load_state_dict(clip_text_from_jax(tvars))
    tvae = VAE(VAEConfig.toy(latent_channels=4))
    tvae.load_state_dict(vae_from_jax(vvars))
    tag = SD15Agent(tu, RLOOConfig(max_inference_steps=T), guidance_scale=GS)
    tag.tpm_fn = lambda tpm: _t_tpm

    def jencode(prompts):
        ids = jnp.asarray(np.concatenate([_ids(p) for p in prompts]))
        return jtext.apply(tvars, ids)[1], jtext.apply(tvars, jnp.zeros_like(ids))[1]

    @torch.no_grad()
    def tencode(prompts):
        ids = torch.as_tensor(np.concatenate([_ids(p) for p in prompts])).long()
        return ttext(ids)[1], ttext(torch.zeros_like(ids))[1]

    lat = {sd: tag.prepare_latents(torch.Generator().manual_seed(sd), 1) for sd in range(4)}
    return dict(jpipe=JSD15Pipeline(jag, jvae, vvars, jtext, tvars),
                tpipe=SD15Pipeline(tag, tvae, ttext), jag=jag, tag=tag, jvae=jvae,
                vvars=vvars, tvae=tvae, jencode=jencode, tencode=tencode, lat=lat)


def _images_close(ours, ref):
    ours, ref = np.asarray(ours).astype(int), np.asarray(ref).astype(int)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    diff = np.abs(ours - ref)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def _same_schedule(ours, ref):
    np.testing.assert_array_equal(ours.schedule, np.asarray(ref.schedule))
    np.testing.assert_array_equal(ours.last_valid_index, np.asarray(ref.last_valid_index))
    assert ours.num_steps == ref.num_steps


def _with_latents(world, monkeypatch, lat):
    """Both agents draw ``lat`` as their initial latents."""
    monkeypatch.setattr(world["jag"], "prepare_latents", lambda key, b: jnp.asarray(lat))
    monkeypatch.setattr(world["tag"], "prepare_latents", lambda g, b: t(lat))


def test_generate_text_to_image_matches_jax(world, monkeypatch):
    lat = np.concatenate([world["lat"][0].numpy(), world["lat"][1].numpy()])
    _with_latents(world, monkeypatch, lat)
    prompts = ["a red cat", "a blue dog on grass"]
    ids = np.concatenate([_ids(p) for p in prompts])
    kw = dict(clip_ids=ids, negative_clip_ids=np.zeros_like(ids), seed=3, tpm_params=0)
    ref = world["jpipe"].generate(**kw)
    ours = world["tpipe"].generate(**kw)
    _same_schedule(ours, ref)
    assert ours.schedule.shape == (B, T + 1) and (ours.schedule[:, 0] == 999).all()
    assert ours.num_steps >= 4
    _images_close(ours.images, ref.images)


def test_generate_img2img_matches_jax(world, monkeypatch):
    """DDPM forward noising at t0 = round(0.6·999) = 599 (JAX's
    ``jax.random.normal`` returns the port's noise for that call) and the
    loop starting there."""
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
    noise = seed_noise(7, (B, 4, 16, 16), torch.device("cpu"), torch.float32)[1]
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(
        noise.numpy()).astype(dtype or jnp.float32))
    prompts = ["a house", "the sea at night"]
    ids = np.concatenate([_ids(p) for p in prompts])
    kw = dict(clip_ids=ids, negative_clip_ids=np.zeros_like(ids), seed=7, tpm_params=0,
              init_image=image, strength=0.6)
    ref = world["jpipe"].generate(**kw)
    monkeypatch.undo()
    ours = world["tpipe"].generate(**kw)
    _same_schedule(ours, ref)
    assert (ours.schedule[:, 0] == 599).all()
    _images_close(ours.images, ref.images)
    with pytest.raises(ValueError, match="strength"):
        world["tpipe"].generate(**{**kw, "strength": 0.0})


def test_generate_deepcache_and_window_match_jax(world, monkeypatch):
    """``cache_interval=2`` composed with the guidance window: the agents'
    DeepCache pair over the UNet's record / reuse forwards, the window in
    integer t."""
    lat = np.concatenate([world["lat"][2].numpy(), world["lat"][3].numpy()])
    _with_latents(world, monkeypatch, lat)
    pe, npe = world["jencode"](["a tree", "a boat"])
    tpe, tnpe = world["tencode"](["a tree", "a boat"])
    kw = dict(seed=1, tpm_params=0, cache_interval=2, guidance_interval=WINDOW)
    ref = world["jpipe"].generate(prompt_embeds=pe, negative_prompt_embeds=npe, **kw)
    ours = world["tpipe"].generate(prompt_embeds=tpe, negative_prompt_embeds=tnpe, **kw)
    _same_schedule(ours, ref)
    times = ours.schedule[0, :ours.num_steps]
    assert any(WINDOW[0] <= v < WINDOW[1] for v in times) and not all(
        WINDOW[0] <= v < WINDOW[1] for v in times)
    _images_close(ours.images, ref.images)
    with pytest.raises(ValueError, match="mutually exclusive"):
        world["tpipe"].generate(prompt_embeds=tpe, negative_prompt_embeds=tnpe, seed=1,
                                tpm_params=0, cache_interval=2, cache_tau=0.1)


@pytest.fixture(scope="module")
def runners(world):
    jrun = jfam.make_sd15_runner(world["jag"], 0, world["jencode"],
                                 jfam.make_vae_decoder(world["jvae"], world["vvars"]))
    trun = serving_families.make_sd15_runner(world["tag"], 0, world["tencode"],
                                             serving_families.make_vae_decoder(world["tvae"]))
    return jrun, trun


def test_runner_matches_jax(world, runners, monkeypatch):
    """Per-request caps (2 and none) and seeds; JAX's per-seed latents are
    the port's (``_per_seed_latents`` patched for the call)."""
    jrun, trun = runners
    prompts, seeds, caps = ["a red cat", "a blue dog on grass"], [0, 1], [2, T]
    lat = serving_families._per_seed_latents(world["tag"], seeds)
    for sd in seeds:
        torch.testing.assert_close(lat[sd], world["lat"][sd][0], rtol=0, atol=0)
    monkeypatch.setattr(jfam, "_per_seed_latents", lambda agent, s: jnp.asarray(lat.numpy()))
    ref = jrun(prompts, seeds, caps)
    ours = trun(prompts, seeds, caps)
    assert [r["inference_steps"] for r in ours] == [r["inference_steps"] for r in ref]
    assert ours[0]["inference_steps"] == 2
    for a, b in zip(ours, ref):
        assert a["sigmas"] == [int(v) for v in b["sigmas"]]
        _images_close(a["image"], b["image"])


def test_engine_rows_equal_direct_calls(world, runners):
    """The fixed-batch engine over the runner: three requests with mixed
    caps coalesce into one padded batch of four, each row equal to a direct
    runner call on the same padded batch, to the bit."""
    _, trun = runners
    engine = BatchingEngine(None, lambda p, _n=None: (None, None), max_batch=4,
                            window_ms=500.0, max_steps=T, runner=trun)
    engine.start()
    try:
        reqs = [engine.submit("a red cat", seed=0, steps=3),
                engine.submit("a tree", seed=2),
                engine.submit("a boat", seed=3, steps=5)]
        got = [r.result(timeout=300) for r in reqs]
    finally:
        engine.stop()
    ref = trun(["a red cat", "a tree", "a boat", "a boat"], [0, 2, 3, 3], [3, T, 5, 5])
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["inference_steps"] == b["inference_steps"] and a["sigmas"] == b["sigmas"]
    assert [r["inference_steps"] for r in got][::2] == [3, 5]
    stats = engine.stats()
    assert stats["batches_run"] == 1 and stats["padded_slots"] == 1


def test_engine_stats_keys_match_jax(runners):
    """A runner engine's stats() has the JAX runner engine's keys (the JAX
    engine runs a stub runner: its stats need no model)."""
    _, trun = runners
    stub = lambda p, s, c: [{"image": np.zeros((2, 2, 3), np.uint8), "inference_steps": 1,
                             "sigmas": [0]} for _ in p]
    tok = lambda p, _n=None: (None, None)
    jeng = jserving.BatchingEngine(None, tok, max_batch=2, runner=stub)
    teng = BatchingEngine(None, tok, max_batch=2, runner=stub)
    for eng in (jeng, teng):
        eng.generate_batch(["a"], [0])
    assert set(teng.stats()) == set(jeng.stats())


def test_engine_refuses_what_a_runner_does_not_take(runners):
    _, trun = runners
    tok = lambda p, _n=None: (None, None)
    with pytest.raises(ValueError, match="resolutions"):
        BatchingEngine(None, tok, runner=trun, resolutions=[512])
    with pytest.raises(ValueError, match="construction"):
        BatchingEngine(None, tok, runner=trun, cache_interval=2)
    with pytest.raises(ValueError, match="solver"):
        BatchingEngine(None, tok, runner=trun, solver="ab2")
    engine = BatchingEngine(None, tok, runner=trun)
    with pytest.raises(ValueError, match="SD3-only"):
        engine.submit("a", guidance_scale=3.0)
    with pytest.raises(ValueError, match="img2img"):
        engine.submit("a", init_image=np.zeros((32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="SD3-only"):
        engine.submit("a", resolution=64)
    with pytest.raises(ValueError, match="SD3-pipeline-engine-only"):
        engine.generate_batch(["a"], [0], negative_prompts=["blurry"])


def test_agent_protocol_and_unported_hooks(world):
    tag = world["tag"]
    lat = torch.cat([world["lat"][0], world["lat"][1]])
    pe, npe = world["tencode"](["a", "b"])
    out = tag.sample(0, {"prompt_embeds": pe, "negative_prompt_embeds": npe, "latents": lat},
                     None, predict=True, step_caps=[3, T])
    torch.testing.assert_close(tag.logprobs(0, out), out.logprobs)
    assert torch.equal(tag.kl_divergence(out), torch.zeros_like(out.logprobs))
    assert out.last_valid_index.tolist()[0] == 2
    for name, args in (("denoise_builder", (None, None)), ("forward_noising", (0, 0, 0)),
                       ("draft_step_builder", (4,))):
        with pytest.raises(NotImplementedError, match=r"9\(e\)"):
            getattr(tag, name)(*args)


def test_vae_configs_match_jax():
    for name in ("sd15", "sdxl"):
        ours, ref = getattr(VAEConfig, name)(), getattr(JVAEConfig, name)()
        for field in ("latent_channels", "block_out_channels", "scaling_factor",
                      "shift_factor", "layers_per_block", "norm_num_groups"):
            assert getattr(ours, field) == getattr(ref, field), (name, field)


def test_serve_family_sd15_cli(tmp_path, capsys):
    out = tmp_path / "cat.png"
    serve.main(["--family", "sd15", "--toy", "--cpu", "--cli", "--prompt", "a cat",
                "--seed", "3", "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "inference steps:" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--family", "sd15", "--cpu", "--cli"], "--toy"),
    (["--family", "sd15", "--toy", "--cpu", "--int8"], "int8"),
    (["--family", "sd15", "--toy", "--cli"], "--cpu"),
    (["--family", "flux", "--toy", "--cpu", "--continuous", "--lora_fused"], "without --lora"),
    (["--family", "flux", "--toy", "--cpu", "--few_step", "0"], r"item 9\(e\)"),
    (["--family", "sd15", "--toy", "--cpu", "--solver", "ab2"], "solver"),
])
def test_serve_family_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(argv)


def test_serve_family_sd15_http(tmp_path):
    """``--family sd15 --toy`` behind the HTTP server: a /generate request
    answers with a PNG and the integer schedule; --continuous over a bare
    runner (without the family world) and --resolutions are refused, as in
    JAX."""
    args = serve.parse_args(["--family", "sd15", "--toy", "--cpu", "--port", "0",
                             "--max_steps", "4"])
    world = serve.build_family_world(args)
    for extra, match in ((dict(continuous=True), "ContinuousSD15Engine"),
                         (dict(resolutions="64"), "SD3-only")):
        with pytest.raises(SystemExit, match=match):
            serve.make_engine(None, None, argparse.Namespace(**{**vars(args), **extra}),
                              runner=world["runner"])
    engine, server = serve.make_http_server(None, None, args, runner=world["runner"])
    engine.start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/generate"
        body = json.dumps({"prompt": "a cat", "seed": 1, "steps": 3}).encode()
        with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=120) as r:
            res = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    assert base64.b64decode(res["image_png_base64"])[:4] == b"\x89PNG"
    assert res["inference_steps"] <= 3 and all(isinstance(v, int) for v in res["sigmas"])
