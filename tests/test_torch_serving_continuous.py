"""The port's continuous batching engine (``tpdm_tpu_torch/
serving_continuous.py``) on the CPU at toy size.

Against the JAX engine: the toy towers, MMDiT and VAE drawn by
``_torch_parity.random_variables`` (no init compile) and a closed-form TPM
(as ``test_torch_text_encoders.py``), one numpy latent a seed in both
engines; two JAX engines (Euler and AB2), each compiling its segment once.
Per request: equal NFE, sigma traces within the fp32 bound, images within
one uint8 level on under 1 % of pixels (ROADMAP §3).

Against the port's own paths, on ``serve.build_pipeline``'s toy: the
engine's final latents equal ``BatchingEngine(max_batch=slots)``'s to the
bit on a pipeline without a VAE (the decode's batch shape changes its
rounding, so images are compared where the decode batch is the same). The
reference engine is given the continuous engine's batch-1 embed rows:
rows encoded at another batch shape round differently too.
"""

import argparse
import base64
import http.client
import json
import logging
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, drawn_models
from test_torch_text_encoders import (
    CLIP_G,
    CLIP_L,
    MIN_SIGMA,
    T5_KW,
    _clip,
    _jax_tpm,
    _t5,
    _torch_tpm,
)
from tpdm_tpu.pipeline.pipeline import TPDMPipeline as JTPDMPipeline
from tpdm_tpu.pipeline.text_encoding import SD3TextEncoders as JSD3TextEncoders
from tpdm_tpu.serving_continuous import ContinuousBatchingEngine as JContinuousBatchingEngine
from tpdm_tpu_torch import serve
from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline
from tpdm_tpu_torch.pipeline.text_encoding import SD3TextEncoders
from tpdm_tpu_torch.serving import (
    BatchingEngine,
    EngineOverloaded,
    RequestExpired,
    ServeRequest,
)
from tpdm_tpu_torch.serving_continuous import (
    ContinuousBatchingEngine,
    MultiResContinuousRouter,
    PromptEmbedCache,
)
from tpdm_tpu_torch.utils.image import read_png

STEPS = 6
PX = 16  # the toy MMDiT's 8 x 8 latents through the toy VAE's factor 2
# (prompt, seed, cap): staggered joins and mixed caps through 2 slots
REQUESTS = [("a cat", 3, None), ("a dog on a hill", 7, 2), ("blue bird", 11, None),
            ("a cat", 3, 3), ("red square", 23, None)]


def _run(engine, jobs, **kw):
    """Each job's result through a started ``engine``."""
    engine.start()
    try:
        reqs = [engine.submit(p, seed=s, steps=c, **kw) for p, s, c in jobs]
        return [r.result(timeout=120) for r in reqs]
    finally:
        engine.stop()


def _level_gap(a, b):
    """(largest uint8 gap, share of pixels that differ)."""
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    return int(d.max()), float((d > 0).mean())


# -- against the JAX engine ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_world():
    """The JAX toy pipeline and the port's copy of it (closed-form TPM)."""
    towers = {"clip_l": _clip(0, CLIP_L), "clip_g": _clip(1, CLIP_G), "t5": _t5(2)}
    (jl, vl, tl), (jg, vg, tg), (jt, vt, tt) = (towers[k] for k in ("clip_l", "clip_g", "t5"))
    models = drawn_models(3, tpm=False)
    jm, mv, tm = models["mmdit"]
    jv, vv, tv = models["vae"]
    jte = JSD3TextEncoders(jl, vl, jg, vg, jt, vt, t5_width=T5_KW["d_model"])
    jtpm = types.SimpleNamespace(apply=lambda params, h, temb: _jax_tpm(h, temb))
    jpipe = JTPDMPipeline(jm, mv, jtpm, {}, jv, vv, text_encoders=jte, min_sigma=MIN_SIGMA)
    te = SD3TextEncoders(tl, tg, tt, t5_width=T5_KW["d_model"])
    tpipe = TPDMPipeline(tm, _torch_tpm, tv, text_encoders=te, min_sigma=MIN_SIGMA)
    return jpipe, tpipe, tm.config


def _latent(seed, mcfg):
    shape = (mcfg.in_channels, mcfg.sample_size, mcfg.sample_size)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("solver", ["euler", "ab2"])
def test_matches_the_jax_engine(jax_world, solver):
    """Five requests through 2 slots, seg_steps 2, mixed caps: the same
    NFE, sigma traces and images as the JAX engine's; and the same
    stats() keys."""
    jpipe, tpipe, mcfg = jax_world
    kw = dict(slots=2, seg_steps=2, max_steps=STEPS, solver=solver)
    jeng = JContinuousBatchingEngine(jpipe, serve.toy_tokenize, **kw)
    jeng._init_latent = lambda seed: jnp.asarray(_latent(seed, mcfg))
    teng = ContinuousBatchingEngine(tpipe, serve.toy_tokenize, **kw)
    teng._init_latent = lambda seed: torch.from_numpy(_latent(seed, mcfg))
    want, got = _run(jeng, REQUESTS), _run(teng, REQUESTS)
    nfes = [g["inference_steps"] for g in got]
    assert nfes == [w["inference_steps"] for w in want]
    assert nfes[1] == 2 and nfes[3] == 3 and max(nfes) < STEPS  # caps, self-stopping
    for g, w in zip(got, want):
        close(np.asarray(g["sigmas"]), np.asarray(w["sigmas"]))
        level, share = _level_gap(g["image"], w["image"])
        assert level <= 1 and share < 0.01, (level, share)
    assert list(teng.stats()) == list(jeng.stats())
    assert teng.segment_traces == 1


# -- against the port's own paths ---------------------------------------------

@pytest.fixture(scope="module")
def toy():
    return serve.build_pipeline(argparse.Namespace(toy=True, cpu=True))


@pytest.fixture(scope="module")
def raw(toy):
    """The toy pipeline without its VAE: engines return final latents."""
    pipe, tokenize = toy
    return TPDMPipeline(pipe.mmdit, pipe.tpm, None, text_encoders=pipe.text_encoders), tokenize


def _engine(toy, **kw):
    pipe, tokenize = toy
    return ContinuousBatchingEngine(pipe, tokenize, **{"slots": 2, "seg_steps": 2,
                                                       "max_steps": STEPS, **kw})


def _reference(engine, texts):
    """``BatchingEngine(max_batch=engine.slots)`` on ``engine``'s pipeline,
    holding ``engine``'s embed rows of ``texts`` and its constant negative."""
    ref = BatchingEngine(engine.pipe, engine.tokenize, max_batch=engine.slots,
                         max_steps=engine.max_steps)
    for text in texts:
        ref._embed_cache[text] = engine._prompt_embeds(text)
        ref._embed_cache[("\x00neg", text)] = engine._neg_prompt_embeds(text)
    ref._neg_embed = engine._neg_rows
    return ref


GUIDED = [("a cat", 3, None, None, None), ("a dog on a hill", 7, 2, 4.0, None),
          ("blue bird", 11, None, None, "blurry"), ("a cat", 3, 3, None, None),
          ("red square", 23, None, 2.5, "a dog on a hill"), ("blue bird", 5, 4, None, None)]


@pytest.mark.parametrize("depth", [1, 2])
def test_matches_the_fixed_engine_to_the_bit(raw, depth):
    """Mixed caps, per-request guidance and negatives: every request's final
    latents, NFE and sigmas equal ``BatchingEngine(max_batch=2)``'s to the
    bit, at pipeline depth 1 and 2."""
    eng = _engine(raw, pipeline_depth=depth)
    eng.warmup()
    eng.start()
    try:
        reqs = [eng.submit(p, seed=s, steps=c, guidance_scale=g, negative_prompt=n)
                for p, s, c, g, n in GUIDED]
        got = [r.result(timeout=120) for r in reqs]
    finally:
        eng.stop()
    ref = _reference(eng, {p for p, *_ in GUIDED} | {n for *_, n in GUIDED if n})
    for (p, s, c, g, n), out in zip(GUIDED, got):
        want = ref.generate_batch([p], [s], steps=[c], guidances=[g], negative_prompts=[n])[0]
        np.testing.assert_array_equal(out["image"], want["image"])
        assert out["inference_steps"] == want["inference_steps"]
        assert out["sigmas"] == want["sigmas"]
    stats = eng.stats()
    assert stats["slot_steps_active"] == sum(o["inference_steps"] for o in got)
    assert eng.segment_traces == 1


class _RowByRow(TPDMPipeline):
    """A pipeline that encodes and decodes one image at a time, as the
    continuous engine encodes a slot's image and decodes a finished slot
    (decode_batch 1): another batch shape rounds differently."""

    def encode_image(self, images, **kw):
        return torch.cat([super(_RowByRow, self).encode_image(images[i:i + 1], **kw)
                          for i in range(len(images))])

    def _decode_impl(self, latents):
        self.decoded = latents  # the final latents, for the test to compare
        return torch.cat([super(_RowByRow, self)._decode_impl(latents[i:i + 1])
                          for i in range(latents.shape[0])])


# (prompt, seed, cap, image seed or None, strength)
IMG2IMG = [("a cat", 3, None, 1, 0.5), ("a dog on a hill", 7, 2, None, None),
           ("blue bird", 11, None, 2, 0.9), ("a cat", 3, 3, None, None),
           ("red square", 23, None, 3, None)]


def test_img2img_slots_match_the_fixed_engine_to_the_bit(toy):
    """img2img slots beside text-to-image slots: every request's image, NFE
    and sigmas equal BatchingEngine(max_batch=2)'s for the same (prompt,
    seed, image, strength, cap) to the bit (the reference encoding and
    decoding at batch 1); an img2img slot starts at its strength (0.6 by
    default)."""
    pipe, tokenize = toy
    images = {k: np.random.default_rng(k).integers(0, 256, (PX, PX, 3), dtype=np.uint8)
              for k in (1, 2, 3)}
    eng = _engine(toy, vae_scale_factor=2)
    finals = {}
    real_complete = eng._complete

    def complete(req, lat_row, nfe, sigmas):
        finals[id(req)] = lat_row.clone()
        real_complete(req, lat_row, nfe, sigmas)

    eng._complete = complete
    eng.start()
    try:
        reqs = [eng.submit(p, seed=s, steps=c, strength=st,
                           init_image=None if k is None else images[k])
                for p, s, c, k, st in IMG2IMG]
        got = [r.result(timeout=120) for r in reqs]
    finally:
        eng.stop()
    ref = _reference(eng, {p for p, *_ in IMG2IMG})
    ref.pipe = _RowByRow(pipe.mmdit, pipe.tpm, pipe.vae, text_encoders=pipe.text_encoders,
                         min_sigma=pipe.min_sigma)
    ref.vae_scale_factor = 2
    for (p, s, c, k, st), req, out in zip(IMG2IMG, reqs, got):
        img = None if k is None else images[k]
        want = ref.generate_batch([p], [s], steps=[c], init_images=[img], strengths=[st])[0]
        assert torch.equal(finals[id(req)], ref.pipe.decoded[:1])  # the final latents
        np.testing.assert_array_equal(out["image"], want["image"])
        assert out["inference_steps"] == want["inference_steps"]
        assert out["sigmas"] == want["sigmas"]
        if k is not None:
            assert out["sigmas"][0] <= (0.6 if st is None else st) + 1e-6
    assert eng.segment_traces == 1


def test_decode_batch_coalesces_and_retries_rows(toy, caplog):
    """Three waiting rows decode as one batch padded to 4, each image within
    one level of its batch-1 decode; a failing batched decode retries its
    rows one by one (logged) and fails none of them."""
    eng = _engine(toy, decode_batch=4)
    lats = torch.randn((3, 16, 8, 8), generator=torch.Generator().manual_seed(0))
    singles = [eng._decode_rows(lats[i:i + 1])[0] for i in range(3)]

    def drain(reqs):
        for i, r in enumerate(reqs):
            eng._decode_queue.put((r, lats[i:i + 1], 2, [1.0, 0.5]))
        eng._decode_queue.put(None)
        eng._decode_worker()  # returns at the sentinel
        return [r.result(timeout=1) for r in reqs]

    for got, want in zip(drain([ServeRequest(f"p{i}", i) for i in range(3)]), singles):
        assert got["inference_steps"] == 2 and _level_gap(got["image"], want)[0] <= 1
    assert eng.stats()["decode_rows_coalesced"] == 3
    real = eng._decode_rows

    def flaky(rows):
        if rows.shape[0] > 1:
            raise RuntimeError("injected batched-decode failure")
        return real(rows)

    eng._decode_rows = flaky
    with caplog.at_level(logging.ERROR, logger="tpdm_tpu_torch.serving_continuous"):
        for got, want in zip(drain([ServeRequest(f"q{i}", i) for i in range(3)]), singles):
            np.testing.assert_array_equal(got["image"], want)
    assert eng.decode_rows_coalesced == 3
    assert any("retrying the 3 rows singly" in r.getMessage() for r in caplog.records)


def test_decode_batch_end_to_end(toy):
    """Four same-cap requests through 4 slots finish in one segment and are
    decoded together; each image within one level of the batch-1 engine's."""
    jobs = [("a cat", 3, 2), ("a dog on a hill", 7, 2), ("blue bird", 11, 2),
            ("red square", 23, 2)]
    kw = dict(slots=4, seg_steps=2)
    single = _run(_engine(toy, **kw), jobs)
    eng = _engine(toy, decode_batch=4, **kw)
    coalesced = _run(eng, jobs)
    for a, b in zip(single, coalesced):
        assert a["inference_steps"] == b["inference_steps"] == 2
        assert _level_gap(a["image"], b["image"])[0] <= 1
    assert eng.stats()["decode_rows_coalesced"] >= 2


def test_captured_row_survives_refill(toy):
    """A finished slot's latent row waits for the decode worker (held on an
    event) while its slot is refilled and another segment runs; its image
    equals a solo run's."""
    solo = _run(_engine(toy, slots=1), [("a cat", 3, 2)])[0]
    eng = _engine(toy, slots=1)
    gate, held = threading.Event(), threading.Event()
    real = eng._complete

    def held_complete(*a):
        held.set()
        assert gate.wait(60)
        real(*a)

    eng._complete = held_complete
    eng.start()
    try:
        first = eng.submit("a cat", seed=3, steps=2)
        second = eng.submit("red square", seed=23, steps=4)
        assert held.wait(60)
        for _ in range(600):  # the refilled slot runs a segment
            if eng.segments_run >= 2:
                break
            time.sleep(0.05)
        assert eng.segments_run >= 2
        gate.set()
        np.testing.assert_array_equal(first.result(timeout=60)["image"], solo["image"])
        assert second.result(timeout=60)["inference_steps"] == 4
    finally:
        gate.set()
        eng.stop()


def test_utilization_embed_cache_and_warmup(toy):
    """The slot-step accounting, one embed entry a distinct prompt (the
    towers run once a prompt), and a warmup that counts no traffic."""
    pipe, tokenize = toy
    calls = []

    def counting(prompt):
        calls.append(prompt)
        return tokenize(prompt)

    eng = ContinuousBatchingEngine(pipe, counting, slots=2, seg_steps=1, max_steps=4)
    eng.warmup()
    s = eng.stats()
    assert s["requests_done"] == s["segments_run"] == s["slot_steps_total"] == 0
    n_warm = len(calls)  # the constant negative and "warmup"
    got = _run(eng, [(p, s, None) for p, s, _ in REQUESTS[:4]])
    nfes = [g["inference_steps"] for g in got]
    s = eng.stats()
    assert s["requests_done"] == 4 and s["slot_steps_active"] == sum(nfes)
    assert s["slot_steps_total"] == 2 * s["segments_run"] >= s["slot_steps_active"]
    assert 0.5 <= s["slot_utilization"] <= 1.0
    assert s["nfe_mean"] == pytest.approx(np.mean(nfes)) and s["nfe_max"] == max(nfes)
    assert calls[n_warm:] == ["a cat", "a dog on a hill", "blue bird"]
    assert s["embed_cache_entries"] == 4


def test_prompt_embed_cache_lru():
    c = PromptEmbedCache(size=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1  # bumps a
    c.put("c", 3)  # evicts b
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3 and len(c) == 2


# -- lifecycle ------------------------------------------------------------------

def test_backpressure_and_deadline(toy):
    eng = _engine(toy, slots=1, queue_limit=1)
    eng.submit("first")  # the worker is not started: it waits in the queue
    with pytest.raises(EngineOverloaded):
        eng.submit("second")
    eng = _engine(toy, slots=1)
    stale = eng.submit("a cat", seed=1, deadline_s=0.01)
    time.sleep(0.05)
    live = eng.submit("blue bird", seed=2)
    eng.start()
    try:
        assert 1 <= live.result(timeout=60)["inference_steps"] <= STEPS
    finally:
        eng.stop()
    with pytest.raises(RequestExpired, match="waited"):
        stale.result(timeout=10)
    assert eng.stats()["requests_expired"] == 1 and eng.stats()["requests_done"] == 1


def test_stop_fails_queued_and_inflight_then_restarts(toy):
    """stop() while a segment runs: the seated request fails mid-generation,
    the queued one before it ran; the engine then starts again from empty
    slots and serves."""
    eng = _engine(toy, slots=1)
    gate = threading.Event()
    real = eng._segment

    def held(*a):
        assert gate.wait(60)
        return real(*a)

    eng._segment = held
    eng.start()
    inflight = eng.submit("a cat", seed=3)
    queued = eng.submit("blue bird", seed=4)
    for _ in range(600):
        if eng._slot_req[0] is inflight:
            break
        time.sleep(0.05)
    opener = threading.Thread(target=lambda: (eng._stop.wait(60), gate.set()))
    opener.start()
    eng.stop()
    opener.join(60)
    with pytest.raises(RuntimeError, match="mid-generation"):
        inflight.result(timeout=5)
    with pytest.raises(RuntimeError, match="before this request ran"):
        queued.result(timeout=5)
    with pytest.raises(EngineOverloaded):
        eng.submit("too late")
    assert float(eng._state.sigma.abs().max()) == 0.0  # fresh, all-empty slots
    eng._segment = real
    eng.stop()  # idempotent
    assert _run(eng, [("hello", 1, 2)])[0]["inference_steps"] == 2


def test_segment_error_fails_its_requests_and_engine_serves_on(toy, caplog):
    eng = _engine(toy, slots=1)
    real, calls = eng._segment, []

    def flaky(*a):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(*a)

    eng._segment = flaky
    eng.start()
    try:
        bad = eng.submit("boom", seed=1)
        with pytest.raises(RuntimeError, match="injected"):
            bad.result(timeout=60)
        assert eng.submit("fine", seed=2, steps=2).result(timeout=60)["inference_steps"] == 2
    finally:
        eng.stop()
    assert "segment failed" in caplog.text


# -- the router -----------------------------------------------------------------

def test_router_routes_with_one_shared_cache(raw):
    """Each resolution's engine equals ``BatchingEngine(max_batch=1,
    resolutions=[24])`` to the bit at its resolution; a prompt is encoded
    once for both; unknown and unpatchable resolutions are refused."""
    pipe, tokenize = raw
    calls = []

    def counting(prompt):
        calls.append(prompt)
        return tokenize(prompt)

    router = MultiResContinuousRouter(pipe, counting, resolutions=[24], slots=1, seg_steps=2,
                                      max_steps=4, vae_scale_factor=2)
    assert router.resolutions == [16, 24]
    n_probe = len(calls)
    router.start()
    try:
        a = router.submit("a cat", seed=3).result(timeout=60)
        b = router.submit("a cat", seed=3, resolution=24).result(timeout=60)
        with pytest.raises(ValueError, match="not in the served set"):
            router.submit("a cat", resolution=32)
    finally:
        router.stop()
    assert calls[n_probe:] == ["a cat"]
    assert a["image"].shape == (16, 8, 8) and b["image"].shape == (16, 12, 12)
    eng16 = router._engines[16]
    ref = BatchingEngine(pipe, tokenize, max_batch=1, max_steps=4, resolutions=[24],
                         vae_scale_factor=2)
    ref._embed_cache["a cat"] = eng16._prompt_embeds("a cat")
    ref._neg_embed = eng16._neg_rows
    for res, out in ((None, a), (24, b)):
        want = ref.generate_batch(["a cat"], [3], resolution=res)[0]
        np.testing.assert_array_equal(out["image"], want["image"])
        assert out["inference_steps"] == want["inference_steps"]
    stats = router.stats()
    assert stats["requests_done"] == 2 and set(stats["resolutions"]) == {"16", "24"}
    with pytest.raises(ValueError, match="patch_size"):
        MultiResContinuousRouter(pipe, tokenize, resolutions=[18], slots=1, vae_scale_factor=2)
    with pytest.raises(ValueError, match="multiple of vae_scale_factor"):
        ContinuousBatchingEngine(pipe, tokenize, resolution=17, vae_scale_factor=2)


# -- guards ---------------------------------------------------------------------

def test_unported_options_name_their_items(toy):
    pipe, tokenize = toy
    for kw, item in ((dict(dp=2), "9\\(d\\)"), (dict(mesh_shape=(1, 1, 1)), "14")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, item {item}"):
            ContinuousBatchingEngine(pipe, tokenize, **kw)
    # adapters are ported (tests/test_torch_lora_serving.py): the checks
    eng = _engine(toy)
    with pytest.raises(ValueError, match="empty"):
        eng.register_adapter("a", {})
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit("a cat", lora="a")
    # img2img slots are ported: their options are checked as in JAX
    with pytest.raises(ValueError, match="strength must be"):
        eng.submit("a cat", init_image=np.zeros((PX, PX, 3), np.uint8), strength=0.0)
    with pytest.raises(ValueError, match="needs an init_image"):
        eng.submit("a cat", strength=0.5)
    for kw, match in ((dict(pipeline_depth=0), "pipeline_depth"),
                      (dict(decode_batch=0), "decode_batch"),
                      (dict(cache_interval=1), "cache_interval"),
                      (dict(solver="heun"), "solver"),
                      (dict(solver="ab2", cache_interval=2), "mutually exclusive")):
        with pytest.raises(ValueError, match=match):
            _engine(toy, **kw)
    with pytest.raises(ValueError, match="MultiResContinuousRouter"):
        eng.submit("a cat", resolution=24)
    with pytest.raises(ValueError, match="steps"):
        eng.submit("a cat", steps=0)
    with pytest.raises(ValueError, match="CFG-enabled"):
        _engine(toy, guidance_scale=None).submit("a cat", guidance_scale=3.0)


def test_cache_interval_and_ab2_are_deterministic(toy):
    """The per-segment Δ-cache and AB2: a request's image does not depend
    on its slot peers (the second pass runs the requests in another mix)."""
    for kw in (dict(cache_interval=2), dict(solver="ab2")):
        eng = _engine(toy, **kw)
        first = _run(eng, REQUESTS)
        again = _run(eng, REQUESTS[::-1])[::-1]
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a["image"], b["image"])
            assert a["inference_steps"] == b["inference_steps"]
        assert eng.stats()["solver"] == kw.get("solver", "euler")


def test_predict_false_draws_from_the_engine_generator(toy):
    """predict=False draws each step's ratio from the engine's generator,
    reseeded with the state: two fresh engines give a request the same
    image, and it differs from the Beta mode's."""
    drawn = [_run(_engine(toy, predict=False), [("a cat", 3, None)])[0] for _ in range(2)]
    mode = _run(_engine(toy), [("a cat", 3, None)])[0]
    np.testing.assert_array_equal(drawn[0]["image"], drawn[1]["image"])
    assert drawn[0]["sigmas"] == drawn[1]["sigmas"] != mode["sigmas"]


# -- serve ----------------------------------------------------------------------

def _args(**kw):
    return serve.parse_args(["--toy", "--cpu", "--max_batch", "2", "--seg_steps", "2",
                             "--max_steps", "3", "--port", "0", *kw.pop("argv", [])])


def test_serve_builds_the_continuous_engines_and_guards(toy):
    pipe, tokenize = toy
    eng = serve.make_engine(pipe, tokenize, _args(argv=["--continuous", "--pipeline_depth", "2",
                                                        "--decode_batch", "2"]))
    assert isinstance(eng, ContinuousBatchingEngine)
    assert (eng.slots, eng.seg_steps, eng.pipeline_depth, eng.decode_batch) == (2, 2, 2, 2)
    router = serve.make_engine(pipe, tokenize, _args(argv=["--continuous", "--resolutions", "24"]))
    assert isinstance(router, MultiResContinuousRouter) and router.resolutions == [16, 24]
    assert isinstance(serve.make_engine(pipe, tokenize, _args()), BatchingEngine)
    for argv in (["--guidance_interval", "0.2,0.8"], ["--cache_tau", "0.1"]):
        with pytest.raises(SystemExit, match="drop --continuous"):
            serve.make_engine(pipe, tokenize, _args(argv=["--continuous", *argv]))
    with pytest.raises(SystemExit, match="drop --resolutions"):
        _args(argv=["--continuous", "--resolutions", "24", "--solver", "ab2"])


@pytest.mark.parametrize("resolutions", [None, "24"])
def test_http_round_trip_continuous(toy, resolutions):
    """``--continuous`` (and with ``--resolutions 24``, the router): POST
    /generate's PNG equals the engine's image of the same request; GET
    /stats carries the continuous keys, /metrics and /healthz answer; a bad
    request gets a 400."""
    pipe, tokenize = toy
    argv = ["--continuous"] + (["--resolutions", resolutions] if resolutions else [])
    engine, server = serve.make_http_server(pipe, tokenize, _args(argv=argv))
    engine.start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        try:
            conn.request(method, path, body=None if body is None else json.dumps(body))
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    try:
        res = 24 if resolutions else None
        status, body = call("POST", "/generate", {"prompt": "a cat", "seed": 7,
                                                  "resolution": res})
        assert status == 200, body[:200]
        out = json.loads(body)
        want = engine.submit("a cat", seed=7, resolution=res).result(timeout=60)
        np.testing.assert_array_equal(read_png(base64.b64decode(out["image_png_base64"])),
                                      want["image"])
        assert out["inference_steps"] == want["inference_steps"]
        status, body = call("GET", "/stats")
        stats = json.loads(body)
        per = stats["resolutions"]["24"] if resolutions else stats
        assert status == 200 and {"segments_run", "slot_utilization"} <= set(per)
        assert stats["requests_done"] == 2
        status, body = call("GET", "/metrics")
        assert status == 200 and b"tpdm_requests_done 2\n" in body
        assert call("GET", "/healthz") == (200, b"ok\n")
        assert call("POST", "/generate", {"prompt": 42})[0] == 400
        status, body = call("POST", "/rank", {"prompt": "a dog", "seed": 5, "n": 2})
        assert status == 200 and json.loads(body)["seeds"] == [5, 6]
    finally:
        server.shutdown()
        engine.stop()
        server.server_close()
