"""The port's serving path on the CPU: ``tpdm_tpu_torch.serving.
BatchingEngine`` on the toy pipeline of ``tpdm_tpu_torch.serve --toy``,
checked as ``tests/test_serving.py`` checks the JAX engine (coalescing,
padding, one image a seed across batch compositions, step caps, guidance
and negatives, the embed cache, backpressure, deadlines, error fan-out,
stop and restart), its unported options' NotImplementedError, its
``stats()`` keys against the JAX engine's, ``prometheus_text`` against
the JAX package's, one HTTP round trip and the ``--cli`` entry point."""

import argparse
import base64
import http.client
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 (one torch thread a test process)

from tpdm_tpu.serving import BatchingEngine as JBatchingEngine
from tpdm_tpu.utils.metrics_export import prometheus_text as jax_prometheus_text
from tpdm_tpu_torch import serve
from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline
from tpdm_tpu_torch.rewards import ImageRewardModel
from tpdm_tpu_torch.rewards.bert import BertMedConfig
from tpdm_tpu_torch.rewards.vit import ViTConfig
from tpdm_tpu_torch.serving import (
    BatchingEngine,
    EngineOverloaded,
    RequestExpired,
    generate_ranked,
)
from tpdm_tpu_torch.train.builders import build_inference_ranker
from tpdm_tpu_torch.utils.bert_tokenizer import BertTokenizer
from tpdm_tpu_torch.utils.image import png_bytes, read_png
from tpdm_tpu_torch.utils.metrics_export import prometheus_text

REPO = Path(__file__).resolve().parents[1]
STEPS = 4
PX = 16  # the toy MMDiT's 8 x 8 latents through the toy VAE's factor 2


@pytest.fixture(scope="module")
def toy():
    return serve.build_pipeline(argparse.Namespace(toy=True, cpu=True))


def _engine(toy, **kw):
    pipe, tokenize = toy
    return BatchingEngine(pipe, tokenize, **{"max_batch": 2, "window_ms": 1,
                                             "max_steps": STEPS, **kw})


def _running(engine):
    engine.start()
    return engine


def test_concurrent_requests_coalesce_into_one_batch(toy):
    eng = _running(_engine(toy, max_batch=3, window_ms=500))
    try:
        results = [r.result(timeout=120)
                   for r in [eng.submit(f"prompt {i}", seed=i) for i in range(3)]]
    finally:
        eng.stop()
    assert eng.batches_run == 1
    for res in results:
        assert res["image"].shape == (PX, PX, 3) and res["image"].dtype == np.uint8
        assert 1 <= res["inference_steps"] <= STEPS
        assert len(res["sigmas"]) == res["inference_steps"]


def test_padding_and_the_same_seed_across_batch_compositions(toy):
    """A partial batch pads by repeating its last request (counted as
    waste), and a (prompt, seed) gives the same image alone or paired."""
    eng = _engine(toy)
    solo = eng.generate_batch(["a cat"], [7])
    paired = eng.generate_batch(["a dog", "a cat"], [3, 7])
    assert len(solo) == 1 and len(paired) == 2
    np.testing.assert_array_equal(solo[0]["image"], paired[1]["image"])
    assert solo[0]["inference_steps"] == paired[1]["inference_steps"]
    s = eng.stats()
    assert s["padded_slots"] == 1 and s["padded_slot_frac"] == pytest.approx(1 / 4)
    assert s["batch_fill_mean"] == pytest.approx(0.75)
    with pytest.raises(ValueError, match="1 to 2 prompts"):
        eng.generate_batch(["a", "b", "c"], [0, 1, 2])


def test_engine_matches_direct_generate_and_cli_path(toy):
    """The same (prompt, seed) through the engine (a cache miss, then a
    hit) and through serve.generate (the --cli path) at batch 1: the same
    image, bit for bit; each latent is the batch-1 generate(seed=) draw."""
    pipe, tokenize = toy
    eng = _engine(toy, max_batch=1)
    miss = eng.generate_batch(["a cat"], [11])[0]
    hit = eng.generate_batch(["a cat"], [11])[0]
    assert (eng.embed_misses, eng.embed_hits) == (1, 1)
    direct = serve.generate(pipe, tokenize, "a cat", 11, STEPS)
    for res in (miss, hit):
        np.testing.assert_array_equal(res["image"], direct.images[0])
        assert res["inference_steps"] == int(direct.last_valid_index[0]) + 1


def test_img2img_rows_beside_text_rows(toy):
    """A batch of two text-to-image and two img2img rows: the text rows equal
    a text-only batch's to the bit, and the batch equals a direct
    generate(init_image=, strength=, seed=<one a row>) at the same batch
    shape, the text rows there blank images at strength 1.0."""
    pipe, tokenize = toy
    eng = _engine(toy, max_batch=4, vae_scale_factor=2)
    prompts, seeds = ["a cat", "a dog", "blue bird", "red square"], [1, 2, 3, 4]
    rng = np.random.default_rng(5)
    imgs = [None, None] + [rng.integers(0, 256, (PX, PX, 3), dtype=np.uint8) for _ in "ab"]
    mixed = eng.generate_batch(prompts, seeds, init_images=imgs, strengths=[None, None, 0.4, 0.8])
    text = eng.generate_batch(prompts, seeds)
    for i in (0, 1):
        np.testing.assert_array_equal(mixed[i]["image"], text[i]["image"])
        assert mixed[i]["sigmas"] == text[i]["sigmas"]
    for i, s in ((2, 0.4), (3, 0.8)):  # the first step starts at the strength
        assert mixed[i]["sigmas"][0] <= s + 1e-6 and mixed[i]["sigmas"] != text[i]["sigmas"]
    ids = [tokenize(p) for p in prompts]
    embeds = eng._embeds_for(prompts, np.concatenate([c for c, _ in ids]),
                             np.concatenate([t5 for _, t5 in ids]), [""] * 4)
    blank = np.zeros((PX, PX, 3), np.uint8)
    direct = pipe.generate(*embeds, init_image=np.stack([blank, blank] + imgs[2:]),
                           strength=[1.0, 1.0, 0.4, 0.8], seed=seeds, max_inference_steps=STEPS,
                           guidance_scale=eng.guidance_scale, step_caps=[STEPS] * 4)
    for i, res in enumerate(mixed):
        np.testing.assert_array_equal(res["image"], direct.images[i])
        assert res["inference_steps"] == int(direct.last_valid_index[i]) + 1
    # the worker: an img2img request and a text request coalesce into one batch
    eng2 = _running(_engine(toy, window_ms=500, vae_scale_factor=2))
    try:
        r_img = eng2.submit("blue bird", seed=3, init_image=imgs[2], strength=0.4)
        r_txt = eng2.submit("a cat", seed=1)
        got = [r_img.result(timeout=120), r_txt.result(timeout=120)]
    finally:
        eng2.stop()
    want = eng2.generate_batch(["blue bird", "a cat"], [3, 1], init_images=[imgs[2], None],
                               strengths=[0.4, None])
    assert eng2.batches_run == 2  # the submitted pair ran as one batch
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
    with pytest.raises(ValueError, match="needs an init_image"):
        eng.submit("a cat", strength=0.5)
    with pytest.raises(ValueError, match="VAE encoder"):
        BatchingEngine(TPDMPipeline(pipe.mmdit, pipe.tpm, None, text_encoders=pipe.text_encoders),
                       tokenize).submit("a cat", init_image=imgs[2])


def test_step_caps_and_per_request_guidance(toy):
    """steps caps a request; guidance 3 on a default-7 engine equals an
    engine whose default is 3; a different strength changes the image."""
    eng7, eng3 = _engine(toy), _engine(toy, guidance_scale=3.0)
    capped = eng7.generate_batch(["a cat", "a dog"], [1, 2], steps=[1, None])
    assert capped[0]["inference_steps"] == 1 and len(capped[0]["sigmas"]) == 1
    assert capped[1]["inference_steps"] > 1
    want = eng3.generate_batch(["a cat"], [7])[0]
    got = eng7.generate_batch(["a cat"], [7], guidances=[3.0])[0]
    np.testing.assert_array_equal(got["image"], want["image"])
    default = eng7.generate_batch(["a cat"], [7])[0]
    assert np.abs(default["image"].astype(int) - got["image"].astype(int)).max() > 0


def test_negative_prompt_matches_pipeline(toy):
    """A per-request negative equals pipe.generate with that negative's
    ids and the engine's latents; the empty negative is the zero ids."""
    pipe, tokenize = toy
    eng = _engine(toy)
    got = eng.generate_batch(["a cat", "a cat"], [7, 7], negative_prompts=["blurry", None])
    c, t5 = tokenize("a cat")
    nc, nt = tokenize("blurry")
    lat = eng._latents([7, 7], pipe.mmdit.config.sample_size)
    ref = pipe.generate(clip_ids=np.concatenate([c, c]), t5_ids=np.concatenate([t5, t5]),
                        negative_clip_ids=np.concatenate([nc, np.zeros_like(nc)]),
                        negative_t5_ids=np.concatenate([nt, np.zeros_like(nt)]),
                        latents=lat, max_inference_steps=STEPS)
    for i in range(2):
        np.testing.assert_array_equal(got[i]["image"], ref.images[i])
    assert np.abs(got[0]["image"].astype(int) - got[1]["image"].astype(int)).max() > 0
    assert ("\x00neg", "blurry") in eng._embed_cache


def test_embed_cache_hits_and_lru_bound(toy):
    eng = _engine(toy)
    first = eng.generate_batch(["a cat", "a dog"], [1, 2])
    again = eng.generate_batch(["a cat", "a dog"], [1, 2])
    assert (eng.embed_misses, eng.embed_hits) == (2, 2)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a["image"], b["image"])
    row = eng._embed_cache["a cat"][0]
    assert row.is_contiguous() and row.untyped_storage().nbytes() == row.nbytes
    small = _engine(toy, max_batch=1, embed_cache=2)
    for p in ["a", "b", "c"]:
        small.generate_batch([p], [0])
    assert list(small._embed_cache) == ["b", "c"]
    small.generate_batch(["c"], [0])
    assert small.embed_hits == 1
    off = _engine(toy, embed_cache=0)
    off.generate_batch(["a cat"], [1])
    assert off.embed_hits == off.embed_misses == 0


def test_split_stages_and_resolutions(toy, monkeypatch):
    """split_stages decodes apart with the same images and reports decode
    seconds, with the decode grad-free on the worker thread (grad mode is
    thread-local, and K2 on the card refuses an operand that requires
    grad) and the VAE frozen; a further resolution is its own batch shape;
    an unknown one and one that the VAE factor does not divide are
    refused."""
    pipe = toy[0]
    assert not any(p.requires_grad for p in pipe.vae.parameters())
    fused = _engine(toy, max_batch=1).generate_batch(["same prompt"], [11])[0]
    split_eng = _engine(toy, max_batch=1, split_stages=True)
    split = split_eng.generate_batch(["same prompt"], [11])[0]
    np.testing.assert_array_equal(fused["image"], split["image"])
    s = split_eng.stats()
    assert 0 < s["decode_s_p50"] <= s["decode_s_p95"] and s["denoise_s_p50"] > 0
    grad_modes, decode = [], pipe.vae.decode
    monkeypatch.setattr(pipe.vae, "decode",
                        lambda z: grad_modes.append(torch.is_grad_enabled()) or decode(z))
    split_eng.start()
    try:
        threaded = split_eng.submit("same prompt", seed=11).result(timeout=120)
    finally:
        split_eng.stop()
    np.testing.assert_array_equal(threaded["image"], split["image"])
    assert grad_modes == [False]
    eng = _engine(toy, max_batch=3, vae_scale_factor=2, resolutions=[24], window_ms=300)
    eng.start()
    try:
        reqs = [eng.submit("a", seed=1), eng.submit("b", seed=2, resolution=24),
                eng.submit("c", seed=3)]
        out = [r.result(timeout=120) for r in reqs]
    finally:
        eng.stop()
    assert [o["image"].shape[0] for o in out] == [16, 24, 16]
    assert eng.batches_run == 2
    with pytest.raises(ValueError, match="served set"):
        _engine(toy, vae_scale_factor=2, resolutions=[24]).submit("a", resolution=32)
    with pytest.raises(ValueError, match="multiple of"):
        _engine(toy, vae_scale_factor=2, resolutions=[25])


def test_backpressure_deadlines_and_errors(toy):
    eng = _engine(toy, max_batch=1, queue_limit=1)
    eng.submit("first")  # no worker yet: it waits in the queue
    with pytest.raises(EngineOverloaded):
        eng.submit("second")
    eng = _engine(toy, max_batch=2)
    stale = eng.submit("a cat", seed=1, deadline_s=0.01)
    time.sleep(0.05)
    live = eng.submit("a dog", seed=2)
    eng.start()
    try:
        assert 1 <= live.result(timeout=120)["inference_steps"] <= STEPS
        with pytest.raises(RequestExpired, match="waited"):
            stale.result(timeout=10)
        assert eng.stats()["requests_expired"] == 1
    finally:
        eng.stop()

    eng = _engine(toy, window_ms=200)

    def boom(*a, **k):
        raise RuntimeError("injected")

    eng.generate_batch = boom
    eng.start()
    try:
        for r in [eng.submit("x"), eng.submit("y")]:
            with pytest.raises(RuntimeError, match="injected"):
                r.result(timeout=60)
    finally:
        eng.stop()


def test_concurrent_submitters_stress(toy):
    """16 threads submit 2 requests each (more threads than cores, a short
    switch interval): every request is answered once, and every slot of
    every batch is a request or counted padding."""
    eng = _running(_engine(toy, max_batch=4, window_ms=5, max_steps=2, queue_limit=64))
    results, errors = [], []

    def client(i):
        try:
            reqs = [eng.submit(f"p{i}", seed=i * 2 + j) for j in range(2)]
            results.extend(r.result(timeout=120)["inference_steps"] for r in reqs)
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        eng.stop()
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(results) == 32
    assert eng.batches_run * 4 == 32 + eng.padded_slots


def test_stop_restart_and_submit_after_stop(toy):
    eng = _engine(toy, max_batch=1)
    eng._thread = threading.Thread(target=lambda: None)  # a worker that never serves
    eng._thread.start()
    orphan = eng.submit("orphan")
    eng.stop()
    with pytest.raises(RuntimeError, match="engine stopped"):
        orphan.result(timeout=5)
    eng.start()
    eng.stop()
    eng.stop()
    with pytest.raises(EngineOverloaded, match="stopped"):
        eng.submit("too late")
    eng.start()
    try:
        assert eng.submit("hello").result(timeout=120)["inference_steps"] >= 1
    finally:
        eng.stop()


def test_validation_and_options_not_ported(toy):
    pipe, tokenize = toy
    for kw, item in ((dict(dp=2), "9\\(d\\)"), (dict(mesh_shape=(1, 1, 1)), "14")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, item {item}"):
            BatchingEngine(pipe, tokenize, **kw)
    # a family runner is ported (serving_families.make_sd15_runner); the
    # engine refuses the SD3-only options beside it, as the JAX engine does
    stub = lambda prompts, seeds, caps: [{"image": None, "inference_steps": 1,
                                          "sigmas": []}] * len(prompts)
    assert BatchingEngine(None, tokenize, max_batch=2, runner=stub).generate_batch(
        ["a"], [0]) == stub(["a"], [0], [1])
    with pytest.raises(ValueError, match="resolutions"):
        BatchingEngine(pipe, tokenize, runner=stub, resolutions=[2 * PX])
    # adapters are ported (tests/test_torch_lora_serving.py): the checks
    eng = _engine(toy)
    with pytest.raises(ValueError, match="empty"):
        eng.register_adapter("a", {})
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit("a cat", lora="a")
    # img2img is ported: its options are checked as the JAX engine checks them
    eng = _engine(toy, vae_scale_factor=2)
    with pytest.raises(ValueError, match="serves"):
        eng.submit("a cat", init_image=np.zeros((PX // 2, PX, 3), np.uint8))
    with pytest.raises(ValueError, match="strength"):
        eng.generate_batch(["a"], [0], init_images=[np.zeros((PX, PX, 3), np.uint8)],
                           strengths=[1.5])
    with pytest.raises(ValueError, match="solver"):
        _engine(toy, solver="heun")
    with pytest.raises(ValueError, match="mutually exclusive"):
        _engine(toy, cache_interval=2, cache_tau=0.1)
    with pytest.raises(ValueError, match="guidance"):
        eng.submit("a cat", guidance_scale=float("nan"))
    no_cfg = _engine(toy, guidance_scale=None)
    with pytest.raises(ValueError, match="CFG-enabled"):
        no_cfg.submit("a cat", guidance_scale=3.0)
    with pytest.raises(ValueError, match="CFG-enabled"):
        no_cfg.generate_batch(["a"], [1], negative_prompts=["bad"])
    ab2 = _engine(toy, solver="ab2", cache_interval=2)
    a, b = (ab2.generate_batch(["a cat"], [3])[0] for _ in range(2))
    np.testing.assert_array_equal(a["image"], b["image"])
    assert ab2.stats()["solver"] == "ab2"


def _jax_stats_keys(rows):
    """The JAX engine's stats() keys after ``rows`` stage records (its
    runner path needs no model and compiles nothing)."""
    eng = JBatchingEngine(None, lambda p: (None, None), max_batch=2,
                          runner=lambda prompts, seeds, caps: [{}] * len(prompts))
    eng.batches_run = len(rows)
    eng._stage_times.extend(rows)
    return list(eng.stats())


def test_stats_keys_equal_the_jax_engine(toy):
    eng = _running(_engine(toy))
    try:
        eng.submit("a cat").result(timeout=120)
    finally:
        eng.stop()
    assert list(eng.stats()) == _jax_stats_keys(list(eng._stage_times))
    split = _engine(toy, split_stages=True)
    split.generate_batch(["a cat"], [0])
    assert list(split.stats()) == _jax_stats_keys(list(split._stage_times))
    assert _engine(toy).stats() == {"batches_run": 0}


def test_prometheus_text_matches_jax():
    stats = {"batches_run": 3, "device_s_p50": 0.125, "solver": "euler", "ok": True,
             "adapter_batches": {"a": 2, "<base>": 1, "bad": "x"}, "nan": float("nan"),
             "inf": float("-inf"), "9lives": 1e20, "weird key/x": 2.5, "none": None}
    assert prometheus_text(stats) == jax_prometheus_text(stats)
    assert prometheus_text(stats, prefix="p") == jax_prometheus_text(stats, prefix="p")


def _toy_ranker():
    """A random toy ImageReward and a WordPiece vocabulary of its prompts."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "dog"]
    reward = ImageRewardModel.create(vit_config=ViTConfig.toy(),
                                     bert_config=BertMedConfig.toy(), device="cpu")
    return build_inference_ranker(reward_model=reward, max_length=8,
                                  tokenizer=BertTokenizer({w: i for i, w in enumerate(vocab)}))


def test_http_round_trip(toy, monkeypatch):
    """/generate (its PNG equals the engine's image), /rank ranked by a toy
    ImageReward, /stats, /metrics, /healthz, and the refusals: 400 for a
    bad body, an unported field or jpeg without PIL, 404."""
    pipe, tokenize = toy
    args = argparse.Namespace(max_steps=3, max_batch=2, batch_window_ms=10.0, prompt="default",
                              seed=1, port=0, max_rank_n=4)
    engine, server = serve.make_http_server(pipe, tokenize, args, ranker=_toy_ranker())
    engine.start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        conn.request(method, path, body=body if body is None or isinstance(body, bytes)
                     else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()

    try:
        status, body = call("POST", "/generate", {"prompt": "a cat", "seed": 7,
                                                 "guidance_scale": 5.0,
                                                 "negative_prompt": "blurry"})
        assert status == 200, body[:200]
        out = json.loads(body)
        want = engine.generate_batch(["a cat"], [7], guidances=[5.0],
                                     negative_prompts=["blurry"])[0]
        np.testing.assert_array_equal(read_png(base64.b64decode(out["image_png_base64"])),
                                      want["image"])
        assert out["inference_steps"] == want["inference_steps"]
        # img2img: the image as a PNG, read without PIL
        init = np.random.default_rng(3).integers(0, 256, (PX, PX, 3), dtype=np.uint8)
        status, body = call("POST", "/generate", {
            "prompt": "a cat", "seed": 7, "strength": 0.5,
            "init_image_png_base64": base64.b64encode(png_bytes(init)).decode()})
        assert status == 200, body[:200]
        out = json.loads(body)
        want = engine.generate_batch(["a cat"], [7], init_images=[init], strengths=[0.5])[0]
        np.testing.assert_array_equal(read_png(base64.b64decode(out["image_png_base64"])),
                                      want["image"])
        assert out["inference_steps"] == want["inference_steps"] and out["sigmas"][0] <= 0.5
        status, body = call("POST", "/rank", {"prompt": "a dog", "seed": 5, "n": 2})
        assert status == 200, body[:200]
        ranked = json.loads(body)
        assert ranked["seeds"] == [5, 6] and ranked["ranked"] is True
        assert sorted(ranked["ranking"]) == [1, 2] and ranked["ranking"][ranked["best"]] == 1
        assert len(ranked["images_png_base64"]) == 2
        status, body = call("GET", "/stats")
        batches = json.loads(body)["batches_run"]
        assert status == 200 and batches >= 3  # /rank's two seeds: one or two batches
        status, body = call("GET", "/metrics")
        assert status == 200 and f"tpdm_batches_run {batches}\n".encode() in body
        assert call("GET", "/healthz") == (200, b"ok\n")
        assert call("GET", "/nope")[0] == 404
        for bad in (b"not json", {"prompt": 42}, {"steps": 9}, {"negative_prompt": 3},
                    {"format": "webp"}, {"lora": "x"}, {"init_image_png_base64": "AAAA"},
                    {"init_image_png_base64": base64.b64encode(png_bytes(
                        np.zeros((PX // 2, PX, 3), np.uint8))).decode()}):
            assert call("POST", "/generate", bad)[0] == 400, bad
        assert call("POST", "/rank", {"n": 99})[0] == 400
        monkeypatch.setattr(serve, "_pil_image", lambda: None)
        status, body = call("POST", "/generate", {"format": "jpeg"})
        assert status == 400 and b"PIL" in body
    finally:
        server.shutdown()
        engine.stop()
    assert engine._thread is None


def test_generate_ranked_without_ranker_and_bad_n(toy):
    eng = _running(_engine(toy, max_batch=3, window_ms=200))
    try:
        out = generate_ranked(eng, "a cat", seed=7, n=3)
    finally:
        eng.stop()
    assert out["seeds"] == [7, 8, 9] and len(out["candidates"]) == 3
    assert "ranking" not in out
    with pytest.raises(ValueError):
        generate_ranked(eng, "x", n=0)


def test_cli_writes_a_png(tmp_path):
    """``python -m tpdm_tpu_torch.serve --toy --cpu --cli`` writes a PNG and
    prints its step count; without --cpu and without a card, and with an
    unported flag, the entry point exits non-zero naming why."""
    out = tmp_path / "cat.png"
    proc = subprocess.run(
        [sys.executable, "-m", "tpdm_tpu_torch.serve", "--toy", "--cpu", "--cli",
         "--prompt", "a cat", "--max_steps", "3", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert "inference steps:" in proc.stdout and "/ cap 3" in proc.stdout
    assert read_png(out.read_bytes()).shape == (PX, PX, 3)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            serve.main(["--toy", "--cli"])
    for flag, item in ((["--dp", "2"], "9\\(d\\)"),
                       (["--mesh", "2,2,1"], "14"), (["--few_step", "0,14"], "9\\(e\\)"),
                       (["--reward_checkpoint", "r"], "8")):
        with pytest.raises(SystemExit, match=f"item {item}"):
            serve.main(["--toy", "--cpu", *flag])
    # --lora and --quant_text are ported: their misuses exit before serving
    for flag, match in ((["--cli", "--lora", "a=x"], "NAME=PATH"),
                        (["--lora", "x", "--lora", "y"], "multiple bare"),
                        (["--lora", "x", "--lora", "a=y"], "mix")):
        with pytest.raises(SystemExit, match=match):
            serve.main(["--toy", "--cpu", *flag])
    # --pretrained is ported: a directory without the tokenizer files exits naming one
    with pytest.raises(SystemExit, match="vocab.json"):
        serve.main(["--cpu", "--cli", "--pretrained", str(tmp_path / "no_checkpoint")])
