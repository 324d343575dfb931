"""LoRA adapters on the port's serving engines, on the CPU at toy size:
``BatchingEngine`` (merged, an LRU of merged weights), the SD3
``ContinuousBatchingEngine`` (multiplexed and fused), the family
continuous engines (fused), and ``serve.py``'s ``--lora NAME=PATH`` /
``--lora_fused`` over HTTP; the JAX tests' cases (``tests/test_serving.py``,
``test_serving_continuous.py``, ``test_serving_continuous_families.py``)
on the port's engines.

The engines run on ``serve.build_pipeline`` / ``build_family_world``'s toy
worlds; the adapters are made on the JAX side over each model's dense
layers (``_torch_parity.noisy_lora``: JAX's ``init_lora`` keys with a
non-zero ``b``). One case runs the JAX continuous engine beside the
port's on the same toy weights (``test_torch_serving_continuous.py``'s
world: drawn towers, MMDiT and VAE, the closed-form TPM, one numpy latent a
seed) with the same adapter.

Bounds: bit-equality where the same weights run the same shapes (a merged
adapter against a manually merged backbone; a base request after adapter
traffic against an adapter-free engine); the one-level uint8 seam where
the batch shapes differ; the fused path against the merged solo run
within the JAX tests' bound (max 24 levels, mean < 3: the fused delta
rounds W and x·a·b apart), and an adapter request further from the base
than that gap; sigmas within the fp32 bound against JAX, integer
schedules exactly.
"""

import argparse
import base64
import http.client
import json
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, drawn_models, noisy_jax_lora, noisy_lora
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
from tpdm_tpu_torch.models.lora import apply_lora, call_merged
from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline
from tpdm_tpu_torch.pipeline.text_encoding import SD3TextEncoders
from tpdm_tpu_torch.serving import BatchingEngine
from tpdm_tpu_torch.serving_continuous import (
    ContinuousBatchingEngine,
    ContinuousFluxEngine,
    ContinuousSD15Engine,
)
from tpdm_tpu_torch.train.draft import save_lora
from tpdm_tpu_torch.utils.convert import lora_from_jax
from tpdm_tpu_torch.utils.image import read_png

FUSED_MAX, FUSED_MEAN = 24, 3.0  # tests/test_serving_continuous.py's fused/merged bound


def _gap(a, b):
    """(largest uint8 gap, mean gap)."""
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    return int(d.max()), float(d.mean())


def _run(engine, jobs):
    """Each (prompt, seed, lora) job's result through a started engine."""
    engine.start()
    try:
        reqs = [engine.submit(p, seed=s, **({} if a is None else {"lora": a}))
                for p, s, a in jobs]
        return [r.result(timeout=120) for r in reqs]
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def toy():
    """serve.py's toy SD3 pipeline and two adapters over its MMDiT."""
    pipe, tokenize = serve.build_pipeline(argparse.Namespace(toy=True, cpu=True))
    return pipe, tokenize, noisy_lora(pipe.mmdit, 1), noisy_lora(pipe.mmdit, 2)


def _fixed(pipe, tokenize, **kw):
    return BatchingEngine(pipe, tokenize, max_batch=1, window_ms=1, max_steps=4, **kw)


@pytest.fixture(scope="module")
def solo(toy):
    """The merged solo runs (a BatchingEngine at batch 1) of the jobs the
    continuous cases run."""
    pipe, tokenize, la, lb = toy
    ref = _fixed(pipe, tokenize)
    ref.register_adapter("a", la, merged_cache=2)
    ref.register_adapter("b", lb, merged_cache=2)
    jobs = [("a cat", 7, None), ("a cat", 7, "a"), ("a cat", 7, "b"), ("blue bird", 3, "a")]
    return jobs, {j: ref.generate_batch([j[0]], [j[1]], lora=j[2])[0] for j in jobs}


# -- BatchingEngine -------------------------------------------------------------

def test_adapter_path_equals_a_manually_merged_backbone(toy):
    """An adapter request equals an adapter-free engine on the manually
    merged weights, bit for bit; base requests before and after adapter
    traffic equal an adapter-free engine's; the module is never written."""
    pipe, tokenize, la, lb = toy
    before = {k: v.clone() for k, v in pipe.mmdit.state_dict().items()}
    plain = _fixed(pipe, tokenize)
    want_base = plain.generate_batch(["a cat"], [7])[0]["image"]
    eng = _fixed(pipe, tokenize)
    eng.register_adapter("a", la, scale=0.7, merged_cache=2)
    eng.register_adapter("b", lb)
    img_a = eng.generate_batch(["a cat"], [7], lora="a")[0]["image"]
    img_b = eng.generate_batch(["a cat"], [7], lora="b")[0]["image"]
    again = eng.generate_batch(["a cat"], [7])[0]["image"]
    merged = apply_lora(pipe.mmdit, la, scale=0.7)
    direct = call_merged(pipe.mmdit, merged, plain.generate_batch, ["a cat"], [7])[0]["image"]
    np.testing.assert_array_equal(img_a, direct)
    np.testing.assert_array_equal(again, want_base)
    assert min(_gap(img_a, want_base)[0], _gap(img_b, want_base)[0], _gap(img_a, img_b)[0]) > 1
    for k, v in pipe.mmdit.state_dict().items():
        assert torch.equal(v, before[k]), k
    st = eng.stats()
    assert st["adapter_batches"] == {"a": 1, "b": 1, "<base>": 1} and st["adapter_merges"] == 2


def test_mixed_window_groups_by_adapter(toy):
    """One window of a base and two adapter requests runs as two
    sub-batches, each image its solo run's."""
    pipe, tokenize, la, _ = toy
    eng = BatchingEngine(pipe, tokenize, max_batch=4, window_ms=200, max_steps=4)
    eng.register_adapter("style", la)
    solo_base = eng.generate_batch(["a cat"], [7])[0]["image"]
    solo_style = eng.generate_batch(["a cat"], [7], lora="style")[0]["image"]
    runs = eng.batches_run
    got = _run(eng, [("a cat", 7, None), ("a cat", 7, "style"), ("a cat", 7, "style")])
    np.testing.assert_array_equal(got[0]["image"], solo_base)
    np.testing.assert_array_equal(got[1]["image"], solo_style)
    np.testing.assert_array_equal(got[2]["image"], solo_style)
    assert eng.batches_run == runs + 2
    st = eng.stats()
    assert st["adapter_batches"]["<base>"] == 2 and st["adapter_batches"]["style"] == 2


def test_lru_eviction_stays_correct(toy):
    pipe, tokenize, la, lb = toy
    eng = _fixed(pipe, tokenize)
    eng.register_adapter("a", la)
    eng.register_adapter("b", lb)
    first_a = eng.generate_batch(["x"], [1], lora="a")[0]["image"]
    eng.generate_batch(["x"], [1], lora="b")  # evicts a
    again_a = eng.generate_batch(["x"], [1], lora="a")[0]["image"]
    np.testing.assert_array_equal(first_a, again_a)
    assert eng.adapter_merges == 3 and len(eng._merged) == 1


def test_fixed_engine_refusals(toy):
    """Unknown adapters, a runner engine, a quantised backbone, an empty
    name and another model's adapter are refused."""
    pipe, tokenize, la, _ = toy
    eng = _fixed(pipe, tokenize)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit("a cat", lora="nope")
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.generate_batch(["a cat"], [0], lora="nope")
    with pytest.raises(ValueError, match="non-empty"):
        eng.register_adapter("", la)
    with pytest.raises(ValueError, match="merged_cache"):
        eng.register_adapter("a", la, merged_cache=0)
    foreign = {"down_0_attn_0.block.attn1_to_q": la["context_embedder"]}
    with pytest.raises(ValueError, match="wrong model"):
        eng.register_adapter("a", foreign)
    runner = lambda p, s, c: [{"image": np.zeros((4, 4, 3), np.uint8), "inference_steps": 1,
                               "sigmas": [1.0]}] * len(p)
    with pytest.raises(ValueError, match="runner"):
        BatchingEngine(None, tokenize=None, max_batch=1, runner=runner).register_adapter("a", la)
    qpipe, _ = serve.build_pipeline(argparse.Namespace(toy=True, cpu=True, int8=True))
    with pytest.raises(ValueError, match="quantized"):
        _fixed(qpipe, tokenize).register_adapter("a", la)


def test_split_lora_args():
    ns = lambda v: argparse.Namespace(lora=v)
    assert serve._split_lora_args(ns(None)) == (None, [])
    assert serve._split_lora_args(ns(["/p/x.st"])) == ("/p/x.st", [])
    assert serve._split_lora_args(ns("/p/x.st")) == ("/p/x.st", [])
    assert serve._split_lora_args(ns(["a=/p/a.st", "b=/p/b.st"])) == (
        None, [("a", "/p/a.st"), ("b", "/p/b.st")])
    for entries, match in ((["/p/x.st", "a=/p/a.st"], "mix"),
                           (["/p/x.st", "/p/y.st"], "multiple bare"),
                           (["a=/p/a.st", "a=/p/b.st"], "duplicate")):
        with pytest.raises(SystemExit, match=match):
            serve._split_lora_args(ns(entries))


@pytest.mark.parametrize("mode", ["fixed", "multiplex", "fused"])
def test_named_adapters_over_http(toy, tmp_path, mode):
    """--lora NAME=PATH on the fixed engine and the continuous engine in
    both modes: the "lora" field of /generate picks the adapter (three
    distinct images), /rank takes it too, a bad field is a 400, and
    /stats shows the adapters."""
    pipe, tokenize, la, lb = toy
    save_lora(str(tmp_path / "a.safetensors"), la)
    save_lora(str(tmp_path / "b.safetensors"), lb)
    argv = ["--toy", "--cpu", "--port", "0", "--max_steps", "3", "--max_batch", "2",
            "--batch_window_ms", "10", "--lora_cache", "2",
            "--lora", f"a={tmp_path}/a.safetensors", "--lora", f"b={tmp_path}/b.safetensors"]
    argv += {"fixed": [], "multiplex": ["--continuous", "--seg_steps", "2"],
             "fused": ["--continuous", "--seg_steps", "2", "--lora_fused"]}[mode]
    args = serve.parse_args(argv)
    engine, server = serve.make_http_server(pipe, tokenize, args)
    engine.start()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]

    def call(path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST" if body is not None else "GET", path,
                     body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()

    try:
        images = []
        for lora in (None, "a", "b"):
            status, body = call("/generate", {"prompt": "a cat", "seed": 7, "lora": lora})
            assert status == 200, body[:200]
            images.append(read_png(base64.b64decode(
                json.loads(body)["image_png_base64"])))
        assert min(_gap(images[0], images[1])[0], _gap(images[0], images[2])[0],
                   _gap(images[1], images[2])[0]) > 1
        status, body = call("/rank", {"prompt": "a cat", "seed": 7, "n": 1, "lora": "a"})
        assert status == 200, body[:200]
        assert call("/generate", {"prompt": "a cat", "lora": "nope"})[0] == 400
        assert call("/generate", {"prompt": "a cat", "lora": 42})[0] == 400
        st = json.loads(call("/stats")[1])
        if mode == "fixed":
            assert st["adapter_batches"] == {"<base>": 1, "a": 2, "b": 1}
        else:
            assert st["lora_mode"] == mode and set(st["adapter_segments"]) == {"a", "b"}
            assert st["adapter_merges"] == (2 if mode == "multiplex" else 0)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


def test_lora_fused_needs_a_continuous_engine(toy, tmp_path):
    """--lora_fused needs --continuous (no router) and NAME=PATH adapters;
    the multi-resolution router serves none."""
    pipe, tokenize, la, _ = toy
    save_lora(str(tmp_path / "a.safetensors"), la)
    named = ["--lora", f"a={tmp_path}/a.safetensors"]
    base = ["--toy", "--cpu", "--port", "0", "--max_steps", "3"]
    for extra, match in ((named + ["--lora_fused"], "continuous"),
                         (["--continuous", "--lora_fused"], "without --lora"),
                         (named + ["--continuous", "--resolutions", "24"], "router")):
        with pytest.raises(SystemExit, match=match):
            serve.make_http_server(pipe, tokenize, serve.parse_args(base + extra))


# -- ContinuousBatchingEngine ---------------------------------------------------

def test_multiplexed_pool_matches_merged_solo(toy, solo):
    """Each segment runs one adapter's merged weights with the others'
    slots frozen: every request is its merged solo run's (a one-level seam
    at most: the solo run is at batch 1), one merge an adapter."""
    pipe, tokenize, la, lb = toy
    jobs, want = solo
    eng = ContinuousBatchingEngine(pipe, tokenize, slots=2, seg_steps=2, max_steps=4)
    eng.register_adapter("a", la, merged_cache=2)
    eng.register_adapter("b", lb, merged_cache=2)
    for j, got in zip(jobs, _run(eng, jobs)):
        assert got["inference_steps"] == want[j]["inference_steps"]
        assert _gap(got["image"], want[j]["image"])[0] <= 1, j
    assert _gap(want[jobs[0]]["image"], want[jobs[1]]["image"])[0] > 1
    st = eng.stats()
    assert st["adapter_merges"] == 2 and set(st["adapter_segments"]) == {"a", "b"}
    assert st["lora_mode"] == "multiplex" and eng.segment_traces == 1


def test_pipelined_fused_adapters(toy):
    pipe, tokenize, la, _ = toy
    eng = ContinuousBatchingEngine(pipe, tokenize, slots=2, seg_steps=2, max_steps=4,
                                   fused_lora=True, pipeline_depth=2)
    eng.register_adapter("a", la)
    base, tuned = _run(eng, [("a cat", 7, None), ("a cat", 7, "a")])
    assert _gap(base["image"], tuned["image"])[0] > 1


def test_base_not_starved_by_adapter_flood(toy):
    pipe, tokenize, la, _ = toy
    eng = ContinuousBatchingEngine(pipe, tokenize, slots=2, seg_steps=1, max_steps=4)
    eng.register_adapter("a", la)
    eng.adapter_fair_every = 2
    got = _run(eng, [(f"p{i}", i, "a") for i in range(6)] + [("base prompt", 99, None)])
    assert all(g["inference_steps"] >= 1 for g in got)
    assert eng.stats()["adapter_segments"]["a"] < eng.stats()["segments_run"]


def test_fused_mixed_pool_matches_merged_solo(toy, solo):
    """Fused: base rows ride an exact zero delta (one level at most);
    adapter rows within the fused/merged bound of the merged solo run,
    and further from the base than that gap; no merged weights."""
    pipe, tokenize, la, lb = toy
    jobs, want = solo
    eng = ContinuousBatchingEngine(pipe, tokenize, slots=2, seg_steps=2, max_steps=4,
                                   fused_lora=True)
    eng.register_adapter("a", la)
    eng.register_adapter("b", lb)
    for j, got in zip(jobs, _run(eng, jobs)):
        level, mean = _gap(got["image"], want[j]["image"])
        if j[2] is None:
            assert level <= 1, level
        else:
            assert level <= FUSED_MAX and mean < FUSED_MEAN, (level, mean)
            if j[:2] == ("a cat", 7):
                assert _gap(want[("a cat", 7, None)]["image"], want[j]["image"])[0] > level
    st = eng.stats()
    assert st["lora_mode"] == "fused" and st["adapter_merges"] == 0


def test_fused_advances_all_tenants_in_one_segment(toy):
    pipe, tokenize, la, lb = toy
    eng = ContinuousBatchingEngine(pipe, tokenize, slots=2, seg_steps=3, max_steps=3,
                                   fused_lora=True)
    eng.register_adapter("a", la)
    eng.register_adapter("b", lb)
    _run(eng, [("x", 1, "a"), ("y", 2, "b")])
    st = eng.stats()
    assert st["segments_run"] == 1 and st["slot_utilization"] == 1.0
    assert st["adapter_segments"] == {"a": 1, "b": 1}


@pytest.mark.parametrize("flag", ["int8", "int4"])
def test_fused_adapters_over_a_quantised_backbone(toy, flag):
    """The fused delta beside stored-int matmuls: base rows within the
    int seam of the fixed engine's, the adapter visibly on; the
    multiplexed mode and the fixed engine refuse the backbone."""
    _, tokenize, la, _ = toy
    qpipe, _ = serve.build_pipeline(argparse.Namespace(toy=True, cpu=True, **{flag: True}))
    assert not qpipe.mmdit.transformer_blocks[0].attn.to_q.weight.is_floating_point()
    want_base = _fixed(qpipe, tokenize).generate_batch(["a cat"], [7])[0]["image"]
    eng = ContinuousBatchingEngine(qpipe, tokenize, slots=2, seg_steps=2, max_steps=4,
                                   fused_lora=True)
    eng.register_adapter("style", la)
    base, tuned = _run(eng, [("a cat", 7, None), ("a cat", 7, "style")])
    assert _gap(base["image"], want_base)[0] <= 3
    assert _gap(tuned["image"], base["image"])[0] > 3
    assert eng.stats()["adapter_merges"] == 0
    with pytest.raises(ValueError, match="fused-only"):
        ContinuousBatchingEngine(qpipe, tokenize, slots=1, max_steps=2).register_adapter("a", la)


def test_adapter_validation(toy):
    pipe, tokenize, la, _ = toy
    eng = ContinuousBatchingEngine(pipe, tokenize, slots=1, seg_steps=1, max_steps=2)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit("x", lora="nope")
    with pytest.raises(ValueError, match="non-empty"):
        eng.register_adapter("", la)
    with pytest.raises(ValueError, match="wrong model"):
        eng.register_adapter("a", {"nope.layer": la["context_embedder"]})
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="before start"):
            eng.register_adapter("late", la)
    finally:
        eng.stop()
    assert "lora_mode" not in eng.stats()


# -- the family engines -----------------------------------------------------------

def _family(name, **kw):
    args = argparse.Namespace(toy=True, cpu=True, family=name, max_steps=4, **kw)
    return serve.build_family_world(args)


@pytest.fixture(scope="module")
def families():
    """The toy SD1.5 and FLUX worlds of serve.py and an adapter over each
    backbone."""
    out = {}
    for name in ("sd15", "flux"):
        w = _family(name)
        module = w["agent"].unet if name == "sd15" else w["agent"].flux
        out[name] = (w, module, noisy_lora(module, 4))
    return out


def test_family_adapters_need_the_fused_mode(families, tmp_path):
    """A family engine serves adapters fused only; a missing adapter file
    fails when the server is built."""
    for name, cls in (("sd15", ContinuousSD15Engine), ("flux", ContinuousFluxEngine)):
        w, _, lora = families[name]
        eng = cls(w["agent"], w["encode"], tpm_params=w["tpm_params"], slots=1)
        with pytest.raises(ValueError, match="fused-only"):
            eng.register_adapter("x", lora)
    args = serve.parse_args(["--family", "sd15", "--toy", "--cpu", "--continuous", "--lora_fused",
                             "--port", "0", "--lora", f"s={tmp_path}/missing.safetensors"])
    w = serve.build_family_world(args)
    with pytest.raises(FileNotFoundError):
        serve.make_http_server(None, None, args, runner=w["runner"], world=w)


@pytest.mark.parametrize("name", ["flux", "sd15"])
def test_family_fused_pool_matches_merged_solo(families, name):
    """A base and an adapter request through the fused family engine: the
    base within one level of the runner's, the adapter within the fused
    bound of the runner on the merged backbone (SD1.5's integer schedule
    exactly), and further from the base than that."""
    w, module, lora = families[name]
    cls = ContinuousSD15Engine if name == "sd15" else ContinuousFluxEngine
    scale = 8.0  # the toy UNet's images move little under a unit-scale adapter
    eng = cls(w["agent"], w["encode"], decode=w["decode"], tpm_params=w["tpm_params"], slots=2,
              seg_steps=2, fused_lora=True)
    args = (["a cat"], [3], [eng.max_steps])
    ref_base = w["runner"](*args)[0]
    ref_tuned = call_merged(module, apply_lora(module, lora, scale=scale), w["runner"], *args)[0]
    eng.register_adapter("style", lora, scale=scale)
    base, tuned = _run(eng, [("a cat", 3, None), ("a cat", 3, "style")])
    assert _gap(base["image"], ref_base["image"])[0] <= 1
    assert tuned["inference_steps"] == ref_tuned["inference_steps"]
    if name == "sd15":
        assert [int(s) for s in tuned["sigmas"]] == [int(s) for s in ref_tuned["sigmas"]]
    level, mean = _gap(tuned["image"], ref_tuned["image"])
    assert level <= FUSED_MAX and mean < FUSED_MEAN
    assert _gap(tuned["image"], base["image"])[0] > max(level, 1)
    assert eng.stats()["lora_mode"] == "fused"


@pytest.mark.parametrize("quant", [[], ["--int8"]])
def test_flux_fused_adapters_over_the_cli(families, tmp_path, quant):
    """--family flux --continuous --lora_fused --lora NAME=PATH (over the
    float and the W8A8 backbone): the adapter registers on the fused
    engine and a {"lora": NAME} request changes the image."""
    _, _, lora = families["flux"]
    save_lora(str(tmp_path / "s.safetensors"), lora)
    args = serve.parse_args(["--family", "flux", "--toy", "--cpu", "--continuous", "--lora_fused",
                             "--max_steps", "3", "--max_batch", "2", "--seg_steps", "1",
                             "--port", "0", "--lora", f"s={tmp_path}/s.safetensors", *quant])
    w = serve.build_family_world(args)
    engine, server = serve.make_http_server(None, None, args, runner=w["runner"], world=w)
    try:
        assert isinstance(engine, ContinuousFluxEngine) and engine.fused_lora
        assert "s" in engine._adapters
        base, tuned = _run(engine, [("a cat", 7, None), ("a cat", 7, "s")])
        assert _gap(base["image"], tuned["image"])[0] > 1
    finally:
        server.server_close()


# -- against the JAX engine -------------------------------------------------------

def test_adapter_request_matches_the_jax_engine():
    """The multiplexed continuous engines of both packages on the same toy
    weights and the same adapter: a request under the adapter and one on
    the base take the same steps, sigmas within the fp32 bound and images
    within one level on under 1 % of pixels."""
    towers = {"clip_l": _clip(0, CLIP_L), "clip_g": _clip(1, CLIP_G), "t5": _t5(2)}
    (jl, vl, tl), (jg, vg, tg), (jt, vt, tt) = (towers[k] for k in ("clip_l", "clip_g", "t5"))
    models = drawn_models(3, tpm=False)
    jm, mv, tm = models["mmdit"]
    jv, vv, tv = models["vae"]
    jte = JSD3TextEncoders(jl, vl, jg, vg, jt, vt, t5_width=T5_KW["d_model"])
    jtpm = types.SimpleNamespace(apply=lambda params, h, temb: _jax_tpm(h, temb))
    jpipe = JTPDMPipeline(jm, mv, jtpm, {}, jv, vv, text_encoders=jte, min_sigma=MIN_SIGMA)
    tpipe = TPDMPipeline(tm, _torch_tpm, tv, text_encoders=SD3TextEncoders(
        tl, tg, tt, t5_width=T5_KW["d_model"]), min_sigma=MIN_SIGMA)
    jlora = noisy_jax_lora(mv, 6)
    mcfg = tm.config
    latent = lambda seed: np.random.default_rng(seed).standard_normal(
        (mcfg.in_channels, mcfg.sample_size, mcfg.sample_size)).astype(np.float32)
    kw = dict(slots=2, seg_steps=2, max_steps=6)
    jeng = JContinuousBatchingEngine(jpipe, serve.toy_tokenize, **kw)
    jeng._init_latent = lambda seed: jnp.asarray(latent(seed))
    jeng.register_adapter("a", jax.tree.map(jnp.asarray, jlora))
    teng = ContinuousBatchingEngine(tpipe, serve.toy_tokenize, **kw)
    teng._init_latent = lambda seed: torch.from_numpy(latent(seed))
    teng.register_adapter("a", lora_from_jax(jlora))
    jobs = [("a cat", 3, "a"), ("blue bird", 11, None), ("a cat", 3, None)]
    want, got = _run(jeng, jobs), _run(teng, jobs)
    for g, w_ in zip(got, want):
        assert g["inference_steps"] == w_["inference_steps"]
        close(np.asarray(g["sigmas"]), np.asarray(w_["sigmas"]))
        d = np.abs(g["image"].astype(np.int16) - np.asarray(w_["image"]).astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < 0.01
    assert _gap(got[0]["image"], got[2]["image"])[0] > 1
    assert set(teng.stats()) == set(jeng.stats())
