"""``serve --family flux``: the FLUX toy world of ``tpdm_tpu_torch.serve`` on
the CPU (no JAX: the world's parts are held to the JAX package in
``test_torch_flux.py``).

The world (``FluxConfig.toy`` caching one front block, hashed-prompt T5 rows
and pooled vectors, a 4-channel TPM, the toy VAE at 4 latent channels,
weights from ``serve.TOY_SEED``) behind ``--cli`` (float, ``--int8`` with
``--cache_interval``, ``--int4``), behind the fixed-batch HTTP engine and,
with ``--continuous``, ``ContinuousFluxEngine``; the flags that do not
apply to FLUX, or are not ported, exit naming why.
"""

import argparse
import base64
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread a process)
from tpdm_tpu_torch import serve
from tpdm_tpu_torch.models.flux import Flux
from tpdm_tpu_torch.ops.quant import DenseMaybeQuant
from tpdm_tpu_torch.serving import BatchingEngine
from tpdm_tpu_torch.serving_continuous import ContinuousFluxEngine
from tpdm_tpu_torch.train.flux_agent import FluxAgent
from tpdm_tpu_torch.utils.image import read_png

FLUX = ["--family", "flux", "--toy", "--cpu"]


def _args(*extra):
    return serve.parse_args(FLUX + ["--port", "0", "--max_steps", "4", *extra])


@pytest.mark.parametrize("extra", [[], ["--int8", "--cache_interval", "2"], ["--int4"]],
                         ids=["float", "int8_cache", "int4"])
def test_serve_family_flux_cli(tmp_path, capsys, extra):
    out = tmp_path / "cat.png"
    serve.main(FLUX + ["--cli", "--prompt", "a cat", "--seed", "3", "--max_steps", "3",
                       "--out", str(out), *extra])
    assert read_png(out.read_bytes()).shape == (16, 16, 3)
    assert "inference steps: 3 / cap 3" in capsys.readouterr().out


def test_serve_family_flux_world():
    """The world's parts: a FluxAgent over the toy FLUX (one cached front
    block), an encode fixed per prompt across calls and batch shapes, the
    runner's results, and its quantised forms."""
    world = serve.build_family_world(_args())
    agent = world["agent"]
    assert isinstance(agent, FluxAgent) and isinstance(agent.flux, Flux)
    assert agent.flux.config.cache_front_blocks == 1 and agent.latent_size == 8
    txt, pooled = world["encode"](["a cat", "a dog"])
    assert txt.shape == (2, 5, 32) and pooled.shape == (2, 24)
    again, again_pooled = world["encode"](["a dog"])
    torch.testing.assert_close(again[0], txt[1], rtol=0, atol=0)
    torch.testing.assert_close(again_pooled[0], pooled[1], rtol=0, atol=0)
    res = world["runner"](["a cat", "a dog"], [1, 2], [2, 4])
    assert [r["inference_steps"] for r in res] == [2, 4]
    assert res[0]["image"].shape == (16, 16, 3) and res[0]["image"].dtype == np.uint8
    assert all(isinstance(v, float) for v in res[1]["sigmas"])
    for flag, dtype in (("--int8", torch.int8), ("--int4", torch.uint8)):
        q = serve.build_family_world(_args(flag))["agent"].flux
        layers = [m for m in q.modules() if isinstance(m, DenseMaybeQuant)]
        assert layers and all(m.weight.dtype == dtype for m in layers)


@pytest.mark.parametrize("continuous", [False, True], ids=["fixed", "continuous"])
def test_serve_family_flux_http(continuous):
    """The fixed-batch engine over the FLUX runner, or ContinuousFluxEngine,
    behind the HTTP server: /generate answers a PNG and the sigmas."""
    extra = ["--continuous", "--seg_steps", "2"] if continuous else []
    args = _args(*extra)
    world = serve.build_family_world(args)
    engine, server = serve.make_http_server(None, None, args, runner=world["runner"],
                                            world=world)
    assert isinstance(engine, ContinuousFluxEngine if continuous else BatchingEngine)
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
    assert read_png(base64.b64decode(res["image_png_base64"])).shape == (16, 16, 3)
    assert res["inference_steps"] == 3 and len(res["sigmas"]) == 3
    assert all(0.0 < s < 1.0 for s in res["sigmas"])


@pytest.mark.parametrize("argv,match", [
    (["--guidance_interval", "0.1,0.9"], "guidance_interval does not apply to FLUX"),
    (["--cache_tau", "0.1", "--cache_interval", "2"], "mutually exclusive"),
    (["--dp", "2"], r"item 9\(d\)"),
    (["--refiner"], "--family sdxl"),
    (["--solver", "ab2"], "solver"),
    (["--lora", "a=x.safetensors"], "NAME=PATH"),
    (["--quant_text"], "has none"),
])
def test_serve_family_flux_refusals(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(FLUX + ["--cli", "--out", str(tmp_path / "x.png"), *argv])


def test_serve_family_flux_engine_refusals():
    """Without --toy the CLI exits; --resolutions is SD3-only; --continuous
    over a bare runner needs the world, and with the world refuses
    --cache_interval (the segment carries no Δ-cache)."""
    with pytest.raises(SystemExit, match="--toy"):
        serve.main(["--family", "flux", "--cpu", "--cli", "--out", "unused.png"])
    args = _args()
    world = serve.build_family_world(args)
    for extra, match in ((dict(continuous=True), "ContinuousFluxEngine"),
                         (dict(resolutions="32"), "SD3-only")):
        with pytest.raises(SystemExit, match=match):
            serve.make_engine(None, None, argparse.Namespace(**{**vars(args), **extra}),
                              runner=world["runner"])
    with pytest.raises(SystemExit, match="drop --continuous"):
        serve.make_engine(None, None, argparse.Namespace(
            **{**vars(args), "continuous": True, "cache_interval": 2}),
            runner=world["runner"], world=world)
