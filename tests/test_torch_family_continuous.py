"""The UNet families' continuous engines (``serving_continuous.py``:
``ContinuousSD15Engine``, ``ContinuousSDXLEngine``) and their command line
(``serve --family sd15|sdxl``), on the CPU at toy size.

Against the port's own fixed runner (``serving_families.make_sd15_runner``
/ ``make_sdxl_runner``) at the engine's batch (slots): a burst of requests
with mixed caps through 2 slots, each request's final latents, steps and
integer schedule equal to a direct runner call to the bit (engines without
a decode return final latents; the runner is given the engine's batch-1
embed rows, as ``test_torch_serving_continuous.py`` gives its reference).
Against the JAX engines of the same toy world (weights drawn by
``_torch_parity.random_variables``, a closed-form TPM on both sides, the
port's encodings and latents given to JAX): each request's steps and
integer schedule exactly, its final latents within the fp32 bound, and the
same stats() keys. Each JAX engine compiles its segment once (module
fixtures).
"""

import argparse
import base64
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, random_variables
from tpdm_tpu.models.tpm import TimePredictor as JTimePredictor
from tpdm_tpu.models.unet_sd15 import UNetConfig as JUNetConfig, UNetSD15 as JUNetSD15
from tpdm_tpu.serving_continuous import ContinuousSD15Engine as JContinuousSD15Engine
from tpdm_tpu.serving_continuous import ContinuousSDXLEngine as JContinuousSDXLEngine
from tpdm_tpu.train import RLOOConfig as JRLOOConfig
from tpdm_tpu.train.sd15_agent import SD15Agent as JSD15Agent
from tpdm_tpu.train.sdxl_agent import SDXLAgent as JSDXLAgent
from tpdm_tpu_torch import serve, serving_families
from tpdm_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from tpdm_tpu_torch.serving_continuous import ContinuousSD15Engine, ContinuousSDXLEngine
from tpdm_tpu_torch.train import RLOOConfig
from tpdm_tpu_torch.train.sd15_agent import SD15Agent
from tpdm_tpu_torch.train.sdxl_agent import SDXLAgent
from tpdm_tpu_torch.utils.convert import unet_sd15_from_jax

T, GS, N_TXT = 6, 5.0, 8
# (prompt, seed, cap): staggered joins and mixed caps through 2 slots
REQUESTS = [("a cat", 3, None), ("a dog on a hill", 7, 2), ("blue bird", 11, None),
            ("a cat", 5, 3), ("red square", 23, 1)]
FAMILIES = {
    # two-level toys at an 8 x 8 latent grid (JAX compiles each segment in seconds)
    "sd15": dict(cfg="toy", kw=dict(block_out_channels=(8, 16), cross_attention_dim=24,
                                    sample_size=8)),
    "sdxl": dict(cfg="toy_xl", kw=dict(block_out_channels=(8, 16), sample_size=8,
                                       transformer_layers_per_block=(0, 1),
                                       mid_transformer_layers=1, cross_attention_dim=24,
                                       addition_pooled_dim=12)),
}


def _j_tpm(h, temb):
    return jnp.stack([3.0 + 0.1 * jnp.tanh(jnp.mean(h, axis=(1, 2, 3))),
                      2.0 + 0.1 * jnp.tanh(jnp.mean(temb, axis=1))], axis=1)


def _t_tpm(h, temb):
    return torch.stack([3.0 + 0.1 * torch.tanh(h.mean(dim=(1, 2, 3))),
                        2.0 + 0.1 * torch.tanh(temb.mean(dim=1))], dim=1)


def _rows(text: str, width: int, seed: int) -> np.ndarray:
    """A prompt's closed-form (N_TXT, width) context rows: fixed per text."""
    rng = np.random.default_rng([seed] + [ord(c) for c in text])
    return rng.standard_normal((N_TXT, width)).astype(np.float32)


def _encode_fn(family: str, ctx: int):
    """The family's encode contract on the port's side: SD1.5 (pe, npe),
    SDXL (pe, pooled, npe, npooled); the negative the empty prompt's."""
    def encode(prompts):
        pe = torch.from_numpy(np.stack([_rows(p, ctx, 1) for p in prompts]))
        npe = torch.from_numpy(np.stack([_rows("", ctx, 1) for _ in prompts]))
        if family == "sd15":
            return pe, npe
        pooled = torch.from_numpy(np.stack([_rows(p, 12, 2)[0] for p in prompts]))
        npooled = torch.from_numpy(np.stack([_rows("", 12, 2)[0] for _ in prompts]))
        return pe, pooled, npe, npooled

    return encode


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, JAX agent, port agent, port encode, JAX encode)."""
    name = request.param
    spec = FAMILIES[name]
    jcfg = getattr(JUNetConfig, spec["cfg"])(**spec["kw"])
    ju = JUNetSD15(jcfg)
    args = [jnp.zeros((1, 4, 8, 8)), jnp.ones((1,)), jnp.zeros((1, N_TXT, 24))]
    if jcfg.addition_embed:
        args.append({"text_embeds": jnp.zeros((1, 12)), "time_ids": jnp.zeros((1, 6))})
    uvars = random_variables(ju.init, 60, *args)
    tu = UNetSD15(getattr(UNetConfig, spec["cfg"])(**spec["kw"]))
    tu.load_state_dict(unet_sd15_from_jax(uvars))
    jtpm = JTimePredictor(conv_out_channels=4, in_channels=16, temb_dim=8)
    jcls, tcls = (JSD15Agent, SD15Agent) if name == "sd15" else (JSDXLAgent, SDXLAgent)
    jag = jcls(ju, uvars, JRLOOConfig(max_inference_steps=T), tpm=jtpm, guidance_scale=GS)
    tag = tcls(tu.eval(), RLOOConfig(max_inference_steps=T), guidance_scale=GS)
    jag.tpm_fn = lambda params: _j_tpm
    tag.tpm_fn = lambda tpm: _t_tpm
    tenc = _encode_fn(name, 24)
    jenc = lambda prompts: tuple(jnp.asarray(x.numpy()) for x in tenc(prompts))
    return name, jag, tag, tenc, jenc


def _engine_cls(name, jax_side=False):
    if jax_side:
        return JContinuousSD15Engine if name == "sd15" else JContinuousSDXLEngine
    return ContinuousSD15Engine if name == "sd15" else ContinuousSDXLEngine


def _run(engine, jobs=REQUESTS):
    engine.start()
    try:
        reqs = [engine.submit(p, seed=s, steps=c) for p, s, c in jobs]
        return [r.result(timeout=120) for r in reqs]
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def port_run(family):
    """The port engine's results of the burst (2 slots, seg_steps 2)."""
    name, _, tag, tenc, _ = family
    eng = _engine_cls(name)(tag, tenc, tpm_params=0, slots=2, seg_steps=2)
    eng.warmup()
    return eng, _run(eng)


def test_engine_matches_the_fixed_runner_to_the_bit(family, port_run):
    """Each request equals a direct runner call at the engine's batch (2)
    holding the engine's rows: steps, integer schedule, final latents."""
    name, _, tag, _, _ = family
    eng, got = port_run
    make = (serving_families.make_sd15_runner if name == "sd15"
            else serving_families.make_sdxl_runner)
    for (p, s, c), out in zip(REQUESTS, got):
        pe_row, pp_row = eng._prompt_embeds(p)
        neg = [eng._neg_pe[0]] * 2

        def encode(prompts, pe_row=pe_row, pp_row=pp_row):
            if name == "sd15":
                return torch.stack([pe_row] * 2), torch.stack(neg)
            return (torch.stack([pe_row] * 2), torch.stack([pp_row] * 2), torch.stack(neg),
                    torch.stack([eng._neg_pp[0]] * 2))

        cap = c or T
        want = make(tag, 0, encode)([p, p], [s, s], [cap, cap])[0]
        assert out["inference_steps"] == want["inference_steps"]
        assert [int(v) for v in out["sigmas"]] == want["sigmas"]
        np.testing.assert_array_equal(out["image"], want["image"])
    nfes = [o["inference_steps"] for o in got]
    assert nfes[1] == 2 and nfes[3] <= 3 and nfes[4] == 1
    stats = eng.stats()
    assert stats["slot_steps_active"] == sum(nfes)
    assert eng.segment_traces == 1


def test_engine_matches_the_jax_engine(family, port_run):
    """The same burst through the JAX engine of the same world: equal steps
    and integer schedules, final latents within the fp32 bound, the same
    stats() keys."""
    name, jag, tag, _, jenc = family
    eng, got = port_run
    jeng = _engine_cls(name, jax_side=True)(jag, jenc, tpm_params=0, slots=2, seg_steps=2)
    jeng._init_latent = lambda seed: jnp.asarray(eng._init_latent(seed).numpy())
    want = _run(jeng)
    for g, w in zip(got, want):
        assert g["inference_steps"] == w["inference_steps"]
        assert g["sigmas"] == [float(v) for v in w["sigmas"]]
        close(g["image"], np.asarray(w["image"]))
    assert list(eng.stats()) == list(jeng.stats())


def test_engine_refusals(family):
    name, _, tag, tenc, _ = family
    cls = _engine_cls(name)
    for kw, match in ((dict(dp=2), r"9\(d\)"), (dict(mesh_shape=(1, 1, 1)), "14")):
        with pytest.raises(NotImplementedError, match=match):
            cls(tag, tenc, tpm_params=0, **kw)
    eng = cls(tag, tenc, tpm_params=0, slots=1)
    # adapters are ported, fused only on the family engines
    with pytest.raises(ValueError, match="fused-only"):
        eng.register_adapter("a", {"x": {"a": torch.zeros(2, 1), "b": torch.zeros(1, 2)}})
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit("a", lora="a")
    with pytest.raises(ValueError, match="SD3-only"):
        eng.submit("a", guidance_scale=3.0)
    with pytest.raises(ValueError, match="img2img"):
        eng.submit("a", init_image=np.zeros((64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="resolution"):
        eng.submit("a", resolution=64)
    assert eng.max_steps == T and eng.guidance_scale == GS


# ---------------------------------------------------------------- the CLI

def test_serve_family_sdxl_cli_and_refiner(tmp_path, capsys):
    """``--family sdxl --toy`` on the CPU, alone and with ``--refiner``: a
    PNG and the step count."""
    for extra in ([], ["--refiner", "--denoising_end", "0.7"]):
        out = tmp_path / f"xl{len(extra)}.png"
        serve.main(["--family", "sdxl", "--toy", "--cpu", "--cli", "--prompt", "a cat",
                    "--max_steps", "4", "--out", str(out), *extra])
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert "inference steps:" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--family", "sdxl", "--cpu", "--cli"], "--toy"),
    (["--family", "sd15", "--toy", "--cpu", "--refiner"], "--family sdxl"),
    (["--family", "sdxl", "--toy", "--cpu", "--refiner", "--continuous"], "--continuous"),
    (["--family", "sdxl", "--toy", "--cpu", "--refiner", "--cache_interval", "2"], "refiner"),
    (["--family", "sdxl", "--toy", "--cli"], "--cpu"),
    (["--family", "sdxl", "--toy", "--cpu", "--int4"], "int4"),
])
def test_serve_family_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(argv)


@pytest.mark.parametrize("fam", ["sd15", "sdxl"])
def test_serve_family_continuous_http(fam):
    """``--family <fam> --toy --continuous`` behind the HTTP server: the
    family's continuous engine answers /generate with a PNG and the integer
    schedule; its accel flags are refused."""
    args = serve.parse_args(["--family", fam, "--toy", "--cpu", "--continuous", "--port", "0",
                             "--max_steps", "4", "--seg_steps", "2"])
    world = serve.build_family_world(args)
    with pytest.raises(SystemExit, match="drop --continuous"):
        serve.make_engine(None, None, argparse.Namespace(**{**vars(args), "cache_interval": 2}),
                          runner=world["runner"], world=world)
    engine, server = serve.make_http_server(None, None, args, runner=world["runner"],
                                            world=world)
    assert type(engine) is _engine_cls(fam)
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
    assert res["inference_steps"] <= 3 and len(res["sigmas"]) == res["inference_steps"]
