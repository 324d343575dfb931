"""The whole tpdm_tpu_torch slice against the JAX package: adaptive sampling
and ``TPDMPipeline.generate`` on the same toy weights, embeds and latents."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import close, t, toy_mmdit, toy_tpm, toy_vae
from tpdm_tpu.models.mmdit import MMDiT as JMMDiT
from tpdm_tpu.ops.quant import fit_quant_params, prequantize_params
from tpdm_tpu.pipeline.denoise import make_cfg_denoise_fn as jax_make_cfg_denoise_fn
from tpdm_tpu.pipeline.pipeline import TPDMPipeline as JTPDMPipeline
from tpdm_tpu.pipeline.sampler import SamplerConfig as JSamplerConfig
from tpdm_tpu.pipeline.sampler import adaptive_sample as jax_adaptive_sample
from tpdm_tpu_torch.pipeline.denoise import make_cfg_denoise_fn
from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline
from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from tpdm_tpu_torch.pipeline.sampler import SamplerConfig, adaptive_sample
from tpdm_tpu_torch.utils.convert import mmdit_from_jax

REPO = Path(__file__).resolve().parents[1]
N_CTX = 6
# W8A8 generation against JAX's: an fp32 drift of ~1e-6 can move an
# activation across an int8 rounding boundary (one level, 1/127 of its
# row's absmax), so the schedule is held to the toy quant MMDiT's bound
# (tests/test_torch_quant.py) rather than the fp32 one
W8A8_TOL = 2e-3


@pytest.fixture(scope="module")
def world():
    jm, mvars, tm = toy_mmdit(seed=0)
    c = tm.config
    jt, tvars, tt = toy_tpm(in_channels=2 * c.inner_dim, temb_dim=c.inner_dim)
    jv, vvars, tv = toy_vae(latent_channels=c.in_channels)
    rng = np.random.default_rng(11)
    b = 2
    inputs = dict(
        pe=rng.standard_normal((b, N_CTX, c.joint_attention_dim), np.float32),
        pp=rng.standard_normal((b, c.pooled_projection_dim), np.float32),
        npe=rng.standard_normal((b, N_CTX, c.joint_attention_dim), np.float32),
        npp=rng.standard_normal((b, c.pooled_projection_dim), np.float32),
        lat=rng.standard_normal((b, c.in_channels, c.sample_size, c.sample_size), np.float32),
    )
    jpipe = JTPDMPipeline(jm, mvars, jt, tvars, jv, vvars, min_sigma=0.01)
    tpipe = TPDMPipeline(tm, tt, tv, min_sigma=0.01)
    return jpipe, tpipe, inputs


def _w8a8(jpipe, tpipe):
    """The W8A8 counterparts of the world's pipelines: JAX's quant MMDiT on
    its prequantised tree, and the port's on that tree converted."""
    jm, mvars = jpipe.mmdit, jpipe.mmdit_params
    jqm = JMMDiT(dataclasses.replace(jm.config, quant_matmuls=True))
    c = jm.config
    shapes = jax.eval_shape(
        jqm.init, jax.random.PRNGKey(0), np.zeros((1, c.in_channels, 8, 8), np.float32),
        np.ones(1, np.float32), np.zeros((1, N_CTX, c.joint_attention_dim), np.float32),
        np.zeros((1, c.pooled_projection_dim), np.float32))["params"]
    qvars = {**mvars, "params": prequantize_params(fit_quant_params(mvars["params"], shapes))}
    qcfg = MMDiTConfig.toy(quant_matmuls=True)
    tqm = MMDiT(qcfg)
    tqm.load_state_dict(mmdit_from_jax(qvars, qcfg))
    return (JTPDMPipeline(jqm, qvars, jpipe.tpm, jpipe.tpm_params, jpipe.vae, jpipe.vae_params,
                          min_sigma=0.01),
            TPDMPipeline(tqm.eval(), tpipe.tpm, tpipe.vae, min_sigma=0.01))


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_generate_matches_jax(world, quant):
    jpipe, tpipe, x = world
    tol = {}
    if quant == "w8a8":
        jpipe, tpipe = _w8a8(jpipe, tpipe)
        tol = dict(rtol=W8A8_TOL, atol=W8A8_TOL)
    kw = dict(max_inference_steps=10, guidance_scale=7.0, predict=True, seed=0)
    ref = jpipe.generate(x["pe"], x["pp"], x["npe"], x["npp"], latents=x["lat"], **kw)
    out = tpipe.generate(t(x["pe"]), t(x["pp"]), t(x["npe"]), t(x["npp"]),
                         latents=t(x["lat"]), **kw)
    assert 1 <= out.num_steps < 10  # the schedule stopped itself
    assert out.num_steps == ref.num_steps
    np.testing.assert_array_equal(out.prob_masks, ref.prob_masks)
    np.testing.assert_array_equal(out.last_valid_index, ref.last_valid_index)
    for name in ("sigmas", "alphas", "betas"):
        close(getattr(out, name), getattr(ref, name), **tol)
    assert out.images.dtype == np.uint8 and out.images.shape == ref.images.shape
    diff = np.abs(out.images.astype(np.int16) - ref.images.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize(
    "cfg_kw,caps,init_sigma",
    [
        (dict(predict=True, relative=False, prediction_type="mode_concentration"), None, None),
        (dict(predict=True), [3, 10], [1.0, 0.4]),
    ],
)
def test_adaptive_sample_matches_jax(world, cfg_kw, caps, init_sigma):
    jpipe, tpipe, x = world
    c = tpipe.mmdit.config
    grid, p = c.sample_size // c.patch_size, c.patch_size
    pe = np.concatenate([x["npe"], x["pe"]])
    pp = np.concatenate([x["npp"], x["pp"]])
    gs = np.array([7.0, 4.0], np.float32)
    common = dict(max_inference_steps=6, min_sigma=0.01, cache_activations=True,
                  keep_history=True, **cfg_kw)
    jden = jax_make_cfg_denoise_fn(lambda *a: jpipe.mmdit.apply(jpipe.mmdit_params, *a),
                                   pe, pp, gs, grid, p)
    ref = jax.jit(
        lambda lat, caps, s0: jax_adaptive_sample(
            jden, lambda h, tb: jpipe.tpm.apply(jpipe.tpm_params, h, tb), lat,
            jax.random.PRNGKey(0), JSamplerConfig(**common), step_caps=caps, init_sigma=s0,
        )
    )(x["lat"], None if caps is None else np.array(caps, np.int32),
      None if init_sigma is None else np.array(init_sigma, np.float32))
    tden = make_cfg_denoise_fn(tpipe.mmdit, t(pe), t(pp), t(gs), grid, p)
    out = adaptive_sample(
        tden, tpipe.tpm, t(x["lat"]), None, SamplerConfig(**common),
        step_caps=None if caps is None else torch.tensor(caps),
        init_sigma=None if init_sigma is None else torch.tensor(init_sigma),
    )
    n = out.num_steps
    assert n == int(ref.num_steps)
    np.testing.assert_array_equal(out.prob_masks.numpy(), np.asarray(ref.prob_masks))
    np.testing.assert_array_equal(out.last_valid_index.numpy(), np.asarray(ref.last_valid_index))
    for name in ("sigmas", "alphas", "betas", "logprobs", "final_latents"):
        close(getattr(out, name), getattr(ref, name))
    for name in ("h_cache", "temb_cache", "history_latents"):
        close(getattr(out, name)[:n], np.asarray(getattr(ref, name))[:n])


def test_generate_options_size_caps_and_raw_latents(world):
    """Port-only checks of the options that change shapes or stop points:
    a rectangular size from height/width, per-sample step caps, and
    decode=False returning the final latents."""
    _, tpipe, x = world
    args = (t(x["pe"]), t(x["pp"]), t(x["npe"]), t(x["npp"]))
    res = tpipe.generate(*args, height=24, width=16, max_inference_steps=10, seed=3)
    assert res.images.shape == (2, 24, 16, 3) and res.images.dtype == np.uint8
    res = tpipe.generate(*args, latents=t(x["lat"]), step_caps=[1, 2], decode=False)
    np.testing.assert_array_equal(res.last_valid_index, [0, 1])
    assert res.num_steps == 2 and res.images.shape == x["lat"].shape


def test_not_ported_options_raise(world):
    """img2img and inpainting are ported: their options now raise the JAX
    package's ValueErrors where they conflict (an image with latents, a
    mask without an image)."""
    _, tpipe, x = world
    args = (t(x["pe"]), t(x["pp"]), t(x["npe"]), t(x["npp"]))
    for kw, match in ((dict(init_image=np.zeros((2, 16, 16, 3), np.uint8)), "not both"),
                      (dict(mask=np.ones((2, 16, 16), np.float32)), "requires init_image")):
        with pytest.raises(ValueError, match=match):
            tpipe.generate(*args, latents=t(x["lat"]), **kw)
    # token ids without text towers: the JAX package's ValueError
    with pytest.raises(ValueError, match="need prompt_embeds or"):
        tpipe.generate(clip_ids=np.zeros((2, 77), np.int32), latents=t(x["lat"]))


def test_port_imports_without_jax():
    """Every tpdm_tpu_torch module imports with JAX, Flax, optax, PIL, the
    JAX package and the JAX study scripts (``experiments``) blocked: the card
    machine has none of them but the scripts."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'flax', 'optax', 'PIL', 'tpdm_tpu', 'experiments'):\n"
        "    sys.modules[m] = None\n"
        "import tpdm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tpdm_tpu_torch.__path__, 'tpdm_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(' '.join(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 18
    assert {"tpdm_tpu_torch.parallel.mesh", "tpdm_tpu_torch.parallel.sp_attention"} <= names
    assert {f"tpdm_tpu_torch.train.{n}" for n in ("config", "rloo", "checkpoint", "builders")} \
        | {f"tpdm_tpu_torch.rewards.{n}" for n in ("vit", "bert", "image_reward")} \
        | {"tpdm_tpu_torch.ops.schedules", "tpdm_tpu_torch.utils.bert_tokenizer",
           "tpdm_tpu_torch.ops.flow_solver"} <= names
    studies = ("attn_variants", "attn_overlap", "attn_layout", "attn_nocopy", "attn_round3",
               "attn_round3b", "attn_round4", "attn_natural_operands", "attn_block_layout",
               "attn_transpose_cost", "attn_kernel_floor")
    assert {"tpdm_tpu_torch.ops.attention_studies"} | {
        f"tpdm_tpu_torch.experiments.{n}" for n in studies} <= names
