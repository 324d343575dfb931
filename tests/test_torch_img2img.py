"""Image-to-image in tpdm_tpu_torch against the JAX package: the VAE encoder,
``encode_image``, ``img2img_sigmas`` and ``generate(init_image, strength)``.

Follows ``tests/test_img2img.py`` case for case on one module-scoped toy
world: the toy MMDiT and VAE drawn by ``_torch_parity.drawn_models`` and the
closed-form TPM of ``test_torch_text_encoders.py``, so the JAX side compiles
the encoder twice, ``encode_image`` once and the adaptive loop once. The
whole-path check feeds JAX's ``generate(latents=mix, init_sigma=s)`` the mix
of JAX's own encode and the port's noise draw (``torch.Generator`` and
``jax.random`` draw different numbers).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from _torch_parity import close, drawn_models, t
from test_torch_text_encoders import MIN_SIGMA, _jax_tpm, _torch_tpm
from tpdm_tpu.ops.schedules import img2img_sigmas as jax_img2img_sigmas
from tpdm_tpu.pipeline.pipeline import TPDMPipeline as JTPDMPipeline
from tpdm_tpu_torch.ops.schedules import img2img_sigmas, uniform_flow_sigmas
from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline, seed_noise

STEPS = 6
SEED = 5


@pytest.fixture(scope="module")
def world():
    models = drawn_models(6, tpm=False, cache_front_blocks=1)
    jm, mv, tm = models["mmdit"]
    jv, vv, tv = models["vae"]
    jtpm = types.SimpleNamespace(apply=lambda params, h, temb: _jax_tpm(h, temb))
    jpipe = JTPDMPipeline(jm, mv, jtpm, {}, jv, vv, min_sigma=MIN_SIGMA)
    tpipe = TPDMPipeline(tm, _torch_tpm, tv, min_sigma=MIN_SIGMA)
    c = tm.config
    rng = np.random.default_rng(11)
    b = 2
    x = dict(
        pe=rng.standard_normal((b, 5, c.joint_attention_dim), np.float32),
        pp=rng.standard_normal((b, c.pooled_projection_dim), np.float32),
        npe=rng.standard_normal((b, 5, c.joint_attention_dim), np.float32),
        npp=rng.standard_normal((b, c.pooled_projection_dim), np.float32),
        # the toy VAE's factor 2 over the MMDiT's 8 x 8 latents
        img=rng.integers(0, 256, (b, 2 * c.sample_size, 2 * c.sample_size, 3), dtype=np.uint8),
    )
    return jpipe, tpipe, x


def _embeds(x):
    return (t(x["pe"]), t(x["pp"]), t(x["npe"]), t(x["npp"]))


@pytest.mark.parametrize("hw", [(16, 16), (9, 14)])
def test_vae_encode_matches_jax(world, hw):
    """mean and logvar of the encoder, on a square image and on an odd
    rectangle (the downsample's bottom / right pad of one row and column)."""
    jpipe, tpipe, _ = world
    x = np.random.default_rng(hw[0]).uniform(-1, 1, (2, 3) + hw).astype(np.float32)
    ref = jax.jit(lambda v, img: jpipe.vae.apply(v, img, method="encode"))(jpipe.vae_params, x)
    with torch.no_grad():
        out = tpipe.vae.encode(t(x))
    assert out[0].shape == (2, 16, hw[0] // 2, hw[1] // 2)
    for o, r in zip(out, ref):
        close(o, r)


def test_encode_image_matches_jax(world):
    """Model-space latents ``(mean - shift) * scaling``; a posterior draw is
    mean + exp(logvar / 2) eps with eps from the caller's generator."""
    jpipe, tpipe, x = world
    z = tpipe.encode_image(x["img"])
    assert z.dtype == torch.float32 and z.shape == (2, 16, 8, 8)
    close(z, jpipe.encode_image(x["img"]))
    drawn = tpipe.encode_image(x["img"], generator=torch.Generator().manual_seed(1),
                               sample_posterior=True)
    cfg = tpipe.vae.config
    with torch.no_grad():
        mean, logvar = tpipe.vae.encode(2 * t(x["img"].transpose(0, 3, 1, 2) / 255.0) - 1)
    eps = torch.randn(mean.shape, generator=torch.Generator().manual_seed(1))
    close(drawn, (mean + torch.exp(0.5 * logvar) * eps - cfg.shift_factor) * cfg.scaling_factor)
    assert not torch.allclose(drawn, z)
    with pytest.raises(ValueError, match="needs a generator"):
        tpipe.encode_image(x["img"], sample_posterior=True)


def test_img2img_sigmas_match_jax():
    for n in (1, 9, 28):
        np.testing.assert_array_equal(img2img_sigmas(n, 1.0).numpy(), uniform_flow_sigmas(n))
        for s in (0.25, 0.5, 0.8):
            lad = img2img_sigmas(n, s)
            close(lad, np.asarray(jax_img2img_sigmas(n, s)), rtol=1e-6, atol=0)
            assert abs(float(lad[0]) - s) < 1e-6 and bool((lad.diff() < 0).all())
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="strength"):
            img2img_sigmas(8, bad)


def test_generate_img2img_matches_jax(world):
    """The whole path with CFG and per-sample strengths: JAX's generate on
    the mix of its encode and the port's noise, against the port's
    ``generate(init_image=, strength=)``."""
    jpipe, tpipe, x = world
    strength = np.array([0.45, 0.9], np.float32)
    kw = dict(max_inference_steps=STEPS, guidance_scale=4.0, decode=False)
    out = tpipe.generate(*_embeds(x), init_image=x["img"], strength=strength, seed=SEED, **kw)
    clean = np.asarray(jpipe.encode_image(x["img"]), np.float32)
    eps = seed_noise(SEED, clean.shape, "cpu", torch.float32)[1].numpy()
    s = strength[:, None, None, None]
    ref = jpipe.generate(x["pe"], x["pp"], x["npe"], x["npp"], latents=(1 - s) * clean + s * eps,
                         init_sigma=strength, **kw)
    assert 1 <= out.num_steps == ref.num_steps < STEPS
    np.testing.assert_array_equal(out.last_valid_index, ref.last_valid_index)
    close(out.sigmas, ref.sigmas)
    close(out.images, ref.images)
    # each sample starts at its strength: the lower one stays nearer the image
    assert (out.sigmas[:, 0] <= strength + 1e-6).all()
    z = tpipe.encode_image(x["img"]).numpy()
    d = np.abs(out.images - z).mean(axis=(1, 2, 3))
    assert d[0] < d[1]


@pytest.mark.parametrize("option", ["euler", "caps", "window", "cache_interval", "cache_tau",
                                    "ab2", "history"])
def test_strength_one_is_text_to_image(world, option):
    """strength 1.0 draws the text-to-image noise with the same call and
    starts at sigma 1: the same images and sigmas to the bit, under each
    of generate's options."""
    _, tpipe, x = world
    extra = {"euler": {}, "caps": dict(step_caps=[2, 3]),
             "window": dict(guidance_interval=(0.3, 0.9)),
             "cache_interval": dict(cache_interval=2), "cache_tau": dict(cache_tau=0.05),
             "ab2": dict(solver="ab2"), "history": dict(return_full_process_images=True)}[option]
    kw = dict(max_inference_steps=STEPS, guidance_scale=4.0, seed=SEED, **extra)
    t2i = tpipe.generate(*_embeds(x), height=16, width=16, **kw)
    i2i = tpipe.generate(*_embeds(x), init_image=x["img"], strength=1.0, **kw)
    np.testing.assert_array_equal(i2i.images, t2i.images)
    np.testing.assert_array_equal(i2i.sigmas, t2i.sigmas)
    if option == "history":
        np.testing.assert_array_equal(i2i.history_images, t2i.history_images)


def test_per_row_seeds_are_batch_one_draws(world):
    """``seed=[s0, s1]`` draws row i as a batch-1 call with s_i does (the
    engines' latents): each row equals its batch-1 generate."""
    _, tpipe, x = world
    kw = dict(guidance_scale=None, max_inference_steps=STEPS, decode=False, strength=0.7)
    both = tpipe.generate(t(x["pe"]), t(x["pp"]), init_image=x["img"], seed=[3, 9], **kw)
    for i, s in enumerate((3, 9)):
        one = tpipe.generate(t(x["pe"][i:i + 1]), t(x["pp"][i:i + 1]),
                             init_image=x["img"][i:i + 1], seed=s, **kw)
        close(both.images[i:i + 1], one.images)
        np.testing.assert_array_equal(both.last_valid_index[i], one.last_valid_index[0])
    with pytest.raises(ValueError, match="3 seeds for a batch of 2"):
        tpipe.generate(t(x["pe"]), t(x["pp"]), init_image=x["img"], seed=[1, 2, 3], **kw)


def test_rectangular_img2img(world):
    _, tpipe, x = world
    img = np.random.default_rng(2).integers(0, 256, (2, 8, 16, 3), dtype=np.uint8)
    res = tpipe.generate(t(x["pe"]), t(x["pp"]), guidance_scale=None, max_inference_steps=3,
                         init_image=img, strength=0.5)
    assert res.images.shape == (2, 8, 16, 3) and res.images.dtype == np.uint8


def test_validation(world, monkeypatch):
    _, tpipe, x = world
    args = (t(x["pe"]), t(x["pp"]))
    kw = dict(guidance_scale=None, max_inference_steps=2)
    img = x["img"]
    for extra, match in ((dict(latents=torch.zeros(2, 4, 8, 8)), "not both"),
                         (dict(init_sigma=[0.5, 0.5]), "init_sigma is derived"),
                         (dict(strength=0.0), "strength must be"),
                         (dict(strength=[0.5, 1.5]), "strength must be")):
        with pytest.raises(ValueError, match=match):
            tpipe.generate(*args, init_image=img, **extra, **kw)
    with pytest.raises(ValueError, match="batch 1 != prompt batch 2"):
        tpipe.generate(*args, init_image=img[:1], **kw)
    mcfg = tpipe.mmdit.config
    monkeypatch.setattr(tpipe.mmdit, "config", dataclasses.replace(mcfg, seq_group=object()))
    with pytest.raises(NotImplementedError, match=r"14\(g\)"):
        tpipe.generate(*args, init_image=img, **kw)
    monkeypatch.setattr(tpipe.mmdit, "config", mcfg)
    no_vae = TPDMPipeline(tpipe.mmdit, tpipe.tpm, None, min_sigma=MIN_SIGMA)
    with pytest.raises(ValueError, match="no VAE encoder"):
        no_vae.generate(*args, init_image=img, **kw)
