"""Inpainting in tpdm_tpu_torch against the JAX package: the mask's
downsample to the latent grid, the per-step projection and the final
composite of ``generate(init_image, strength, mask)``.

Follows ``tests/test_inpaint.py`` case for case on one module-scoped toy
world (``drawn_models`` and the closed-form TPM of
``test_torch_text_encoders.py``). The whole-path check runs JAX's own
``generate(init_image=, mask=)`` with its noise draw replaced, for that
call only, by the port's draw, so both sides mix, project and composite the
same numbers; no JAX file changes.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, drawn_models, t
from test_torch_text_encoders import MIN_SIGMA, _jax_tpm, _torch_tpm
from tpdm_tpu.pipeline.pipeline import TPDMPipeline as JTPDMPipeline
from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline, latent_mask, seed_noise

STEPS = 6
SEED = 5


@pytest.fixture(scope="module")
def world():
    models = drawn_models(7, tpm=False)
    jm, mv, tm = models["mmdit"]
    jv, vv, tv = models["vae"]
    jtpm = types.SimpleNamespace(apply=lambda params, h, temb: _jax_tpm(h, temb))
    jpipe = JTPDMPipeline(jm, mv, jtpm, {}, jv, vv, min_sigma=MIN_SIGMA)
    tpipe = TPDMPipeline(tm, _torch_tpm, tv, min_sigma=MIN_SIGMA)
    c = tm.config
    rng = np.random.default_rng(12)
    b, px = 2, 2 * c.sample_size  # the toy VAE's factor 2
    x = dict(pe=rng.standard_normal((b, 5, c.joint_attention_dim), np.float32),
             pp=rng.standard_normal((b, c.pooled_projection_dim), np.float32),
             img=rng.integers(0, 256, (b, px, px, 3), dtype=np.uint8))
    return jpipe, tpipe, x


def _kw(x, **extra):
    return dict(prompt_embeds=t(x["pe"]), pooled_prompt_embeds=t(x["pp"]), guidance_scale=None,
                max_inference_steps=STEPS, seed=SEED, decode=False, **extra)


def _hard_mask(b, h, w, seed):
    """A binary mask of one random rectangle per sample, its edges off the
    8-pixel grid."""
    rng = np.random.default_rng(seed)
    m = np.zeros((b, 1, h, w), np.float32)
    for i in range(b):
        y0, x0 = rng.integers(1, h // 2, 2) | 1, rng.integers(1, w // 2, 2) | 1
        m[i, :, y0[0]:y0[0] + h // 2 + 3, x0[0]:x0[0] + w // 3 + 5] = 1.0
    return m


@pytest.mark.parametrize("hw,lat", [((64, 64), (8, 8)), ((128, 96), (16, 12)),
                                    ((1024, 1024), (128, 128)), ((16, 16), (8, 8))])
def test_mask_downsample_matches_jax_image_resize(hw, lat):
    """The latent mask is JAX's ``jax.image.resize(method="linear")`` (an
    antialiased triangle filter, not an area mean), clipped to [0, 1]."""
    m = _hard_mask(2, *hw, seed=hw[0] + hw[1])
    ref = jnp.clip(jax.image.resize(jnp.asarray(m), (2, 1) + lat, method="linear"), 0.0, 1.0)
    out = latent_mask(torch.from_numpy(m), lat, "cpu")
    assert out.shape == (2, 1) + lat
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_inpaint_matches_jax(world, monkeypatch):
    """generate(init_image, strength, mask) against JAX's on the port's
    noise: the projection every step and the final composite."""
    jpipe, tpipe, x = world
    img = x["img"]
    m = _hard_mask(2, *img.shape[1:3], seed=3)[:, 0]
    out = tpipe.generate(**_kw(x, init_image=img, strength=0.8, mask=m))
    eps = seed_noise(SEED, (2, 16, 8, 8), "cpu", torch.float32)[1].numpy()
    real_normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        jnp.asarray(eps, dtype) if tuple(shape) == eps.shape else real_normal(key, shape, dtype)))
    ref = jpipe.generate(x["pe"], x["pp"], guidance_scale=None, max_inference_steps=STEPS,
                         seed=SEED, decode=False, init_image=img, strength=0.8, mask=m)
    monkeypatch.setattr(jax.random, "normal", real_normal)
    assert 1 <= out.num_steps == ref.num_steps < STEPS
    np.testing.assert_array_equal(out.last_valid_index, ref.last_valid_index)
    close(out.sigmas, ref.sigmas)
    close(out.images, ref.images)


def test_all_ones_mask_equals_plain_img2img(world):
    _, tpipe, x = world
    img = x["img"]
    plain = tpipe.generate(**_kw(x, init_image=img, strength=0.8))
    ones = np.ones((2,) + img.shape[1:3], np.float32)
    masked = tpipe.generate(**_kw(x, init_image=img, strength=0.8, mask=ones))
    np.testing.assert_allclose(masked.images, plain.images, rtol=0, atol=1e-6)


def test_all_zeros_mask_returns_init_latents(world):
    _, tpipe, x = world
    img = x["img"]
    clean = tpipe.encode_image(img).numpy()
    zeros = np.zeros((2,) + img.shape[1:3], np.float32)
    res = tpipe.generate(**_kw(x, init_image=img, strength=1.0, mask=zeros))
    np.testing.assert_array_equal(res.images, clean)


def test_half_mask_keeps_known_half_exactly(world):
    """Where the latent mask is 0 the output is the init latents, bit for
    bit (the final composite); the regenerated half really changed."""
    _, tpipe, x = world
    img = x["img"]
    clean = tpipe.encode_image(img).numpy()
    h = img.shape[1]
    m = np.zeros((2, h, h), np.float32)
    m[:, :, h // 2:] = 1.0  # regenerate the right half, keep the left
    res = tpipe.generate(**_kw(x, init_image=img, strength=1.0, mask=m))
    kept = latent_mask(torch.from_numpy(m[:, None]), clean.shape[-2:], "cpu").numpy() == 0
    kept = np.broadcast_to(kept, clean.shape)
    assert kept[..., : clean.shape[-1] // 2 - 1].all()
    np.testing.assert_array_equal(res.images[kept], clean[kept])
    lw = clean.shape[-1]
    assert np.abs(res.images[..., lw // 2 + 1:] - clean[..., lw // 2 + 1:]).mean() > 1e-3


def test_mask_shapes_accepted(world):
    _, tpipe, x = world
    img = x["img"]
    m3 = np.ones((2,) + img.shape[1:3], np.float32)
    r3 = tpipe.generate(**_kw(x, init_image=img, mask=m3))
    r4 = tpipe.generate(**_kw(x, init_image=img, mask=m3[:, None]))
    np.testing.assert_array_equal(r3.images, r4.images)


def test_validation(world):
    _, tpipe, x = world
    img = x["img"]
    h = img.shape[1]
    for extra, match in ((dict(mask=np.ones((2, h, h))), "requires init_image"),
                         (dict(init_image=img, mask=np.ones((2, 2, h, h))), "mask must be"),
                         (dict(init_image=img, mask=np.ones((2, h // 2, h))), "init_image is")):
        with pytest.raises(ValueError, match=match):
            tpipe.generate(**_kw(x, **extra))


def test_rectangular_inpaint(world):
    _, tpipe, x = world
    img = np.random.default_rng(3).integers(0, 256, (2, 8, 16, 3), dtype=np.uint8)
    m = np.zeros((2, 8, 16), np.float32)
    m[:, :, 8:] = 1.0
    res = tpipe.generate(**_kw(x, init_image=img, strength=1.0, mask=m))
    assert res.images.shape[-2:] == (4, 8)  # the latent grid of 8 x 16 px


def test_soft_mask_blends(world):
    _, tpipe, x = world
    img = x["img"]
    clean = tpipe.encode_image(img).numpy()
    h = img.shape[1]
    full = tpipe.generate(**_kw(x, init_image=img, strength=1.0,
                                mask=np.ones((2, h, h), np.float32)))
    half = tpipe.generate(**_kw(x, init_image=img, strength=1.0,
                                mask=np.full((2, h, h), 0.5, np.float32)))
    # a 0.5 mask pulls the output toward the init latents
    d_full = np.abs(full.images - clean).mean()
    d_half = np.abs(half.images - clean).mean()
    assert 1e-4 < d_half < d_full, (d_half, d_full)
