"""The port's sequence-parallel MMDiT against the JAX package.

``MMDiTConfig(seq_group=...)`` shards the image tokens over a group; here a
4-rank gloo group of worker processes (``_torch_sp_worker.py``, started once
for the module) runs the toy MMDiT, the adaptive loop and
``TPDMPipeline.generate``, held against the JAX MMDiT with ``seq_mesh`` on
the conftest's virtual CPU devices and against unsharded runs. For the
forward the toy latents are 10 x 10: 25 image tokens over 4 ranks, 7 a
rank, so the last shard carries 3 pad rows (and the JAX joint length
25 + 6 = 31 pads to 32). The loop's TPM reads the token grid in 2 x 2
patches, so its grid is even and 4 ranks would need no pad: the loop runs
8 x 8 latents on the first 3 ranks, 16 tokens as 6 + 6 + 4 and 2 pad rows.

Tolerances: the MMDiT's outputs with ``_torch_parity``'s fp32 bound across
programs; the adaptive loop as the JAX package's own seq-parallel test
(tests/test_mmdit_seqparallel.py): the same step count, sigmas within
rtol 1e-5 / atol 1e-6, final latents within 5e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_parity import TPM_KW, close, t, toy_mmdit, toy_tpm
from _torch_sp_worker import run_ranks
from tpdm_tpu.models.layers import PatchEmbed as JPatchEmbed, get_2d_sincos_pos_embed_jnp
from tpdm_tpu.pipeline.denoise import make_cfg_denoise_fn as jax_make_cfg_denoise_fn
from tpdm_tpu.pipeline.sampler import SamplerConfig as JSamplerConfig
from tpdm_tpu.pipeline.sampler import adaptive_sample as jax_adaptive_sample
from tpdm_tpu_torch.models.layers import PatchEmbed, get_2d_sincos_pos_embed_fp32
from tpdm_tpu_torch.models.vae import VAE, VAEConfig
from tpdm_tpu_torch.pipeline.denoise import make_cfg_denoise_fn
from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline
from tpdm_tpu_torch.pipeline.sampler import SamplerConfig, adaptive_sample

WORLD = 4
LOOP_WORLD = 3
FORWARD_CFG = dict(sample_size=10)
N_CTX = 6
SAMPLER = dict(max_inference_steps=4, min_sigma=0.01, predict=True, cache_activations=False)
GENERATE = dict(max_inference_steps=4, guidance_scale=7.0, predict=True)
SEED = 5


@pytest.mark.parametrize("latent_hw", [(32, 32), (32, 24)])
def test_patch_embed_regenerates_its_table_past_the_stored_size(latent_hw):
    """A 16 x 16 (or 16 x 12) token grid against a stored 12 x 12 table."""
    rng = np.random.default_rng(sum(latent_hw))
    lat = rng.standard_normal((2, 4, *latent_hw), np.float32)
    kernel = 0.1 * rng.standard_normal((16, 64), np.float32)
    bias = 0.1 * rng.standard_normal(64, np.float32)
    jpe = JPatchEmbed(patch_size=2, embed_dim=64, pos_embed_max_size=12, base_size=4)
    variables = {**jpe.init(jax.random.PRNGKey(0), lat),
                 "params": {"proj": {"kernel": kernel, "bias": bias}}}
    pe = PatchEmbed(2, 4, 64, 12, 4)
    with torch.no_grad():
        pe.proj.weight.copy_(t(kernel.T))
        pe.proj.bias.copy_(t(bias))
        out = pe(t(lat))
    close(out, jpe.apply(variables, lat))
    close(get_2d_sincos_pos_embed_fp32(64, 16, 4), get_2d_sincos_pos_embed_jnp(64, 16, 4))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    fwd_jm, fwd_mvars, fwd_tm = toy_mmdit(seed=0, **FORWARD_CFG)
    jm, mvars, tm = toy_mmdit(seed=0)
    c = tm.config
    jt, tvars, tt = toy_tpm(in_channels=2 * c.inner_dim, temb_dim=c.inner_dim)
    # the generate check compares the port with itself: its VAE needs no JAX twin
    tv = VAE(VAEConfig.toy(latent_channels=c.in_channels))
    tv.init_weights(torch.Generator().manual_seed(2), 0.05).eval()
    rng = np.random.default_rng(7)
    b = 2
    x = dict(
        fwd_lat=rng.standard_normal((b, c.in_channels, 10, 10), np.float32),
        lat=rng.standard_normal((b, c.in_channels, 8, 8), np.float32),
        ts=np.array([1000.0, 437.5], np.float32),
        pe=rng.standard_normal((2 * b, N_CTX, c.joint_attention_dim), np.float32),
        pp=rng.standard_normal((2 * b, c.pooled_projection_dim), np.float32),
        gs=np.array([7.0, 4.0], np.float32),
    )
    loop = dict(world=LOOP_WORLD, mmdit_cfg={}, mmdit=tm.state_dict(), tpm=tt.state_dict(),
                tpm_kw=dict(in_channels=2 * c.inner_dim, temb_dim=c.inner_dim, **TPM_KW))
    embeds = (t(x["pe"][b:]), t(x["pp"][b:]), t(x["pe"][:b]), t(x["pp"][:b]))
    cases = [
        dict(name="mmdit", kind="mmdit", world=WORLD, mmdit_cfg=FORWARD_CFG,
             mmdit=fwd_tm.state_dict(),
             inputs=(t(x["fwd_lat"]), t(x["ts"]), t(x["pe"][:b]), t(x["pp"][:b]))),
        dict(name="sample", kind="sample", **loop, sampler=SAMPLER,
             pe=t(x["pe"]), pp=t(x["pp"]), gs=t(x["gs"]), lat=t(x["lat"])),
        dict(name="generate", kind="generate", **loop, vae=tv.state_dict(),
             vae_cfg=dict(latent_channels=c.in_channels), embeds=embeds, seed=SEED,
             kw=GENERATE),
    ]
    per_rank = run_ranks(cases, WORLD, tmp_path_factory.mktemp("mmdit_sp"))
    return dict(fwd_jm=fwd_jm, fwd_mvars=fwd_mvars, fwd_tm=fwd_tm, jm=jm, mvars=mvars, jt=jt,
                tvars=tvars, tm=tm, tt=tt, tv=tv, x=x, embeds=embeds, per_rank=per_rank)


def test_seq_parallel_forward_matches_jax_seq_mesh_and_unsharded(world):
    jm, mvars, x, per_rank = world["fwd_jm"], world["fwd_mvars"], world["x"], world["per_rank"]
    args = (x["fwd_lat"], x["ts"], x["pe"][:2], x["pp"][:2])
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("seq",))
    jm_sp = type(jm)(dataclasses.replace(jm.config, seq_mesh=mesh))
    ref_sp = jax.jit(jm_sp.apply)(mvars, *args)
    ref = jax.jit(jm.apply)(mvars, *args)
    with torch.no_grad():
        unsharded = world["fwd_tm"](*(t(a) for a in args))
    names = ("velocity", "temb", "h1", "h2")
    for i, name in enumerate(names):
        got = per_rank[0]["mmdit"][name]
        assert got.shape == tuple(ref[i].shape), name
        close(got, ref_sp[i])
        close(got, ref[i])
        close(got, unsharded[i])
        for other in per_rank[1:]:  # every rank ends with the same whole tensors
            assert torch.equal(other["mmdit"][name], got), name


def test_seq_parallel_adaptive_sample_matches_jax_and_unsharded(world):
    x, per_rank = world["x"], world["per_rank"]
    jm, mvars, jt, tvars = world["jm"], world["mvars"], world["jt"], world["tvars"]
    c = world["tm"].config
    grid, p = c.sample_size // c.patch_size, c.patch_size
    jden = jax_make_cfg_denoise_fn(lambda *a: jm.apply(mvars, *a), x["pe"], x["pp"], x["gs"],
                                   grid, p)
    ref = jax.jit(lambda lat: jax_adaptive_sample(
        jden, lambda h, tb: jt.apply(tvars, h, tb), lat, jax.random.PRNGKey(0),
        JSamplerConfig(**SAMPLER)))(x["lat"])
    tden = make_cfg_denoise_fn(world["tm"], t(x["pe"]), t(x["pp"]), t(x["gs"]), grid, p)
    unsharded = adaptive_sample(tden, world["tt"], t(x["lat"]), None, SamplerConfig(**SAMPLER))
    got = per_rank[0]["sample"]
    assert got["num_steps"] == int(ref.num_steps) == unsharded.num_steps
    for other in (np.asarray(ref.sigmas), unsharded.sigmas.numpy()):
        np.testing.assert_allclose(got["sigmas"].numpy(), other, rtol=1e-5, atol=1e-6)
    for other in (np.asarray(ref.final_latents), unsharded.final_latents.numpy()):
        np.testing.assert_allclose(got["final_latents"].numpy(), other, rtol=5e-4, atol=5e-4)
    for r in per_rank[1:LOOP_WORLD]:
        assert r["sample"]["num_steps"] == got["num_steps"]
        assert torch.equal(r["sample"]["sigmas"], got["sigmas"])
        assert torch.equal(r["sample"]["final_latents"], got["final_latents"])


def test_seq_parallel_generate_matches_unsharded(world):
    """Every rank asks with another seed; rank 0's latents are broadcast, so
    every rank returns the images of rank 0's seed."""
    per_rank = world["per_rank"]
    ref = TPDMPipeline(world["tm"], world["tt"], world["tv"], min_sigma=0.01).generate(
        *world["embeds"], seed=SEED, **GENERATE)
    got = per_rank[0]["generate"]
    assert got["num_steps"] == ref.num_steps
    close(got["sigmas"], ref.sigmas)
    images = got["images"].numpy()
    assert images.dtype == np.uint8 and images.shape == ref.images.shape
    diff = np.abs(images.astype(np.int16) - ref.images.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    for r in per_rank[1:LOOP_WORLD]:
        assert torch.equal(r["generate"]["images"], got["images"])
