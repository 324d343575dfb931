"""tpdm_tpu_torch MMDiT against the JAX MMDiT on the same weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, t, toy_mmdit
from tpdm_tpu.models.layers import (
    get_2d_sincos_pos_embed as jax_pos_embed,
    sinusoidal_timestep_embedding as jax_timestep_embedding,
)
from tpdm_tpu_torch.models.layers import (
    get_2d_sincos_pos_embed,
    sinusoidal_timestep_embedding,
)
from tpdm_tpu_torch.models.mmdit import MMDiTConfig


@pytest.fixture(scope="module")
def models():
    return toy_mmdit(seed=0)


def test_rms_norm_matches():
    from tpdm_tpu.models.layers import RMSNorm as JRMSNorm
    from tpdm_tpu_torch.models.layers import RMSNorm

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 16), np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    norm = RMSNorm(16)
    with torch.no_grad():
        norm.weight.copy_(t(scale))
        out = norm(t(x))
    close(out, JRMSNorm(16).apply({"params": {"scale": scale}}, x))


def test_timestep_embedding_and_pos_table():
    ts = np.array([0.0, 1.5, 250.0, 999.0], np.float32)
    close(sinusoidal_timestep_embedding(t(ts), 256), jax_timestep_embedding(jnp.asarray(ts), 256))
    np.testing.assert_array_equal(get_2d_sincos_pos_embed(64, 12, 4), jax_pos_embed(64, 12, 4))


@pytest.mark.parametrize("n_ctx", [6, 128 - 16])  # 16 + 6 tokens pad to 128; 128 needs no pad
def test_forward_four_tuple_matches(models, n_ctx):
    jm, variables, tm = models
    c = tm.config
    rng = np.random.default_rng(n_ctx)
    lat = rng.standard_normal((2, c.in_channels, c.sample_size, c.sample_size), np.float32)
    ts = np.array([1000.0, 437.5], np.float32)
    ctx = rng.standard_normal((2, n_ctx, c.joint_attention_dim), np.float32)
    pooled = rng.standard_normal((2, c.pooled_projection_dim), np.float32)
    ref = jax.jit(jm.apply)(variables, lat, ts, ctx, pooled)
    with torch.no_grad():
        out = tm(t(lat), t(ts), t(ctx), t(pooled))
    assert [o.shape for o in out] == [tuple(r.shape) for r in ref]
    for o, r in zip(out, ref):
        close(o, r)


def test_sd3_medium_config_matches_the_jax_package():
    from tpdm_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig

    ours, ref = MMDiTConfig.sd3_medium(), JMMDiTConfig.sd3_medium()
    for f in ("sample_size", "patch_size", "num_layers", "attention_head_dim",
              "num_attention_heads", "joint_attention_dim", "caption_projection_dim",
              "pooled_projection_dim", "pos_embed_max_size"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.dtype == torch.bfloat16
