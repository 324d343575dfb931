"""tpdm_tpu_torch VAE decoder against the JAX VAE on the same weights."""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import close, t, toy_vae
from tpdm_tpu_torch.models.vae import VAE, VAEConfig


@pytest.fixture(scope="module")
def models():
    return toy_vae(latent_channels=4)


def test_decode_matches(models):
    jv, variables, tv = models
    z = np.random.default_rng(0).standard_normal((2, 4, 8, 8), np.float32)
    ref = jax.jit(lambda v, z: jv.apply(v, z, method="decode"))(variables, z)
    with torch.no_grad():
        out = tv.decode(t(z))
    assert out.shape == (2, 3, 16, 16)
    close(out, ref)


def test_encoder_parameters_are_dropped(models):
    _, variables, tv = models
    from tpdm_tpu_torch.utils.convert import vae_from_jax

    sd = vae_from_jax(variables)
    assert all(k.startswith("decoder.") for k in sd)
    assert set(sd) == set(tv.state_dict())


def test_bf16_decode_keeps_fp32_statistics_and_stays_close(models):
    """The fast-decode policy: bf16 weights and convs, GroupNorm statistics
    in fp32, output in bf16."""
    _, _, tv = models
    bf16 = VAE(VAEConfig.toy(latent_channels=4))
    bf16.load_state_dict(tv.state_dict())
    bf16.to(torch.bfloat16)
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 4, 8, 8), np.float32))
    with torch.no_grad():
        ref = tv.decode(z)
        out = bf16.decode(z)
    assert out.dtype == torch.bfloat16
    # bf16 convs over a toy decoder: a few bf16 steps (2^-8) of the output scale
    close(out.float(), ref, rtol=5e-2, atol=5e-2)
