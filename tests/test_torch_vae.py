"""tpdm_tpu_torch VAE against the JAX VAE on the same weights (the encode
path's parity checks are in test_torch_img2img.py)."""

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
    """No parameter is dropped any more: ``vae_from_jax`` carries the
    encoder's tree beside the decoder's, leaf for leaf, and a decoder-only
    VAE refuses to encode."""
    _, variables, tv = models
    from tpdm_tpu_torch.utils.convert import vae_from_jax

    sd = vae_from_jax(variables)
    n_flax = sum(np.size(leaf) for leaf in jax.tree_util.tree_leaves(variables))
    assert {k.split(".")[0] for k in sd} == {"decoder", "encoder"}
    assert set(sd) == set(tv.state_dict())
    assert sum(v.numel() for v in sd.values()) == n_flax
    dec_only = VAE(VAEConfig.toy(latent_channels=4), encoder=False)
    dec_only.load_state_dict({k: v for k, v in sd.items() if k.startswith("decoder.")})
    with pytest.raises(ValueError, match="without an encoder"):
        dec_only.encode(torch.zeros(1, 3, 16, 16))


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
