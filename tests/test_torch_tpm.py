"""tpdm_tpu_torch TPM against the JAX TPM on the same weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, t, toy_tpm
from tpdm_tpu.models.tpm import reshape_tokens_to_2d as jax_reshape_tokens_to_2d
from tpdm_tpu.models.tpm import TimePredictor as JTimePredictor
from tpdm_tpu_torch.models.tpm import TimePredictor, reshape_tokens_to_2d
from tpdm_tpu_torch.utils.convert import tpm_from_jax


def test_reshape_tokens_to_2d_is_exact():
    x = np.arange(2 * 256 * 6, dtype=np.float32).reshape(2, 256, 6)
    np.testing.assert_array_equal(
        reshape_tokens_to_2d(t(x), 16, 16, 2).numpy(),
        np.asarray(jax_reshape_tokens_to_2d(jnp.asarray(x), 16, 16, 2)),
    )


@pytest.mark.parametrize("size", [8, 40])  # 40: uneven adaptive-pool bins (20 -> 16)
def test_forward_matches(size):
    jt, variables, tt = toy_tpm(in_channels=16, temb_dim=24)
    rng = np.random.default_rng(size)
    x = rng.standard_normal((3, 16, size, size), np.float32)
    temb = rng.standard_normal((3, 24), np.float32)
    ref = jax.jit(jt.apply)(variables, x, temb)
    with torch.no_grad():
        out = tt(t(x), t(temb))
    assert out.dtype == torch.float32 and out.shape == (3, 2)
    assert (out > 1.0).all()
    close(out, ref)


def test_param_cap_matches():
    kw = dict(conv_out_channels=4, in_channels=8, temb_dim=8, param_cap=3.0)
    jt = JTimePredictor(**kw)
    variables = jt.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 8)), jnp.zeros((1, 8)))
    tt = TimePredictor(**kw)
    tt.load_state_dict(tpm_from_jax(jax.device_get(variables)))
    rng = np.random.default_rng(3)
    x = 5.0 * rng.standard_normal((2, 8, 8, 8), np.float32)
    temb = rng.standard_normal((2, 8), np.float32)
    with torch.no_grad():
        out = tt(t(x), t(temb))
    assert (out < 1.0 + 3.0).all()
    close(out, jt.apply(variables, x, temb))


def test_init_weights_sets_the_head_bias():
    tt = TimePredictor(conv_out_channels=4, in_channels=8, temb_dim=8,
                       init_alpha=1.0, init_beta=0.55)
    tt.init_weights(torch.Generator().manual_seed(0))
    torch.testing.assert_close(tt.fc2.bias, torch.tensor([1.0, 0.55]))
    assert tt.conv1.bias.abs().max() == 0
