"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA card: the
kernels have no CPU mode. On a machine with an sm_90a card run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` because the suite's conftest sets up JAX, which this file
does not use.) The first test builds the kernels with nvcc.

Tolerance for the bf16 kernels: atol 2e-2 / rtol 2e-2 on outputs of order
one. Both versions round P to bf16 before the PV product and the output to
bf16 (a relative step of 2^-8 = 0.4 %); they sum in different orders and the
kernel rescales its running sums tile by tile, so a few output ulps apart is
expected and anything wrong in the algorithm is far outside the bound.
"""

import pytest
import torch

from tpdm_tpu_torch.ops.attention import (
    attention_reference,
    flash_attention,
    flash_attention_streaming,
    joint_attention,
)

pytestmark = pytest.mark.cuda

ATOL = RTOL = 2e-2


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(device, b, h, n_q, n_kv, d, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda n: torch.randn(b, h, n, d, generator=g, device=device).to(torch.bfloat16)
    return mk(n_q), mk(n_kv), mk(n_kv)


def _assert_close(out, ref):
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "shape,kv_len",
    [
        ((2, 24, 4480, 4480), 4429),  # SD3 1024 px joint attention
        ((1, 2, 333, 437), None),  # ragged on both axes
        ((2, 3, 64, 64), None),  # one tile
        ((1, 1, 200, 256), 1),  # a single valid kv column
    ],
)
def test_k1_matches_plain(device, shape, kv_len):
    b, h, n_q, n_kv = shape
    q, k, v = _qkv(device, b, h, n_q, n_kv, 64, seed=n_q)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_close(out, attention_reference(q, k, v, kv_len))


def test_k1_mask_with_strongly_negative_scores(device):
    """Masked kv must score like -inf: every valid score ~ -120 here, so a
    zero-filled mask would pull the max to 0 and NaN the row."""
    q, k, v = _qkv(device, 1, 2, 128, 256, 64, seed=20)
    q[..., 0] += 12.0
    k[..., 0] = -80.0
    out = flash_attention(q, k, v, 200)
    ref = attention_reference(q[:, :, :, :], k[:, :, :200], v[:, :, :200])
    _assert_close(out, ref)


@pytest.mark.parametrize(
    "shape,kv_len",
    [
        ((1, 1, 16384, 16384), None),  # SD3 VAE mid block at 1024 px
        ((1, 1, 300, 450), None),
        ((2, 1, 128, 512), 300),
    ],
)
def test_k2_matches_plain(device, shape, kv_len):
    b, h, n_q, n_kv = shape
    q, k, v = _qkv(device, b, h, n_q, n_kv, 512, seed=n_q)
    before = flash_attention_streaming.launches
    out = flash_attention_streaming(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert flash_attention_streaming.launches == before + 1
    _assert_close(out, attention_reference(q, k, v, kv_len))


def test_joint_attention_routes_by_head_dim(device):
    q, k, v = _qkv(device, 1, 1, 64, 64, 64, seed=1)
    before = flash_attention.launches
    joint_attention(q, k, v)
    assert flash_attention.launches == before + 1
    q, k, v = _qkv(device, 1, 1, 64, 64, 512, seed=1)
    before = flash_attention_streaming.launches
    joint_attention(q, k, v)
    assert flash_attention_streaming.launches == before + 1
    q, k, v = _qkv(device, 1, 1, 64, 64, 32, seed=1)
    with pytest.raises(ValueError, match="head_dim 32"):
        joint_attention(q, k, v)


def test_wrappers_raise_on_what_the_kernel_does_not_take(device):
    q, k, v = _qkv(device, 1, 2, 64, 64, 64, seed=2)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_streaming(q, k, v)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, k, v, 0)
