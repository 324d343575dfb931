"""tpdm_tpu_torch attention on the CPU against the JAX package's kernels.

On CPU tensors the port's K1/K2 wrappers run their plain version
(``attention_reference``); here it is held against the Pallas kernels as the
JAX package's own tests run them, in interpret mode. The kernels themselves
are checked on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from _torch_parity import CPU, close, t
from tpdm_tpu.ops.attention import (
    _flash_attention_streaming_impl,
    flash_attention as jax_flash_attention,
)
from tpdm_tpu_torch.ops import _build
from tpdm_tpu_torch.ops.attention import (
    attention_reference,
    flash_attention,
    flash_attention_streaming,
    joint_attention,
)


def _qkv(seed, b, h, n_q, n_kv, d, strongly_negative=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d), np.float32) for n in (n_q, n_kv, n_kv))
    if strongly_negative:
        # every valid score ~ -120: a zero-filled mask would pull the running
        # max to 0 and underflow every valid exp to 0 (0/0 = NaN)
        q[..., 0] += 12.0
        k[..., 0] = -80.0
    return q, k, v


# strongly negative scores (~ -120) carry ~1e-5 absolute fp32 rounding in the
# exponent; the JAX package's own test of this case uses 2e-4 for that reason
NEG_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize(
    "shape,kv_len,negative",
    [
        ((1, 2, 333, 437), None, False),  # ragged on both axes
        ((1, 1, 128, 256), 200, False),  # kv_len mask
        ((1, 1, 128, 256), 200, True),  # mask with strongly negative scores
        ((1, 1, 128, 200), None, True),  # kernel's own padding, negative scores
    ],
)
def test_k1_plain_matches_jax_kernel(shape, kv_len, negative):
    b, h, n_q, n_kv = shape
    q, k, v = _qkv(n_q + n_kv, b, h, n_q, n_kv, 64, negative)
    ref = jax_flash_attention(q, k, v, kv_len, 128, True)
    out = flash_attention(t(q), t(k), t(v), kv_len)
    assert out.device == CPU and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    close(out, ref, **(NEG_TOL if negative else {}))


@pytest.mark.parametrize(
    "d,n_q,n_kv,kv_len",
    [(64, 300, 450, None), (64, 128, 512, 300), (512, 200, 384, None), (512, 128, 256, 130)],
)
def test_k2_plain_matches_jax_streaming_kernel(d, n_q, n_kv, kv_len):
    q, k, v = _qkv(d + n_q, 1, 1, n_q, n_kv, d)
    ref = _flash_attention_streaming_impl(q, k, v, kv_len, 128, 128, True)
    out = flash_attention_streaming(t(q), t(k), t(v), kv_len)
    close(out, ref)


def test_joint_attention_runs_plain_version_on_cpu():
    q, k, v = _qkv(5, 2, 3, 40, 70, 16)
    out = joint_attention(t(q), t(k), t(v), 50)
    close(out, attention_reference(t(q), t(k)[:, :, :50], t(v)[:, :, :50]))


def test_cpu_wrappers_do_not_count_launches():
    q, k, v = (t(a) for a in _qkv(6, 1, 1, 64, 64, 64))
    before = (flash_attention.launches, flash_attention_streaming.launches)
    flash_attention(q, k, v)
    flash_attention_streaming(q, k, v)
    assert (flash_attention.launches, flash_attention_streaming.launches) == before


def test_build_without_nvcc_raises_naming_it(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library()
    _build.load_library.cache_clear()
