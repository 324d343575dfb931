"""The port's stats contract (K3's plain version), shard merge and ring
attention against the JAX package.

On the CPU, ``flash_attention_with_stats`` runs its plain version; here it is
held against the JAX Pallas kernel in interpret mode and the JAX plain
version. The ring runs in gloo worker processes (``_torch_sp_worker.py``),
started once for the module, and is held against JAX ``make_ring_attention``
on the conftest's virtual CPU devices and against dense attention. K3 itself
is checked on the card in test_torch_cuda.py.

Tolerances are the JAX package's own for the same checks
(tests/test_sp_attention.py): o within 2e-5, log2(l) + m (the frame that
does not depend on where m sits) within rtol 1e-5 / atol 1e-4, the ring
within 3e-5 of dense attention.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_parity import t
from _torch_sp_worker import run_ranks
from tpdm_tpu.ops.attention import (
    attention_reference as jax_attention_reference,
    attention_reference_stats as jax_attention_reference_stats,
    flash_attention_with_stats as jax_flash_attention_with_stats,
    merge_attention_shards as jax_merge_attention_shards,
)
from tpdm_tpu.parallel.sp_attention import make_ring_attention as jax_make_ring_attention
from tpdm_tpu_torch.ops.attention import (
    attention_reference,
    attention_reference_stats,
    flash_attention_with_stats,
    merge_attention_shards,
)
from tpdm_tpu_torch.parallel import seq_group
from tpdm_tpu_torch.parallel.sp_attention import make_ring_attention, shard_valid_counts

O_TOL = dict(rtol=2e-5, atol=2e-5)
LSE_TOL = dict(rtol=1e-5, atol=1e-4)
RING_TOL = dict(rtol=3e-5, atol=3e-5)


def _qkv(seed, b, h, n_q, n_kv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, n, d), np.float32) for n in (n_q, n_kv, n_kv))


def _lse(m, l):
    return np.log2(np.asarray(l)) + np.asarray(m)


@pytest.mark.parametrize(
    "n_q,n_kv,kv_len",
    [(256, 256, None), (200, 384, 333), (128, 300, 1)],
)
def test_stats_match_jax_kernel_and_plain_version(n_q, n_kv, kv_len):
    q, k, v = _qkv(n_q + n_kv, 1, 2, n_q, n_kv, 64)
    before = flash_attention_with_stats.launches
    o, m, l = flash_attention_with_stats(t(q), t(k), t(v), kv_len)
    assert flash_attention_with_stats.launches == before  # the CPU runs the plain version
    assert m.dtype == l.dtype == torch.float32 and m.shape == l.shape == (1, 2, n_q)
    for o_ref, m_ref, l_ref in (
        jax_flash_attention_with_stats(q, k, v, kv_len, interpret=True),
        jax_attention_reference_stats(q, k, v, kv_len),
    ):
        np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **O_TOL)
        np.testing.assert_allclose(_lse(m, l), _lse(m_ref, l_ref), **LSE_TOL)


def test_merge_of_manual_shards_equals_dense_and_jax_merge():
    q, k, v = _qkv(1, 2, 2, 160, 512, 32)
    parts = [attention_reference_stats(t(q), t(k[:, :, i:i + 128]), t(v[:, :, i:i + 128]))
             for i in range(0, 512, 128)]
    stacked = [torch.stack(x) for x in zip(*parts)]
    o = merge_attention_shards(*stacked)
    np.testing.assert_allclose(o.numpy(), attention_reference(t(q), t(k), t(v)).numpy(), **O_TOL)
    ref = jax_merge_attention_shards(*(x.numpy() for x in stacked))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **O_TOL)


def test_shard_valid_counts():
    assert shard_valid_counts(64, 8, 384) == [64] * 6 + [0, 0]
    assert shard_valid_counts(64, 8, 257) == [64] * 4 + [1, 0, 0, 0]
    assert shard_valid_counts(128, 4, 512) == [128] * 4


# name: (ring size, kv_len, what the case stresses)
RING_CASES = {
    "world1": (1, None, None),
    "world2": (2, None, None),
    "world4": (4, None, None),
    # one ring stop sees scores ~25x larger: the running merge must not overflow
    "world4_skewed": (4, None, "skew"),
    # 512 rows over 8 shards of 64: pad inside the last shard; two dead shards;
    # one valid row in shard 4 and three dead shards
    "world8_kv450": (8, 450, None),
    "world8_kv384": (8, 384, None),
    "world8_kv257": (8, 257, None),
    # every valid score ~ -120 (natural units) and a padded last shard
    "world4_kv450_negative": (4, 450, "negative"),
}


def _ring_inputs(name):
    world, kv_len, kind = RING_CASES[name]
    q, k, v = _qkv(len(name), 1, 2, 512, 512, 32)
    if kind == "skew":
        k[:, :, 128:256] *= 25.0
    if kind == "negative":
        q[..., 0] += 12.0
        k[..., 0] = -80.0
    if kv_len is not None:  # pad rows are exact zeros, as the JAX ring requires
        k[:, :, kv_len:] = 0.0
        v[:, :, kv_len:] = 0.0
    return world, kv_len, kind, (q, k, v)


@pytest.fixture(scope="module")
def ring_outputs(tmp_path_factory):
    cases = []
    for name in RING_CASES:
        world, kv_len, _, (q, k, v) = _ring_inputs(name)
        cases.append(dict(name=name, kind="ring", world=world, kv_len=kv_len,
                          q=t(q), k=t(k), v=t(v)))
    per_rank = run_ranks(cases, 8, tmp_path_factory.mktemp("ring"))
    return {name: np.concatenate([r[name]["o"].numpy() for r in per_rank[:RING_CASES[name][0]]],
                                 axis=2)
            for name in RING_CASES}


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_over_gloo_matches_jax_ring_and_dense(ring_outputs, name):
    world, kv_len, kind, (q, k, v) = _ring_inputs(name)
    n = kv_len or q.shape[2]
    out = ring_outputs[name][:, :, :n]
    dense = attention_reference(t(q), t(k), t(v), kv_len).numpy()[:, :, :n]
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, dense, **RING_TOL)
    if kind == "negative":
        # the JAX ring's post-hoc pad correction (l - pad_count * exp2(-m))
        # cancels when every valid score sits far below the pad rows' 0, and
        # its output here is NaN: dense attention is the only reference
        return
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    ring = jax.jit(jax_make_ring_attention(mesh, axis="seq", use_pallas=False, kv_len=kv_len))
    np.testing.assert_allclose(out, np.asarray(ring(q, k, v))[:, :, :n], **RING_TOL)
    np.testing.assert_allclose(dense, np.asarray(jax_attention_reference(q, k, v, kv_len))[:, :, :n],
                               **RING_TOL)


def test_ring_backward_is_not_ported():
    with pytest.raises(NotImplementedError, match=r"item 9\(e\)"):
        make_ring_attention(None, differentiable=True)


def test_seq_group_refuses_a_missing_card_and_unknown_devices(tmp_path):
    missing = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA device"):
        seq_group("cuda", rank=missing, world_size=missing + 1,
                  init_method=f"file://{tmp_path}/store")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        seq_group("tpu")
