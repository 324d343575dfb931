"""The ported K1 studies (``tpdm_tpu_torch/experiments``) against the JAX
studies (``experiments/attn_*.py``) on the same inputs, on the CPU.

The JAX side runs unchanged, its ``pl.pallas_call`` in interpret mode and
its modules' shape constants (B, H, N, C) shrunk to one batch of two
heads; each JAX output is computed once, in a module fixture. The port
runs the kernels' plain versions, as a CPU tensor makes it do. Inputs are
fp32 numpy draws from a seed, so the comparison is of the algorithms: fp32
at the port's tolerance (``_torch_parity.close``), the bf16-softmax modes
(vTb, vTc, vTmc) at 1e-2 of max |ref| (both round s and s - m to bf16 and
take exp2 in bf16 as exp(x * ln 2), at maxima taken over other chunks),
and ``_quant_rows`` bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import experiments.attn_block_layout as j_block_layout
import experiments.attn_kernel_floor as j_kernel_floor
import experiments.attn_layout as j_layout
import experiments.attn_natural_operands as j_natural
import experiments.attn_nocopy as j_nocopy
import experiments.attn_overlap as j_overlap
import experiments.attn_round3 as j_round3
import experiments.attn_round3b as j_round3b
import experiments.attn_round4 as j_round4
import experiments.attn_transpose_cost as j_transpose_cost
import experiments.attn_variants as j_variants
from _torch_parity import close, t
from tpdm_tpu_torch.experiments import (
    attn_block_layout,
    attn_kernel_floor,
    attn_layout,
    attn_natural_operands,
    attn_nocopy,
    attn_overlap,
    attn_round3,
    attn_round3b,
    attn_round4,
    attn_transpose_cost,
    attn_variants,
)
from tpdm_tpu_torch.ops.attention_studies import attention_probe_reference

B, H, D = 1, 2, 64
N = 256  # the transposed studies' n (a multiple of 128)
N_Q, N_KV, KV_LEN = 200, 250, 245  # ragged: kv padded to 256, the pad masked
C = H * D
BF16_REL = 1e-2
BF16 = jnp.bfloat16

_PALLAS_CALL = pl.pallas_call


def _interpret(*args, **kwargs):
    kwargs["interpret"] = True
    return _PALLAS_CALL(*args, **kwargs)


def _draw(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    d = dict(
        q=_draw(rng, B, H, N_Q, D), k=_draw(rng, B, H, N_KV, D), v=_draw(rng, B, H, N_KV, D),
        qn=_draw(rng, B, H, N, D), kn=_draw(rng, B, H, N, D), vn=_draw(rng, B, H, N, D),
        x=_draw(rng, B, N, C), w=[_draw(rng, C, C, scale=0.05) for _ in range(4)],
    )
    bh = B * H
    d["qt"] = (np.swapaxes(d["qn"], -1, -2).reshape(bh, D, N) * 0.18).astype(np.float32)
    d["k3"] = d["kn"].reshape(bh, N, D)
    vt = np.swapaxes(d["vn"], -1, -2).reshape(bh, D, N)
    extra = np.zeros((bh, 16, N), np.float32)
    extra[:, 0] = 1.0
    d["vt_ext"] = np.concatenate([vt, extra], axis=1)
    d["q2"], d["k2"], d["v2"] = (np.swapaxes(d[n], 1, 2).reshape(B, N, C)
                                 for n in ("qn", "kn", "vn"))
    return d


def _jax_outputs(d):
    """Every JAX study function's output on ``d`` (shrunk constants,
    interpret mode)."""
    j = {n: jnp.asarray(d[n]) for n in d if n != "w"}
    w = [jnp.asarray(a) for a in d["w"]]
    q, k, v, qn, kn, vn = (j[n] for n in ("q", "k", "v", "qn", "kn", "vn"))
    tr = (j["qt"], j["k3"], j["vt_ext"])
    runner = lambda kernel: j_overlap.make_runner(kernel, 64, 128)(q, k, v)
    out = {
        "v1": j_variants.attn_v1(q, k, v, KV_LEN, block_q=64),
        "v2": j_variants.attn_v2(q, k, v, KV_LEN, block_q=64, chunk=128),
        "v3": j_variants.attn_v3(q, k, v, KV_LEN, block_q=64, chunk=128),
        "v4": j_variants.attn_v4(q, k, v, None, block_q=64, chunk=128),
        "prefetch": runner(j_overlap._kernel_prefetch),
        "qk_only": runner(j_overlap._kernel_qk_only),
        "noexp": runner(j_overlap._kernel_noexp),
        "kt": j_layout.attn_kt(q, k, v, block_q=64, chunk=128),
        "kt_qkonly": j_layout.attn_kt(q, k, v, block_q=64, chunk=128,
                                      kernel=j_layout._kernel_kt_qkonly),
        "vsum": j_nocopy.attn_vsum(qn, kn, vn, KV_LEN, block_q=128, chunk=128),
        "packed2": j_nocopy.attn_packed2(j["q2"], j["k2"], j["v2"], KV_LEN, block_q=128,
                                         chunk=128),
        "r3_T": j_round3.attn_T(qn, kn, vn, n_block=128, chunk=128),
        "r3_Tb": j_round3.attn_T(qn, kn, vn, n_block=128, chunk=128, score_dtype=BF16),
        "r3_I": j_round3.attn_I(qn, kn, vn, block_q=128, chunk=128),
        "r3_TI": j_round3.attn_TI(qn, kn, vn, n_block=128, chunk=128),
        "r3b_T": j_round3b.attn_T(qn, kn, vn, n_block=128, chunk=128),
        "r3b_Tc": j_round3b.attn_T(qn, kn, vn, n_block=128, chunk=128, soft_dtype=BF16),
        "r3b_Tm": j_round3b.attn_Tm(qn, kn, vn, n_block=128, chunk=128),
        "r3b_Tmc": j_round3b.attn_Tm(qn, kn, vn, n_block=128, chunk=128, soft_dtype=BF16),
        "nat": j_natural.flash_nat(qn, kn, vn, chunk=128),
        "r4_kernel": j_round4.kernel_call(*tr, 128),
        "r4_split": j_round4.split_call(*tr, 64),
        "bl_kernel": j_block_layout._kernel_call(*tr, chunk=128),
        "tc_kernel": j_transpose_cost.kernel_only(*tr, chunk=128),
        "kf_kernel": j_kernel_floor.kernel_call(*tr, 128),
        "kf_inT": j_kernel_floor.kernel_call_inT(jnp.swapaxes(j["qt"], 1, 2), *tr[1:], 128),
        "block_standard": j_natural.block_standard(j["x"], *w),
        "block_nat": j_natural.block_nat(j["x"], *w),
        "block_transposed": j_block_layout.block_transposed(j["x"], *w),
    }
    return {name: np.asarray(a, np.float32) for name, a in out.items()}


@pytest.fixture(scope="module")
def jax_out(data):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", _interpret)
        for mod in (j_nocopy, attn_nocopy):
            mp.setattr(mod, "H", H)
            mp.setattr(mod, "B", B)
        for mod in (j_natural, j_block_layout, j_round4, j_kernel_floor):
            mp.setattr(mod, "B", B)
            mp.setattr(mod, "H", H)
            mp.setattr(mod, "N", N)
        for mod in (j_natural, j_block_layout):
            mp.setattr(mod, "C", C)
        yield _jax_outputs(data)


def _port_calls(d):
    """name -> (the port's call on torch tensors of ``d``, tolerance kind)."""
    p = {n: t(d[n]) for n in d if n != "w"}
    w = [t(a) for a in d["w"]]
    q, k, v, qn, kn, vn = (p[n] for n in ("q", "k", "v", "qn", "kn", "vn"))
    tr = (p["qt"], p["k3"], p["vt_ext"])
    bf = torch.bfloat16
    return {
        "v1": (lambda: attn_variants.attn_v1(q, k, v, KV_LEN), "fp32"),
        "v2": (lambda: attn_variants.attn_v2(q, k, v, KV_LEN), "fp32"),
        "v3": (lambda: attn_variants.attn_v3(q, k, v, KV_LEN), "fp32"),
        "v4": (lambda: attn_variants.attn_v4(q, k, v), "fp32"),
        "prefetch": (lambda: attn_overlap.make_runner("prefetch", 128)(q, k, v), "fp32"),
        "qk_only": (lambda: attn_overlap.make_runner("qk_only", 128)(q, k, v), "fp32"),
        "noexp": (lambda: attn_overlap.make_runner("noexp", 128)(q, k, v), "fp32"),
        "kt": (lambda: attn_layout.attn_kt(q, k, v, 128), "fp32"),
        "kt_qkonly": (lambda: attn_layout.attn_kt(q, k, v, 128, "kt_qkonly"), "fp32"),
        "vsum": (lambda: attn_nocopy.attn_vsum(qn, kn, vn, KV_LEN), "fp32"),
        "packed2": (lambda: attn_nocopy.attn_packed2(p["q2"], p["k2"], p["v2"], KV_LEN), "fp32"),
        "r3_T": (lambda: attn_round3.attn_T(qn, kn, vn), "fp32"),
        "r3_Tb": (lambda: attn_round3.attn_T(qn, kn, vn, bf), "bf16"),
        "r3_I": (lambda: attn_round3.attn_I(qn, kn, vn), "fp32"),
        "r3_TI": (lambda: attn_round3.attn_TI(qn, kn, vn), "fp32"),
        "r3b_T": (lambda: attn_round3b.attn_T(qn, kn, vn), "fp32"),
        "r3b_Tc": (lambda: attn_round3b.attn_T(qn, kn, vn, bf), "bf16"),
        "r3b_Tm": (lambda: attn_round3b.attn_Tm(qn, kn, vn), "fp32"),
        "r3b_Tmc": (lambda: attn_round3b.attn_Tm(qn, kn, vn, bf), "bf16"),
        "nat": (lambda: attn_natural_operands.flash_nat(qn, kn, vn), "fp32"),
        "r4_kernel": (lambda: attn_round4.kernel_call(*tr), "fp32"),
        "r4_split": (lambda: attn_round4.split_call(*tr), "fp32"),
        "bl_kernel": (lambda: attn_block_layout._kernel_call(*tr), "fp32"),
        "tc_kernel": (lambda: attn_transpose_cost.kernel_only(*tr), "fp32"),
        "kf_kernel": (lambda: attn_kernel_floor.kernel_call(*tr), "fp32"),
        "kf_inT": (lambda: attn_kernel_floor.kernel_call_inT(p["qt"].transpose(1, 2), *tr[1:]),
                   "fp32"),
        "block_standard": (lambda: attn_natural_operands.block_standard(p["x"], *w), "fp32"),
        "block_nat": (lambda: attn_natural_operands.block_nat(p["x"], *w), "fp32"),
        "block_transposed": (lambda: attn_block_layout.block_transposed(p["x"], *w), "fp32"),
    }


# the JAX study rows: variants v1-v4, overlap, layout, nocopy, round3 (T,
# Tb, I, TI), round3b (T, Tc, Tm, Tmc), natural operands, round4, block
# layout, transpose cost, kernel floor; then the three attention blocks
ROWS = ["v1", "v2", "v3", "v4", "prefetch", "qk_only", "noexp", "kt", "kt_qkonly", "vsum",
        "packed2", "r3_T", "r3_Tb", "r3_I", "r3_TI", "r3b_T", "r3b_Tc", "r3b_Tm", "r3b_Tmc",
        "nat", "r4_kernel", "r4_split", "bl_kernel", "tc_kernel", "kf_kernel", "kf_inT",
        "block_standard", "block_nat", "block_transposed"]


@pytest.mark.parametrize("row", ROWS)
def test_study_matches_jax(data, jax_out, row):
    call, kind = _port_calls(data)[row]
    ours = call()
    ref = jax_out[row]
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    if kind == "bf16":
        err = np.abs(ours.numpy() - ref).max()
        assert err <= BF16_REL * np.abs(ref).max(), (err, np.abs(ref).max())
    else:
        close(ours, ref)


def test_quant_rows_is_bit_identical():
    rng = np.random.default_rng(3)
    x = _draw(rng, 2, 40, 64, scale=3.0)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-8 floor of the scale
    x[1, 1, :4] = [127.5 / 127, -0.5, 2.5, 1.5]  # halves round to even
    jq, js = j_round3._quant_rows(jnp.asarray(x))
    tq, ts = attn_round3._quant_rows(t(x))
    assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))


STUDIES = [attn_block_layout, attn_kernel_floor, attn_layout, attn_natural_operands,
           attn_nocopy, attn_overlap, attn_round3, attn_round3b, attn_round4,
           attn_transpose_cost, attn_variants]


@pytest.mark.parametrize("study", STUDIES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_study_main_needs_a_card(study, monkeypatch):
    """``python -m tpdm_tpu_torch.experiments.<name>`` times kernels: with
    no CUDA card it raises instead of running anything on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        study.main()


def test_probe_chunk_is_part_of_the_function(data):
    """The probes' chunk sets where they take their columns: another chunk
    gives another output (so the port carries it over)."""
    q, k, v = (t(data[n]) for n in ("q", "k", "v"))
    a = attn_overlap.make_runner("qk_only", 128)(q, k, v)
    b = attn_overlap.make_runner("qk_only", 64)(q, k, v)
    assert not torch.allclose(a, b)
    with pytest.raises(ValueError, match="kind"):
        attn_overlap.make_runner("exp")
    with pytest.raises(ValueError, match="kernel"):
        attn_layout.attn_kt(q, k, v, kernel="kv")


def test_noexp_plain_version_in_fp64_matches_jax(data, jax_out, monkeypatch):
    """The noexp probe's plain version evaluated in fp64 (the one the card
    holds K9's noexp to) computes the JAX probe's function."""
    monkeypatch.setattr(attn_overlap, "attention_probe",
                        functools.partial(attention_probe_reference, dtype=torch.float64))
    q, k, v = (t(data[n]) for n in ("q", "k", "v"))
    ours = attn_overlap.make_runner("noexp", 128)(q, k, v)
    assert ours.dtype == torch.float32
    close(ours, jax_out["noexp"])
