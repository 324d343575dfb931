"""tpdm_tpu_torch quantised dense layers against the JAX package's
``tpdm_tpu/ops/quant.py``, and the quantised toy MMDiT against the JAX one
on the same prequantised weights.

Tolerances: weight quantisation is bit-identical (the same fp32 absmax,
division and round-half-to-even); the single-op matmuls are held to the
repo's fp32 bound (rtol 1e-4 / atol 1e-5, ``_torch_parity.close``), since
identical inputs give identical int8 operands and an exact accumulator.
Through the toy MMDiT an upstream fp32 drift of ~1e-6 can move one
activation across a rounding boundary, which shifts a product by one int8
level (1/127 of its row's absmax), so the whole model is held to 2e-3 of
each output's range instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, t, toy_mmdit
from tpdm_tpu.models.mmdit import MMDiT as JMMDiT, MMDiTConfig as JMMDiTConfig
from tpdm_tpu.ops import quant as jq
from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from tpdm_tpu_torch.ops import quant as tq
from tpdm_tpu_torch.ops.gemm import (
    bf16_gemm,
    bf16_gemm_reference,
    int8_gemm,
    int8_gemm_reference,
)
from tpdm_tpu_torch.utils.convert import mmdit_from_jax

MODEL_REL_TOL = 2e-3


def _weight(rng, in_f, out_f, levels):
    """(in, out) fp32 kernel: column 0 all zero (the 1e-8 clip), column 1
    exact .5 ties (max |w| = levels / 2^k, so scale = 2^-k exactly and
    w / scale lands on n + 0.5), the rest N(0, 1)."""
    k = rng.standard_normal((in_f, out_f)).astype(np.float32)
    k[:, 0] = 0.0
    ties = (rng.integers(-levels, levels, in_f) + 0.5).astype(np.float32)
    ties[0] = levels  # the column's absmax
    k[:, 1] = ties / 8.0
    return k


@pytest.mark.parametrize(
    "bits,in_f,group",
    [(8, 256, None), (4, 256, 128), (4, 96, 96)],  # int8; int4 in groups of 128; whole column
    ids=["int8", "int4-group128", "int4-whole-column"],
)
def test_quantize_weight_bit_identical_to_jax(bits, in_f, group):
    k = _weight(np.random.default_rng(bits + in_f), in_f, 40, 127 if bits == 8 else 7)
    w = t(np.ascontiguousarray(k.T))
    if bits == 8:
        ref, ours = jq.quantize_weight(jnp.asarray(k)), tq.quantize_weight(w)
        q = ours.weight_q
    else:
        assert tq._w4_group(in_f) == jq._w4_group(in_f) == group
        ref, ours = jq.quantize_weight_w4(jnp.asarray(k)), tq.quantize_weight_w4(w)
        assert ours.weight_q.dtype == torch.uint8 and ours.weight_q.shape == (40, in_f // 2)
        q = tq.unpack_int4(ours.weight_q)
        assert ours.scale.shape == (in_f // group, 40)
    ref_q = np.asarray(ref.kernel_q).astype(np.int8).T
    assert np.abs(ref_q[:, 1]).max() > 0 and not ref_q[0].any()  # ties and the zero column
    np.testing.assert_array_equal(q.numpy(), ref_q)
    assert ours.scale.dtype == torch.float32
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))


@pytest.mark.parametrize("op", ["int8_dynamic_matmul", "w8_matmul", "w4_matmul"])
def test_quantised_matmuls_match_jax(op):
    rng = np.random.default_rng(3)
    k = rng.standard_normal((256, 96)).astype(np.float32) * 0.2
    b = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    if op == "w4_matmul":
        qj = jq.quantize_weight_w4(jnp.asarray(k), jnp.asarray(b))
        qt = tq.quantize_weight_w4(t(np.ascontiguousarray(k.T)), t(b))
    else:
        qj = jq.quantize_weight(jnp.asarray(k), jnp.asarray(b))
        qt = tq.quantize_weight(t(np.ascontiguousarray(k.T)), t(b))
    out = getattr(tq, op)(t(x), qt)
    assert out.shape == (3, 5, 96) and out.dtype == torch.float32
    close(out, getattr(jq, op)(jnp.asarray(x), qj))


@pytest.mark.parametrize("epilogue", ["int32", "dequant"])
def test_int8_gemm_reference_is_exact(epilogue):
    """The plain K4 against numpy: the int64 product, and the dequant
    epilogue formed in fp32 in the same order (IEEE, so bit for bit)."""
    rng = np.random.default_rng(5)
    a = rng.integers(-128, 128, (33, 96), dtype=np.int8)
    b_t = rng.integers(-128, 128, (17, 96), dtype=np.int8)
    acc = a.astype(np.int64) @ b_t.astype(np.int64).T
    if epilogue == "int32":
        out = int8_gemm_reference(t(a), t(b_t))
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), acc)
        return
    xs = rng.uniform(0.01, 0.1, 33).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, 17).astype(np.float32)
    bias = rng.standard_normal(17).astype(np.float32)
    out = int8_gemm_reference(t(a), t(b_t), t(xs), t(ws), t(bias), out_dtype=torch.float32)
    ref = acc.astype(np.float32) * xs[:, None] * ws[None, :] + bias
    np.testing.assert_array_equal(out.numpy(), ref)


def test_gemm_wrappers_run_the_plain_version_on_cpu():
    rng = np.random.default_rng(6)
    a, b_t = (t(rng.integers(-127, 128, s, dtype=np.int8)) for s in ((5, 64), (7, 64)))
    x, w = (t(rng.standard_normal(s).astype(np.float32)) for s in ((5, 48), (7, 48)))
    before = (int8_gemm.launches, bf16_gemm.launches)
    assert torch.equal(int8_gemm(a, b_t), int8_gemm_reference(a, b_t))
    assert torch.equal(bf16_gemm(x, w), bf16_gemm_reference(x, w))
    assert (int8_gemm.launches, bf16_gemm.launches) == before


def test_dense_maybe_quant_scale_stays_fp32_and_int_weight_needs_quant():
    layer = tq.DenseMaybeQuant(256, 64, bits=4)
    layer.quantize_()
    scale = layer.weight_scale.clone()
    assert layer.weight.dtype == torch.uint8 and layer.weight.nbytes == 64 * 256 // 2
    layer.to(torch.bfloat16)
    layer.half()
    assert layer.weight_scale.dtype == torch.float32 and torch.equal(layer.weight_scale, scale)
    assert layer.weight.dtype == torch.uint8 and layer.bias.dtype == torch.float16
    with pytest.raises(RuntimeError, match="weight_scale"):
        torch.nn.Linear(256, 64).load_state_dict(layer.state_dict())


@pytest.fixture(scope="module")
def toy():
    """The toy JAX MMDiT's perturbed float params (one init), the JAX
    quant models' prequantised trees at bits 8 and 4 (through JAX's own
    fit_quant_params + prequantize_params), and seeded inputs."""
    jm, variables, _ = toy_mmdit(seed=0)
    c = jm.config
    rng = np.random.default_rng(7)
    inputs = (
        rng.standard_normal((2, c.in_channels, c.sample_size, c.sample_size), np.float32),
        np.array([1000.0, 437.5], np.float32),
        rng.standard_normal((2, 6, c.joint_attention_dim), np.float32),
        rng.standard_normal((2, c.pooled_projection_dim), np.float32),
    )
    worlds = {}
    for bits in (8, 4):
        jqm = JMMDiT(dataclasses.replace(c, quant_matmuls=True, quant_bits=bits))
        shapes = jax.eval_shape(jqm.init, jax.random.PRNGKey(0), *inputs)["params"]
        qparams = jq.prequantize_params(jq.fit_quant_params(variables["params"], shapes))
        worlds[bits] = (jqm, qparams)
    return variables, worlds, inputs


def _quant_cfg(bits):
    return MMDiTConfig.toy(quant_matmuls=True, quant_bits=bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_mmdit_matches_jax(toy, bits):
    """The converted prequantised JAX tree, and the float tree loaded then
    prequantize_d, give the same int tensors, and the port's forward
    (prequantised, and quantising in-graph) follows JAX's within
    MODEL_REL_TOL of each output's range."""
    variables, worlds, inputs = toy
    jqm, qparams = worlds[bits]
    ref = jax.jit(jqm.apply)({**variables, "params": qparams}, *inputs)
    cfg = _quant_cfg(bits)
    pre = MMDiT(cfg)
    pre.load_state_dict(mmdit_from_jax({"params": qparams}, cfg))
    ingraph = MMDiT(cfg)
    ingraph.load_state_dict(mmdit_from_jax(variables, cfg))
    ours = MMDiT(cfg)
    ours.load_state_dict(ingraph.state_dict())
    tq.prequantize_(ours)
    int_dtype = torch.int8 if bits == 8 else torch.uint8
    sd_pre, sd_ours = pre.state_dict(), ours.state_dict()
    n_int = 0
    for name, v in sd_pre.items():
        assert torch.equal(sd_ours[name], v), name
        n_int += v.dtype == int_dtype
    assert n_int == 12 + 9  # 12 quantised matmuls in the first block, 9 in the last
    for model in (pre, ingraph):
        with torch.no_grad():
            out = model(*(t(a) for a in inputs))
        for o, r in zip(out, ref):
            r = np.asarray(r)
            rel = float(np.abs(o.numpy() - r).max() / np.abs(r).max())
            assert rel <= MODEL_REL_TOL, (bits, rel)


@pytest.mark.parametrize("fault", ["scale missing", "scale misshapen", "int weight misshapen",
                                   "int weight into a float model",
                                   "float weight into a prequantised model"])
def test_bad_quantised_tree_raises(toy, fault):
    variables, worlds, _ = toy
    sd = mmdit_from_jax({"params": worlds[8][1]}, _quant_cfg(8))
    key = "transformer_blocks.0.ff.proj_in.weight"
    model = MMDiT(_quant_cfg(8))
    if fault == "scale missing":
        del sd[key + "_scale"]
    elif fault == "scale misshapen":
        sd[key + "_scale"] = sd[key + "_scale"][:-1]
    elif fault == "int weight misshapen":
        sd[key] = sd[key][:, :-2]
    elif fault == "int weight into a float model":
        model = MMDiT(MMDiTConfig.toy())
    else:
        sd = mmdit_from_jax(variables, _quant_cfg(8))
        tq.prequantize_(model)
    with pytest.raises((ValueError, RuntimeError), match="weight"):
        model.load_state_dict(sd)


def test_quant_with_seq_group_is_refused():
    """No parity check covers quantised matmuls under sequence parallelism
    yet, so the model refuses the pair instead of running it unchecked."""
    with pytest.raises(NotImplementedError, match="13"):
        MMDiT(MMDiTConfig.toy(quant_matmuls=True, seq_group=object()))
