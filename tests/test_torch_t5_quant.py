"""The weight-only int8 / int4 T5 tower (``models/t5.py`` with
``quant_matmuls``, ``ops/quant.py:DenseMaybeQuant(bias=False)``, ``serve
--quant_text``) against the JAX package, on the CPU at toy size.

The float toy T5 is drawn by ``_torch_parity.random_variables``; JAX
quantises it with its own ``fit_quant_params`` + ``prequantize_params``
and runs the quantised tower compiled; the port loads JAX's prequantised
tree through ``t5_from_jax`` (strictly: no biases) and, apart, quantises
the float tree itself with ``prequantize_``. The int tensors are held
bit for bit, the last hidden state to the fp32 bound (weight-only: the
dequantised weights are the same numbers on both sides and the
activations stay fp32). ``load_pipeline_from_pretrained(quant_text=True)``
is held in ``test_torch_pretrained.py``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, random_variables, t
from tpdm_tpu.models.t5 import T5Config as JT5Config, T5Encoder as JT5Encoder
from tpdm_tpu.ops import quant as jq
from tpdm_tpu_torch import serve
from tpdm_tpu_torch.models.t5 import T5Config, T5Encoder
from tpdm_tpu_torch.ops import quant as tq
from tpdm_tpu_torch.utils.convert import t5_from_jax
from tpdm_tpu_torch.utils.image import read_png

N, B = 12, 2


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 120, (B, N)).astype(np.int32)
    mask = np.ones((B, N), bool)
    mask[1, 9:] = False
    jm = JT5Encoder(JT5Config.toy())
    variables = random_variables(jm.init, 3, jnp.zeros((1, N), jnp.int32))
    return ids, mask, variables


@pytest.mark.parametrize("bits", [8, 4])
def test_quantised_t5_matches_jax(inputs, bits):
    """JAX's prequantised tower through ``t5_from_jax`` equals the port's
    own quantisation of the float tree bit for bit, and its forward JAX's
    quantised forward to the fp32 bound; 7 weight-only matmuls a block."""
    ids, mask, variables = inputs
    jqm = JT5Encoder(JT5Config.toy(quant_matmuls=True, quant_bits=bits))
    shapes = jax.eval_shape(jqm.init, jax.random.PRNGKey(0), jnp.zeros((1, N), jnp.int32))
    qparams = jq.prequantize_params(jq.fit_quant_params(
        jax.tree.map(jnp.asarray, variables["params"]), shapes["params"]))
    ref = np.asarray(jax.jit(jqm.apply)({"params": qparams}, ids, mask))
    cfg = T5Config.toy(quant_matmuls=True, quant_bits=bits)
    ours = T5Encoder(cfg)
    ours.load_state_dict(t5_from_jax(jax.device_get({"params": qparams})))
    own = T5Encoder(cfg)
    own.load_state_dict(t5_from_jax(jax.tree.map(np.asarray, variables)))
    tq.prequantize_(own)
    sd = own.state_dict()
    int_dtype = torch.int8 if bits == 8 else torch.uint8
    quantised = [k for k, v in ours.state_dict().items() if v.dtype == int_dtype]
    assert len(quantised) == 7 * cfg.num_layers
    dense = [m for m in own.modules() if isinstance(m, tq.DenseMaybeQuant)]
    assert len(dense) == 7 * cfg.num_layers and all(m.bias is None for m in dense)
    for k, v in ours.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with torch.no_grad():
        close(ours.eval()(t(ids).long(), t(mask)), ref)
        float_t5 = T5Encoder(T5Config.toy())
        float_t5.load_state_dict(t5_from_jax(jax.tree.map(np.asarray, variables)))
        assert not torch.allclose(float_t5(t(ids).long(), t(mask)), t(ref))


def test_bias_free_dense_loads_strictly():
    """``DenseMaybeQuant(bias=False)``: no bias parameter, a state dict with
    one is refused, and its quantised products equal the plain ones on
    the dequantised weight."""
    layer = tq.DenseMaybeQuant(64, 32, bits=8, act_quant=False, bias=False)
    assert layer.bias is None and set(layer.state_dict()) == {"weight"}
    with pytest.raises(RuntimeError, match="bias"):
        layer.load_state_dict({"weight": torch.zeros(32, 64), "bias": torch.zeros(32)})
    x = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(0))
    for bits in (8, 4):
        q = tq.DenseMaybeQuant(64, 32, bits=bits, act_quant=False, bias=False)
        q.load_state_dict(layer.state_dict())
        want = q(x)
        q.quantize_()
        assert set(q.state_dict()) == {"weight", "weight_scale"}
        torch.testing.assert_close(q(x), want, rtol=0, atol=0)


def test_serve_toy_quant_text_is_not_a_no_op(tmp_path, monkeypatch):
    """``serve --toy --quant_text`` stores the T5 tower's matmuls int8 (int4
    with --int4) and encodes through them, 7 weight-only products a block
    on every encode, near the float tower's embeds; the CLI writes its
    image; a family without a T5 tower refuses the flag."""
    calls = []
    plain = tq.bf16_gemm
    monkeypatch.setattr(tq, "bf16_gemm", lambda a, b: calls.append(a.shape) or plain(a, b))
    base, tokenize = serve.build_pipeline(argparse.Namespace(toy=True, cpu=True))
    c, t5_ids = tokenize("a cat")
    want = base.text_encoders.encode(c, t5_ids)[0]
    for flags, int_dtype in (({}, torch.int8), ({"int4": True}, torch.uint8)):
        pipe, _ = serve.build_pipeline(argparse.Namespace(toy=True, cpu=True, quant_text=True,
                                                          **flags))
        t5 = pipe.text_encoders.t5
        assert t5.block[0].attention.q.weight.dtype == int_dtype
        assert t5.config.quant_matmuls and t5.config.quant_bits == (4 if flags else 8)
        del calls[:]
        got = pipe.text_encoders.encode(c, t5_ids)[0]
        assert len(calls) == 7 * t5.config.num_layers
        rel = float((got - want).abs().max() / want.abs().max())
        # quantised (not a no-op), and still near the float tower: int4's
        # groups are the toy's whole 96-input columns, so it drifts more
        assert 0 < rel < (0.5 if flags else 0.05), rel
    out = tmp_path / "q.png"
    serve.main(["--toy", "--cpu", "--quant_text", "--cli", "--prompt", "a cat", "--max_steps",
                "3", "--out", str(out)])
    assert read_png(out.read_bytes()).shape[2] == 3
    with pytest.raises(SystemExit, match="has none"):
        serve.main(["--family", "sd15", "--toy", "--cpu", "--quant_text", "--cli",
                    "--out", str(out)])
