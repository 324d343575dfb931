"""tpdm_tpu_torch's SD3.5 layers against the JAX package: qk RMSNorm,
``AdaLayerNormZeroX``, the image-only ``SelfAttention`` and a toy SD3.5
MMDiT (dual attention in layer 0, qk norm, a sincos table six times the
token grid, as SD3.5-medium's 384 is to its 64), in fp32 and at W8A8 and
int4 against JAX's prequantised tree.

Tolerances: fp32 at the repo's cross-program bound (rtol 1e-4 / atol 1e-5,
scaled as ``_torch_parity.close`` scales it). Weight quantisation is held
bit for bit. The int4 (weight-only) model at ``test_torch_quant.py``'s
2e-3 of each output's range. The W8A8 model at one int8 level, 1/127 of
each output's range: the fp32 drift of ~2e-6 at block 0's q/k/v input
moves one of its 2048 activations across a rounding boundary, a level of
its row's absmax, and SD3.5's attn2 adds four quantised products after it
(measured: 5.0e-3 on the velocity, 5.9e-3 on h2).
Parameters are drawn by ``random_variables`` (no init compile).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, drawn_models, random_variables, t
from tpdm_tpu.models import layers as jl
from tpdm_tpu.models.mmdit import (
    MMDiT as JMMDiT,
    MMDiTConfig as JMMDiTConfig,
    SelfAttention as JSelfAttention,
)
from tpdm_tpu.ops import quant as jq
from tpdm_tpu_torch.models import layers as tl
from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig, SelfAttention
from tpdm_tpu_torch.ops import quant as tq
from tpdm_tpu_torch.utils.convert import _flax_to_state_dict, mmdit_from_jax

MODEL_REL_TOL = {4: 2e-3, 8: 1 / 127}
# the toy's 8 x 8 latents make a 4 x 4 token grid; SD3.5-medium holds a
# 384 x 384 table for its 64 x 64 grid
SD35_TOY = dict(dual_attention_layers=(0,), qk_norm="rms_norm", pos_embed_max_size=24)


def _load(module, variables):
    module.load_state_dict(_flax_to_state_dict(variables))
    return module.eval()


@pytest.mark.parametrize("layer", ["rms_norm_bf16", "ada_layer_norm_zero_x", "self_attention",
                                   "self_attention_no_qk_norm"])
def test_sd35_layer_matches_jax(layer):
    rng = np.random.default_rng(11)
    if layer == "rms_norm_bf16":
        # the qk norm on (b, h, n, d) heads in the card's dtype: the
        # same fp32 statistics, one rounding to bf16 on both sides
        x = rng.standard_normal((2, 4, 7, 16), np.float32)
        scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
        ref = jl.RMSNorm(16).apply({"params": {"scale": scale}},
                                   jnp.asarray(x, jnp.bfloat16))
        norm = tl.RMSNorm(16)
        with torch.no_grad():
            norm.weight.copy_(t(scale))
            out = norm(t(x).to(torch.bfloat16))
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
        return
    if layer == "ada_layer_norm_zero_x":
        x = rng.standard_normal((2, 9, 32), np.float32)
        emb = rng.standard_normal((2, 32), np.float32)
        jm = jl.AdaLayerNormZeroX(32)
        variables = random_variables(jm.init, 3, x, emb)
        ref = jax.jit(jm.apply)(variables, x, emb)
        with torch.no_grad():
            out = _load(tl.AdaLayerNormZeroX(32), variables)(t(x), t(emb))
    else:
        cfg_kw = dict(num_attention_heads=2, attention_head_dim=16,
                      qk_norm=None if layer.endswith("no_qk_norm") else "rms_norm")
        x = rng.standard_normal((2, 12, 32), np.float32)
        jm = JSelfAttention(JMMDiTConfig.toy(**cfg_kw))
        variables = random_variables(jm.init, 4, x)
        ref = (jax.jit(jm.apply)(variables, x),)
        ours = _load(SelfAttention(MMDiTConfig.toy(**cfg_kw)), variables)
        assert hasattr(ours, "norm_q") == (cfg_kw["qk_norm"] is not None)
        with torch.no_grad():
            out = (ours(t(x)),)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        close(o, r)


@pytest.fixture(scope="module")
def toy():
    """The toy SD3.5 JAX MMDiT with drawn parameters, the port's copy, and
    seeded inputs (6 text tokens: the joint length pads to 128)."""
    jm, variables, tm = drawn_models(seed=5, vae=False, tpm=False, **SD35_TOY)["mmdit"]
    c = jm.config
    rng = np.random.default_rng(8)
    inputs = (
        rng.standard_normal((2, c.in_channels, c.sample_size, c.sample_size), np.float32),
        np.array([1000.0, 437.5], np.float32),
        rng.standard_normal((2, 6, c.joint_attention_dim), np.float32),
        rng.standard_normal((2, c.pooled_projection_dim), np.float32),
    )
    return jm, variables, tm, inputs


def test_sd35_mmdit_matches_jax(toy):
    jm, variables, tm, inputs = toy
    # SD3.5's modules where JAX has them: attn2 and a 9-way norm1 in block 0
    block0 = tm.transformer_blocks[0]
    assert block0.use_dual_attention and not tm.transformer_blocks[1].use_dual_attention
    assert block0.norm1.linear.out_features == 9 * tm.config.inner_dim
    # the stored sincos table is JAX's, bit for bit, at six times the grid
    np.testing.assert_array_equal(tm.pos_embed.pos_embed.numpy(),
                                  jl.get_2d_sincos_pos_embed(tm.config.inner_dim, 24, 4))
    ref = jax.jit(jm.apply)(variables, *inputs)
    with torch.no_grad():
        out = tm(*(t(a) for a in inputs))
    assert [o.shape for o in out] == [tuple(r.shape) for r in ref]
    for o, r in zip(out, ref):
        close(o, r)


@pytest.mark.parametrize("bits", [8, 4])
def test_sd35_quant_mmdit_matches_jax(toy, bits):
    """JAX's prequantised SD3.5 tree converted, and the float tree loaded
    and prequantize_d, give the same int tensors (attn2 quantised, the norm
    scales float), and the port's forward follows JAX's."""
    jm, variables, _, inputs = toy
    jqm = JMMDiT(dataclasses.replace(jm.config, quant_matmuls=True, quant_bits=bits))
    shapes = jax.eval_shape(jqm.init, jax.random.PRNGKey(0), *inputs)["params"]
    qparams = jq.prequantize_params(jq.fit_quant_params(variables["params"], shapes))
    ref = jax.jit(jqm.apply)({**variables, "params": qparams}, *inputs)
    cfg = MMDiTConfig.toy(quant_matmuls=True, quant_bits=bits, **SD35_TOY)
    pre = MMDiT(cfg)
    pre.load_state_dict(mmdit_from_jax({"params": qparams}, cfg))
    ours = MMDiT(cfg)
    ours.load_state_dict(mmdit_from_jax(variables, cfg))
    tq.prequantize_(ours)
    int_dtype = torch.int8 if bits == 8 else torch.uint8
    sd_pre, sd_ours = pre.state_dict(), ours.state_dict()
    assert sd_pre.keys() == sd_ours.keys()
    for name, v in sd_pre.items():
        assert torch.equal(sd_ours[name], v), name
    quantised = {n for n, v in sd_pre.items() if v.dtype == int_dtype}
    assert len(quantised) == 12 + 4 + 9  # block 0 with its attn2, then the last block
    assert {n for n in quantised if ".attn2." in n} == {
        f"transformer_blocks.0.attn2.{p}.weight" for p in ("to_q", "to_k", "to_v", "to_out")}
    assert all(sd_pre[n].dtype == torch.float32 for n in sd_pre if ".norm_" in n)
    with torch.no_grad():
        out = pre(*(t(a) for a in inputs))
    for o, r in zip(out, ref):
        r = np.asarray(r)
        rel = float(np.abs(o.numpy() - r).max() / np.abs(r).max())
        assert rel <= MODEL_REL_TOL[bits], (bits, rel)


@pytest.mark.parametrize("feature", [dict(dual_attention_layers=(0,)),
                                     dict(qk_norm="rms_norm")], ids=["dual_attention", "qk_norm"])
def test_sd35_with_seq_group_is_refused(feature):
    """No parity check holds SD3.5's features through the ring yet."""
    with pytest.raises(NotImplementedError, match=r"14\(d\)"):
        MMDiT(MMDiTConfig.toy(seq_group=object(), **feature))


@pytest.mark.parametrize("variant", ["sd35_medium", "sd35_large"])
def test_sd35_configs_match_the_jax_package_and_build(variant):
    ours, ref = getattr(MMDiTConfig, variant)(), getattr(JMMDiTConfig, variant)()
    for f in dataclasses.fields(ref):
        if hasattr(ours, f.name) and f.name != "dtype":
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.dtype == torch.bfloat16
    # two of its layers at full width, on the meta device (no weights)
    cfg = dataclasses.replace(ours, num_layers=2)
    with torch.device("meta"):
        model = MMDiT(cfg)
    block = model.transformer_blocks[0]
    assert block.use_dual_attention == (variant == "sd35_medium")
    assert block.attn.norm_added_k.weight.shape == (64,)
    n = cfg.pos_embed_max_size
    assert model.pos_embed.pos_embed.shape == (n * n, cfg.inner_dim)
    with pytest.raises(ValueError, match="qk_norm"):
        MMDiT(MMDiTConfig.toy(qk_norm="layer_norm"))
