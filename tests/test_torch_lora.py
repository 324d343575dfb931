"""LoRA adapters in tpdm_tpu_torch (``models/lora.py``, ``train/draft.py``'s
LoRA files, ``utils/convert.py``'s key map, ``serve.py``'s bare ``--lora``
merge) against the JAX package, on the CPU at toy size.

One toy world a model, built once (module fixture): the JAX MMDiT, FLUX
(2 + 2 blocks) and SD1.5 UNet with parameters drawn by
``_torch_parity.random_variables`` and the port's copies, and the JAX
MMDiT's prequantised W8A8 and int4 trees. The factors are made on the JAX
side (the keys and shapes of ``init_lora``, traced only, with ``a`` and a
non-zero ``b`` drawn from seeded numpy: a fresh adapter is an identity and
proves nothing) and carried across with ``lora_from_jax``; the torch and JAX random streams differ, so the port's
``init_lora`` is checked for its statistics and for being an identity
only. The JAX forwards run compiled, each under ``nn.intercept_methods``
where the port's run under ``lora_interceptor``.

Tolerances: the fp32 bound (rtol 1e-4 / atol 1e-5 scaled by the
magnitude, ``_torch_parity.close``); the quantised forwards within
``MODEL_REL_TOL`` of each output's range, as ``test_torch_quant.py`` holds
the quantised MMDiT; bank rows, ids, keys and the base row exactly.
"""

import argparse
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, drawn_models, kernel_tree, noisy_jax_lora, random_variables, t
from tpdm_tpu.models import lora as jlora
from tpdm_tpu.models.flux import Flux as JFlux, FluxConfig as JFluxConfig, pack_latents as j_pack
from tpdm_tpu.models.mmdit import MMDiT as JMMDiT
from tpdm_tpu.models.unet_sd15 import UNetConfig as JUNetConfig, UNetSD15 as JUNetSD15
from tpdm_tpu.ops import quant as jq
from tpdm_tpu.train import draft as jdraft
from tpdm_tpu_torch import serve
from tpdm_tpu_torch.models import lora
from tpdm_tpu_torch.models.flux import Flux, FluxConfig, pack_latents
from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from tpdm_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from tpdm_tpu_torch.train import draft
from tpdm_tpu_torch.utils import convert
from tpdm_tpu_torch.utils import safetensors as st

MODEL_REL_TOL = 2e-3  # test_torch_quant.py's bound on the quantised MMDiT
B = 3  # one batch row a bank row: base, adapter x, adapter y
SCALE = 0.7
NAMES = ("mmdit", "flux", "unet")


def _mmdit_world():
    jm, v, tm = drawn_models(0, vae=False, tpm=False)["mmdit"]
    c = jm.config
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, c.in_channels, c.sample_size, c.sample_size), np.float32),
         np.array([1000.0, 437.5, 12.0], np.float32),
         rng.standard_normal((B, 6, c.joint_attention_dim), np.float32),
         rng.standard_normal((B, c.pooled_projection_dim), np.float32))
    return dict(jm=jm, v=v, tm=tm, x=x, j_apply=lambda v_, *a: jm.apply(v_, *a),
                t_apply=lambda m, *a: m(*(t(b) for b in a)),
                from_jax=lambda tree: convert.mmdit_from_jax(tree, tm.config))


def _flux_world():
    kw = dict(guidance_embed=True, cache_front_blocks=1)
    jm = JFlux(JFluxConfig.toy(**kw))
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((B, 4, 8, 8)).astype(np.float32)
    rest = (rng.standard_normal((B, 5, 32)).astype(np.float32), np.zeros((B, 5, 3), np.float32),
            np.array([0.7, 0.25, 0.9], np.float32), rng.standard_normal((B, 24)).astype(np.float32),
            np.array([3.5, 2.0, 1.0], np.float32))
    tok, ids = j_pack(jnp.asarray(lat))
    v = jax.tree.map(np.asarray, random_variables(jm.init, 0, tok, ids, *rest))
    cfg = FluxConfig.toy(**kw)
    tm = Flux(cfg)
    tm.load_state_dict(convert.flux_from_jax(v, cfg))

    def j_apply(v_, lat_, *a):
        return jm.apply(v_, *j_pack(jnp.asarray(lat_)), *a)

    def t_apply(m, lat_, *a):
        return m(*pack_latents(t(lat_)), *(t(b) for b in a))

    return dict(jm=jm, v=v, tm=tm.eval(), x=(lat, *rest), j_apply=j_apply, t_apply=t_apply,
                from_jax=lambda tree: convert.flux_from_jax(tree, cfg))


def _unet_world():
    ju = JUNetSD15(JUNetConfig.toy())
    c = ju.config
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, 4, c.sample_size, c.sample_size), np.float32),
         np.array([999.0, 420.5, 12.0], np.float32),
         rng.standard_normal((B, 7, c.cross_attention_dim), np.float32))
    v = random_variables(ju.init, 5, jnp.zeros((1, 4, c.sample_size, c.sample_size)),
                         jnp.ones((1,)), jnp.zeros((1, 7, c.cross_attention_dim)))
    tu = UNetSD15(UNetConfig.toy())
    tu.load_state_dict(convert.unet_sd15_from_jax(v))
    return dict(jm=ju, v=v, tm=tu.eval(), x=x, j_apply=lambda v_, *a: ju.apply(v_, *a),
                t_apply=lambda m, *a: m(*(t(b) for b in a)),
                from_jax=convert.unet_sd15_from_jax)


@pytest.fixture(scope="module")
def worlds():
    """Each toy model with two JAX adapters: x (rank 4, every dense
    kernel, scale 0.8) and y (rank 8, every other kernel, scale 1.3),
    JAX's bank of the two and its forward under the bank's rows [0, 1, 2]."""
    out = {}
    for name, build in zip(NAMES, (_mmdit_world, _flux_world, _unet_world)):
        w = build()
        w["lora_x"] = noisy_jax_lora(w["v"], 1, rank=4)
        every_other = set(sorted(w["lora_x"])[::2])
        w["lora_y"] = noisy_jax_lora(w["v"], 2, rank=8, keep=every_other.__contains__)

        @jax.jit
        def run(v, lx, ly, *x, _w=w):
            bank = jlora.stack_adapters({"x": (lx, 0.8), "y": (ly, 1.3)})[0]
            with fnn.intercept_methods(jlora.lora_interceptor(bank, jnp.arange(B))):
                return bank, _w["j_apply"](v, *x)

        w["bank"], w["ref"] = jax.device_get(run(w["v"], w["lora_x"], w["lora_y"], *w["x"]))
        out[name] = w
    return out


def _jax_matched(params) -> list:
    """The keys that JAX's ``default_match`` selects in ``params``."""
    paths = ((jlora._path_str(path), leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0])
    return sorted(p for p, leaf in paths if jlora.default_match(p, leaf))


def test_lora_key_map():
    """Flax kernel paths <-> the port's module names, both ways, by the
    converters' indexing rule; anything else raises."""
    cases = {"params/transformer_blocks_0/attn/to_q/kernel": "transformer_blocks.0.attn.to_q",
             "params/single_blocks_3/linear1/kernel": "single_blocks.3.linear1",
             "params/down_1_attn_0/block/attn1_to_q/kernel": "down_1_attn_0.block.attn1_to_q",
             "params/time_linear_1/kernel": "time_linear_1"}
    for path, name in cases.items():
        assert convert.lora_key_from_jax(path) == name
        assert convert.lora_key_to_jax(name) == path
    assert convert.lora_key_from_jax("transformer_blocks_0/attn/to_q/kernel") == (
        "transformer_blocks.0.attn.to_q")
    for bad in ("params/transformer_blocks_0/attn/to_q/bias", "kernel", "params/norm/scale"):
        with pytest.raises(ValueError, match="dense kernel"):
            convert.lora_key_from_jax(bad)


@pytest.mark.parametrize("name", NAMES)
def test_default_match_equals_jax(worlds, name):
    """The port's targets are JAX's 2-D kernels, key for key."""
    w = worlds[name]
    jax_keys = _jax_matched(w["v"])
    assert jax_keys and sorted(w["lora_x"]) == jax_keys
    ours = lora.lora_targets(w["tm"])
    assert sorted(convert.lora_key_to_jax(k) for k in ours) == jax_keys
    assert {k for k in convert.lora_from_jax(w["lora_x"])} == set(ours)


@pytest.mark.parametrize("name", NAMES)
def test_apply_lora_matches_jax(worlds, name):
    """apply_lora's merged weights equal ``*_from_jax(JAX apply_lora(...))``;
    the module itself is not written."""
    w = worlds[name]
    merge = jax.jit(jlora.apply_lora, static_argnames="scale")
    ref = w["from_jax"](jax.device_get(merge(w["v"], w["lora_x"], scale=SCALE)))
    before = {k: v.clone() for k, v in w["tm"].state_dict().items()}
    merged = lora.apply_lora(w["tm"], convert.lora_from_jax(w["lora_x"]), scale=SCALE)
    assert len(merged) == len(w["lora_x"])
    for k, v in merged.items():
        close(v, ref[k].numpy())
        assert not torch.equal(v, before[k]), k
    for k, v in w["tm"].state_dict().items():
        assert torch.equal(v, before[k]), k


def test_init_lora_is_an_identity_with_jax_statistics(worlds):
    """The port's init_lora: fp32 factors over every target, ``b`` zero (the
    merged weights equal the base exactly), ``a`` ~ N(0, 1/d_in) (JAX's
    draw): its pooled variance times d_in is one within sampling error."""
    tm = worlds["mmdit"]["tm"]
    fresh = lora.init_lora(tm, 16, torch.Generator().manual_seed(0))
    assert set(fresh) == set(lora.lora_targets(tm))
    z = torch.cat([(f["a"] * f["a"].shape[0] ** 0.5).flatten() for f in fresh.values()])
    assert abs(float(z.mean())) < 0.02 and abs(float(z.var()) - 1.0) < 0.03
    for f in fresh.values():
        assert f["a"].dtype == f["b"].dtype == torch.float32 and not f["b"].any()
    sd = tm.state_dict()
    for k, v in lora.apply_lora(tm, fresh, scale=3.0).items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(ValueError, match="rank"):
        lora.init_lora(tm, 0, torch.Generator())
    assert lora.lora_param_count(fresh) == jlora.lora_param_count(
        {k: {"a": np.zeros(f["a"].shape), "b": np.zeros(f["b"].shape)} for k, f in fresh.items()})


def test_stack_adapters_matches_jax(worlds):
    """Ranks 4 and 8 over different key sets: the union of keys, each row
    padded to the largest rank at its key, scales folded into b; ids by
    sorted name."""
    w = worlds["mmdit"]
    bank, ids = lora.stack_adapters({"y": (convert.lora_from_jax(w["lora_y"]), 1.3),
                                     "x": (convert.lora_from_jax(w["lora_x"]), 0.8)})
    assert ids == {"x": 1, "y": 2}
    ref = {convert.lora_key_from_jax(k): v for k, v in w["bank"].items()}
    assert set(bank) == set(ref) == {convert.lora_key_from_jax(k) for k in w["lora_x"]}
    for k, v in bank.items():
        in_y = convert.lora_key_to_jax(k) in w["lora_y"]
        assert v["a"].shape == ref[k]["a"].shape and v["a"].shape[2] == (8 if in_y else 4)
        close(v["a"], ref[k]["a"])
        close(v["b"], ref[k]["b"])
        assert not v["a"][0].any() and not v["b"][0].any()
    with pytest.raises(ValueError, match="no adapters"):
        lora.stack_adapters({})


def _forward(w, module, bank=None):
    with torch.no_grad():
        if bank is None:
            return w["t_apply"](module, *w["x"])
        with lora.lora_interceptor(module, bank, torch.arange(B)):
            return w["t_apply"](module, *w["x"])


def _port_bank(w):
    return lora.stack_adapters({"x": (convert.lora_from_jax(w["lora_x"]), 0.8),
                                "y": (convert.lora_from_jax(w["lora_y"]), 1.3)})[0]


@pytest.mark.parametrize("name", NAMES)
def test_interceptor_matches_jax(worlds, name):
    """A forward at batch 3 under rows [0, 1, 2] of the bank equals JAX's
    under ``nn.intercept_methods``; row 0 equals the base forward's row to
    the bit; the hooks are gone afterwards."""
    w = worlds[name]
    ours = _forward(w, w["tm"], _port_bank(w))
    for o, r in zip(ours, w["ref"]):
        close(o, np.asarray(r))
    base = _forward(w, w["tm"])
    assert torch.equal(ours[0][0], base[0][0])
    assert not torch.allclose(ours[0][1], base[0][1], rtol=1e-3, atol=1e-3)
    assert not any(m._forward_hooks for m in w["tm"].modules())


@pytest.mark.parametrize("bits", [8, 4])
def test_interceptor_over_quantised_mmdit_matches_jax(worlds, bits):
    """The fused delta beside the stored-int matmuls (K4's W8A8, K5's int4
    on the card): JAX's prequantised toy MMDiT under the same bank."""
    w = worlds["mmdit"]
    jqm = JMMDiT(dataclasses.replace(w["jm"].config, quant_matmuls=True, quant_bits=bits))
    shapes = jax.eval_shape(jqm.init, jax.random.PRNGKey(0), *w["x"])["params"]
    qparams = jq.prequantize_params(jq.fit_quant_params(w["v"]["params"], shapes))
    qv = {**w["v"], "params": qparams}

    @jax.jit
    def run(v, bank, *x):
        with fnn.intercept_methods(jlora.lora_interceptor(bank, jnp.arange(B))):
            return jqm.apply(v, *x)

    ref = jax.device_get(run(qv, w["bank"], *w["x"]))
    cfg = MMDiTConfig.toy(quant_matmuls=True, quant_bits=bits)
    tm = MMDiT(cfg)
    tm.load_state_dict(convert.mmdit_from_jax({"params": qparams}, cfg))
    tm.pos_embed.pos_embed.copy_(w["tm"].pos_embed.pos_embed)
    ours = _forward(w, tm.eval(), _port_bank(w))
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        assert float(np.abs(o.numpy() - r).max() / np.abs(r).max()) <= MODEL_REL_TOL
    base = _forward(w, tm)
    assert torch.equal(ours[0][0], base[0][0])
    with pytest.raises(ValueError, match="quantized"):
        lora.apply_lora(tm, convert.lora_from_jax(w["lora_x"]))


def test_lora_files_load_across_packages(worlds, tmp_path):
    """A file written by either package loads in the other, factor for
    factor, under the Flax-path keys."""
    w = worlds["unet"]
    jdraft.save_lora(str(tmp_path / "jax.safetensors"), w["lora_y"])
    ours = draft.load_lora(str(tmp_path / "jax.safetensors"))
    want = convert.lora_from_jax(w["lora_y"])
    assert set(ours) == set(want)
    for k in ours:
        assert all(torch.equal(ours[k][f], want[k][f]) for f in ("a", "b"))
    draft.save_lora(str(tmp_path / "port.safetensors"), want)
    assert set(st.read_header(str(tmp_path / "port.safetensors"))) - {"__metadata__"} == {
        f"{k}|{f}" for k in w["lora_y"] for f in ("a", "b")}
    back = jdraft.load_lora(str(tmp_path / "port.safetensors"))
    for k, f in w["lora_y"].items():
        np.testing.assert_array_equal(np.asarray(back[k]["a"]), f["a"])
        np.testing.assert_array_equal(np.asarray(back[k]["b"]), f["b"])
    paths = [draft.save_rotating_lora(str(tmp_path / "rot"), u, want, 2) for u in (1, 2, 3)]
    assert sorted(p.name for p in (tmp_path / "rot").iterdir()) == [
        "lora-2.safetensors", "lora-3.safetensors"] and paths[-1].endswith("lora-3.safetensors")


def test_load_lora_refuses_non_lora_files(tmp_path):
    """A TPM checkpoint and an incomplete adapter raise, as in JAX's
    ``tests/test_draft.py``."""
    from tpdm_tpu_torch.models.tpm import TimePredictor

    tpm = TimePredictor(conv_out_channels=8, in_channels=16, temb_dim=8)
    st.save_file(convert.export_tpm(tpm.state_dict()), str(tmp_path / "tpm.safetensors"))
    with pytest.raises(ValueError, match="not a LoRA file"):
        draft.load_lora(str(tmp_path / "tpm.safetensors"))
    st.save_file({"params/x/kernel|a": torch.zeros(4, 2)}, str(tmp_path / "half.safetensors"))
    with pytest.raises(ValueError, match="incomplete"):
        draft.load_lora(str(tmp_path / "half.safetensors"))
    st.save_file({"params/x/bias|a": torch.zeros(4, 2)}, str(tmp_path / "bias.safetensors"))
    with pytest.raises(ValueError, match="not a LoRA file"):
        draft.load_lora(str(tmp_path / "bias.safetensors"))


def test_unmatched_keys_raise(worlds):
    """An adapter key that names no dense layer of the module (another
    model's adapter) raises in every entry point that takes the module."""
    w = worlds["mmdit"]
    foreign = convert.lora_from_jax(worlds["unet"]["lora_x"])
    for call in (lambda: lora.apply_lora(w["tm"], foreign),
                 lambda: lora.check_lora(w["tm"], foreign),
                 lambda: lora.lora_interceptor(w["tm"], foreign, torch.arange(B)).__enter__()):
        with pytest.raises(ValueError, match="wrong model"):
            call()
    with pytest.raises(ValueError, match="empty"):
        lora.check_lora(w["tm"], {})
    # an input of a rank the delta does not take
    one = {"context_embedder": {"a": torch.zeros(1, 2, 1), "b": torch.zeros(1, 1, 2)}}
    layer = torch.nn.Linear(2, 2)
    module = torch.nn.Module()
    module.context_embedder = layer
    with lora.lora_interceptor(module, one, torch.zeros(1)), pytest.raises(ValueError,
                                                                        match="rank 4"):
        layer(torch.zeros(1, 1, 1, 2))


def test_serve_merges_a_bare_lora_at_load(worlds, tmp_path):
    """``serve --toy --lora PATH`` merges the file into the MMDiT once at
    load (the weights are apply_lora's, the image changes); into a
    quantised backbone, or a family backbone without the continuous fused
    engine for NAME=PATH entries, it exits."""
    base, tokenize = serve.build_pipeline(argparse.Namespace(toy=True, cpu=True))
    jtree = noisy_jax_lora(kernel_tree(base.mmdit), 5, rank=2)
    path = str(tmp_path / "a.safetensors")
    jdraft.save_lora(path, jtree)
    args = argparse.Namespace(toy=True, cpu=True, lora=[path], lora_scale=0.5)
    pipe, _ = serve.build_pipeline(args)
    want = lora.apply_lora(base.mmdit, draft.load_lora(path), scale=0.5)
    sd = pipe.mmdit.state_dict()
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    a = serve.generate(pipe, tokenize, "a cat", 3, 3).images
    b = serve.generate(base, tokenize, "a cat", 3, 3).images
    assert np.abs(a.astype(int) - b.astype(int)).max() > 1
    with pytest.raises(SystemExit, match="quantized"):
        serve.build_pipeline(argparse.Namespace(**vars(args), int8=True))
    with pytest.raises(SystemExit, match="--lora_fused"):
        serve.build_family_world(argparse.Namespace(toy=True, cpu=True, family="sd15",
                                                    max_steps=3, lora=[f"a={path}"]))
    with pytest.raises(ValueError, match="wrong model"):
        serve.build_family_world(argparse.Namespace(toy=True, cpu=True, family="sd15",
                                                    max_steps=3, lora=[path]))
