"""Loading local checkpoints into tpdm_tpu_torch: the port's safetensors
reader and writer against the ``safetensors`` package, each converter of
``tpdm_tpu_torch/utils/convert.py`` against the JAX package's converter
followed by the port's ``*_from_jax``, and ``load_pipeline_from_pretrained``,
``build_sd3_agent`` and ``serve --pretrained`` on a toy diffusers-layout
directory written here.

Everything is held exactly: the converters and the reader only move
bytes, and the pipeline loaded from files is the in-memory one, bit for
bit. The towers' configs are patched to toy sizes inside the tests
(``toy_configs``); the toy MMDiT is SD3.5's (dual attention in layer 0,
qk norm).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from _torch_parity import t
from test_mmdit_oracle import _synth_sd35_extras, _synth_state_dict
from test_torch_text_encoders import _clip_vocab_dir, _t5_pieces
from tpdm_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig
from tpdm_tpu.train import checkpoint as jckpt
from tpdm_tpu.utils import convert as jconvert
from tpdm_tpu.utils import t5_tokenizer as jax_t5_tokenizer
from tpdm_tpu_torch import serve
from tpdm_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from tpdm_tpu_torch.models.t5 import T5Config, T5Encoder
from tpdm_tpu_torch.models.tpm import TimePredictor
from tpdm_tpu_torch.models.vae import VAE, VAEConfig
from tpdm_tpu_torch.ops.quant import prequantize_
from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline, load_pipeline_from_pretrained
from tpdm_tpu_torch.pipeline.text_encoding import SD3TextEncoders
from tpdm_tpu_torch.train import checkpoint as ckpt
from tpdm_tpu_torch.train.builders import build_sd3_agent
from tpdm_tpu_torch.train.config import RLOOConfig
from tpdm_tpu_torch.utils import convert
from tpdm_tpu_torch.utils import safetensors as st
from tpdm_tpu_torch.utils.image import read_png
from tpdm_tpu_torch.utils.instantiate import instantiate_file

REPO = Path(__file__).resolve().parents[1]


def _same(ours: dict, ref: dict):
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert torch.equal(ours[k], v), k


# ---------------------------------------------------------------------------
# the safetensors format
# ---------------------------------------------------------------------------

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.int32, torch.int64,
          torch.uint8, torch.bool]


def _tensors(seed: int):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dtype in enumerate(DTYPES):
        if dtype.is_floating_point:
            x = torch.randn(3, 5, generator=g).to(dtype)
        elif dtype == torch.bool:
            x = torch.rand(3, 5, generator=g) > 0.5
        else:
            info = torch.iinfo(dtype)
            x = torch.randint(max(info.min, -1000), min(info.max, 1000), (3, 5), generator=g,
                              dtype=dtype)
        out[f"t{i}.{str(dtype)[6:]}"] = x
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros(0, 4, dtype=torch.bfloat16)
    out["transposed"] = torch.randn(4, 6, generator=g).T  # a view: written contiguous
    return out


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}], ids=["plain", "metadata"])
def test_safetensors_agree_with_the_package_byte_for_byte(tmp_path, metadata):
    tensors = _tensors(0)
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    st.save_file(tensors, str(ours), metadata=metadata)
    safetensors.torch.save_file({k: v.contiguous() for k, v in tensors.items()}, str(theirs),
                                metadata=metadata)
    assert ours.read_bytes() == theirs.read_bytes()
    _same(st.load_file(str(theirs)), {k: v.contiguous() for k, v in tensors.items()})
    _same(safetensors.torch.load_file(str(ours)), {k: v.contiguous() for k, v in tensors.items()})
    assert st.read_header(str(ours)).get("__metadata__") == metadata
    # the numpy framework reads bf16 as JAX's load_safetensors does
    as_np = jconvert.load_safetensors(str(ours))
    np.testing.assert_array_equal(as_np["t0.float32"], tensors["t0.float32"].numpy())


def test_safetensors_lazy_keys_and_bad_input(tmp_path):
    tensors = _tensors(1)
    path = str(tmp_path / "a.safetensors")
    st.save_file(tensors, path)
    names = ["t2.bfloat16", "t7.bool"]
    _same(st.load_file(path, names), {k: tensors[k] for k in names})
    assert st.load_file(path, []) == {}
    with pytest.raises(KeyError, match="nope"):
        st.load_file(path, ["nope"])
    with pytest.raises(ValueError, match="float64"):
        st.save_file({"x": torch.zeros(2, dtype=torch.float64)}, str(tmp_path / "b.safetensors"))
    safetensors.numpy.save_file({"x": np.zeros(2)}, str(tmp_path / "f64.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        st.load_file(str(tmp_path / "f64.safetensors"))
    truncated = tmp_path / "short.safetensors"
    truncated.write_bytes(open(path, "rb").read()[:-4])
    with pytest.raises(ValueError, match="offsets"):
        st.load_file(str(truncated))


# ---------------------------------------------------------------------------
# the converters against JAX's converter followed by *_from_jax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["sd3", "sd35"])
def test_convert_mmdit_matches_jax(variant):
    kw = dict(dual_attention_layers=(0,), qk_norm="rms_norm") if variant == "sd35" else {}
    jcfg = JMMDiTConfig.toy(num_layers=3, **kw)
    sd = _synth_state_dict(jcfg)
    if variant == "sd35":
        sd = _synth_sd35_extras(sd, jcfg)
    sd["pos_embed.pos_embed"] = np.zeros((1, 4, jcfg.inner_dim), np.float32)  # not a weight
    args = (jcfg.num_layers, jcfg.dual_attention_layers, jcfg.qk_norm)
    ref = convert.mmdit_from_jax(jconvert.convert_mmdit(sd, *args), jcfg)
    ours = convert.convert_mmdit(sd, *args)
    _same(ours, ref)
    cfg = MMDiTConfig.toy(num_layers=3, **kw)
    MMDiT(cfg).load_state_dict(ours)  # strict: every parameter, nothing more
    del sd["pos_embed.pos_embed"]
    back = convert.export_mmdit(ours, cfg)
    _same(back, {k: t(v) for k, v in sd.items()})
    assert ours["pos_embed.proj.weight"].dtype == torch.float32
    bf16 = convert.convert_mmdit(back, *args, dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in bf16.values())


def _drawn(module, seed):
    """Seeded N(0, 1) values in every parameter of a module, as float."""
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g) for k, v in module.state_dict().items()}


def _hf(state, keys):
    """A port state dict in a checkpoint's layout, by a converter's table."""
    return {src: state[dst] for src, dst in keys}


@pytest.mark.parametrize("tower", ["vae", "clip_l", "clip_g", "t5"])
def test_convert_towers_match_jax(tower):
    if tower == "vae":
        vcfg = VAEConfig.toy(block_out_channels=(8, 16, 16), layers_per_block=1)
        ours_sd = _drawn(VAE(vcfg), 0)
        # the exported layout holds the encoder's keys beside the decoder's
        sd = {k: v.numpy() for k, v in convert.export_vae(ours_sd, vcfg).items()}
        args = (vcfg.block_out_channels, vcfg.layers_per_block)
        ref = convert.vae_from_jax(jconvert.convert_vae(sd, *args))
        ours = convert.convert_vae(sd, *args)
        VAE(vcfg).load_state_dict(ours)
    elif tower in ("clip_l", "clip_g"):
        ccfg = CLIPTextConfig.toy(hidden_size=48, projection_dim=40) if tower == "clip_g" \
            else CLIPTextConfig.toy()
        n = ccfg.num_hidden_layers
        sd = {k: v.numpy() for k, v in
              _hf(_drawn(CLIPTextModel(ccfg), 1), convert._clip_text_keys(n)).items()}
        ref = convert.clip_text_from_jax(jconvert.convert_clip_text(sd, n))
        ours = convert.convert_clip_text(sd, n)
        CLIPTextModel(ccfg).load_state_dict(ours)
    else:
        tcfg = T5Config.toy()
        n = tcfg.num_layers
        sd = {k: v.numpy() for k, v in
              _hf(_drawn(T5Encoder(tcfg), 2), convert._t5_keys(n)).items()}
        ref = convert.t5_from_jax(jconvert.convert_t5(sd, n))
        ours = convert.convert_t5(sd, n)
        T5Encoder(tcfg).load_state_dict(ours)
    _same(ours, ref)


@pytest.mark.parametrize("prefix", ["agent_model.time_predictor.", "time_predictor.", ""])
def test_convert_and_export_tpm_match_jax(prefix):
    tpm = TimePredictor(conv_out_channels=8, in_channels=16, temb_dim=8)
    state = _drawn(tpm, 3)
    sd = {k: v.numpy() for k, v in convert.export_tpm(state, prefix).items()}
    ref_params = jconvert.convert_tpm(sd)
    _same(convert.convert_tpm(sd), convert.tpm_from_jax(ref_params))
    # and back: JAX's export of its tree, the port's export of its state dict
    _same(convert.export_tpm(convert.tpm_from_jax(ref_params)),
          {k: t(v) for k, v in jconvert.export_tpm(ref_params).items()})


def test_checkpoint_writes_tpm_safetensors_that_both_packages_read(tmp_path):
    tpm = TimePredictor(conv_out_channels=4, in_channels=8, temb_dim=6)
    state = _drawn(tpm, 4)
    tpm.load_state_dict(state)
    path = ckpt.save_checkpoint(str(tmp_path), 1, tpm.state_dict(), {"count": 0})
    tpm_file = f"{path}/{ckpt.TPM_FILE}"
    _same(ckpt.load_tpm_safetensors(tpm_file), state)
    assert all(k.startswith("agent_model.time_predictor.") for k in st.read_header(tpm_file))
    _same(convert.tpm_from_jax(jckpt.load_tpm_safetensors(tpm_file)), state)
    assert ckpt.restore_checkpoint(path)["update"] == 1


# ---------------------------------------------------------------------------
# a toy diffusers-layout directory: the loader, the agent builder, the server
# ---------------------------------------------------------------------------

SD35_TOY = dict(dual_attention_layers=(0,), qk_norm="rms_norm", pos_embed_max_size=24)
CLIP_L = dict(hidden_size=32, projection_dim=24, max_position_embeddings=77, vocab_size=49408,
              eos_token_id=49407)
CLIP_G = dict(CLIP_L, hidden_size=48, projection_dim=40)
T5_TOY = dict(d_model=96, vocab_size=512)


def _toy_mmdit_config(**kw):
    return MMDiTConfig.toy(joint_attention_dim=96, pooled_projection_dim=64, **SD35_TOY, **kw)


@pytest.fixture
def toy_configs(monkeypatch):
    """The published configs the loader builds from, at toy sizes: both
    SD3 MMDiT classmethods give the toy SD3.5 MMDiT (its widths fit the
    toy towers), the VAE is the toy one with 16 latent channels."""
    for name in ("sd3_medium", "sd35_medium"):
        monkeypatch.setattr(MMDiTConfig, name, classmethod(lambda cls, **kw: _toy_mmdit_config(**kw)))
    monkeypatch.setattr(VAEConfig, "sd3", classmethod(
        lambda cls, **kw: VAEConfig.toy(latent_channels=16, **kw)))
    monkeypatch.setattr(CLIPTextConfig, "sd3_clip_l", classmethod(
        lambda cls, **kw: CLIPTextConfig.toy(**CLIP_L, **kw)))
    monkeypatch.setattr(CLIPTextConfig, "sd3_clip_g", classmethod(
        lambda cls, **kw: CLIPTextConfig.toy(**CLIP_G, **kw)))
    monkeypatch.setattr(T5Config, "t5_xxl", classmethod(lambda cls, **kw: T5Config.toy(**T5_TOY, **kw)))


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    """(root, in-memory modules) of a toy checkpoint directory: the
    transformer in two shards with metadata, the VAE with its encoder, the
    three towers, both tokenizers and a TPM file."""
    root = tmp_path_factory.mktemp("checkpoint")
    g = torch.Generator().manual_seed(0)
    mcfg = _toy_mmdit_config()
    mods = dict(
        mmdit=MMDiT(mcfg).init_weights(g),
        vae=VAE(VAEConfig.toy(latent_channels=16)).init_weights(g),
        clip_l=CLIPTextModel(CLIPTextConfig.toy(**CLIP_L)).init_weights(g),
        clip_g=CLIPTextModel(CLIPTextConfig.toy(**CLIP_G)).init_weights(g),
        t5=T5Encoder(T5Config.toy(**T5_TOY)).init_weights(g),
        tpm=TimePredictor(conv_out_channels=128, in_channels=2 * mcfg.inner_dim,
                          temb_dim=mcfg.inner_dim).init_weights(g),
    )
    for m in mods.values():
        m.eval()

    def write(sub, tensors, shards=1):
        (root / sub).mkdir()
        names = sorted(tensors)
        for i in range(shards):
            part = {k: tensors[k] for k in names[i::shards]}
            st.save_file(part, str(root / sub / f"model-{i + 1:05d}-of-{shards:05d}.safetensors"),
                         metadata={"format": "pt"})

    write("transformer", convert.export_mmdit(mods["mmdit"].state_dict(), mcfg), shards=2)
    vcfg = mods["vae"].config
    write("vae", convert.export_vae(mods["vae"].state_dict(), vcfg))
    for sub, name in (("text_encoder", "clip_l"), ("text_encoder_2", "clip_g")):
        write(sub, _hf(mods[name].state_dict(), convert._clip_text_keys(2)))
    write("text_encoder_3", _hf(mods["t5"].state_dict(), convert._t5_keys(2)))
    shutil.copytree(_clip_vocab_dir(root, sparse=True), root / "tokenizer")
    (root / "tokenizer_3").mkdir()
    (root / "tokenizer_3" / "spiece.model").write_bytes(
        jax_t5_tokenizer.serialize_spm_model(_t5_pieces()))
    st.save_file(convert.export_tpm(mods["tpm"].state_dict()), str(root / "tpm.safetensors"))
    return root, mods


def _memory_pipeline(mods):
    text = SD3TextEncoders(mods["clip_l"], mods["clip_g"], mods["t5"], t5_width=96)
    return TPDMPipeline(mods["mmdit"], mods["tpm"], mods["vae"], text_encoders=text)


def test_load_pipeline_from_pretrained_equals_the_models_in_memory(toy_dir, toy_configs):
    root, mods = toy_dir
    pipe = load_pipeline_from_pretrained(str(root), dtype=torch.float32,
                                         tpm_checkpoint=str(root / "tpm.safetensors"),
                                         mmdit_config=_toy_mmdit_config(), device="cpu")
    te = pipe.text_encoders
    for name, loaded in (("mmdit", pipe.mmdit), ("vae", pipe.vae), ("tpm", pipe.tpm),
                         ("clip_l", te.clip_l), ("clip_g", te.clip_g), ("t5", te.t5)):
        _same(loaded.state_dict(), mods[name].state_dict())
        assert not loaded.training
    assert te.t5_width == 96
    tokenize = serve.pretrained_tokenize(str(root))
    ours = serve.generate(pipe, tokenize, "hello cat", seed=3, max_steps=3)
    ref = serve.generate(_memory_pipeline(mods), tokenize, "hello cat", seed=3, max_steps=3)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.sigmas, ref.sigmas)
    image = np.random.default_rng(0).integers(0, 256, (1, 16, 16, 3), dtype=np.uint8)
    torch.testing.assert_close(pipe.encode_image(image),
                               _memory_pipeline(mods).encode_image(image), rtol=0, atol=0)


def test_decoder_only_vae_directory_loads_and_refuses_to_encode(toy_dir, toy_configs, tmp_path):
    """A directory whose vae/ holds the decoder alone (an older export)
    loads a VAE without an encoder; encoding, and so img2img, raises."""
    root, mods = toy_dir
    shutil.copytree(root / "transformer", tmp_path / "transformer")
    (tmp_path / "vae").mkdir()
    decoder = {k: v for k, v in convert.export_vae(mods["vae"].state_dict(),
                                                   mods["vae"].config).items()
               if k.startswith("decoder.")}
    st.save_file(decoder, str(tmp_path / "vae" / "model.safetensors"))
    pipe = load_pipeline_from_pretrained(str(tmp_path), dtype=torch.float32,
                                         load_text_encoders=False,
                                         mmdit_config=_toy_mmdit_config(), device="cpu")
    assert pipe.vae.encoder is None
    _same(pipe.vae.state_dict(), {k: v for k, v in mods["vae"].state_dict().items()
                                  if k.startswith("decoder.")})
    image = np.zeros((1, 16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="no VAE encoder"):
        pipe.encode_image(image)
    pe, pp = torch.zeros(1, 5, 96), torch.zeros(1, 64)
    with pytest.raises(ValueError, match="no VAE encoder"):
        pipe.generate(pe, pp, guidance_scale=None, init_image=image, max_inference_steps=1)


def test_load_pipeline_quantised_and_refusals(toy_dir, toy_configs):
    """The default MMDiT config (patched) with quant_int8: the float weights
    loaded, then prequantised, equal to prequantize_ of the in-memory copy;
    no text towers; the TPM drawn from seed 0 without a checkpoint."""
    root, mods = toy_dir
    pipe = load_pipeline_from_pretrained(str(root), dtype=torch.float32, load_text_encoders=False,
                                         quant_int8=True, device="cpu")
    ref = MMDiT(_toy_mmdit_config(quant_matmuls=True))
    ref.load_state_dict(mods["mmdit"].state_dict())
    _same(pipe.mmdit.state_dict(), prequantize_(ref).state_dict())
    assert pipe.text_encoders is None
    drawn = TimePredictor(conv_out_channels=128, in_channels=128, temb_dim=64).init_weights(
        torch.Generator().manual_seed(0))
    _same(pipe.tpm.state_dict(), drawn.state_dict())
    # quant_text: the T5 tower's float weights loaded, then prequantised
    # (weight-only int8, int4 at quant_bits 4), equal to prequantize_ of the
    # in-memory copy; the MMDiT stays float
    for bits, int_dtype in ((8, torch.int8), (4, torch.uint8)):
        pipe = load_pipeline_from_pretrained(str(root), dtype=torch.float32, quant_text=True,
                                             quant_bits=bits, device="cpu")
        ref = T5Encoder(T5Config.toy(**T5_TOY, quant_matmuls=True, quant_bits=bits))
        ref.load_state_dict(mods["t5"].state_dict())
        _same(pipe.text_encoders.t5.state_dict(), prequantize_(ref).state_dict())
        assert pipe.text_encoders.t5.block[0].attention.q.weight.dtype == int_dtype
        assert all(p.is_floating_point() for p in pipe.mmdit.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_pipeline_from_pretrained(str(root))


def test_build_sd3_agent_from_the_yaml(toy_dir, toy_configs):
    root, mods = toy_dir
    builder = instantiate_file(str(REPO / "configs" / "torch" / "models" / "sd3_agent.yaml"))
    config = RLOOConfig(max_inference_steps=3)
    agent = builder(config=config, device="cpu", pretrained=str(root), dtype="float32",
                    variant="sd35_medium", tpm_checkpoint=str(root / "tpm.safetensors"))
    _same(agent.mmdit.state_dict(), mods["mmdit"].state_dict())
    # training starts from the checkpoint's TPM, or from drawn weights without one
    _same(agent.init_tpm_params(torch.Generator().manual_seed(1)).state_dict(),
          mods["tpm"].state_dict())
    fresh = builder(config=config, device="cpu", pretrained=str(root), dtype="float32",
                    variant="sd35_medium")
    tpm = fresh.init_tpm_params(torch.Generator().manual_seed(1))
    assert tpm.conv1.in_channels == 128 and tpm.fc2.bias.tolist() == [1.5, 0.5]
    with pytest.raises(ValueError, match="variant"):
        build_sd3_agent(config, str(root), variant="sd35_turbo", device="cpu")


def test_serve_pretrained_cli(toy_dir, toy_configs, tmp_path, capsys):
    """``serve --pretrained DIR --tpm FILE --cpu --cli``: the image of the
    models in memory (fp32 on the CPU), through the checkpoint's own
    tokenizers; without tokenizer_3 it exits naming the missing file."""
    root, mods = toy_dir
    out = tmp_path / "cat.png"
    serve.main(["--pretrained", str(root), "--tpm", str(root / "tpm.safetensors"), "--cpu",
                "--cli", "--prompt", "hello cat", "--max_steps", "3", "--seed", "5",
                "--out", str(out)])
    assert "/ cap 3" in capsys.readouterr().out
    ref = serve.generate(_memory_pipeline(mods), serve.pretrained_tokenize(str(root)),
                         "hello cat", seed=5, max_steps=3)
    np.testing.assert_array_equal(read_png(out.read_bytes()), ref.images[0])
    broken = tmp_path / "broken"
    shutil.copytree(root, broken, ignore=shutil.ignore_patterns("tokenizer_3"))
    with pytest.raises(SystemExit, match="spiece.model"):
        serve.main(["--pretrained", str(broken), "--cpu", "--cli"])
    with pytest.raises(SystemExit, match="--pretrained"):
        serve.main(["--toy", "--cpu", "--cli", "--tpm", str(root / "tpm.safetensors")])
