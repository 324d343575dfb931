"""The port's prompt encoding against the JAX package: the CLIP text tower
(quick_gelu and exact gelu, all four outputs, a row without EOS), the T5
encoder with and without its attention mask, the relative-position
buckets past ``max_distance``, ``SD3TextEncoders.encode`` with and without
T5, both tokenizers id for id on the toy vocabularies of
``tests/test_aux.py`` and ``tests/test_t5_tokenizer.py`` (and on a CLIP
vocabulary with CLIP's sparse special ids), and ``generate`` from token
ids on the same latents. Weights come from ``_torch_parity.
random_variables`` (no init compile); the towers' JAX functions run in one
jit (module fixture), ``generate`` in one more. fp32 bound:
``_torch_parity.close`` (rtol 1e-4 / atol 1e-5 scaled by the output's
magnitude)."""

import json
import random
import string
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, drawn_models, random_variables, t
from tpdm_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig
from tpdm_tpu.models.clip_text import CLIPTextModel as JCLIPTextModel
from tpdm_tpu.models.t5 import T5Config as JT5Config
from tpdm_tpu.models.t5 import T5Encoder as JT5Encoder
from tpdm_tpu.models.t5 import t5_relative_position_bucket as jax_bucket
from tpdm_tpu.pipeline.pipeline import TPDMPipeline as JTPDMPipeline
from tpdm_tpu.pipeline.text_encoding import SD3TextEncoders as JSD3TextEncoders
from tpdm_tpu.utils import t5_tokenizer as jax_t5_tokenizer
from tpdm_tpu.utils import tokenizer as jax_clip_tokenizer
from tpdm_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from tpdm_tpu_torch.models.t5 import T5Config, T5Encoder, t5_relative_position_bucket
from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline
from tpdm_tpu_torch.pipeline.text_encoding import SD3TextEncoders
from tpdm_tpu_torch.utils.convert import clip_text_from_jax, t5_from_jax
from tpdm_tpu_torch.utils.t5_tokenizer import T5Tokenizer
from tpdm_tpu_torch.utils.tokenizer import CLIPTokenizer

# the toy towers feed the toy MMDiT: [8 + 16 CLIP widths] padded to T5's 32
# (its joint_attention_dim), pooled 24 + 24 = 48 (its pooled_projection_dim)
CLIP_L = dict(hidden_size=8, num_attention_heads=2, intermediate_size=16, projection_dim=24)
CLIP_G = dict(hidden_size=16, num_attention_heads=4, intermediate_size=32, projection_dim=24,
              hidden_act="gelu")
T5_KW = dict(d_model=32)
N_CLIP, N_T5, B = 8, 12, 3
EOS = 98  # the toy CLIP's eos_token_id


def _clip(seed, kw):
    jm = JCLIPTextModel(JCLIPTextConfig.toy(**kw))
    variables = random_variables(jm.init, seed, jnp.zeros((1, N_CLIP), jnp.int32))
    tm = CLIPTextModel(CLIPTextConfig.toy(**kw))
    tm.load_state_dict(clip_text_from_jax(variables))
    return jm, variables, tm.eval()


def _t5(seed):
    jm = JT5Encoder(JT5Config.toy(**T5_KW))
    # device arrays: T5 gathers its bias table with traced buckets
    variables = jax.tree.map(jnp.asarray, random_variables(jm.init, seed,
                                                           jnp.zeros((1, N_T5), jnp.int32)))
    tm = T5Encoder(T5Config.toy(**T5_KW))
    tm.load_state_dict(t5_from_jax(jax.tree.map(np.asarray, variables)))
    return jm, variables, tm.eval()


@pytest.fixture(scope="module")
def world():
    """The three toy towers on both sides, seeded ids and one jit of every
    JAX function the tests compare with."""
    towers = {"clip_l": _clip(0, CLIP_L), "clip_g": _clip(1, CLIP_G), "t5": _t5(2)}
    rng = np.random.default_rng(5)
    clip_ids = rng.integers(1, 97, (B, N_CLIP)).astype(np.int32)
    clip_ids[0, 5], clip_ids[1, 3], clip_ids[1, 6] = EOS, EOS, EOS  # row 2: no EOS
    t5_ids = rng.integers(3, 120, (B, N_T5)).astype(np.int32)
    t5_mask = np.ones((B, N_T5), bool)
    t5_mask[1, 8:] = False
    rel = np.arange(-300, 301, dtype=np.int32)  # past max_distance 128 both ways
    (jl, vl, _), (jg, vg, _), (jt, vt, _) = (towers[k] for k in ("clip_l", "clip_g", "t5"))
    jte = JSD3TextEncoders(jl, vl, jg, vg, jt, vt, t5_width=T5_KW["d_model"])

    def reference(clip_ids, t5_ids, t5_mask, rel):
        return dict(clip_l=jl.apply(vl, clip_ids), clip_g=jg.apply(vg, clip_ids),
                    t5=jt.apply(vt, t5_ids), t5_masked=jt.apply(vt, t5_ids, t5_mask),
                    encode=jte._encode_impl(clip_ids, t5_ids),
                    encode_no_t5=jte._encode_impl(clip_ids, None),
                    buckets=jax_bucket(rel), buckets_16_64=jax_bucket(rel, 16, 64))

    ref = jax.jit(reference)(clip_ids, t5_ids, t5_mask, rel)
    ids = dict(clip=clip_ids, t5=t5_ids, mask=t5_mask, rel=rel)
    return towers, jte, ids, jax.tree.map(np.asarray, ref)


@pytest.mark.parametrize("tower", ["clip_l", "clip_g"])
def test_clip_matches_jax(world, tower):
    """quick_gelu (CLIP-L) and exact gelu (CLIP-G): penultimate, final,
    EOS-pooled (first EOS; position 0 in the row without one) and
    projected outputs."""
    towers, _, ids, ref = world
    with torch.no_grad():
        out = towers[tower][2](t(ids["clip"]).long())
    for ours, theirs in zip(out, ref[tower]):
        close(ours, theirs)
    close(out[2][2], out[1][2, 0])  # no EOS: pooled at position 0


@pytest.mark.parametrize("masked", [False, True])
def test_t5_matches_jax(world, masked):
    towers, _, ids, ref = world
    mask = t(ids["mask"]) if masked else None
    with torch.no_grad():
        out = towers["t5"][2](t(ids["t5"]).long(), attention_mask=mask)
    close(out, ref["t5_masked" if masked else "t5"])


def test_relative_position_bucket_matches_jax(world):
    """Every distance in [-300, 300], past max_distance both ways, at the
    default 32 buckets / 128 and at 16 / 64: equal buckets."""
    *_, ids, ref = world
    rel = t(ids["rel"])
    np.testing.assert_array_equal(t5_relative_position_bucket(rel).numpy(), ref["buckets"])
    np.testing.assert_array_equal(t5_relative_position_bucket(rel, 16, 64).numpy(),
                                  ref["buckets_16_64"])


@pytest.mark.parametrize("with_t5", [True, False])
def test_sd3_text_encoders_match_jax(world, with_t5):
    """[pen_l ‖ pen_g] zero-padded to T5's width, then T5's rows (zeros of
    length 256 with T5 dropped); pooled [proj_l ‖ proj_g]."""
    towers, _, ids, ref = world
    te = SD3TextEncoders(towers["clip_l"][2], towers["clip_g"][2],
                         towers["t5"][2] if with_t5 else None, t5_width=T5_KW["d_model"])
    pe, pp = te.encode(ids["clip"], ids["t5"])
    want = ref["encode" if with_t5 else "encode_no_t5"]
    assert pe.shape == want[0].shape == (B, N_CLIP + (N_T5 if with_t5 else 256), 32)
    close(pe, want[0])
    close(pp, want[1])
    assert not pe.requires_grad and not any(
        p.requires_grad for tower in (te.clip_l, te.clip_g) for p in tower.parameters())


def _clip_vocab_dir(tmp_path, sparse: bool):
    """``tests/test_aux.py``'s miniature CLIP BPE vocabulary (every byte
    symbol alone and with "</w>", a few merges); ``sparse`` puts the two
    special tokens at CLIP's 49406 and 49407, leaving a gap below them."""
    b2u = jax_clip_tokenizer._bytes_to_unicode()
    syms = sorted(set(b2u.values()))
    vocab = {s: i for i, s in enumerate(syms)}
    vocab.update({s + "</w>": len(syms) + i for i, s in enumerate(syms)})
    merges = ["#version: 0.2"]
    for a, b in [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"), ("w", "o"),
                 ("r", "l"), ("wo", "rl"), ("worl", "d</w>"), ("c", "a"), ("ca", "t</w>")]:
        vocab.setdefault(a + b, len(vocab))
        merges.append(f"{a} {b}")
    first = 49406 if sparse else len(vocab)
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = first, first + 1
    d = tmp_path / ("sparse" if sparse else "dense")
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("\n".join(merges) + "\n")
    return str(d)


CLIP_TEXTS = ["hello world", "a cat!", "Hello, WORLD  cat", "héllo", "hello_world",
              "snake_case cat", "!_!", "<|startoftext|>cat<|endoftext|>", ""]


@pytest.mark.parametrize("sparse", [False, True])
def test_clip_tokenizer_matches_jax(tmp_path, sparse):
    path = _clip_vocab_dir(tmp_path, sparse)
    ours, theirs = CLIPTokenizer.from_pretrained(path), jax_clip_tokenizer.CLIPTokenizer.from_pretrained(path)
    for text in CLIP_TEXTS:
        for max_length in (16, 4):  # 4 truncates, keeping the EOS
            a, b = ours(text, max_length=max_length), theirs(text, max_length=max_length)
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
            np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
    if sparse:
        ids = ours("hello world", max_length=77)["input_ids"][0]
        assert ids[0] == 49406 and ids[3] == 49407 and (ids[3:] == 49407).all()


def _t5_pieces():
    """``tests/test_t5_tokenizer.py``'s Unigram vocabulary: the specials
    (pad 0, eos 1, unk 2), every character alone and after "▁", and scored
    subwords."""
    rng = random.Random(7)
    chars = sorted(set(string.ascii_letters + string.digits + ".,!?-:;'\"()&%$#@/"
                       + "éñüçöà中文日本語" + "⁄"))
    words = ["the", "he", "th", "ing", "ion", "ell", "llo", "hello", "wor", "world", "cat",
             "at", "dog", "photo", "graph", "photograph", "ph", "oto", "moun", "tain",
             "mountain", "ser", "ene", "serene", "lake", "la", "ke", "an", "and", "nd", "er",
             "re", "en", "on", "es", "ti"]
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2),
              ("▁", rng.uniform(-11, -9), 1)]
    for c in chars:
        pieces += [(c, rng.uniform(-10, -8), 1), ("▁" + c, rng.uniform(-10, -8), 1)]
    for w in words:
        pieces.append((w, rng.uniform(-9, -4) - 0.01 * len(w), 1))
        pieces.append(("▁" + w, rng.uniform(-9, -4) - 0.01 * len(w), 1))
    return pieces


T5_TEXTS = ["hello world", "The cat sat on the mat.", "a serene mountain lake at dawn, photograph",
            "  leading and   trailing   spaces  ", "tabs\tand\nnewlines",
            "unicode: éñü çöà", "cjk 中文 and 日本語 mixed", "nfkc ligature ﬁne and fraction ½",
            "hello ⊗⊗ world", "hello </s> world", "the " * 40, ""]


def test_t5_tokenizer_matches_jax(tmp_path):
    """The call surface (eos, padding, truncation at 24) from the pieces, and
    from the same vocabulary serialised as spiece.model."""
    pieces = _t5_pieces()
    (tmp_path / "spiece.model").write_bytes(jax_t5_tokenizer.serialize_spm_model(pieces))
    pairs = [(T5Tokenizer(pieces, max_length=24), jax_t5_tokenizer.T5Tokenizer(pieces, max_length=24)),
             (T5Tokenizer.from_pretrained(str(tmp_path)),
              jax_t5_tokenizer.T5Tokenizer.from_pretrained(str(tmp_path)))]
    for ours, theirs in pairs:
        assert (ours.pad_id, ours.eos_id, ours.unk_id) == (0, 1, 2)
        for text in T5_TEXTS:
            assert ours.encode(text) == theirs.encode(text), text
            a, b = ours([text], max_length=24), theirs([text], max_length=24)
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
            np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])


# a closed-form TPM, the same formula on both sides (as in
# tests/test_torch_sampling_knobs.py): the JAX loop compiles in about a
# second, and a mode ratio of ~2/3 stops the schedule at MIN_SIGMA
MIN_SIGMA = 0.25


def _jax_tpm(h, temb):
    return jnp.stack([3.0 + 0.1 * jnp.tanh(jnp.mean(h, axis=(1, 2, 3))),
                      2.0 + 0.1 * jnp.tanh(jnp.mean(temb, axis=1))], axis=1)


def _torch_tpm(h, temb):
    return torch.stack([3.0 + 0.1 * torch.tanh(h.mean(dim=(1, 2, 3))),
                        2.0 + 0.1 * torch.tanh(temb.mean(dim=1))], dim=1)


def test_generate_from_ids_matches_jax(world):
    """``generate(clip_ids=, t5_ids=, negative_*_ids=)`` through the towers
    on both sides, on the same toy MMDiT and latents (the TPM in closed
    form), to the final latents; then the port's ids path against its own embeds path,
    equal to the bit."""
    towers, jte, ids, _ = world
    jm, mv, tm = drawn_models(4, vae=False, tpm=False)["mmdit"]
    c = tm.config
    te = SD3TextEncoders(*(towers[k][2] for k in ("clip_l", "clip_g", "t5")), t5_width=32)
    b = 2
    lat = np.random.default_rng(6).standard_normal(
        (b, c.in_channels, c.sample_size, c.sample_size), np.float32)
    id_kw = dict(clip_ids=ids["clip"][:b], t5_ids=ids["t5"][:b],
                 negative_clip_ids=np.zeros((b, N_CLIP), np.int32),
                 negative_t5_ids=np.zeros((b, N_T5), np.int32))
    # decode=False: the final latents (the decode's parity is
    # tests/test_torch_pipeline.py's)
    kw = dict(max_inference_steps=6, guidance_scale=7.0, predict=True, decode=False)
    jtpm = types.SimpleNamespace(apply=lambda params, h, temb: _jax_tpm(h, temb))
    jpipe = JTPDMPipeline(jm, mv, jtpm, {}, text_encoders=jte, min_sigma=MIN_SIGMA)
    tpipe = TPDMPipeline(tm, _torch_tpm, text_encoders=te, min_sigma=MIN_SIGMA)
    ref = jpipe.generate(latents=lat, **id_kw, **kw)
    out = tpipe.generate(latents=t(lat), **id_kw, **kw)
    assert 1 < out.num_steps == ref.num_steps < 6  # the schedule stopped itself
    np.testing.assert_array_equal(out.last_valid_index, ref.last_valid_index)
    close(out.sigmas, ref.sigmas)
    close(out.images, ref.images)
    pe, pp = te.encode(id_kw["clip_ids"], id_kw["t5_ids"])
    npe, npp = te.encode(id_kw["negative_clip_ids"], id_kw["negative_t5_ids"])
    direct = tpipe.generate(pe, pp, npe, npp, latents=t(lat), **kw)
    np.testing.assert_array_equal(direct.images, out.images)
    with pytest.raises(ValueError, match="CFG needs negative ids"):
        tpipe.generate(clip_ids=id_kw["clip_ids"], latents=t(lat), **kw)
