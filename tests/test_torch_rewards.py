"""tpdm_tpu_torch's ImageReward stack against the JAX package's.

The toy ViT, BERT-med (cross-attention, padding mask) and
``ImageRewardModel.score`` / ``inference_rank`` on a JAX-built model whose
parameters are drawn from a seed and carried over by ``utils/convert.py``; the
resize and crop against the JAX package's PIL function; the CLIP
normalisation; the tokenizer's ids on a toy vocabulary; the
out-of-vocabulary guard; and the trainer's image reward wired end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, random_variables, t
from tpdm_tpu.rewards.bert import BertMedConfig as JBertMedConfig
from tpdm_tpu.rewards.bert import BertMedModel as JBertMedModel
from tpdm_tpu.rewards.image_reward import ImageRewardModel as JImageRewardModel
from tpdm_tpu.rewards.image_reward import ImageRewardNet as JImageRewardNet
from tpdm_tpu.rewards.vit import ViT as JViT
from tpdm_tpu.rewards.vit import ViTConfig as JViTConfig
from tpdm_tpu.utils.bert_tokenizer import BertTokenizer as JBertTokenizer
from tpdm_tpu.utils.image import bicubic_resize_center_crop as jax_resize
from tpdm_tpu.utils.image import normalize_clip as jax_normalize
from tpdm_tpu_torch.models.vae import VAE, VAEConfig
from tpdm_tpu_torch.pipeline.pipeline import decode_latents
from tpdm_tpu_torch.pipeline.sampler import SampleOutput
from tpdm_tpu_torch.rewards import BertMedConfig, ImageRewardModel, ViTConfig
from tpdm_tpu_torch.rewards.image_reward import ImageRewardNet
from tpdm_tpu_torch.train.builders import build_image_reward_fn
from tpdm_tpu_torch.utils.bert_tokenizer import BertTokenizer
from tpdm_tpu_torch.utils.convert import image_reward_from_jax
from tpdm_tpu_torch.utils.image import (
    bicubic_resize_center_crop,
    normalize_clip,
    postprocess_images,
)

IMAGE_PX = 32  # toy images, resized to the toy ViT's 16


@pytest.fixture(scope="module")
def reward():
    """A toy JAX ImageReward, its parameters drawn from a seed, and the
    port's copy, plus toy prompt ids (one padded) and uint8 images."""
    vcfg, bcfg = JViTConfig.toy(), JBertMedConfig.toy()
    # drawn, not initialised: the init's compile would take seconds
    params = random_variables(JImageRewardNet(vcfg, bcfg).init, 1,
                              jnp.zeros((1, 3, vcfg.image_size, vcfg.image_size)),
                              jnp.zeros((1, 5), jnp.int32))
    jmodel = JImageRewardModel.create(params=params, vit_config=vcfg, bert_config=bcfg)
    net = ImageRewardNet(ViTConfig.toy(), BertMedConfig.toy())
    net.load_state_dict(image_reward_from_jax(jax.device_get(jmodel.params)))
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 50, (3, 7)).astype(np.int64)
    mask = np.ones((3, 7), bool)
    mask[1, 4:] = False
    ids[1, 4:] = 0
    images = rng.integers(0, 256, (3, IMAGE_PX, IMAGE_PX + 8, 3), dtype=np.uint8)
    return jmodel, ImageRewardModel(net.requires_grad_(False)), ids, mask, images


def test_converter_fills_every_parameter(reward):
    jmodel, model, *_ = reward
    sd = image_reward_from_jax(jax.device_get(jmodel.params))
    assert sd.keys() == model.net.state_dict().keys()


def test_vit_matches_jax(reward):
    jmodel, model, *_ = reward
    x = np.random.default_rng(3).standard_normal((2, 3, 16, 16)).astype(np.float32)
    ref = jax.jit(JViT(JViTConfig.toy()).apply)(
        {"params": jmodel.params["params"]["visual_encoder"]}, x)
    with torch.no_grad():
        close(model.net.visual_encoder(t(x)), ref)


def test_bert_med_matches_jax(reward):
    jmodel, model, ids, mask, _ = reward
    img = np.random.default_rng(4).standard_normal((3, 5, 24)).astype(np.float32)
    ref = jax.jit(JBertMedModel(JBertMedConfig.toy()).apply)(
        {"params": jmodel.params["params"]["text_encoder"]}, ids, mask, img)
    with torch.no_grad():
        close(model.net.text_encoder(t(ids), t(mask), t(img)), ref)


def test_score_matches_jax(reward):
    jmodel, model, ids, mask, images = reward
    ours = model.score(ids, images, text_mask=mask)
    assert ours.dtype == torch.float32 and ours.shape == (3,)
    close(ours, jmodel.score(ids, images, text_mask=mask))


def test_inference_rank_matches_jax(reward):
    jmodel, model, ids, mask, images = reward
    ranking, rewards = model.inference_rank(ids[1], images, text_mask=mask[1])
    jranking, jrewards = jmodel.inference_rank(ids[1], images, text_mask=mask[1])
    assert ranking == jranking and sorted(ranking) == [1, 2, 3]
    close(np.array(rewards), np.array(jrewards))


def test_out_of_vocabulary_ids_raise(reward):
    _, model, ids, _, images = reward
    with pytest.raises(ValueError, match="vocab_size=50"):
        model.score(np.full_like(ids, 50), images)
    with pytest.raises(ValueError, match="out of range"):
        model.inference_rank(-ids[0], images)


@pytest.mark.parametrize("shape", [(2, 1024, 1024, 3), (1, 300, 517, 3)])
def test_resize_center_crop_matches_pil(shape):
    """PIL rounds each pass to uint8 in fixed point: at most one level
    apart on >= 99 % of the pixels, and at most two anywhere."""
    images = np.random.default_rng(shape[1]).integers(0, 256, shape, dtype=np.uint8)
    ours = bicubic_resize_center_crop(images, 224)
    ref = jax_resize(images, 224)
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == ref.shape == (shape[0], 224, 224, 3)
    diff = np.abs(ours.numpy().astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 2 and (diff <= 1).mean() >= 0.99


def test_normalize_clip_matches_jax():
    images = np.random.default_rng(5).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    close(normalize_clip(t(images)), jax_normalize(images))


def test_tokenizer_ids_match_jax(tmp_path):
    words = ["a", "cat", "dog", "on", "the", "mat", "sleep", "##ing", "##s", "red", ","]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    texts = ["A red cat, sleeping on the mat", "The dogs", "zebra Crossing", ""]
    ours = BertTokenizer.from_pretrained(str(tmp_path))(texts, max_length=8)
    ref = JBertTokenizer.from_pretrained(str(path))(texts, max_length=8)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(ours[k], ref[k])
    assert ours["input_ids"][2, 1] == 1  # [UNK]


def test_image_reward_fn_end_to_end(reward, tmp_path):
    """The trainer's reward: the final latents decoded by the port's
    decode, made uint8, tokenized and scored in one call each."""
    _, model, *_ = reward
    vae = VAE(VAEConfig.toy()).init_weights(torch.Generator().manual_seed(0), 0.2).eval()
    (tmp_path / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "cat", "dog"]) + "\n")
    reward_fn = build_image_reward_fn(vae, model, BertTokenizer.from_pretrained(str(tmp_path)),
                                      max_length=6)
    latents = torch.from_numpy(
        np.random.default_rng(6).standard_normal((2, 4, 8, 8)).astype(np.float32))
    outputs = SampleOutput(None, latents, *([None] * 10))
    scores, last = reward_fn(["a cat", "a dog dog"], outputs)
    assert scores is last and scores.shape == (2,) and torch.isfinite(scores).all()
    with torch.no_grad():
        images = postprocess_images(decode_latents(vae, latents))
    ids = np.array([[2, 4, 5, 3, 0, 0], [2, 4, 6, 6, 3, 0]])
    close(scores, model.score(ids, images, text_mask=ids > 0).numpy())
