"""Component builders for training: agents, rewards and the prompt
embedder that stands in for the text towers.

Counterpart of ``tpdm_tpu/train/builders.py``'s ``build_toy_agent``,
``build_sd3_agent``, ``build_toy_reward``, ``build_toy_draft_reward``,
``build_image_reward_fn``, ``build_inference_ranker`` and
``make_prompt_encoder``, and ``build_image_reward_grad_fn``, the
differentiable ImageReward of ``--trainer draft``. The agent builders
take ``device`` ("cuda" by default, which raises without a card; the tests
pass "cpu"); the others run where the modules they are given live. Not
ported yet: the checkpoint loading of the reward and the VAE (ROADMAP
queue 1, item 8).
"""

from __future__ import annotations

import functools
import hashlib
import logging
from typing import Callable, Optional

import torch

from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from tpdm_tpu_torch.models.tpm import TimePredictor
from tpdm_tpu_torch.models.vae import VAE
from tpdm_tpu_torch.pipeline.pipeline import (
    decode_latents,
    load_pipeline_from_pretrained,
    not_ported,
    resolve_device,
)
from tpdm_tpu_torch.rewards.image_reward import ImageRewardModel
from tpdm_tpu_torch.train.config import RLOOConfig
from tpdm_tpu_torch.train.rloo import TPDMAgent
from tpdm_tpu_torch.utils.bert_tokenizer import BertTokenizer
from tpdm_tpu_torch.utils.image import uint8_images

logger = logging.getLogger(__name__)


SD3_VARIANTS = ("sd3_medium", "sd35_medium", "sd35_large")


def build_toy_agent(config: RLOOConfig, seed: int = 0, device="cuda") -> TPDMAgent:
    """Random-weight toy agent (the toy MMDiT, a 4-channel TPM), fp32."""
    device = resolve_device(device)
    with torch.device(device):
        mmdit = MMDiT(MMDiTConfig.toy())
    mmdit.init_weights(torch.Generator(device=device).manual_seed(seed)).eval()
    mcfg = mmdit.config
    tpm = functools.partial(TimePredictor, conv_out_channels=4, in_channels=2 * mcfg.inner_dim,
                            temb_dim=mcfg.inner_dim, init_alpha=config.init_alpha,
                            init_beta=config.init_beta)
    return TPDMAgent(mmdit, config, tpm=tpm)


def build_sd3_agent(
    config: RLOOConfig,
    pretrained: str,
    tpm_checkpoint: Optional[str] = None,
    dtype: str = "bfloat16",
    variant: str = "sd3_medium",
    device="cuda",
) -> TPDMAgent:
    """Agent over a local diffusers-layout checkpoint directory
    (``pipeline.load_pipeline_from_pretrained`` without the text towers):
    ``variant`` names the ``MMDiTConfig`` classmethod (``sd3_medium``,
    ``sd35_medium`` or ``sd35_large``). The agent's TPM factory builds the
    pipeline's TPM (128 channels, its default head bias, computing in
    ``dtype``), as the JAX builder passes ``pipe.tpm``. Training starts
    from a ``tpm_checkpoint``'s weights (``TPDMAgent(tpm_start=)``), and
    from weights drawn by the trainer without one."""
    if variant not in SD3_VARIANTS:
        raise ValueError(f"variant must be one of {SD3_VARIANTS}, got {variant!r}")
    tdtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    mcfg = getattr(MMDiTConfig, variant)(dtype=tdtype)
    pipe = load_pipeline_from_pretrained(pretrained, dtype=tdtype, load_text_encoders=False,
                                         tpm_checkpoint=tpm_checkpoint, mmdit_config=mcfg,
                                         device=device)
    tpm = functools.partial(TimePredictor, conv_out_channels=128, in_channels=2 * mcfg.inner_dim,
                            temb_dim=mcfg.inner_dim, dtype=tdtype)
    start = pipe.tpm.state_dict() if tpm_checkpoint is not None else None
    return TPDMAgent(pipe.mmdit, config, tpm=tpm, tpm_start=start)


def build_toy_reward() -> Callable:
    """Deterministic latent-statistic reward: tanh of each sample's mean
    final latent."""

    def reward_fn(prompts, outputs):
        s = torch.tanh(outputs.final_latents.float().mean(dim=(1, 2, 3)))
        return s, s

    return reward_fn


def build_toy_draft_reward() -> Callable:
    """Differentiable latent-mean reward for ``--trainer draft`` toy runs
    (DraftTrainer's reward_apply contract: (images, batch) -> (b,) scores
    with gradients)."""

    def reward_apply(images, batch):
        return images.mean(dim=(1, 2, 3))

    return reward_apply


def build_image_reward_fn(
    vae: VAE,
    reward_model: ImageRewardModel,
    tokenizer: BertTokenizer,
    max_length: int = 35,
) -> Callable:
    """ImageReward as the trainer's reward: each sample's final latents
    decoded by ``pipeline.decode_latents`` (the VAE in its own dtype: bf16
    with K2 on the card), turned into uint8 images on the same device, and
    scored with the prompts tokenized by ``tokenizer`` at ``max_length``.
    The whole batch decodes in one call and scores in one call."""

    def reward_fn(prompts, outputs):
        with torch.no_grad():
            images = uint8_images(decode_latents(vae, outputs.final_latents))
        enc = tokenizer(list(prompts), padding="max_length", truncation=True,
                        max_length=max_length, return_tensors="np")
        scores = reward_model.score(enc["input_ids"], images,
                                    text_mask=enc["attention_mask"].astype(bool))
        return scores, scores

    return reward_fn


def build_image_reward_grad_fn(
    vae: Optional[VAE] = None,
    reward_model: Optional[ImageRewardModel] = None,
    tokenizer: Optional[BertTokenizer] = None,
    tokenizer_path: Optional[str] = None,
    reward_checkpoint: Optional[str] = None,
    max_length: int = 35,
    seed: int = 0,
    device="cuda",
) -> Callable:
    """ImageReward as DraftTrainer's differentiable ``reward_apply(final
    latents, batch)``: ``models/vae.py:make_fast_decode`` (the 1024 px
    decode under autograd, K2's backward in the mid block), then
    ``train/draft.py:build_image_reward_grad_apply`` (the cubic resize and
    ``score_grad``), the prompts (``batch["prompt"]``) tokenized by
    ``tokenizer`` at ``max_length``. Without a ``vae`` an SD3 VAE decoder
    and without a ``reward_model`` an ImageReward are built on ``device``
    with random weights from ``seed`` (the checkpoint converters are ROADMAP
    queue 1, item 8); without a ``tokenizer`` one is read from
    ``tokenizer_path`` (a BERT vocab.txt)."""
    from tpdm_tpu_torch.models.vae import VAEConfig, make_fast_decode
    from tpdm_tpu_torch.train.draft import build_image_reward_grad_apply

    if reward_checkpoint is not None:
        raise not_ported("reward_checkpoint (convert_image_reward)", "8")
    if vae is None:
        device = resolve_device(device)
        with torch.device(device):
            vae = VAE(VAEConfig.sd3(), encoder=False)
        vae.init_weights(torch.Generator(device=device).manual_seed(seed))
        vae = vae.to(torch.bfloat16 if device.type == "cuda" else torch.float32).eval()
        logger.warning("draft ImageReward decoding with a RANDOM-weight VAE")
    if reward_model is None:
        reward_model = ImageRewardModel.create(seed=seed + 1, device=device)
        logger.warning("draft ImageReward running with RANDOM weights")
    if tokenizer is None:
        if tokenizer_path is None:
            raise ValueError("the ImageReward needs a BERT vocab.txt path")
        tokenizer = BertTokenizer.from_pretrained(tokenizer_path)
    vae.requires_grad_(False)
    decode = make_fast_decode(vae)
    score = build_image_reward_grad_apply(reward_model)

    def reward_apply(latents, batch):
        enc = tokenizer(list(batch["prompt"]), padding="max_length", truncation=True,
                        max_length=max_length, return_tensors="np")
        return score(decode(latents), {"reward_ids": enc["input_ids"],
                                       "reward_mask": enc["attention_mask"].astype(bool)})

    return reward_apply


def build_inference_ranker(
    reward_checkpoint: Optional[str] = None,
    tokenizer_path: Optional[str] = None,
    max_length: int = 35,
    reward_model: Optional[ImageRewardModel] = None,
    tokenizer: Optional[BertTokenizer] = None,
    device="cuda",
) -> Callable:
    """Best-of-N candidate ranker for serving: ``(prompt, images_uint8 (k,
    H, W, 3)) -> (ranking, rewards)`` by ``ImageRewardModel.inference_rank``.

    ``reward_model`` and ``tokenizer`` are injected (toy towers, a random
    ImageReward, a WordPiece vocabulary written at run time); without a
    model, a random-weight ImageReward is built on ``device``, and without a
    tokenizer one is read from ``tokenizer_path`` (a BERT vocab.txt).
    ``reward_checkpoint`` needs the ImageReward converter, not ported yet
    (ROADMAP queue 1, item 8).
    """
    if reward_checkpoint is not None:
        raise not_ported("reward_checkpoint (convert_image_reward)", "8")
    if reward_model is None:
        reward_model = ImageRewardModel.create(device=device)
        logger.warning("ImageReward ranker running with RANDOM weights")
    if tokenizer is None:
        if tokenizer_path is None:
            raise ValueError("ranker needs a BERT vocab.txt path")
        tokenizer = BertTokenizer.from_pretrained(tokenizer_path)

    def ranker(prompt: str, images):
        enc = tokenizer([prompt], padding="max_length", truncation=True,
                        max_length=max_length, return_tensors="np")
        return reward_model.inference_rank(enc["input_ids"][0], images,
                                           text_mask=enc["attention_mask"][0].astype(bool))

    return ranker


def _strip_prefix(prompt: str) -> str:
    """The reference collator drops a leading "The image shows "."""
    prefix = "The image shows "
    return prompt[len(prefix):] if prompt.startswith(prefix) else prompt


def make_prompt_encoder(agent: TPDMAgent, n_txt: int = 8, seed: int = 1234) -> Callable:
    """A collate function for toy and random-weight runs without text
    towers: rows {"prompt": str} -> {"prompt": [...], "prompt_embeds" (b,
    n_txt, joint_dim), "pooled_prompt_embeds" (b, pooled_dim), and zero
    negatives}, in the MMDiT's dtype on its device. Every distinct prompt
    maps to a fixed N(0, 1) embedding, drawn from a ``torch.Generator`` on
    that device seeded by the md5 digest of "prompt|seed" (stable across
    processes, unlike ``hash()``). The embeddings differ from the JAX
    package's, which come from ``jax.random`` under the same digest."""
    mcfg = agent.mmdit.config
    device, dtype = agent.device, agent.dtype

    def collate_with_embeds(rows):
        prompts = [_strip_prefix(r["prompt"]) for r in rows]
        pe, pp = [], []
        for p in prompts:
            digest = hashlib.md5(f"{p}|{seed}".encode()).digest()
            g = torch.Generator(device=device).manual_seed(int.from_bytes(digest[:4], "little"))
            pe.append(torch.randn((n_txt, mcfg.joint_attention_dim), generator=g, device=device))
            pp.append(torch.randn((mcfg.pooled_projection_dim,), generator=g, device=device))
        pe, pp = torch.stack(pe).to(dtype), torch.stack(pp).to(dtype)
        return {"prompt": prompts, "prompt_embeds": pe, "pooled_prompt_embeds": pp,
                "negative_prompt_embeds": torch.zeros_like(pe),
                "negative_pooled_prompt_embeds": torch.zeros_like(pp)}

    return collate_with_embeds
