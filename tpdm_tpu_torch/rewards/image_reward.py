"""ImageReward: the BLIP ViT-L, BERT-med with cross-attention, and an MLP
head.

Counterpart of ``tpdm_tpu/rewards/image_reward.py``:

    image_embeds = vit(image_224)
    txt = bert(prompt_ids, cross_attend=image_embeds).last_hidden[:, 0]
    r = mlp(txt);  score = (r - IR_MEAN) / IR_STD + 3 IR_STD

The whole batch scores in one call, on the model's device, in fp32 (the
JAX module's dtype). Not ported yet: ``score_grad`` and the checkpoint
converters (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from tpdm_tpu_torch.models.layers import init_weights_by_rank
from tpdm_tpu_torch.rewards.bert import BertMedConfig, BertMedModel
from tpdm_tpu_torch.rewards.vit import ViT, ViTConfig
from tpdm_tpu_torch.utils.image import bicubic_resize_center_crop, normalize_clip

# the reference's normalisation constants
IR_MEAN = 0.16717362830052426
IR_STD = 1.0333394966054072


class RewardMLP(nn.Module):
    """hidden -> 1024 -> 128 -> 64 -> 16 -> 1, a plain linear stack (the
    reference's activations are commented out)."""

    def __init__(self, in_features: int = 768):
        super().__init__()
        widths = (in_features, 1024, 128, 64, 16, 1)
        for i in range(5):
            setattr(self, f"fc{i}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(5):
            x = getattr(self, f"fc{i}")(x)
        return x


class ImageRewardNet(nn.Module):
    """(pixels (b, 3, S, S), ids (b, n), text mask) -> raw rewards (b,)."""

    def __init__(self, vit_config: ViTConfig, bert_config: BertMedConfig):
        super().__init__()
        self.vit_config, self.bert_config = vit_config, bert_config
        self.visual_encoder = ViT(vit_config)
        self.text_encoder = BertMedModel(bert_config)
        self.mlp = RewardMLP(bert_config.hidden_size)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor, text_mask=None):
        image_embeds = self.visual_encoder(pixels)
        txt = self.text_encoder(input_ids, attention_mask=text_mask,
                                encoder_hidden_states=image_embeds)
        return self.mlp(txt[:, 0])[:, 0]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> "ImageRewardNet":
        """Random weights from ``generator`` (on the net's device): every
        linear, conv, embedding, cls token and position table ~ N(0, std²),
        biases 0, LayerNorms 1 and 0. For runs without a checkpoint."""
        return init_weights_by_rank(self, generator, std)


class ImageRewardModel:
    """``score(prompt_ids, images_uint8)`` -> reference-normalised rewards.

    Tokenize the prompts on the host (``utils/bert_tokenizer.py``,
    max_length 35) and pass the ids.
    """

    def __init__(self, net: ImageRewardNet):
        self.net = net.eval()
        self.image_size = net.vit_config.image_size

    @classmethod
    def create(
        cls,
        state_dict: Optional[dict] = None,
        vit_config: Optional[ViTConfig] = None,
        bert_config: Optional[BertMedConfig] = None,
        seed: int = 0,
        device="cuda",
    ) -> "ImageRewardModel":
        """The ViT-L / BERT-med net (or the given configs) on ``device``,
        fp32, with ``state_dict``'s weights (e.g. from
        ``utils/convert.py:image_reward_from_jax``) or random ones drawn from
        ``seed`` there. ``device="cuda"`` raises without a card."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ImageRewardModel.create: no CUDA device; pass device='cpu'")
        with torch.device(device):
            net = ImageRewardNet(vit_config or ViTConfig.blip_large(),
                                 bert_config or BertMedConfig.image_reward())
        if state_dict is None:
            net.init_weights(torch.Generator(device=device).manual_seed(seed))
        else:
            net.load_state_dict(state_dict)
        return cls(net.requires_grad_(False))

    @property
    def device(self) -> torch.device:
        return self.net.mlp.fc0.weight.device

    def _check_ids(self, prompt_ids) -> None:
        # an id out of the vocabulary would index past the embedding table:
        # an IndexError on the CPU, a device-side assert on the card
        vocab = self.net.bert_config.vocab_size
        ids = np.asarray(prompt_ids)
        if ids.size and (ids.min() < 0 or ids.max() >= vocab):
            raise ValueError(
                f"prompt ids out of range for vocab_size={vocab}: "
                f"min={ids.min()}, max={ids.max()} — tokenizer/model mismatch?"
            )

    @torch.no_grad()
    def _raw_scores(self, prompt_ids, images, text_mask) -> torch.Tensor:
        self._check_ids(prompt_ids)
        dev = self.device
        ids = torch.as_tensor(np.asarray(prompt_ids), device=dev).long()
        mask = (torch.ones_like(ids, dtype=torch.bool) if text_mask is None
                else torch.as_tensor(np.asarray(text_mask), device=dev).bool())
        images = torch.as_tensor(images, device=dev)
        pixels = normalize_clip(bicubic_resize_center_crop(images, self.image_size))
        return self.net(pixels, ids, mask)

    def score(self, prompt_ids, images, text_mask=None) -> torch.Tensor:
        """(b, n) int ids and (b, H, W, 3) uint8 images (numpy or tensors)
        -> (b,) fp32 scores (r - IR_MEAN) / IR_STD + 3 IR_STD on the
        model's device."""
        r = self._raw_scores(prompt_ids, images, text_mask)
        return (r - IR_MEAN) / IR_STD + 3 * IR_STD

    def inference_rank(self, prompt_ids, images, text_mask=None) -> tuple[list, list]:
        """Rank k candidate images of ONE prompt (ids (n,) or (1, n)).
        Returns (ranking, rewards) in the candidates' order: ranking[i] is
        candidate i's 1-based rank (1 = best), rewards[i] = (r - IR_MEAN) /
        IR_STD, without the +3σ shift, as the reference."""
        k = int(images.shape[0])
        ids = np.asarray(prompt_ids).reshape(1, -1).repeat(k, axis=0)
        mask = (None if text_mask is None
                else np.asarray(text_mask).reshape(1, -1).repeat(k, axis=0).astype(bool))
        r = self._raw_scores(ids, images, mask)
        rewards = (r.double().cpu().numpy() - IR_MEAN) / IR_STD
        order = np.argsort(-rewards, kind="stable")
        ranking = np.empty(k, dtype=int)
        ranking[order] = np.arange(1, k + 1)
        return ranking.tolist(), rewards.tolist()
