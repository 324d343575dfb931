"""BERT "med" with a cross-attention sublayer in every block: ImageReward's
text encoder.

Counterpart of ``tpdm_tpu/rewards/bert.py``'s ``BertMedModel`` in encoder
mode: HF-BERT post-norm residuals (eps 1e-12), bidirectional
self-attention over the prompt tokens (padding masked), then
cross-attention to the image tokens. Submodules carry the Flax names
(``layer.{i}.attention_self.query``, ``cross_self``, ...). Not ported yet:
the causal decoder, the LM head and ``greedy_caption``, which ImageReward's
score does not run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpdm_tpu_torch.rewards.vit import attention


@dataclasses.dataclass(frozen=True)
class BertMedConfig:
    vocab_size: int = 30524  # bert-base + 2 BLIP special tokens
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    encoder_width: int = 1024  # image-token width (ViT-L)
    layer_norm_eps: float = 1e-12

    @classmethod
    def image_reward(cls, **kw) -> "BertMedConfig":
        return cls(**kw)

    @classmethod
    def toy(cls, **kw) -> "BertMedConfig":
        d = dict(vocab_size=50, hidden_size=24, num_hidden_layers=2, num_attention_heads=3,
                 intermediate_size=40, max_position_embeddings=16, encoder_width=24)
        d.update(kw)
        return cls(**d)


class _Attention(nn.Module):
    """q from x, k and v from y (self-attention when y is x)."""

    def __init__(self, cfg: BertMedConfig, kv_width: int):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(kv_width, d)
        self.value = nn.Linear(kv_width, d)

    def forward(self, x, y, mask: Optional[torch.Tensor]):
        b, n, d = x.shape
        h = self.num_heads
        heads = lambda t: t.reshape(b, t.shape[1], h, d // h).transpose(1, 2)
        o = attention(heads(self.query(x)), heads(self.key(y)), heads(self.value(y)), mask)
        return o.transpose(1, 2).reshape(b, n, d)


class BertMedLayer(nn.Module):
    def __init__(self, cfg: BertMedConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention_self = _Attention(cfg, d)
        self.attention_output = nn.Linear(d, d)
        self.attention_ln = nn.LayerNorm(d, eps=eps)
        self.cross_self = _Attention(cfg, cfg.encoder_width)
        self.cross_output = nn.Linear(d, d)
        self.cross_ln = nn.LayerNorm(d, eps=eps)
        self.intermediate = nn.Linear(d, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, d)
        self.output_ln = nn.LayerNorm(d, eps=eps)

    def forward(self, x, image_embeds, text_mask, image_mask):
        x = self.attention_ln(x + self.attention_output(self.attention_self(x, x, text_mask)))
        if image_embeds is not None:
            cross = self.cross_self(x, image_embeds, image_mask)
            x = self.cross_ln(x + self.cross_output(cross))
        return self.output_ln(x + self.output(F.gelu(self.intermediate(x))))


class BertMedModel(nn.Module):
    """(ids (b, n), masks, image tokens) -> last hidden state (b, n, hidden)."""

    def __init__(self, config: BertMedConfig):
        super().__init__()
        cfg = self.config = config
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size))
        self.embeddings_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layer = nn.ModuleList(BertMedLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        encoder_attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        n = input_ids.shape[1]
        x = self.embeddings_ln(self.word_embeddings(input_ids) + self.position_embeddings[:n])
        for layer in self.layer:
            x = layer(x, encoder_hidden_states, attention_mask, encoder_attention_mask)
        return x
