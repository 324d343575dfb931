"""CLIP text encoder with projection (SD3's text_encoder / text_encoder_2).

Counterpart of ``tpdm_tpu/models/clip_text.py``: the transformers
``CLIPTextModelWithProjection`` architecture. Submodules carry the Flax
names (``layers.{i}.self_attn.q_proj``, ``final_layer_norm``,
``text_projection``), so ``utils/convert.py:clip_text_from_jax`` maps a
Flax tree one to one. The numerics follow the JAX module: scores in fp32
scaled by hd**-0.5, the causal mask at -3.4e38, an fp32 softmax cast to
V's dtype. The attention stays in plain torch ops: its causal mask is not
what K1 computes, and at 77 tokens it is a small share of the tower. The
dense layers go to cuBLAS through ``nn.Linear``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tpdm_tpu_torch.models.layers import init_weights_by_rank

_NEG_INF = -3.4e38


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # CLIP-L; CLIP-G uses "gelu"
    projection_dim: int = 768
    eos_token_id: int = 49407
    layer_norm_eps: float = 1e-5

    @classmethod
    def sd3_clip_l(cls, **kw) -> "CLIPTextConfig":
        return cls(**kw)

    @classmethod
    def sd3_clip_g(cls, **kw) -> "CLIPTextConfig":
        d = dict(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                 num_attention_heads=20, hidden_act="gelu", projection_dim=1280)
        d.update(kw)
        return cls(**d)

    @classmethod
    def toy(cls, **kw) -> "CLIPTextConfig":
        d = dict(vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=16, projection_dim=24,
                 eos_token_id=98)
        d.update(kw)
        return cls(**d)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    if name == "gelu_new":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown act {name}")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        hd = d // h
        heads = lambda t: t.reshape(b, n, h, hd).transpose(1, 2)
        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd**-0.5
        s = s.masked_fill(~causal, _NEG_INF)
        o = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
        return self.out_proj(o.transpose(1, 2).reshape(b, n, d))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, d)
        self.act = _act(cfg.hidden_act)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class CLIPTextModel(nn.Module):
    """ids (b, n) -> (penultimate_hidden, final_hidden, pooled, projected).

    - penultimate_hidden: hidden_states[-2], what SD3 feeds the MMDiT;
    - final_hidden: the final LayerNorm's output;
    - pooled: final_hidden at each row's first ``eos_token_id`` (position 0
      in a row without one);
    - projected: ``text_projection(pooled)``, (b, projection_dim).
    """

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        cfg = self.config = config
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size))
        self.layers = nn.ModuleList(CLIPLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> "CLIPTextModel":
        """Random weights from ``generator`` (on the module's device): every
        linear, the embedding and the position table ~ N(0, std²), biases
        0, LayerNorms 1 and 0. For runs without converted weights."""
        return init_weights_by_rank(self, generator, std)

    def forward(self, input_ids: torch.Tensor):
        b, n = input_ids.shape
        tok = self.token_embedding(input_ids)
        x = tok + self.position_embedding[:n].to(tok.dtype)
        causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        penultimate = None
        for i, layer in enumerate(self.layers):
            if i == len(self.layers) - 1:
                penultimate = x
            x = layer(x, causal)
        final = self.final_layer_norm(x)
        eos_idx = (input_ids == self.config.eos_token_id).int().argmax(dim=1)
        pooled = final[torch.arange(b, device=final.device), eos_idx]
        return penultimate, final, pooled, self.text_projection(pooled)

