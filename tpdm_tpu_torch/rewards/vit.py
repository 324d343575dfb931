"""The BLIP Vision Transformer, ImageReward's visual encoder.

Counterpart of ``tpdm_tpu/rewards/vit.py``: conv patchify, a cls token, a
learned position table, pre-norm blocks with a fused qkv, a final
LayerNorm. Submodules carry the Flax names (``blocks.{i}.qkv``, ...), so
``utils/convert.py:image_reward_from_jax`` maps the JAX parameters one to
one. Attention is plain ``torch.matmul`` and softmax, as the JAX module's
is plain einsum: no kernel of the repository is replaced here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6

    @classmethod
    def blip_large(cls, **kw) -> "ViTConfig":
        return cls(**kw)

    @classmethod
    def toy(cls, **kw) -> "ViTConfig":
        d = dict(image_size=16, patch_size=8, embed_dim=24, depth=2, num_heads=3)
        d.update(kw)
        return cls(**d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (b, h, n, d) heads with an fp32
    softmax; key positions where ``mask`` (b, n_kv) is False get -1e9, as
    the JAX modules set them."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :].bool(), -1e9)
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, int(d * cfg.mlp_ratio))
        self.fc2 = nn.Linear(int(d * cfg.mlp_ratio), d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        qkv = self.qkv(self.norm1(x)).reshape(b, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
        o = attention(qkv[0], qkv[1], qkv[2]).transpose(1, 2).reshape(b, n, d)
        x = x + self.proj(o)
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class ViT(nn.Module):
    """pixels (b, 3, H, W), normalised -> token embeddings (b, 1 + n, d)."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        cfg = self.config = config
        d, p = cfg.embed_dim, cfg.patch_size
        n = (cfg.image_size // p) ** 2
        self.patch_embed = nn.Conv2d(3, d, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, d))
        self.blocks = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(pixels).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.norm(x)
