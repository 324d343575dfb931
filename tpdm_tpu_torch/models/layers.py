"""Shared building blocks for the diffusion transformer, TPM and VAE.

Counterpart of ``tpdm_tpu/models/layers.py``. Submodule names follow the
JAX package's Flax names so that ``utils/convert.py`` maps parameter trees
one to one. Matmuls and convs run in the weights' dtype (bf16 on the card);
normalisation statistics are fp32, with the output in the input's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    scale: float = 1.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """(b,) timesteps -> (b, dim) fp32 sin/cos features (diffusers
    ``get_timestep_embedding``; SD3 uses flip_sin_to_cos, shift 0)."""
    half_dim = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.to(torch.float32)[:, None] * torch.exp(exponent)[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    return emb


def get_2d_sincos_pos_embed(
    embed_dim: int,
    grid_size: int,
    base_size: int,
    interpolation_scale: float = 1.0,
) -> np.ndarray:
    """(grid_size², embed_dim) fp32 sincos position table, diffusers layout
    (including its meshgrid order: the "h" half takes the w-varying grid)."""
    grid_h = (
        np.arange(grid_size, dtype=np.float64) / (grid_size / base_size) / interpolation_scale
    )
    grid = np.stack(np.meshgrid(grid_h, grid_h), axis=0).reshape([2, grid_size, grid_size])

    def _1d(dim: int, pos: np.ndarray) -> np.ndarray:
        omega = 1.0 / 10000.0 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def _layer_norm_fp32(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm over the last axis with fp32 statistics."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm with a learned scale (``weight``), fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        out = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (out * self.weight.float()).to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW input: fp32 statistics and affine, output in the
    input's dtype (the fast-decode policy of the JAX package's VAE)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(
            x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps
        )
        return y.to(x.dtype)


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2 over the 256 sinusoidal features."""

    def __init__(self, in_dim: int, embedding_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embedding_dim)
        self.linear_2 = nn.Linear(embedding_dim, embedding_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class TextProjection(nn.Module):
    """Pooled-text MLP: linear_1 -> silu -> linear_2."""

    def __init__(self, in_dim: int, hidden_size: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, hidden_size)
        self.linear_2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, caption: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(caption)))


class CombinedTimestepTextEmbed(nn.Module):
    """temb = MLP(sinusoid(t)) + MLP(pooled text)."""

    def __init__(self, embedding_dim: int, pooled_projection_dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, embedding_dim)
        self.text_embedder = TextProjection(pooled_projection_dim, embedding_dim)

    def forward(self, timestep: torch.Tensor, pooled_projection: torch.Tensor) -> torch.Tensor:
        t_feat = sinusoidal_timestep_embedding(timestep, 256).to(pooled_projection.dtype)
        return self.timestep_embedder(t_feat) + self.text_embedder(pooled_projection)


class PatchEmbed(nn.Module):
    """Patchify NCHW latents into tokens and add the center-cropped sincos
    table. The stride-p conv is a Linear over each (p, p, c)-ordered patch,
    as in the JAX package."""

    def __init__(
        self,
        patch_size: int,
        in_channels: int,
        embed_dim: int,
        pos_embed_max_size: int,
        base_size: int,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.pos_embed_max_size = pos_embed_max_size
        self.proj = nn.Linear(patch_size * patch_size * in_channels, embed_dim)
        table = get_2d_sincos_pos_embed(embed_dim, pos_embed_max_size, base_size)
        self.register_buffer("pos_embed", torch.from_numpy(table), persistent=False)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """(b, c, h, w) -> (b, (h/p)(w/p), embed_dim)."""
        b, c, h, w = latent.shape
        p, m = self.patch_size, self.pos_embed_max_size
        gh, gw = h // p, w // p
        if gh > m or gw > m:
            raise NotImplementedError(
                f"a {gh}x{gw} token grid exceeds the stored {m}x{m} position "
                "table; regenerating it (2048 px generation) is not ported yet"
            )
        x = latent.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1)
        x = self.proj(x.reshape(b, gh * gw, p * p * c))
        top, left = (m - gh) // 2, (m - gw) // 2
        pos = self.pos_embed.reshape(m, m, self.embed_dim)[top : top + gh, left : left + gw]
        return x + pos.reshape(1, gh * gw, self.embed_dim).to(x.dtype)


class AdaLayerNormZero(nn.Module):
    """temb -> 6 modulation vectors (shift, scale, gate for attention, then
    for the MLP); returns (normed x, gate_msa, shift_mlp, scale_mlp, gate_mlp)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 6 * dim)

    def forward(self, x: torch.Tensor, emb: torch.Tensor):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.linear(
            F.silu(emb)
        ).chunk(6, dim=-1)
        normed = _layer_norm_fp32(x) * (1.0 + scale_msa[:, None]) + shift_msa[:, None]
        return normed, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormContinuous(nn.Module):
    """LN(x)·(1+scale) + shift with chunk order (scale, shift) — the
    opposite of AdaLayerNormZero (diffusers ``AdaLayerNormContinuous``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        scale, shift = self.linear(F.silu(cond)).chunk(2, dim=-1)
        return _layer_norm_fp32(x) * (1.0 + scale[:, None]) + shift[:, None]


class FeedForward(nn.Module):
    """proj_in -> tanh-GELU -> proj_out, hidden width mult·dim."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj_in = nn.Linear(dim, dim * mult)
        self.proj_out = nn.Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(F.gelu(self.proj_in(x), approximate="tanh"))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator, std: float) -> nn.Module:
    """Random weights from ``generator`` (on the module's device): every
    Linear and Conv2d weight ~ N(0, std²) and bias 0, every norm weight 1
    and bias 0. For runs without converted weights."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (GroupNorm, RMSNorm)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    return module
