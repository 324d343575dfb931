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

from tpdm_tpu_torch.ops.quant import DenseMaybeQuant


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
    (including its meshgrid order: the "h" half takes the w-varying grid).

    Row i * m + j is (e[j], e[i]), e the 1-D embedding of the m coordinates:
    each element is the same float64 product, sin or cos as diffusers' m² x
    embed_dim evaluation, so the table is bit-identical to it, at m x
    embed_dim of the work (SD3.5-medium's 384² x 1536 table)."""
    grid_h = (
        np.arange(grid_size, dtype=np.float64) / (grid_size / base_size) / interpolation_scale
    )
    half = embed_dim // 2
    omega = 1.0 / 10000.0 ** (np.arange(half // 2, dtype=np.float64) / (half / 2.0))
    out = np.einsum("m,d->md", grid_h, omega)
    e = np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)
    table = np.empty((grid_size, grid_size, 2 * half), np.float32)
    table[:, :, :half] = e[None, :, :]
    table[:, :, half:] = e[:, None, :]
    return table.reshape(grid_size * grid_size, 2 * half)


def get_2d_sincos_pos_embed_fp32(
    embed_dim: int,
    grid_size: int,
    base_size: int,
    device: torch.device = None,
) -> torch.Tensor:
    """``get_2d_sincos_pos_embed`` computed in fp32 torch on ``device``, as
    ``tpdm_tpu/models/layers.py:get_2d_sincos_pos_embed_jnp``: the table for
    a grid larger than the stored one, made when it is needed rather than
    kept as a (grid², embed_dim) buffer."""
    coords = torch.arange(grid_size, dtype=torch.float32, device=device) / (grid_size / base_size)
    gw, gh = torch.meshgrid(coords, coords, indexing="xy")  # w first, per diffusers

    def _1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
        omega = torch.arange(dim // 2, dtype=torch.float32, device=device) / (dim / 2.0)
        omega = 1.0 / 10000.0**omega
        out = pos.reshape(-1)[:, None] * omega[None, :]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    # the "h" half takes the w-varying grid, as in the stored table
    return torch.cat([_1d(embed_dim // 2, gw), _1d(embed_dim // 2, gh)], dim=1)


def _layer_norm_fp32(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm over the last axis with fp32 statistics."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm with a learned scale (``weight``, JAX's ``scale``), fp32
    statistics, output in the input's dtype: SD3.5's qk norm."""

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
    as in the JAX package. A token grid larger than the stored table (SD3
    at 2048 px: 128 x 128 against 96 x 96) gets the table regenerated at
    m = max(gh, gw) with the same base_size, whose coordinates stay in the
    trained [0, base_size) range (``tpdm_tpu/models/layers.py:233-247``)."""

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
        self.base_size = base_size
        self.proj = nn.Linear(patch_size * patch_size * in_channels, embed_dim)
        table = get_2d_sincos_pos_embed(embed_dim, pos_embed_max_size, base_size)
        self.register_buffer("pos_embed", torch.from_numpy(table), persistent=False)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """(b, c, h, w) -> (b, (h/p)(w/p), embed_dim)."""
        b, c, h, w = latent.shape
        p, m = self.patch_size, self.pos_embed_max_size
        gh, gw = h // p, w // p
        table = self.pos_embed
        if gh > m or gw > m:
            m = max(gh, gw)
            table = get_2d_sincos_pos_embed_fp32(self.embed_dim, m, self.base_size, latent.device)
        x = latent.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1)
        x = self.proj(x.reshape(b, gh * gw, p * p * c))
        top, left = (m - gh) // 2, (m - gw) // 2
        pos = table.reshape(m, m, self.embed_dim)[top : top + gh, left : left + gw]
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


class AdaLayerNormZeroX(nn.Module):
    """SD3.5's dual-attention AdaLN: temb -> 9 modulation vectors (the six of
    ``AdaLayerNormZero``, then shift, scale and gate of the image-only
    attention); returns (normed x, gate_msa, shift_mlp, scale_mlp, gate_mlp,
    normed x for attn2, gate_msa2). Both branches share one LayerNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 9 * dim)

    def forward(self, x: torch.Tensor, emb: torch.Tensor):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp,
         shift_msa2, scale_msa2, gate_msa2) = self.linear(F.silu(emb)).chunk(9, dim=-1)
        normed = _layer_norm_fp32(x)
        out1 = normed * (1.0 + scale_msa[:, None]) + shift_msa[:, None]
        out2 = normed * (1.0 + scale_msa2[:, None]) + shift_msa2[:, None]
        return out1, gate_msa, shift_mlp, scale_mlp, gate_mlp, out2, gate_msa2


class AdaLayerNormContinuous(nn.Module):
    """LN(x)·(1+scale) + shift with chunk order (scale, shift) — the
    opposite of AdaLayerNormZero (diffusers ``AdaLayerNormContinuous``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        scale, shift = self.linear(F.silu(cond)).chunk(2, dim=-1)
        return _layer_norm_fp32(x) * (1.0 + scale[:, None]) + shift[:, None]


def dense(in_features: int, out_features: int, quant: bool = False, bits: int = 8,
          act_quant: bool = True) -> nn.Module:
    """``nn.Linear``, or with ``quant`` a quantised ``DenseMaybeQuant``: the
    matmuls that the JAX package builds as ``DenseMaybeQuant``
    (``act_quant=False``: weight-only int8 at 8 bits)."""
    if quant:
        return DenseMaybeQuant(in_features, out_features, bits=bits, act_quant=act_quant)
    return nn.Linear(in_features, out_features)


class FeedForward(nn.Module):
    """proj_in -> tanh-GELU -> proj_out, hidden width mult·dim; both
    projections quantised with ``quant`` (int8 W8A8, or int4 weight-only at
    ``quant_bits`` 4)."""

    def __init__(self, dim: int, mult: int = 4, quant: bool = False, quant_bits: int = 8):
        super().__init__()
        self.proj_in = dense(dim, dim * mult, quant, quant_bits)
        self.proj_out = dense(dim * mult, dim, quant, quant_bits)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(F.gelu(self.proj_in(x), approximate="tanh"))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator, std: float) -> nn.Module:
    """Random weights from ``generator`` (on the module's device): every
    Linear, float DenseMaybeQuant and Conv2d weight ~ N(0, std²) and bias 0,
    every norm weight 1 and bias 0. For runs without converted weights."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)) or (
            isinstance(m, DenseMaybeQuant) and not m.quantized
        ):
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (GroupNorm, RMSNorm)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    return module


@torch.no_grad()
def init_weights_by_rank(module: nn.Module, generator: torch.Generator, std: float) -> nn.Module:
    """Random weights from ``generator`` (on the module's device) for towers
    whose tables are parameters of their own (embeddings, position and
    relative-position tables): every parameter of two or more dimensions
    ~ N(0, std²), every ``bias`` 0 and every other vector (norm weights) 1."""
    for name, p in module.named_parameters():
        if name.rsplit(".", 1)[-1] == "bias":
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, std, generator=generator)
    return module
