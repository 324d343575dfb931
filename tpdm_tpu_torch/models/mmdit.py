"""SD3 MMDiT denoiser in PyTorch.

Counterpart of ``tpdm_tpu/models/mmdit.py``: SD3-medium's MMDiT, returning
``(velocity, temb, h1, h2)`` where h1 are the post-PatchEmbed tokens and h2
the post-final-AdaLN tokens that feed the Time Prediction Module. The joint
attention runs kernel K1 on the card (``ops/attention.py``).

Not ported yet: SD3.5's dual attention and qk RMSNorm, sequence
parallelism, the Δ-cache ``cache_mode`` and quantised matmuls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from tpdm_tpu_torch.models.layers import (
    AdaLayerNormContinuous,
    AdaLayerNormZero,
    CombinedTimestepTextEmbed,
    FeedForward,
    PatchEmbed,
    _layer_norm_fp32,
    init_weights,
)
from tpdm_tpu_torch.ops.attention import joint_attention


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """SD3-family MMDiT hyperparameters (defaults = SD3-medium)."""

    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 96
    dual_attention_layers: Tuple[int, ...] = ()
    qk_norm: Optional[str] = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def sd3_medium(cls, **kw) -> "MMDiTConfig":
        return cls(**kw)

    @classmethod
    def toy(cls, **kw) -> "MMDiTConfig":
        """Tiny config for tests: 2 layers, 8x8 latents, 64-dim."""
        defaults = dict(
            sample_size=8,
            num_layers=2,
            attention_head_dim=16,
            num_attention_heads=4,
            joint_attention_dim=32,
            caption_projection_dim=64,
            pooled_projection_dim=48,
            pos_embed_max_size=12,
            dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)


class JointAttention(nn.Module):
    """MMDiT joint attention: separate image and text q/k/v projections, one
    softmax over the image tokens followed by the text tokens. The last
    block (context_pre_only) has no text output projection."""

    def __init__(self, config: MMDiTConfig, context_pre_only: bool = False):
        super().__init__()
        self.config = config
        self.context_pre_only = context_pre_only
        dim = config.inner_dim
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, name, nn.Linear(dim, dim))
        self.to_out = nn.Linear(dim, dim)
        if not context_pre_only:
            self.to_add_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor):
        cfg = self.config
        h, d = cfg.num_attention_heads, cfg.attention_head_dim
        b, n_img, _ = x.shape
        n_ctx = ctx.shape[1]

        def heads(t):  # (b, n, h*d) -> (b, h, n, d)
            return t.reshape(b, -1, h, d).transpose(1, 2)

        # The context is padded so the joint length is a multiple of 128;
        # the pad kv columns are masked through kv_len and the pad query
        # rows sliced away (tpdm_tpu/models/mmdit.py:222-244).
        n_tok = n_img + n_ctx
        pad = -n_tok % 128

        def joint(img_proj, ctx_proj):
            tc = heads(ctx_proj(ctx))
            if pad:
                tc = nn.functional.pad(tc, (0, 0, 0, pad))
            return torch.cat([heads(img_proj(x)), tc], dim=2)

        q = joint(self.to_q, self.add_q_proj)
        k = joint(self.to_k, self.add_k_proj)
        v = joint(self.to_v, self.add_v_proj)
        o = joint_attention(q, k, v, kv_len=n_tok if pad else None)
        o = o.transpose(1, 2).reshape(b, n_tok + pad, h * d)
        o_img = self.to_out(o[:, :n_img])
        if self.context_pre_only:
            return o_img, None
        return o_img, self.to_add_out(o[:, n_img:n_tok])


class JointBlock(nn.Module):
    """One MMDiT dual-stream block (diffusers ``JointTransformerBlock``)."""

    def __init__(self, config: MMDiTConfig, context_pre_only: bool = False):
        super().__init__()
        dim = config.inner_dim
        self.context_pre_only = context_pre_only
        self.norm1 = AdaLayerNormZero(dim)
        self.norm1_context = (
            AdaLayerNormContinuous(dim) if context_pre_only else AdaLayerNormZero(dim)
        )
        self.attn = JointAttention(config, context_pre_only)
        self.ff = FeedForward(dim)
        if not context_pre_only:
            self.ff_context = FeedForward(dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, temb: torch.Tensor):
        norm_x, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, temb)
        if self.context_pre_only:
            norm_ctx = self.norm1_context(ctx, temb)
        else:
            norm_ctx, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(
                ctx, temb
            )
        attn_out, ctx_attn_out = self.attn(norm_x, norm_ctx)
        x = x + gate_msa[:, None] * attn_out
        norm_x = _layer_norm_fp32(x) * (1.0 + scale_mlp[:, None]) + shift_mlp[:, None]
        x = x + gate_mlp[:, None] * self.ff(norm_x)
        if self.context_pre_only:
            return x, ctx
        ctx = ctx + c_gate_msa[:, None] * ctx_attn_out
        norm_ctx = _layer_norm_fp32(ctx) * (1.0 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        ctx = ctx + c_gate_mlp[:, None] * self.ff_context(norm_ctx)
        return x, ctx


class MMDiT(nn.Module):
    """The SD3 denoiser. ``forward`` returns (velocity, temb, h1, h2)."""

    def __init__(self, config: MMDiTConfig):
        super().__init__()
        if config.dual_attention_layers or config.qk_norm is not None:
            raise NotImplementedError(
                "SD3.5 dual attention and qk RMSNorm are not ported yet "
                "(ROADMAP queue 1, SD3.5 layers)"
            )
        if config.caption_projection_dim != config.inner_dim:
            raise ValueError("caption_projection_dim must equal the inner width")
        self.config = config
        p, dim = config.patch_size, config.inner_dim
        self.pos_embed = PatchEmbed(
            p, config.in_channels, dim, config.pos_embed_max_size, config.sample_size // p
        )
        self.time_text_embed = CombinedTimestepTextEmbed(dim, config.pooled_projection_dim)
        self.context_embedder = nn.Linear(
            config.joint_attention_dim, config.caption_projection_dim
        )
        self.transformer_blocks = nn.ModuleList(
            JointBlock(config, context_pre_only=(i == config.num_layers - 1))
            for i in range(config.num_layers)
        )
        self.norm_out = AdaLayerNormContinuous(dim)
        self.proj_out = nn.Linear(dim, p * p * config.out_channels)

    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> "MMDiT":
        return init_weights(self, generator, std)

    def forward(
        self,
        latents: torch.Tensor,  # (b, c, h, w)
        timestep: torch.Tensor,  # (b,) continuous, sigma*1000
        encoder_hidden_states: torch.Tensor,  # (b, n_txt, joint_attention_dim)
        pooled_projections: torch.Tensor,  # (b, pooled_projection_dim)
    ):
        cfg = self.config
        b, _, height, width = latents.shape
        p = cfg.patch_size
        x = self.pos_embed(latents)
        h1 = x
        temb = self.time_text_embed(timestep, pooled_projections)
        ctx = self.context_embedder(encoder_hidden_states)
        for block in self.transformer_blocks:
            x, ctx = block(x, ctx, temb)
        x = self.norm_out(x, temb)
        h2 = x
        x = self.proj_out(x)
        # unpatchify: (b, gh*gw, p*p*c) -> (b, c, h, w), einsum nhwpqc->nchpwq
        gh, gw = height // p, width // p
        x = x.reshape(b, gh, gw, p, p, cfg.out_channels).permute(0, 5, 1, 3, 2, 4)
        velocity = x.reshape(b, cfg.out_channels, gh * p, gw * p)
        return velocity, temb, h1, h2
