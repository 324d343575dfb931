"""SD3 MMDiT denoiser in PyTorch.

Counterpart of ``tpdm_tpu/models/mmdit.py``: SD3-medium's MMDiT, returning
``(velocity, temb, h1, h2)`` where h1 are the post-PatchEmbed tokens and h2
the post-final-AdaLN tokens that feed the Time Prediction Module. The joint
attention runs kernel K1 on the card (``ops/attention.py``).

SD3.5 (``MMDiTConfig.sd35_medium``, ``sd35_large``): ``qk_norm="rms_norm"``
puts an RMSNorm over each head's q and k, image and text apart, before the
joint concatenation; a block listed in ``dual_attention_layers`` takes
``AdaLayerNormZeroX`` as its ``norm1`` and adds an image-only
``SelfAttention`` (``attn2``, K1 without a kv_len) after the joint one.

Sequence parallelism (``MMDiTConfig.seq_group``, the counterpart of
``seq_mesh``) shards the image tokens over the group's ranks, rank r
holding the r-th of P equal shards (the last ones padded). The text tokens
are held whole on every rank. Each joint attention runs the ring of
``parallel/sp_attention.py`` over the image kv shards (K3, P calls) plus
one K3 call against the local text kv; rank 0 alone adds the text queries
to its own and updates the text stream, which it then broadcasts, so the
text stream is the same bits on every rank. At the end the ranks
all-gather h2, and velocity comes from the whole h2 on every rank; h1 is
computed whole on every rank. The JAX package pads the joint sequence to a
multiple of lcm(128, P) for its Pallas kernel; the port's kernels take any
length, so only the image tokens are padded, to a multiple of P.

Quantised matmuls (``MMDiTConfig.quant_matmuls``, ``quant_bits``): the ten
attention projections and both feed-forwards of every block are
``ops/quant.py``'s ``DenseMaybeQuant``, W8A8 int8 on K4 at ``quant_bits`` 8
and int4 weight-only on K5 at 4; the AdaLN, embedder, ``context_embedder``
and ``proj_out`` linears stay ``nn.Linear``, as in JAX. Load the float
weights, then ``prequantize_`` the model once (or load a prequantised
state dict).

The Δ-cache (``forward``'s ``cache_mode``, ``MMDiTConfig.
cache_front_blocks``): a "record" forward also returns the back blocks'
residual Δ, and a "reuse" forward runs only the front blocks and adds a
recorded Δ, so it skips the back blocks' work. The parameters are the same
in every mode.

Not ported yet: the batch axis sharded beside the token axis
(``seq_batch_axes``), and under ``seq_group`` the quantised matmuls, the
Δ-cache and SD3.5's two features (``MMDiT`` refuses each pair).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from tpdm_tpu_torch.models.layers import (
    AdaLayerNormContinuous,
    AdaLayerNormZero,
    AdaLayerNormZeroX,
    CombinedTimestepTextEmbed,
    FeedForward,
    PatchEmbed,
    RMSNorm,
    _layer_norm_fp32,
    dense,
    init_weights,
)
from tpdm_tpu_torch.ops.attention import joint_attention
from tpdm_tpu_torch.parallel.mesh import SeqGroup
from tpdm_tpu_torch.parallel.sp_attention import _ring_forward, shard_valid_counts


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
    qk_norm: Optional[str] = None  # None | "rms_norm" (SD3.5)
    dtype: torch.dtype = torch.bfloat16
    # sequence parallelism: the image tokens sharded over this group's ranks
    # (parallel/mesh.py); the parameters are the same as without it
    seq_group: Optional[SeqGroup] = None
    quant_matmuls: bool = False  # W8A8-dynamic int8 for the qkv/out/FF matmuls
    quant_bits: int = 8  # 4 = group-int4 weight-only (capacity mode)
    # Δ-cache (forward's cache_mode): "record" runs every block and returns
    # Δ = x after all blocks - x after the first cache_front_blocks;
    # "reuse" runs only those front blocks and adds a recorded Δ
    cache_front_blocks: int = 4

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def sd3_medium(cls, **kw) -> "MMDiTConfig":
        return cls(**kw)

    @classmethod
    def sd35_medium(cls, **kw) -> "MMDiTConfig":
        defaults = dict(
            num_layers=24,
            num_attention_heads=24,
            dual_attention_layers=tuple(range(13)),
            qk_norm="rms_norm",
            pos_embed_max_size=384,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def sd35_large(cls, **kw) -> "MMDiTConfig":
        defaults = dict(
            num_layers=38,
            num_attention_heads=38,
            caption_projection_dim=2432,
            qk_norm="rms_norm",
            pos_embed_max_size=192,
        )
        defaults.update(kw)
        return cls(**defaults)

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


def _heads(t: torch.Tensor, b: int, h: int, d: int, norm=None) -> torch.Tensor:
    """(b, n, h*d) -> (b, h, n, d), with an optional norm over each head's
    d features applied before the transpose."""
    t = t.reshape(b, -1, h, d)
    if norm is not None:
        t = norm(t)
    return t.transpose(1, 2)


class JointAttention(nn.Module):
    """MMDiT joint attention: separate image and text q/k/v projections, one
    softmax over the image tokens followed by the text tokens. The last
    block (context_pre_only) has no text output projection."""

    def __init__(self, config: MMDiTConfig, context_pre_only: bool = False):
        super().__init__()
        self.config = config
        self.context_pre_only = context_pre_only
        dim = config.inner_dim
        linear = lambda: dense(dim, dim, config.quant_matmuls, config.quant_bits)
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, name, linear())
        self.to_out = linear()
        if not context_pre_only:
            self.to_add_out = linear()
        if config.qk_norm == "rms_norm":
            d = config.attention_head_dim
            for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                setattr(self, name, RMSNorm(d))

    def forward(
        self, x: torch.Tensor, ctx: torch.Tensor, shard_valid: Optional[Sequence[int]] = None
    ):
        """Without a seq group: (image output, text output or None). With
        one, x is this rank's image shard, shard_valid the valid rows of
        each rank's shard, and the text output is None except on rank 0."""
        cfg = self.config
        h, d = cfg.num_attention_heads, cfg.attention_head_dim
        b, n_img, _ = x.shape
        n_ctx = ctx.shape[1]
        if cfg.seq_group is not None:
            return self._seq_parallel(x, ctx, shard_valid)

        # The context is padded so the joint length is a multiple of 128;
        # the pad kv columns are masked through kv_len and the pad query
        # rows sliced away (tpdm_tpu/models/mmdit.py:222-244). The qk norm
        # acts on each part before the pad and the concatenation.
        n_tok = n_img + n_ctx
        pad = -n_tok % 128
        norms = cfg.qk_norm == "rms_norm"

        def joint(img_proj, ctx_proj, norm=None, norm_ctx=None):
            tc = _heads(ctx_proj(ctx), b, h, d, norm_ctx)
            if pad:
                tc = nn.functional.pad(tc, (0, 0, 0, pad))
            return torch.cat([_heads(img_proj(x), b, h, d, norm), tc], dim=2)

        q_norms = (self.norm_q, self.norm_added_q) if norms else (None, None)
        k_norms = (self.norm_k, self.norm_added_k) if norms else (None, None)
        q = joint(self.to_q, self.add_q_proj, *q_norms)
        k = joint(self.to_k, self.add_k_proj, *k_norms)
        v = joint(self.to_v, self.add_v_proj)
        o = joint_attention(q, k, v, kv_len=n_tok if pad else None)
        o = o.transpose(1, 2).reshape(b, n_tok + pad, h * d)
        o_img = self.to_out(o[:, :n_img])
        if self.context_pre_only:
            return o_img, None
        return o_img, self.to_add_out(o[:, n_img:n_tok])

    def _seq_parallel(self, x, ctx, shard_valid):
        cfg = self.config
        group = cfg.seq_group
        b, n_local, _ = x.shape
        heads = lambda t: _heads(t, b, cfg.num_attention_heads, cfg.attention_head_dim)
        q = heads(self.to_q(x))
        k, v = (heads(proj(x)).contiguous() for proj in (self.to_k, self.to_v))
        k_ctx, v_ctx = (heads(proj(ctx)).contiguous() for proj in (self.add_k_proj, self.add_v_proj))
        text_rows = group.rank == 0 and not self.context_pre_only
        if text_rows:
            q = torch.cat([q, heads(self.add_q_proj(ctx))], dim=2)
        o, _, _ = _ring_forward(q.contiguous(), k, v, group, shard_valid,
                                local_kv=((k_ctx, v_ctx, None),))
        o = o.transpose(1, 2).reshape(b, -1, o.shape[1] * o.shape[3])
        o_img = self.to_out(o[:, :n_local])
        if not text_rows:
            return o_img, None
        return o_img, self.to_add_out(o[:, n_local:])


class SelfAttention(nn.Module):
    """SD3.5's image-only self-attention (``attn2`` of a dual-attention
    block): q/k/v and output projections, the optional qk RMSNorm, and K1 on
    the card over the image tokens alone (no kv_len)."""

    def __init__(self, config: MMDiTConfig):
        super().__init__()
        self.config = config
        dim = config.inner_dim
        for name in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, name, dense(dim, dim, config.quant_matmuls, config.quant_bits))
        if config.qk_norm == "rms_norm":
            self.norm_q = RMSNorm(config.attention_head_dim)
            self.norm_k = RMSNorm(config.attention_head_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b = x.shape[0]
        h, d = cfg.num_attention_heads, cfg.attention_head_dim
        norms = cfg.qk_norm == "rms_norm"
        q = _heads(self.to_q(x), b, h, d, self.norm_q if norms else None).contiguous()
        k = _heads(self.to_k(x), b, h, d, self.norm_k if norms else None).contiguous()
        v = _heads(self.to_v(x), b, h, d).contiguous()
        o = joint_attention(q, k, v)
        return self.to_out(o.transpose(1, 2).reshape(b, -1, cfg.inner_dim))


class JointBlock(nn.Module):
    """One MMDiT dual-stream block (diffusers ``JointTransformerBlock``);
    with ``use_dual_attention`` SD3.5's: ``AdaLayerNormZeroX`` as ``norm1``
    and ``attn2`` after the joint attention."""

    def __init__(self, config: MMDiTConfig, context_pre_only: bool = False,
                 use_dual_attention: bool = False):
        super().__init__()
        dim = config.inner_dim
        self.context_pre_only = context_pre_only
        self.use_dual_attention = use_dual_attention
        self.norm1 = AdaLayerNormZeroX(dim) if use_dual_attention else AdaLayerNormZero(dim)
        self.norm1_context = (
            AdaLayerNormContinuous(dim) if context_pre_only else AdaLayerNormZero(dim)
        )
        self.attn = JointAttention(config, context_pre_only)
        ff = lambda: FeedForward(dim, quant=config.quant_matmuls, quant_bits=config.quant_bits)
        self.ff = ff()
        if not context_pre_only:
            self.ff_context = ff()
        if use_dual_attention:
            self.attn2 = SelfAttention(config)

    def forward(
        self,
        x: torch.Tensor,
        ctx: torch.Tensor,
        temb: torch.Tensor,
        shard_valid: Optional[Sequence[int]] = None,
    ):
        """Returns (x, ctx); ctx comes back unchanged where the attention
        gave no text output (the last block, and ranks other than 0 of a
        seq group)."""
        if self.use_dual_attention:
            (norm_x, gate_msa, shift_mlp, scale_mlp, gate_mlp, norm_x2,
             gate_msa2) = self.norm1(x, temb)
        else:
            norm_x, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, temb)
        if self.context_pre_only:
            norm_ctx = self.norm1_context(ctx, temb)
        else:
            norm_ctx, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(
                ctx, temb
            )
        attn_out, ctx_attn_out = self.attn(norm_x, norm_ctx, shard_valid)
        x = x + gate_msa[:, None] * attn_out
        if self.use_dual_attention:
            x = x + gate_msa2[:, None] * self.attn2(norm_x2)
        norm_x = _layer_norm_fp32(x) * (1.0 + scale_mlp[:, None]) + shift_mlp[:, None]
        x = x + gate_mlp[:, None] * self.ff(norm_x)
        if ctx_attn_out is None:
            return x, ctx
        ctx = ctx + c_gate_msa[:, None] * ctx_attn_out
        norm_ctx = _layer_norm_fp32(ctx) * (1.0 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        ctx = ctx + c_gate_mlp[:, None] * self.ff_context(norm_ctx)
        return x, ctx


class MMDiT(nn.Module):
    """The SD3 denoiser. ``forward`` returns (velocity, temb, h1, h2)."""

    def __init__(self, config: MMDiTConfig):
        super().__init__()
        if config.qk_norm not in (None, "rms_norm"):
            raise ValueError(f"qk_norm must be None or 'rms_norm', got {config.qk_norm!r}")
        if (config.dual_attention_layers or config.qk_norm) and config.seq_group is not None:
            raise NotImplementedError(
                "SD3.5's dual attention and qk norm with seq_group have no parity check yet "
                "(ROADMAP queue 1, item 14(d))"
            )
        if config.quant_matmuls and config.seq_group is not None:
            raise NotImplementedError(
                "quant_matmuls with seq_group has no parity check yet "
                "(ROADMAP queue 1, item 13(d))"
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
            JointBlock(config, context_pre_only=(i == config.num_layers - 1),
                       use_dual_attention=(i in config.dual_attention_layers))
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
        delta: Optional[torch.Tensor] = None,  # (b, n_img, inner) cached Δ
        cache_mode: Optional[str] = None,  # None | "record" | "reuse"
    ):
        """cache_mode None returns (velocity, temb, h1, h2). "record" and
        "reuse" return (velocity, temb, h1, h2, delta): "record" runs every
        block and returns Δ over the back blocks, in the model's dtype;
        "reuse" runs only the first ``config.cache_front_blocks`` blocks
        and adds the given Δ in place of the rest. Only the image stream
        needs a Δ: the text stream feeds nothing after the blocks."""
        cfg = self.config
        group = cfg.seq_group
        if cache_mode is not None:
            if cache_mode not in ("record", "reuse"):
                raise ValueError(f"cache_mode must be None, 'record' or 'reuse'; got {cache_mode!r}")
            if group is not None:
                raise NotImplementedError(
                    "cache_mode with seq_group has no parity check yet (ROADMAP queue 1, "
                    "item 14(g))")
            if not 1 <= cfg.cache_front_blocks < cfg.num_layers:
                raise ValueError(
                    "cache_front_blocks must be in [1, num_layers): got "
                    f"{cfg.cache_front_blocks} of {cfg.num_layers}")
            if cache_mode == "reuse" and delta is None:
                raise ValueError("cache_mode='reuse' needs a delta")
        b, _, height, width = latents.shape
        p = cfg.patch_size
        x = self.pos_embed(latents)
        h1 = x
        temb = self.time_text_embed(timestep, pooled_projections)
        ctx = self.context_embedder(encoder_hidden_states)
        shard_valid = None
        if group is not None:
            n_img = x.shape[1]
            n_local = -(-n_img // group.size)
            shard_valid = shard_valid_counts(n_local, group.size, n_img)
            x = x[:, group.rank * n_local : (group.rank + 1) * n_local]
            x = nn.functional.pad(x, (0, 0, 0, n_local - x.shape[1]))
        blocks = self.transformer_blocks
        if cache_mode == "reuse":
            blocks = blocks[: cfg.cache_front_blocks]
        for i, block in enumerate(blocks):
            x, ctx = block(x, ctx, temb, shard_valid)
            if group is not None and group.size > 1 and not block.context_pre_only:
                dist.broadcast(ctx, src=group.global_rank(0), group=group.group)
            if cache_mode == "record" and i == cfg.cache_front_blocks - 1:
                x_front = x
        if cache_mode == "record":
            delta = x - x_front
        elif cache_mode == "reuse":
            x = x + delta.to(x.dtype)
        x = self.norm_out(x, temb)
        if group is not None:
            parts = [torch.empty_like(x) for _ in range(group.size)]
            dist.all_gather(parts, x.contiguous(), group=group.group)
            x = torch.cat(parts, dim=1)[:, :n_img]
        h2 = x
        x = self.proj_out(x)
        # unpatchify: (b, gh*gw, p*p*c) -> (b, c, h, w), einsum nhwpqc->nchpwq
        gh, gw = height // p, width // p
        x = x.reshape(b, gh, gw, p, p, cfg.out_channels).permute(0, 5, 1, 3, 2, 4)
        velocity = x.reshape(b, cfg.out_channels, gh * p, gw * p)
        if cache_mode is not None:
            return velocity, temb, h1, h2, delta
        return velocity, temb, h1, h2
