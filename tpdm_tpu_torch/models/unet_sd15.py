"""SD1.x / SDXL UNet in PyTorch, returning the TPDM four-output contract.

Counterpart of ``tpdm_tpu/models/unet_sd15.py``: diffusers' SD1.5
``UNet2DConditionModel`` that also returns the pre-MLP sinusoidal time
features ``t_feat``, ``h1`` (after ``conv_in``) and ``h2`` (after
``conv_norm_out`` and silu, before ``conv_out``) for the TPM. The same
module covers the SDXL-base and refiner topologies (per-level transformer
depth and head counts, the "text_time" addition embedding through
``added_cond``) and DeepCache's ``cache_mode`` "record" / "reuse".

The module runs NCHW throughout (JAX's runs NHWC inside and NCHW at its
boundary); the DeepCache feature is NCHW too. Submodules carry the Flax
names (``down_0_resnet_1``, ``mid_attn``, ``up_2_upsample``, ``block`` or
``block_0``...), so ``utils/convert.py:unet_sd15_from_jax`` maps a Flax
tree one to one. Convs and matmuls run in the weights' dtype (bf16 on the
card); GroupNorm and LayerNorm keep fp32 statistics and return their
input's dtype, as the Flax modules do. Attention goes through
``ops/attention.py:joint_attention``: K1 at head dims 40, 80 and 160 on
CUDA tensors (bf16 only: it raises on any other dtype or head dim), the
plain version on CPU tensors. Convolutions and GroupNorm are cuDNN's and
torch's, as the JAX package left them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpdm_tpu_torch.models.layers import GroupNorm, init_weights, sinusoidal_timestep_embedding
from tpdm_tpu_torch.ops.attention import joint_attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """UNet geometry; the fields and presets of the JAX ``UNetConfig``
    (its GSPMD anchors excepted). ``dtype`` is not a field: cast the module
    (``.to(torch.bfloat16)``)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_attention_heads: int = 8  # SD1.x: 8 heads of C/8
    norm_num_groups: int = 32
    sample_size: int = 64
    # None: SD1.x, one transformer layer at every level but the last; SDXL
    # gives a depth a level, 0 for an attention-free level
    transformer_layers_per_block: Optional[Tuple[int, ...]] = None
    mid_transformer_layers: int = 1
    # None: num_attention_heads everywhere; else heads = channels // dim
    attention_head_dim: Optional[int] = None
    # SDXL "text_time": pooled text and num_time_ids sinusoid embeddings
    # projected into the time embedding
    addition_embed: bool = False
    addition_time_embed_dim: int = 256
    addition_pooled_dim: int = 1280
    num_time_ids: int = 6
    # DeepCache: the levels below this one (and the mid block) are the deep
    # subnetwork whose output a "reuse" forward takes from the cache
    cache_shallow_levels: int = 1

    @classmethod
    def sd15(cls, **kw) -> "UNetConfig":
        return cls(**kw)

    @classmethod
    def sdxl(cls, **kw) -> "UNetConfig":
        """SDXL-base 2.6B topology (diffusers unet/config.json)."""
        d = dict(block_out_channels=(320, 640, 1280), layers_per_block=2,
                 cross_attention_dim=2048, attention_head_dim=64,
                 transformer_layers_per_block=(0, 2, 10), mid_transformer_layers=10,
                 sample_size=128, addition_embed=True)
        d.update(kw)
        return cls(**d)

    @classmethod
    def sdxl_refiner(cls, **kw) -> "UNetConfig":
        """SDXL-refiner 2.3B topology: attention-free first and last levels,
        depth 4, bigG-only context (1280), five time ids (the aesthetic
        score replaces the target size)."""
        d = dict(block_out_channels=(384, 768, 1536, 1536), layers_per_block=2,
                 cross_attention_dim=1280, attention_head_dim=64,
                 transformer_layers_per_block=(0, 4, 4, 0), mid_transformer_layers=4,
                 sample_size=128, addition_embed=True, num_time_ids=5)
        d.update(kw)
        return cls(**d)

    @classmethod
    def toy(cls, **kw) -> "UNetConfig":
        d = dict(block_out_channels=(8, 12, 16, 16), layers_per_block=1,
                 cross_attention_dim=24, num_attention_heads=2, norm_num_groups=4,
                 sample_size=16)
        d.update(kw)
        return cls(**d)

    @classmethod
    def toy_xl(cls, **kw) -> "UNetConfig":
        d = dict(block_out_channels=(8, 12, 16), layers_per_block=1,
                 cross_attention_dim=24, attention_head_dim=4,
                 transformer_layers_per_block=(0, 1, 2), mid_transformer_layers=2,
                 norm_num_groups=4, sample_size=16, addition_embed=True,
                 addition_time_embed_dim=8, addition_pooled_dim=12)
        d.update(kw)
        return cls(**d)

    @classmethod
    def toy_refiner(cls, **kw) -> "UNetConfig":
        d = dict(block_out_channels=(8, 12, 16, 16), layers_per_block=1,
                 cross_attention_dim=20, attention_head_dim=4,
                 transformer_layers_per_block=(0, 1, 1, 0), mid_transformer_layers=1,
                 norm_num_groups=4, sample_size=16, addition_embed=True,
                 addition_time_embed_dim=8, addition_pooled_dim=12, num_time_ids=5)
        d.update(kw)
        return cls(**d)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def depths(self) -> Tuple[int, ...]:
        """Transformer depth a level on the down path (reversed for up)."""
        if self.transformer_layers_per_block is not None:
            return self.transformer_layers_per_block
        return tuple(1 for _ in self.block_out_channels[:-1]) + (0,)

    def heads_for(self, out_ch: int) -> int:
        if self.attention_head_dim is None:
            return self.num_attention_heads
        return out_ch // self.attention_head_dim


def deepcache_feature_shape(cfg: UNetConfig, batch: int,
                            latent_hw: Optional[Tuple[int, int]] = None):
    """NCHW shape of the DeepCache feature a "record" forward returns: the
    up-path activation where the deep subnetwork rejoins the shallow levels
    (the resolution of level cache_shallow_levels - 1, the width of level
    cache_shallow_levels). JAX's function gives the same sizes NHWC."""
    s = cfg.cache_shallow_levels
    h, w = latent_hw if latent_hw is not None else (cfg.sample_size,) * 2
    return (batch, cfg.block_out_channels[s], h // 2 ** (s - 1), w // 2 ** (s - 1))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics and affine,
    output in the input's dtype (Flax ``nn.LayerNorm(dtype=...)``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class ResnetBlockTimeEmb(nn.Module):
    """diffusers ResnetBlock2D with the time embedding added after conv1
    (norms at eps 1e-5)."""

    def __init__(self, in_channels: int, out_channels: int, groups: int, temb_dim: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class _CrossAttnBlock(nn.Module):
    """diffusers BasicTransformerBlock: self-attention, cross-attention
    against the text context, GEGLU feed-forward; pre-LayerNorm at eps 1e-5."""

    def __init__(self, dim: int, heads: int, ctx_dim: int):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        for prefix, kv_dim in (("attn1", dim), ("attn2", ctx_dim)):
            self.add_module(f"{prefix}_to_q", nn.Linear(dim, dim, bias=False))
            self.add_module(f"{prefix}_to_k", nn.Linear(kv_dim, dim, bias=False))
            self.add_module(f"{prefix}_to_v", nn.Linear(kv_dim, dim, bias=False))
            self.add_module(f"{prefix}_to_out", nn.Linear(dim, dim))
        self.ff_proj = nn.Linear(dim, 8 * dim)
        self.ff_out = nn.Linear(4 * dim, dim)

    def _attn(self, x: torch.Tensor, y: torch.Tensor, prefix: str) -> torch.Tensor:
        b, n, d = x.shape
        h = self.heads

        def heads(t):  # (b, m, d) -> (b, h, m, d/h), contiguous for the kernel
            return t.reshape(b, t.shape[1], h, d // h).transpose(1, 2).contiguous()

        q = heads(getattr(self, f"{prefix}_to_q")(x))
        k = heads(getattr(self, f"{prefix}_to_k")(y))
        v = heads(getattr(self, f"{prefix}_to_v")(y))
        o = joint_attention(q, k, v).transpose(1, 2).reshape(b, n, d)
        return getattr(self, f"{prefix}_to_out")(o)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        n1 = self.norm1(x)
        x = x + self._attn(n1, n1, "attn1")
        x = x + self._attn(self.norm2(x), ctx, "attn2")
        a, g = self.ff_proj(self.norm3(x)).chunk(2, dim=-1)
        return x + self.ff_out(a * F.gelu(g))  # GEGLU, exact gelu


class SpatialTransformer(nn.Module):
    """diffusers Transformer2DModel: GroupNorm, 1x1 conv in, ``depth``
    blocks over the h·w tokens, 1x1 conv out, residual. A depth-1
    transformer names its block ``block`` (the SD1.x checkpoints' name),
    deeper ones ``block.0``... (Flax's ``block_0``)."""

    def __init__(self, dim: int, heads: int, ctx_dim: int, groups: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm(groups, dim)
        self.proj_in = nn.Conv2d(dim, dim, 1)
        blocks = [_CrossAttnBlock(dim, heads, ctx_dim) for _ in range(depth)]
        self.block = blocks[0] if depth == 1 else nn.ModuleList(blocks)
        self.proj_out = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        h = h.reshape(b, c, hh * ww).transpose(1, 2)
        for blk in (self.block if isinstance(self.block, nn.ModuleList) else [self.block]):
            h = blk(h, ctx)
        h = h.transpose(1, 2).reshape(b, c, hh, ww)
        return self.proj_out(h) + x


class UNetSD15(nn.Module):
    """Returns (noise_pred, t_feat, h1, h2), NCHW; with ``cache_mode`` also
    the DeepCache feature."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        ch, g, ctx = cfg.block_out_channels, cfg.norm_num_groups, cfg.cross_attention_dim
        n, depths, temb = len(ch), cfg.depths, cfg.time_embed_dim

        def resnet(name, c_in, c_out):
            self.add_module(name, ResnetBlockTimeEmb(c_in, c_out, g, temb))

        def transformer(name, c, depth):
            self.add_module(name, SpatialTransformer(c, cfg.heads_for(c), ctx, g, depth))

        self.time_linear_1 = nn.Linear(ch[0], temb)
        self.time_linear_2 = nn.Linear(temb, temb)
        if cfg.addition_embed:
            add_in = cfg.addition_pooled_dim + cfg.num_time_ids * cfg.addition_time_embed_dim
            self.add_linear_1 = nn.Linear(add_in, temb)
            self.add_linear_2 = nn.Linear(temb, temb)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        cur, skips = ch[0], [ch[0]]
        for i, out_ch in enumerate(ch):
            for j in range(cfg.layers_per_block):
                resnet(f"down_{i}_resnet_{j}", cur, out_ch)
                cur = out_ch
                if depths[i] > 0:
                    transformer(f"down_{i}_attn_{j}", out_ch, depths[i])
                skips.append(cur)
            if i < n - 1:
                self.add_module(f"down_{i}_downsample",
                                nn.Conv2d(out_ch, out_ch, 3, stride=2, padding=1))
                skips.append(cur)
        resnet("mid_resnet_0", ch[-1], ch[-1])
        transformer("mid_attn", ch[-1], cfg.mid_transformer_layers)
        resnet("mid_resnet_1", ch[-1], ch[-1])
        for i, out_ch in enumerate(reversed(ch)):
            depth_i = depths[n - 1 - i]
            for j in range(cfg.layers_per_block + 1):
                resnet(f"up_{i}_resnet_{j}", cur + skips.pop(), out_ch)
                cur = out_ch
                if depth_i > 0:
                    transformer(f"up_{i}_attn_{j}", out_ch, depth_i)
            if i < n - 1:
                self.add_module(f"up_{i}_upsample", nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.conv_norm_out = GroupNorm(g, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> "UNetSD15":
        """N(0, std²) weights, zero biases, unit norms (random-weight runs)."""
        init_weights(self, generator, std)
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self

    def _dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(
        self,
        latents: torch.Tensor,
        timestep: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        added_cond: Optional[dict] = None,
        cache: Optional[torch.Tensor] = None,
        cache_mode: Optional[str] = None,
    ):
        """latents (b, 4, h, w); timestep (b,) float in [0, 999];
        encoder_hidden_states (b, n_text, cross_attention_dim); added_cond
        (SDXL) {"text_embeds": (b, pooled), "time_ids": (b, num_time_ids)}.

        cache_mode None returns (noise_pred, t_feat, h1, h2); "record" runs
        the whole UNet and also returns the up-path feature where the deep
        subnetwork rejoins the shallow levels; "reuse" takes that feature
        from ``cache`` in place of the deep subnetwork (the mid block and
        every level >= cache_shallow_levels) and runs only the shallow
        levels."""
        cfg = self.config
        ch, n, depths = cfg.block_out_channels, len(cfg.block_out_channels), cfg.depths
        dtype = self._dtype()
        if cache_mode is not None:
            if not 1 <= cfg.cache_shallow_levels < n:
                raise ValueError("cache_shallow_levels must be in [1, num_levels): got "
                                 f"{cfg.cache_shallow_levels} of {n}")
            if cache_mode == "reuse" and cache is None:
                raise ValueError("cache_mode='reuse' needs a cache")
        mod = lambda name: getattr(self, name)

        t_feat = sinusoidal_timestep_embedding(timestep, ch[0]).to(dtype)
        temb = self.time_linear_2(F.silu(self.time_linear_1(t_feat)))
        if cfg.addition_embed:
            if added_cond is None:
                raise ValueError('config.addition_embed is on: pass added_cond={"text_embeds": '
                                 '(b, pooled), "time_ids": (b, num_time_ids)}')
            pooled = added_cond["text_embeds"]
            time_ids = torch.as_tensor(added_cond["time_ids"], dtype=torch.float32,
                                       device=pooled.device)
            b = pooled.shape[0]
            t6 = sinusoidal_timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim)
            add = torch.cat([pooled.to(dtype), t6.reshape(b, -1).to(dtype)], dim=-1)
            temb = temb + self.add_linear_2(F.silu(self.add_linear_1(add)))

        ctx = encoder_hidden_states.to(dtype)
        x = self.conv_in(latents.to(dtype))
        h1 = x
        skips = [x]
        shallow = cfg.cache_shallow_levels
        reuse = cache_mode == "reuse"
        for i in range(shallow if reuse else n):
            for j in range(cfg.layers_per_block):
                x = mod(f"down_{i}_resnet_{j}")(x, temb)
                if depths[i] > 0:
                    x = mod(f"down_{i}_attn_{j}")(x, ctx)
                skips.append(x)
            # a reuse forward skips level shallow - 1's downsample: only the
            # deep subnetwork takes it
            if i < n - 1 and not (reuse and i == shallow - 1):
                x = mod(f"down_{i}_downsample")(x)
                skips.append(x)

        if reuse:
            x = cache.to(dtype)
        else:
            x = self.mid_resnet_0(x, temb)
            x = self.mid_attn(x, ctx)
            x = self.mid_resnet_1(x, temb)

        for i in range(n - shallow if reuse else 0, n):
            depth_i = depths[n - 1 - i]
            for j in range(cfg.layers_per_block + 1):
                x = mod(f"up_{i}_resnet_{j}")(torch.cat([x, skips.pop()], dim=1), temb)
                if depth_i > 0:
                    x = mod(f"up_{i}_attn_{j}")(x, ctx)
            if i < n - 1:
                x = mod(f"up_{i}_upsample")(F.interpolate(x, scale_factor=2.0, mode="nearest"))
            if cache_mode == "record" and i == n - 1 - shallow:
                cache = x

        h2 = F.silu(self.conv_norm_out(x))
        out = self.conv_out(h2)
        # the TPM conditions on the pre-MLP sinusoidal t_feat (ch[0] wide)
        if cache_mode is not None:
            return out, t_feat, h1, h2, cache
        return out, t_feat, h1, h2
