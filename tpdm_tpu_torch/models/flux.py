"""FLUX.1 backbone in PyTorch: the double/single-stream DiT with 3-axis RoPE.

Counterpart of ``tpdm_tpu/models/flux.py``: packed 2 x 2 latent tokens,
joint text + image double-stream blocks (text first in the joint
sequence), fused single-stream blocks, rotary position embedding over
(0, row, column) ids, and modulation from the timestep, the pooled text
vector and (FLUX.1-dev) the embedded guidance scale. ``Flux.forward``
returns ``(velocity_tokens, vec, h1, h2)``: h1 the image tokens after
``img_in``, h2 the image tokens after the final modulation, both (b,
n_img, hidden), which ``reshape_tokens_to_2d`` turns into the TPM's map.

Every attention runs ``ops/attention.py:joint_attention``: on the card K1
at head dim 128 (FLUX.1-dev's 24 heads of 128), or at the toy config's
head dim 12 through the padded d-64 entry; the operands are bf16 there.
The per-head RMSNorm of q and k and the RoPE rotation (interleaved pairs,
BFL's convention, computed in fp32 and cast back) run in plain torch.
The dtype is the module's own: build it, load or draw its weights and
cast it (bf16 on the card, fp32 on the CPU); activations follow the
weights' dtype.

Quantised matmuls (``FluxConfig.quant_matmuls``, ``quant_bits``): the
blocks' q/k/v, output and MLP projections and the single blocks' fused
``linear1`` / ``linear2`` are ``ops/quant.py:DenseMaybeQuant``, W8A8 on K4
at 8 bits; the modulation projections are weight-only int8 on K5
(``act_quant=False``: their outputs gate every residual); at 4 bits all of
them are group-wise int4 weight-only on K5. The embedders and
``final_proj`` stay ``nn.Linear``, as in JAX. Load the float weights, then
``prequantize_`` the model once.

The Δ-cache (``forward``'s ``cache_mode``, ``FluxConfig.
cache_front_blocks``): a "record" forward also returns Δ = the image
tokens after every block - those after the first ``cache_front_blocks``
double blocks; a "reuse" forward runs only those front double blocks and
adds a recorded Δ in place of the rest (the text stream feeds nothing
after the blocks, so the image Δ suffices).

Not ported: ``act_mesh`` / ``_anchor``, the JAX package's GSPMD sharding
constraints (the port has no sharded FLUX, ROADMAP queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpdm_tpu_torch.models.layers import (
    RMSNorm,
    _layer_norm_fp32,
    dense,
    init_weights,
    sinusoidal_timestep_embedding,
)
from tpdm_tpu_torch.ops.attention import joint_attention


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """FLUX hyperparameters (defaults = FLUX.1-dev's published config)."""

    in_channels: int = 64  # packed 2 x 2 x 16 latents
    hidden_size: int = 3072
    num_heads: int = 24
    depth_double: int = 19
    depth_single: int = 38
    txt_dim: int = 4096
    vec_dim: int = 768
    mlp_ratio: float = 4.0
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10000
    guidance_embed: bool = True  # "dev"; False for "schnell" (no guidance_in)
    quant_matmuls: bool = False  # W8A8 blocks, weight-only int8 modulations
    quant_bits: int = 8  # 4 = group-int4 weight-only everywhere quantised
    # Δ-cache (forward's cache_mode): "record" runs every block and returns
    # Δ over the blocks after the first cache_front_blocks double blocks;
    # "reuse" runs only those and adds a recorded Δ
    cache_front_blocks: int = 4

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @classmethod
    def flux_dev(cls, **kw) -> "FluxConfig":
        return cls(**kw)

    @classmethod
    def toy(cls, **kw) -> "FluxConfig":
        """Tiny config for tests: 48 wide, 4 heads of 12, 2 + 2 blocks."""
        d = dict(in_channels=16, hidden_size=48, num_heads=4, depth_double=2, depth_single=2,
                 txt_dim=32, vec_dim=24, axes_dim=(4, 4, 4))
        d.update(kw)
        return cls(**d)


def rope_freqs(ids: torch.Tensor, axes_dim: Tuple[int, ...], theta: int):
    """ids (b, n, n_axes) -> (cos, sin), each (b, n, sum(axes_dim) // 2)
    fp32: the per-axis rotary frequencies, concatenated (BFL's convention)."""
    comps_cos, comps_sin = [], []
    for i, dim in enumerate(axes_dim):
        half = dim // 2
        omega = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=ids.device)
                                 / half))
        angles = ids[..., i].to(torch.float32)[..., None] * omega
        comps_cos.append(torch.cos(angles))
        comps_sin.append(torch.sin(angles))
    return torch.cat(comps_cos, -1), torch.cat(comps_sin, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (b, h, n, d), d = 2 x cos.shape[-1]: rotate the interleaved pairs
    (x[..., 0::2], x[..., 1::2]) in fp32; the result in x's dtype."""
    x32 = x.float()
    x_even, x_odd = x32[..., 0::2], x32[..., 1::2]
    c, s = cos[:, None], sin[:, None]  # (b, 1, n, d/2)
    out = torch.stack([x_even * c - x_odd * s, x_even * s + x_odd * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class MLPEmbed(nn.Module):
    """in_layer -> silu -> out_layer: the time, vector and guidance embeds."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.in_layer = nn.Linear(in_dim, hidden)
        self.out_layer = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(self.in_layer(x)))


class Modulation(nn.Module):
    """vec -> n_mod chunks of hidden modulation parameters. Quantised, the
    projection stores int8 weights and computes in the activations' dtype
    (``w8_matmul`` on K5; int4 weight-only at 4 bits): at (b, d) x (d,
    n_mod d) it streams weights, and its outputs gate every residual."""

    def __init__(self, hidden: int, n_mod: int, quant: bool = False, bits: int = 8):
        super().__init__()
        self.n_mod = n_mod
        self.lin = dense(hidden, n_mod * hidden, quant, bits, act_quant=False)

    def forward(self, vec: torch.Tensor):
        return self.lin(F.silu(vec)).chunk(self.n_mod, dim=-1)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _layer_norm_fp32(x) * (1 + scale[:, None]) + shift[:, None]


def _heads(t: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    """(b, n, h hd) -> (b, h, n, hd)."""
    return t.reshape(t.shape[0], -1, h, hd).transpose(1, 2)


def _attention(q, k, v, cos, sin) -> torch.Tensor:
    """RoPE on q and k, then K1 (the plain version on the CPU); (b, h, n,
    hd) -> (b, n, h hd)."""
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = joint_attention(q.contiguous(), k.contiguous(), v.contiguous())
    return o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)


class DoubleStreamBlock(nn.Module):
    """Image and text streams with their own weights, one attention over the
    joint [text, image] sequence."""

    def __init__(self, config: FluxConfig):
        super().__init__()
        self.config = config
        d, mlp = config.hidden_size, config.mlp_dim
        q, bits = config.quant_matmuls, config.quant_bits
        for side in ("img", "txt"):
            setattr(self, f"{side}_mod", Modulation(d, 6, q, bits))
            for name in ("to_q", "to_k", "to_v"):
                setattr(self, f"{side}_attn_{name}", dense(d, d, q, bits))
            setattr(self, f"{side}_attn_norm_q", RMSNorm(config.head_dim))
            setattr(self, f"{side}_attn_norm_k", RMSNorm(config.head_dim))
            setattr(self, f"{side}_attn_proj", dense(d, d, q, bits))
            setattr(self, f"{side}_mlp_0", dense(d, mlp, q, bits))
            setattr(self, f"{side}_mlp_2", dense(mlp, d, q, bits))

    def _qkv(self, x: torch.Tensor, side: str):
        h, hd = self.config.num_heads, self.config.head_dim
        proj = lambda name: _heads(getattr(self, f"{side}_attn_{name}")(x), h, hd)
        q = getattr(self, f"{side}_attn_norm_q")(proj("to_q"))
        k = getattr(self, f"{side}_attn_norm_k")(proj("to_k"))
        return q, k, proj("to_v")

    def _mlp(self, x: torch.Tensor, side: str) -> torch.Tensor:
        y = F.gelu(getattr(self, f"{side}_mlp_0")(x), approximate="tanh")
        return getattr(self, f"{side}_mlp_2")(y)

    def forward(self, img, txt, vec, cos, sin):
        n_txt = txt.shape[1]
        im = self.img_mod(vec)
        tx = self.txt_mod(vec)
        iq, ik, iv = self._qkv(_modulate(img, im[0], im[1]), "img")
        tq, tk, tv = self._qkv(_modulate(txt, tx[0], tx[1]), "txt")
        o = _attention(torch.cat([tq, iq], dim=2), torch.cat([tk, ik], dim=2),
                       torch.cat([tv, iv], dim=2), cos, sin)
        img = img + im[2][:, None] * self.img_attn_proj(o[:, n_txt:])
        txt = txt + tx[2][:, None] * self.txt_attn_proj(o[:, :n_txt])
        img = img + im[5][:, None] * self._mlp(_modulate(img, im[3], im[4]), "img")
        txt = txt + tx[5][:, None] * self._mlp(_modulate(txt, tx[3], tx[4]), "txt")
        return img, txt


class SingleStreamBlock(nn.Module):
    """One stream over the joint sequence: ``linear1`` fuses q, k, v and
    the MLP's input projection (3d + mlp_dim outputs), ``linear2`` takes
    [attention output, activated MLP] back to d."""

    def __init__(self, config: FluxConfig):
        super().__init__()
        self.config = config
        d, mlp = config.hidden_size, config.mlp_dim
        q, bits = config.quant_matmuls, config.quant_bits
        self.modulation = Modulation(d, 3, q, bits)
        self.linear1 = dense(d, 3 * d + mlp, q, bits)
        self.linear2 = dense(d + mlp, d, q, bits)
        self.norm_q = RMSNorm(config.head_dim)
        self.norm_k = RMSNorm(config.head_dim)

    def forward(self, x, vec, cos, sin):
        cfg = self.config
        d, h, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        shift, scale, gate = self.modulation(vec)
        fused = self.linear1(_modulate(x, shift, scale))
        q, k, v = (_heads(t, h, hd) for t in fused[..., :3 * d].chunk(3, dim=-1))
        o = _attention(self.norm_q(q), self.norm_k(k), v, cos, sin)
        mlp = F.gelu(fused[..., 3 * d:], approximate="tanh")
        return x + gate[:, None] * self.linear2(torch.cat([o, mlp], dim=-1))


class Flux(nn.Module):
    """The FLUX denoiser. ``forward`` returns (velocity_tokens (b, n_img,
    in_channels), vec, h1, h2) in packed token space (``unpack_latents``
    gives the latent map)."""

    def __init__(self, config: FluxConfig):
        super().__init__()
        self.config = config
        d, q, bits = config.hidden_size, config.quant_matmuls, config.quant_bits
        self.img_in = nn.Linear(config.in_channels, d)
        self.txt_in = nn.Linear(config.txt_dim, d)
        self.time_in = MLPEmbed(256, d)
        if config.guidance_embed:
            self.guidance_in = MLPEmbed(256, d)
        self.vector_in = MLPEmbed(config.vec_dim, d)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(config) for _ in range(config.depth_double))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(config) for _ in range(config.depth_single))
        self.final_mod = Modulation(d, 2, q, bits)
        self.final_proj = nn.Linear(d, config.in_channels)

    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> "Flux":
        return init_weights(self, generator, std)

    def forward(
        self,
        img_tokens: torch.Tensor,  # (b, n_img, in_channels) packed latents
        img_ids: torch.Tensor,  # (b, n_img, 3)
        txt_tokens: torch.Tensor,  # (b, n_txt, txt_dim)
        txt_ids: torch.Tensor,  # (b, n_txt, 3)
        timestep: torch.Tensor,  # (b,) in [0, 1]
        pooled: torch.Tensor,  # (b, vec_dim)
        guidance: Optional[torch.Tensor] = None,  # (b,) guidance scale
        delta: Optional[torch.Tensor] = None,  # (b, n_img, hidden) cached Δ
        cache_mode: Optional[str] = None,  # None | "record" | "reuse"
    ):
        """cache_mode None returns (velocity, vec, h1, h2); "record" and
        "reuse" return (velocity, vec, h1, h2, delta), Δ in the model's
        dtype. ``guidance`` None embeds 3.5 (with ``guidance_embed``)."""
        cfg = self.config
        if cache_mode is not None:
            if cache_mode not in ("record", "reuse"):
                raise ValueError(
                    f"cache_mode must be None, 'record' or 'reuse'; got {cache_mode!r}")
            if not 1 <= cfg.cache_front_blocks <= cfg.depth_double:
                raise ValueError(
                    "cache_front_blocks must be in [1, depth_double]: got "
                    f"{cfg.cache_front_blocks} of {cfg.depth_double}")
            if cache_mode == "reuse" and delta is None:
                raise ValueError("cache_mode='reuse' needs a delta")
        dtype = self.img_in.weight.dtype
        img = self.img_in(img_tokens.to(dtype))
        h1 = img
        txt = self.txt_in(txt_tokens.to(dtype))
        t_feat = sinusoidal_timestep_embedding(timestep * 1000.0, 256, flip_sin_to_cos=True)
        vec = self.time_in(t_feat.to(dtype))
        if cfg.guidance_embed:
            if guidance is None:
                guidance = torch.full(timestep.shape, 3.5, device=timestep.device)
            g_feat = sinusoidal_timestep_embedding(guidance * 1000.0, 256)
            vec = vec + self.guidance_in(g_feat.to(dtype))
        vec = vec + self.vector_in(pooled.to(dtype))

        cos, sin = rope_freqs(torch.cat([txt_ids, img_ids], dim=1), cfg.axes_dim, cfg.theta)
        doubles = self.double_blocks
        if cache_mode == "reuse":
            doubles = doubles[:cfg.cache_front_blocks]
        for i, block in enumerate(doubles):
            img, txt = block(img, txt, vec, cos, sin)
            if cache_mode == "record" and i == cfg.cache_front_blocks - 1:
                img_front = img
        if cache_mode == "reuse":
            img = img + delta.to(img.dtype)
        else:
            x = torch.cat([txt, img], dim=1)
            for block in self.single_blocks:
                x = block(x, vec, cos, sin)
            img = x[:, txt.shape[1]:]
            if cache_mode == "record":
                delta = (img - img_front).to(dtype)

        shift, scale = self.final_mod(vec)
        h2 = _modulate(img, shift, scale)
        velocity = self.final_proj(h2)
        if cache_mode is not None:
            return velocity, vec, h1, h2, delta
        return velocity, vec, h1, h2


def pack_latents(latents: torch.Tensor):
    """(b, c, h, w) -> packed tokens (b, (h/2)(w/2), 4c) and img_ids (b, n,
    3) fp32 = (0, row, column) of each 2 x 2 patch."""
    b, c, h, w = latents.shape
    gh, gw = h // 2, w // 2
    x = latents.reshape(b, c, gh, 2, gw, 2).permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * 4)
    ys = torch.arange(gh, device=latents.device).repeat_interleave(gw)
    xs = torch.arange(gw, device=latents.device).repeat(gh)
    ids = torch.stack([torch.zeros_like(ys), ys, xs], dim=-1).to(torch.float32)
    return x, ids[None].expand(b, -1, -1)


def unpack_latents(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of ``pack_latents``: (b, n, 4c) -> (b, c, h, w)."""
    b, _, c4 = tokens.shape
    c = c4 // 4
    x = tokens.reshape(b, h // 2, w // 2, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)
