"""The SD VAEs (AutoencoderKL layout) in PyTorch, NCHW: decoder and encoder.

Counterpart of ``tpdm_tpu/models/vae.py``. The mid-block attention of both
halves (one head, 512 wide, 16384 tokens at 1024 px) runs kernel K2 on the
card (``ops/attention.py``). Convs and matmuls run in the weights' dtype
and GroupNorm keeps fp32 statistics: with bf16 weights (``vae.to(
torch.bfloat16)``) that is the JAX package's ``make_fast_decode`` policy,
for the encode as for the decode.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpdm_tpu_torch.models.layers import GroupNorm, init_weights
from tpdm_tpu_torch.ops.attention import joint_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Autoencoder geometry (diffusers AutoencoderKL layout)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 1.5305
    shift_factor: float = 0.0609

    @classmethod
    def sd3(cls, **kw) -> "VAEConfig":
        return cls(**kw)

    @classmethod
    def sd15(cls, **kw) -> "VAEConfig":
        """SD1.5's AutoencoderKL: 4 latent channels, scaling 0.18215, no shift."""
        d = dict(latent_channels=4, scaling_factor=0.18215, shift_factor=0.0)
        d.update(kw)
        return cls(**d)

    @classmethod
    def sdxl(cls, **kw) -> "VAEConfig":
        """SDXL's AutoencoderKL: SD1.5's topology at scaling 0.13025 (a wrong
        scaling factor decodes silently wrong)."""
        d = dict(latent_channels=4, scaling_factor=0.13025, shift_factor=0.0)
        d.update(kw)
        return cls(**d)

    @classmethod
    def toy(cls, **kw) -> "VAEConfig":
        d = dict(latent_channels=4, block_out_channels=(8, 16), norm_num_groups=4,
                 layers_per_block=1)
        d.update(kw)
        return cls(**d)


def vae_scale_factor(config: VAEConfig) -> int:
    """Image pixels per latent cell (8 for the SD VAEs)."""
    return 2 ** (len(config.block_out_channels) - 1)


class ResnetBlock(nn.Module):
    """GN -> silu -> conv, twice, plus a 1x1 shortcut when widths differ."""

    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention with a residual (d = channels)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wid = x.shape
        h = self.group_norm(x).flatten(2).transpose(1, 2)  # (b, hw, c)
        q, k, v = (proj(h)[:, None] for proj in (self.to_q, self.to_k, self.to_v))
        o = self.to_out(joint_attention(q, k, v)[:, 0])  # K2 on the card
        return x + o.transpose(1, 2).reshape(b, c, hgt, wid)


class MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(channels, channels, groups), ResnetBlock(channels, channels, groups)]
        )
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class UpBlock(nn.Module):
    """layers_per_block + 1 resnets, then (except the last) a 2x nearest
    upsample and a 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int, n_resnets: int, groups: int,
                 upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels, groups)
            for j in range(n_resnets)
        )
        self.upsamplers = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, padding=1)] if upsample else []
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for conv in self.upsamplers:
            x = conv(F.interpolate(x, scale_factor=2, mode="nearest"))
        return x


class DownBlock(nn.Module):
    """layers_per_block resnets, then (except the last) a stride-2 3x3 conv
    over the input padded by one row and column at the bottom and right
    (diffusers Downsample2D)."""

    def __init__(self, in_channels: int, out_channels: int, n_resnets: int, groups: int,
                 downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels, groups)
            for j in range(n_resnets)
        )
        self.downsamplers = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, stride=2)] if downsample else []
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for conv in self.downsamplers:
            x = conv(F.pad(x, (0, 1, 0, 1)))
        return x


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        ch = list(config.block_out_channels)  # e.g. [128, 256, 512, 512]
        groups = config.norm_num_groups
        self.conv_in = nn.Conv2d(config.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            DownBlock(ch[max(i - 1, 0)], out_ch, config.layers_per_block, groups,
                      downsample=i < len(ch) - 1)
            for i, out_ch in enumerate(ch)
        )
        self.mid_block = MidBlock(ch[-1], groups)
        self.conv_norm_out = GroupNorm(groups, ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], 2 * config.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        ch = list(reversed(config.block_out_channels))  # e.g. [512, 512, 256, 128]
        groups = config.norm_num_groups
        self.conv_in = nn.Conv2d(config.latent_channels, ch[0], 3, padding=1)
        self.mid_block = MidBlock(ch[0], groups)
        self.up_blocks = nn.ModuleList(
            UpBlock(ch[max(i - 1, 0)], out_ch, config.layers_per_block + 1, groups,
                    upsample=i < len(ch) - 1)
            for i, out_ch in enumerate(ch)
        )
        self.conv_norm_out = GroupNorm(groups, ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], config.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    """``decode(z)``: (b, latent_c, h, w) unscaled latents -> (b, 3, 8h, 8w)
    in [-1, 1]-ish; ``encode(img)``: (b, 3, H, W) -> (mean, logvar), each
    (b, latent_c, H/8, W/8); both in the weights' dtype.

    ``encoder=False`` builds the decoder alone (a checkpoint that holds no
    encoder): ``encoder`` is then None and ``encode`` raises. The encoder
    is registered after the decoder, so ``init_weights`` draws the decoder's
    weights first, as it did before the encoder was ported.
    """

    def __init__(self, config: VAEConfig, encoder: bool = True):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.encoder = Encoder(config) if encoder else None

    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> "VAE":
        return init_weights(self, generator, std)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Apply ``z / scaling_factor + shift_factor`` before calling."""
        return self.decoder(z.to(self.decoder.conv_in.weight.dtype))

    def encode(self, img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, logvar) of the posterior, logvar clipped to [-30, 20]."""
        if self.encoder is None:
            raise ValueError("this VAE was built without an encoder (decoder-only weights)")
        out = self.encoder(img.to(self.encoder.conv_in.weight.dtype))
        mean, logvar = out.chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)

