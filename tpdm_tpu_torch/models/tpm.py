"""Time Prediction Module (TPM): the policy that picks each next noise level.

Counterpart of ``tpdm_tpu/models/tpm.py``: two 3x3 convs (stride 1, then
2) with a temb-conditioned single-group GroupNorm between them, adaptive
average pool to 16x16, global max pool, then a 2-layer MLP whose
exp() + epsilon output gives Beta parameters (alpha, beta) > epsilon.

As the Flax module, it computes in ``dtype`` whatever its parameters' dtype:
each forward casts the weights and the input of every conv and linear to
``dtype``. Training keeps fp32 parameters with a bf16 ``dtype``: at a
learning rate of 1e-6 an Adam step on bf16 parameters (2^-8 relative)
would round away. ``torch.autocast`` is not the same: it picks per op
which ones run in the lower precision.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpdm_tpu_torch.models.layers import GroupNorm, init_weights


def reshape_tokens_to_2d(
    tokens: torch.Tensor, height: int = 64, width: int = 64, patch_size: int = 2
) -> torch.Tensor:
    """(b, n_tokens, c) -> (b, c, height, width), reading the token axis as
    (h', w', p, q) — the exact ``nhwpqc->nchpwq`` arrangement the TPM was
    trained against."""
    b, _, c = tokens.shape
    gh, gw = height // patch_size, width // patch_size
    x = tokens.reshape(b, gh, gw, patch_size, patch_size, c)
    return x.permute(0, 5, 1, 3, 2, 4).reshape(b, c, height, width)


def _linear(m: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), m.weight.to(dtype), m.bias.to(dtype))


def _conv(m: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), m.weight.to(dtype), m.bias.to(dtype), m.stride, m.padding)


class AdaGroupNormZeroSingle(nn.Module):
    """GroupNorm(1 group) with temb-conditioned (shift, scale); NCHW. The
    linear runs in ``dtype``; the norm keeps fp32 statistics and returns
    its input's dtype."""

    def __init__(self, input_dim: int, embedding_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(input_dim, 2 * embedding_dim)
        self.norm = GroupNorm(1, embedding_dim)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        shift, scale = _linear(self.linear, F.silu(emb), self.dtype).chunk(2, dim=-1)
        return self.norm(x) * (1.0 + scale[:, :, None, None]) + shift[:, :, None, None]


class TimePredictor(nn.Module):
    """Predicts Beta(alpha, beta) decay-ratio parameters from activations.

    ``param_cap`` (None = exp() as the reference) bounds alpha and beta
    smoothly at epsilon + param_cap. ``dtype`` is the compute dtype (see the
    module docstring).
    """

    def __init__(
        self,
        conv_out_channels: int = 128,
        in_channels: int = 1536 * 2,
        temb_dim: int = 1536,
        projection_dim: int = 2,
        init_alpha: float = 1.5,
        init_beta: float = 0.5,
        epsilon: float = 1.0,
        param_cap: Optional[float] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.init_alpha, self.init_beta = init_alpha, init_beta
        self.dtype = dtype
        self.epsilon = epsilon
        self.param_cap = param_cap
        self.conv1 = nn.Conv2d(in_channels, conv_out_channels, 3, padding=1)
        self.norm1 = AdaGroupNormZeroSingle(temb_dim, conv_out_channels, dtype)
        self.conv2 = nn.Conv2d(conv_out_channels, conv_out_channels, 3, stride=2, padding=1)
        self.fc1 = nn.Linear(conv_out_channels, 128)
        self.fc2 = nn.Linear(128, projection_dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> "TimePredictor":
        """N(0, std²) weights, zero biases, fc2 bias = (init_alpha, init_beta)."""
        init_weights(self, generator, std)
        self.fc2.bias.copy_(torch.tensor([self.init_alpha, self.init_beta]))
        return self

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        """x: (b, in_channels, H, W); temb: (b, temb_dim). Returns (b, 2)
        fp32 (alpha, beta), each > epsilon."""
        dt = self.dtype
        x = _conv(self.conv1, x, dt)
        x = F.silu(self.norm1(x, temb))
        x = _conv(self.conv2, x, dt)
        x = F.adaptive_avg_pool2d(x, (16, 16)).amax(dim=(2, 3))
        x = _linear(self.fc2, F.silu(_linear(self.fc1, x, dt)), dt).float()
        if self.param_cap is not None:
            cap = float(self.param_cap)
            return self.epsilon + cap * torch.sigmoid(x - math.log(cap))
        return torch.exp(x) + self.epsilon
