"""T5 v1.1 encoder (SD3's text_encoder_3, T5-XXL).

Counterpart of ``tpdm_tpu/models/t5.py``: the transformers
``T5EncoderModel`` architecture. RMS norm without mean subtraction, no
biases, a gated-GELU MLP, and a relative-position bias computed once in
block 0 and reused by every block. Submodules carry the Flax names
(``block.{i}.attention.q``, ``ln_attn``, ``wi_0``, ``shared``), so
``utils/convert.py:t5_from_jax`` maps a Flax tree one to one.

The numerics follow the JAX module: scores in fp32 without the
sqrt(d_kv) scale, the bias added in fp32, padding masked at -1e9, an fp32
softmax cast to V's dtype. The attention stays in plain torch ops: K1
takes no additive bias, and at 256 tokens the tower's time is in its
dense layers, which go to cuBLAS through ``nn.Linear``.

``quant_matmuls`` stores the seven matmuls of every block as weight-only
int8 or int4 (``quant_bits``): bias-free ``ops/quant.py:DenseMaybeQuant``
layers with fp activations (``act_quant=False``), so ``w8_matmul`` or
``w4_matmul`` dequantise the weight and multiply on K5. Load the float
weights, then ``ops/quant.py:prequantize_`` quantises the tower once; a
JAX-prequantised tree loads as it is (``utils/convert.py:t5_from_jax``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    # weight-only stored-int block matmuls (int8 halves T5-XXL's 9.5 GB of
    # bf16 weights, int4 quarters them); the activations stay float
    quant_matmuls: bool = False
    quant_bits: int = 8

    @classmethod
    def t5_xxl(cls, **kw) -> "T5Config":
        return cls(**kw)

    @classmethod
    def toy(cls, **kw) -> "T5Config":
        d = dict(vocab_size=120, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4)
        d.update(kw)
        return cls(**d)


class T5LayerNorm(nn.Module):
    """RMS norm without mean subtraction, weight only: the statistics and
    the scaling in fp32, cast to the weight's dtype, then times the weight."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps)).to(self.weight.dtype) * self.weight


def t5_relative_position_bucket(
    relative_position: torch.Tensor, num_buckets: int = 32, max_distance: int = 128
) -> torch.Tensor:
    """Bidirectional bucket of each (memory - query) distance, as the JAX
    function (transformers ``T5Attention`` parity): exact up to a quarter
    of ``num_buckets``, then logarithmic up to ``max_distance``, truncated
    toward zero in fp32. log(0) at distance 0 is masked by the ``where``."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_range = torch.log(torch.full((), max_distance / max_exact, dtype=torch.float32,
                                     device=n.device))
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact) / log_range
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


def _dense(cfg: T5Config, in_features: int, out_features: int) -> nn.Module:
    """A bias-free block matmul: ``nn.Linear``, or with ``quant_matmuls`` a
    weight-only ``DenseMaybeQuant`` at ``quant_bits``."""
    if cfg.quant_matmuls:
        from tpdm_tpu_torch.ops.quant import DenseMaybeQuant

        return DenseMaybeQuant(in_features, out_features, bits=cfg.quant_bits,
                               act_quant=False, bias=False)
    return nn.Linear(in_features, out_features, bias=False)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = _dense(cfg, cfg.d_model, inner)
        self.k = _dense(cfg, cfg.d_model, inner)
        self.v = _dense(cfg, cfg.d_model, inner)
        self.o = _dense(cfg, inner, cfg.d_model)
        if has_relative_bias:
            self.relative_attention_bias = nn.Parameter(
                torch.zeros(cfg.relative_attention_num_buckets, cfg.num_heads))

    def position_bias(self, n: int, device) -> torch.Tensor:
        """(1, h, n, n) bias from this block's table."""
        cfg = self.cfg
        pos = torch.arange(n, device=device)
        buckets = t5_relative_position_bucket(
            pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        return self.relative_attention_bias[buckets.long()].permute(2, 0, 1)[None]

    def forward(self, x, mask: Optional[torch.Tensor], position_bias: Optional[torch.Tensor]):
        b, n, _ = x.shape
        h, dk = self.cfg.num_heads, self.cfg.d_kv
        heads = lambda t: t.reshape(b, n, h, dk).transpose(1, 2)
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        if position_bias is None:
            position_bias = self.position_bias(n, x.device)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))  # no 1/sqrt(d_kv)
        s = s + position_bias.float()
        if mask is not None:
            s = s.masked_fill(~mask[:, None, None, :].bool(), -1e9)
        o = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
        return self.o(o.transpose(1, 2).reshape(b, n, h * dk)), position_bias


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln_attn = T5LayerNorm(cfg.d_model, eps)
        self.attention = T5Attention(cfg, has_relative_bias)
        self.ln_mlp = T5LayerNorm(cfg.d_model, eps)
        self.wi_0 = _dense(cfg, cfg.d_model, cfg.d_ff)
        self.wi_1 = _dense(cfg, cfg.d_model, cfg.d_ff)
        self.wo = _dense(cfg, cfg.d_ff, cfg.d_model)

    def forward(self, x, mask, position_bias):
        att, position_bias = self.attention(self.ln_attn(x), mask, position_bias)
        x = x + att
        y = self.ln_mlp(x)
        y = F.gelu(self.wi_0(y), approximate="tanh") * self.wi_1(y)  # gated GELU (T5 v1.1)
        return x + self.wo(y), position_bias


class T5Encoder(nn.Module):
    """ids (b, n) [, attention_mask (b, n), True = token] -> last hidden
    state (b, n, d_model)."""

    def __init__(self, config: T5Config):
        super().__init__()
        cfg = self.config = config
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.block = nn.ModuleList(T5Block(cfg, has_relative_bias=(i == 0))
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "T5Encoder":
        """Random weights from ``generator`` (on the module's device) at T5's
        own scales (transformers ``T5PreTrainedModel._init_weights``): the
        embedding N(0, 1), q N(0, 1/(d_model d_kv)), k, v,
        wi_0, wi_1 and the bias table N(0, 1/d_model), o N(0, 1/(heads
        d_kv)), wo N(0, 1/d_ff), norm weights 1. T5 does not scale its
        scores, so these scales are what keep them of order one. For runs
        without converted weights."""
        cfg = self.config
        std = {"q": (cfg.d_model * cfg.d_kv) ** -0.5, "k": cfg.d_model**-0.5,
               "v": cfg.d_model**-0.5, "o": (cfg.num_heads * cfg.d_kv) ** -0.5,
               "wi_0": cfg.d_model**-0.5, "wi_1": cfg.d_model**-0.5, "wo": cfg.d_ff**-0.5,
               "relative_attention_bias": cfg.d_model**-0.5, "shared": 1.0}
        for name, p in self.named_parameters():
            parts = name.split(".")
            if p.dim() == 1:
                p.fill_(1.0)
            else:
                key = parts[-1] if parts[-1] != "weight" else parts[-2]
                p.normal_(0.0, std[key], generator=generator)
        return self

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        x = self.shared(input_ids)
        position_bias = None
        for block in self.block:
            x, position_bias = block(x, attention_mask, position_bias)
        return self.final_layer_norm(x)
