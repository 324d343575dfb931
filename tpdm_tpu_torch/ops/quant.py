"""Quantised dense layers: W8A8-dynamic int8 and weight-only int8 / int4.

Counterpart of ``tpdm_tpu/ops/quant.py``, with its public names. Weights
keep ``nn.Linear``'s (out, in) layout, so a quantised weight is K-major
for the kernels of ``ops/gemm.py``:

- int8: symmetric per output channel, ``weight`` int8 (out, in) and
  ``weight_scale`` fp32 (out,);
- int4: symmetric per (input group, output channel), q in [-7, 7], packed
  two to a byte along the input axis (uint8 (out, in/2); the low nibble
  holds the even input index), with ``weight_scale`` fp32 (in/g, out) as
  in JAX. Weights take a quarter of bf16's bytes.

W8A8 (``int8_dynamic_matmul``) quantises the activations per row in plain
torch ops, as JAX does outside any kernel, and runs the int8 product with
its dequant epilogue on K4 (``ops/gemm.py:int8_gemm``). The weight-only
products (``w4_matmul``, ``w8_matmul``) dequantise the weight in the
activations' dtype, in JAX's order, and multiply on K5 (``bf16_gemm``).
``DenseMaybeQuant`` runs W8A8 at 8 bits, ``w8_matmul`` at 8 bits with
``act_quant=False`` (FLUX's modulations and the quantised T5 tower, whose
layers have no bias) and ``w4_matmul`` at 4.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from tpdm_tpu_torch.ops.gemm import bf16_gemm, int8_gemm


class QuantizedLinear(NamedTuple):
    """Quantised weights: int8 (out, in) with scale (out,), or packed int4
    uint8 (out, in/2) with scale (in/g, out); w = q * scale."""

    weight_q: torch.Tensor
    scale: torch.Tensor  # float32
    bias: Optional[torch.Tensor]


def quantize_weight(weight: torch.Tensor, bias=None) -> QuantizedLinear:
    """fp weight (out, in) -> per-out-channel symmetric int8 (JAX's
    ``quantize_weight`` on the kernel ``weight.T``)."""
    w32 = weight.float()
    scale = w32.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127).to(torch.int8)
    return QuantizedLinear(q, scale, bias)


W4_GROUP = 128


def _w4_group(in_features: int, group: int = W4_GROUP) -> int:
    """Group size for int4 quantization over ``in_features``: W4_GROUP when
    it divides the contraction dim, else the whole column (toy layers)."""
    if in_features >= group and in_features % group == 0:
        return group
    return in_features


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], (..., 2k) -> uint8 (..., k): the low nibble
    holds the even index."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last axis, got {tuple(q.shape)}")
    nib = q.to(torch.uint8) & 0xF
    return nib[..., 0::2] | (nib[..., 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., k) -> int8 (..., 2k), the inverse of ``pack_int4``."""
    nib = torch.stack([packed & 0xF, packed >> 4], dim=-1).to(torch.int8)
    return torch.where(nib > 7, nib - 16, nib).flatten(-2)


def quantize_weight_w4(
    weight: torch.Tensor, bias=None, group: int = W4_GROUP
) -> QuantizedLinear:
    """fp weight (out, in) -> group-wise symmetric int4, packed (JAX's
    ``quantize_weight_w4`` on the kernel ``weight.T``): scale (in/g, out)."""
    out_f, in_f = weight.shape
    g = _w4_group(in_f, group)
    w32 = weight.float().reshape(out_f, in_f // g, g)
    scale = w32.abs().amax(dim=2).clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(w32 / scale[:, :, None]), -7, 7).to(torch.int8)
    return QuantizedLinear(pack_int4(q.reshape(out_f, in_f)), scale.T.contiguous(), bias)


def _as_matrix(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def _weight_only(x: torch.Tensor, w: torch.Tensor, bias) -> torch.Tensor:
    """x @ w.T on K5, then the bias added in x's dtype."""
    y = bf16_gemm(_as_matrix(x), w).reshape(*x.shape[:-1], w.shape[0])
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def w4_matmul(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """y = x @ dequant4(W).T (+ b): int4 weight storage, compute in x's
    dtype. The weight is dequantised as JAX does it, ``q.astype(x.dtype) *
    scale.astype(x.dtype)`` per group, then multiplied on K5."""
    q = unpack_int4(qw.weight_q)
    out_f, in_f = q.shape
    n_groups = qw.scale.shape[0]
    w = q.to(x.dtype).reshape(out_f, n_groups, in_f // n_groups) * qw.scale.T.to(x.dtype)[:, :, None]
    return _weight_only(x, w.reshape(out_f, in_f), qw.bias)


def w8_matmul(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """y = x @ dequant(W).T (+ b): int8 weight storage, compute in x's
    dtype (the weight dequantised per output channel, then K5)."""
    w = qw.weight_q.to(x.dtype) * qw.scale[:, None].to(x.dtype)
    return _weight_only(x, w, qw.bias)


def _quantize_rows(x2: torch.Tensor):
    """Per-row dynamic int8 of a (M, K) activation, as JAX's
    ``int8_dynamic_matmul`` forms it: absmax in fp32 over each row,
    clipped at 1e-8, / 127, round half to even, clip to ±127. Returns
    (int8 (M, K), fp32 scale (M,)).

    The same fp32 values without an fp32 copy of x: |x| and its max are
    exact in x's dtype, and dividing x by the fp32 scale promotes to fp32;
    round and clip then work in place."""
    x_scale = x2.abs().amax(dim=1).float().clamp_min(1e-8) / 127.0
    xq = (x2 / x_scale[:, None]).round_().clamp_(-127, 127).to(torch.int8)
    return xq, x_scale


def int8_dynamic_matmul(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """y = x @ W.T (+ b) with W int8 and x quantised per row on the fly.

    x: (..., in); returns (..., out) in x's dtype. The product and its
    dequant epilogue run on K4 (``int8_gemm``)."""
    xq, x_scale = _quantize_rows(_as_matrix(x))
    y = int8_gemm(xq, qw.weight_q, x_scale, qw.scale, qw.bias, out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], qw.weight_q.shape[0])


class DenseMaybeQuant(nn.Module):
    """The quantised counterpart of ``nn.Linear``: what JAX's
    ``DenseMaybeQuant`` is with ``quant`` on. ``models/layers.py:dense``
    builds it for a quant model and ``nn.Linear`` otherwise, so a
    quantised state dict meets a float model only as a strict load's
    unexpected ``weight_scale``.

    It holds either a float ``weight`` (out, in) Parameter, quantised in
    every forward as JAX's in-graph mode does, or, once quantised
    (``prequantize_``, or a state dict with an int ``weight``), int
    ``weight`` and fp32 ``weight_scale`` buffers of the shapes listed at the
    top of this file. ``bits`` 8 runs W8A8, or with ``act_quant=False``
    weight-only int8 (``w8_matmul``: fp activations); ``bits`` 4 is
    weight-only whatever ``act_quant`` says, as in JAX. ``bias=False``
    builds it without a bias (JAX's ``use_bias=False``), and a state dict
    then loads strictly without one.

    The scale stays fp32 through ``.to(dtype)``, ``.half()`` and the like,
    as JAX keeps it: only the device of ``weight_scale`` follows the module.
    """

    def __init__(self, in_features: int, out_features: int, bits: int = 8,
                 act_quant: bool = True, bias: bool = True):
        super().__init__()
        if bits not in (4, 8):
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        if bits == 4 and in_features % 2:
            raise ValueError(f"int4 packs two inputs a byte: in_features {in_features} is odd")
        self.in_features, self.out_features, self.bits = in_features, out_features, bits
        self.act_quant = act_quant
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        # nn.Linear's initialisation
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features))
            bound = 1 / math.sqrt(in_features) if in_features > 0 else 0
            nn.init.uniform_(self.bias, -bound, bound)
        else:
            self.register_parameter("bias", None)

    @property
    def quantized(self) -> bool:
        """Whether the weight is stored as int (with ``weight_scale``)."""
        return not self.weight.is_floating_point()

    def _stored_shapes(self):
        """(weight dtype, weight shape, scale shape) of the quantised form."""
        if self.bits == 4:
            g = _w4_group(self.in_features)
            return (torch.uint8, (self.out_features, self.in_features // 2),
                    (self.in_features // g, self.out_features))
        return torch.int8, (self.out_features, self.in_features), (self.out_features,)

    def _quantize(self, weight: torch.Tensor) -> QuantizedLinear:
        if self.bits == 4:
            return quantize_weight_w4(weight, self.bias, group=_w4_group(self.in_features))
        return quantize_weight(weight, self.bias)

    def _store(self, weight_q: torch.Tensor, scale: torch.Tensor) -> None:
        del self.weight
        self.register_buffer("weight", weight_q)
        self.register_buffer("weight_scale", scale.float())

    @torch.no_grad()
    def quantize_(self) -> "DenseMaybeQuant":
        """Replace a float weight by its quantisation (once, in place)."""
        if not self.quantized:
            qw = self._quantize(self.weight)
            self._store(qw.weight_q, qw.scale)
        return self

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        # the incoming weight's dtype picks the form: an int weight needs its
        # scale, of the quantised shapes; a float weight loads only before
        # prequantisation and drops any scale (a JAX tree from a quant
        # model's init carries unit ones, which prequantisation recomputes)
        w = state_dict.get(prefix + "weight")
        scale_key = prefix + "weight_scale"
        if w is not None and w.is_floating_point():
            if self.quantized:
                raise ValueError(f"{prefix}weight: a float weight for a prequantised layer; "
                                 "load the float weights first, then prequantize_")
            state_dict.pop(scale_key, None)
        elif w is not None:
            dtype, w_shape, s_shape = self._stored_shapes()
            if w.dtype != dtype or tuple(w.shape) != w_shape:
                raise ValueError(f"{prefix}weight: {w.dtype} {tuple(w.shape)}, expected "
                                 f"{dtype} {w_shape} for int{self.bits}")
            scale = state_dict.get(scale_key)
            if scale is None or tuple(scale.shape) != s_shape:
                got = "missing" if scale is None else tuple(scale.shape)
                raise ValueError(f"{scale_key}: {got}, expected {s_shape} for the int weight")
            if not self.quantized:
                device = self.weight.device
                self._store(torch.empty(w_shape, dtype=dtype, device=device),
                            torch.empty(s_shape, dtype=torch.float32, device=device))
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys, error_msgs)

    def _apply(self, fn, recurse=True):
        scale = self._buffers.get("weight_scale")
        super()._apply(fn, recurse)
        if scale is not None and self.weight_scale.dtype != torch.float32:
            self._buffers["weight_scale"] = scale.to(self.weight_scale.device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantized:
            qw = QuantizedLinear(self.weight, self.weight_scale, self.bias)
        else:
            qw = self._quantize(self.weight)
        if self.bits == 4:
            return w4_matmul(x, qw)
        if not self.act_quant:
            return w8_matmul(x, qw)
        return int8_dynamic_matmul(x, qw)


def prequantize_(module: nn.Module) -> nn.Module:
    """Quantise every ``DenseMaybeQuant`` of ``module`` in place, once,
    after its float weights are loaded: its forwards then skip the in-graph
    weight quantisation. Counterpart of JAX's ``prequantize_params``
    (+ ``fit_quant_params``: the port's modules need no scale leaf to load a
    float tree). Returns ``module``."""
    for m in module.modules():
        if isinstance(m, DenseMaybeQuant):
            m.quantize_()
    return module
