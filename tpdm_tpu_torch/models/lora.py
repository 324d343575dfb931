"""LoRA adapters over a frozen backbone module.

Counterpart of ``tpdm_tpu/models/lora.py``, with its public names. A LoRA
dict maps the module name of each targeted dense layer (``transformer_
blocks.0.attn.to_q``) to its rank-r factors ``{"a": (d_in, r), "b": (r,
d_out)}``, in fp32 and in JAX's orientation. The port's ``nn.Linear``
weight is (out, in), so the merged delta is ``(scale · a @ b)ᵀ``.
``utils/convert.py:lora_from_jax`` / ``lora_to_jax`` carry a dict to and
from the JAX package's Flax paths (``params/transformer_blocks_0/attn/
to_q/kernel``), which are also the keys of the LoRA files
(``train/draft.py``).

- ``apply_lora`` merges: it returns the merged weight tensors (a dict of
  ``"<module>.weight"`` entries) and never writes into the module.
  ``call_merged`` runs a function with those tensors standing in for the
  module's own (``torch.func.functional_call``). ``merge_lora`` is the
  same merge under autograd, for training: gradients reach the factors,
  never the base weights (JAX's ``apply_lora`` is differentiable).
- ``stack_adapters`` and ``lora_interceptor`` are the fused path: the
  factors of several adapters stacked into a bank (row 0 the base, an
  exact zero delta), and forward hooks that add each batch row's own
  delta ``(x @ a[id]) @ b[id]`` in fp32 beside the layer's output. One
  forward then serves any mix of adapters, over a float or a quantised
  backbone. The delta is a plain fp32 ``einsum``, as in JAX (an XLA
  einsum outside any Pallas kernel there).

A key that names no dense layer of the module raises, in every function
that takes a module: a misnamed adapter never serves the base weights
silently. A fresh adapter (``b`` zero) is an exact identity.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from tpdm_tpu_torch.ops.quant import DenseMaybeQuant

__all__ = [
    "default_match",
    "lora_targets",
    "check_lora",
    "init_lora",
    "apply_lora",
    "merge_lora",
    "call_merged",
    "MergedLRU",
    "lora_param_count",
    "stack_adapters",
    "lora_interceptor",
]


def default_match(name: str, module: nn.Module) -> bool:
    """Every 2-D dense weight: each ``nn.Linear`` and ``DenseMaybeQuant``
    (attention projections, MLPs, the adaLN and embedding projections).
    Convolutions and norms are left out, as JAX's 2-D ``kernel`` rule
    leaves out conv kernels and norm scales."""
    del name
    return isinstance(module, (nn.Linear, DenseMaybeQuant))


def lora_targets(module: nn.Module, match: Optional[Callable] = None) -> Dict[str, nn.Module]:
    """{name: submodule} of the layers that ``match`` selects."""
    match = match or default_match
    return {name: m for name, m in module.named_modules() if name and match(name, m)}


def _checked_targets(module: nn.Module, keys) -> Dict[str, nn.Module]:
    """The dense layers named by ``keys``; a key that names none raises."""
    targets = lora_targets(module)
    missing = sorted(set(keys) - set(targets))
    if missing:
        raise ValueError(
            f"{len(missing)}/{len(set(keys))} LoRA keys name no nn.Linear / DenseMaybeQuant "
            f"of the {type(module).__name__} (e.g. {missing[0]!r}): wrong model's adapter?")
    return targets


def check_lora(module: nn.Module, lora: Mapping) -> dict:
    """``lora``'s factors as fp32 tensors on ``module``'s device, once every
    key is checked to name a dense layer of ``module``."""
    if not lora:
        raise ValueError("empty LoRA dict")
    _checked_targets(module, lora)
    device = next(module.parameters()).device
    return {k: {w: torch.as_tensor(f[w], dtype=torch.float32, device=device) for w in ("a", "b")}
            for k, f in lora.items()}


def init_lora(module: nn.Module, rank: int, generator: torch.Generator,
              match: Optional[Callable] = None, dtype: torch.dtype = torch.float32) -> dict:
    """A LoRA dict over ``module``'s targeted layers: ``a`` ~ N(0, 1/d_in)
    drawn from ``generator`` (on its device), ``b`` zero, both fp32: a
    fresh adapter is an exact identity."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    device = generator.device
    lora = {}
    for name, m in sorted(lora_targets(module, match).items()):
        d_in, d_out = m.in_features, m.out_features
        a = torch.randn(d_in, rank, generator=generator, dtype=dtype, device=device)
        lora[name] = {"a": a / torch.sqrt(torch.tensor(float(d_in), dtype=dtype)),
                      "b": torch.zeros(rank, d_out, dtype=dtype, device=device)}
    if not lora:
        raise ValueError("no layer matched the LoRA target predicate")
    return lora


def merge_lora(module: nn.Module, lora: Mapping, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """The merged weights ``W + ((a @ b) · scale)ᵀ``, the delta formed in
    fp32 and cast to W's dtype before the add (JAX's ``leaf +
    delta.astype(leaf.dtype)``), as {"<module>.weight": tensor} for every
    key of ``lora``, differentiable with respect to the factors (the base
    weights enter detached: they never receive a gradient). The module's own
    parameters are not written. A quantised (stored-int) layer has no float
    weight to merge into and raises."""
    targets = _checked_targets(module, lora)
    merged = {}
    for name, fac in lora.items():
        w = targets[name].weight
        if not w.is_floating_point():
            raise ValueError(f"{name}: cannot merge LoRA into a quantized weight; serve float "
                             "weights, or fused adapters (lora_interceptor)")
        a = torch.as_tensor(fac["a"], dtype=torch.float32, device=w.device)
        b = torch.as_tensor(fac["b"], dtype=torch.float32, device=w.device)
        delta = (a @ b) * scale
        merged[f"{name}.weight"] = w.detach() + delta.T.to(w.dtype)
    return merged


@torch.no_grad()
def apply_lora(module: nn.Module, lora: Mapping, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """``merge_lora`` without autograd: the serving path's merge."""
    return merge_lora(module, lora, scale)


class _Call(nn.Module):
    """Holds a module so that ``functional_call`` can swap its tensors
    around a whole function, not one forward."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, fn, args, kwargs):
        return fn(*args, **kwargs)


def call_merged(module: nn.Module, merged: Mapping[str, torch.Tensor], fn: Callable,
                *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``merged`` (``apply_lora``'s tensors)
    standing in for ``module``'s parameters of the same names, through
    ``torch.func.functional_call``: the module's own parameters are not
    written, and they are back in place when ``fn`` returns or raises."""
    params = {f"module.{k}": v for k, v in merged.items()}
    return torch.func.functional_call(_Call(module), params, (fn, args, kwargs))


class MergedLRU:
    """The merged weights (``apply_lora``) of named adapters over a module,
    kept for the ``size`` adapters used last: each entry is a copy of every
    targeted weight on the device. ``merges`` counts the merges paid."""

    def __init__(self, size: int = 1):
        self.size, self.merges = size, 0
        self._entries: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, module: nn.Module, name: str, lora: Mapping, scale: float) -> dict:
        if name in self._entries:
            self._entries.move_to_end(name)
            return self._entries[name]
        while len(self._entries) >= self.size:  # evict first: never size + 1 copies
            self._entries.popitem(last=False)
        merged = self._entries[name] = apply_lora(module, lora, scale=scale)
        self.merges += 1
        return merged

    def drop(self, name: str) -> None:
        self._entries.pop(name, None)

    def __len__(self) -> int:
        return len(self._entries)


def lora_param_count(lora: Mapping) -> int:
    return sum(int(f["a"].numel()) + int(f["b"].numel()) for f in lora.values())


def stack_adapters(adapters: Mapping) -> tuple:
    """Stack named adapters into a factor bank for the fused path.

    adapters: {name: (lora, scale)}. Returns (bank, name_to_id): bank
    {key: {"a": (n+1, d_in, r_max), "b": (n+1, r_max, d_out)}} fp32 over the
    union of the adapters' keys, row 0 the base (zero factors, an exact
    no-op delta), row name_to_id[name] that adapter's factors right-padded
    with zero rank columns to r_max and ``scale`` folded into ``b``;
    name_to_id {name: id >= 1} in sorted name order."""
    if not adapters:
        raise ValueError("no adapters to stack")
    names = sorted(adapters)
    name_to_id = {n: i + 1 for i, n in enumerate(names)}
    keys = sorted({k for lora, _ in adapters.values() for k in lora})
    n = len(names) + 1
    bank = {}
    for key in keys:
        geometry, r_max, device = None, 0, None
        for lora, _ in adapters.values():
            fac = lora.get(key)
            if fac is None:
                continue
            a, b = fac["a"], fac["b"]
            if geometry is None:
                geometry, device = (a.shape[0], b.shape[1]), a.device
            elif (a.shape[0], b.shape[1]) != geometry:
                raise ValueError(f"adapter shape mismatch at {key}")
            r_max = max(r_max, a.shape[1])
        d_in, d_out = geometry
        A = torch.zeros((n, d_in, r_max), dtype=torch.float32, device=device)
        B = torch.zeros((n, r_max, d_out), dtype=torch.float32, device=device)
        for name in names:
            lora, scale = adapters[name]
            fac = lora.get(key)
            if fac is None:
                continue
            i, r = name_to_id[name], fac["a"].shape[1]
            A[i, :, :r] = fac["a"].float()
            B[i, :r, :] = fac["b"].float() * float(scale)
        bank[key] = {"a": A, "b": B}
    return bank, name_to_id


def _delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, name: str) -> torch.Tensor:
    """((x @ a) @ b) per batch row, in fp32."""
    x = x.float()
    if x.dim() == 2:
        return torch.einsum("br,bro->bo", torch.einsum("bd,bdr->br", x, a), b)
    if x.dim() == 3:
        return torch.einsum("blr,bro->blo", torch.einsum("bld,bdr->blr", x, a), b)
    raise ValueError(f"unsupported dense input rank {x.dim()} at {name}")


@contextlib.contextmanager
def lora_interceptor(module: nn.Module, bank: Mapping, row_ids: torch.Tensor):
    """Within the block, every dense layer of ``module`` named in ``bank``
    adds each batch row's delta ``(x @ a[row_ids]) @ b[row_ids]``, in fp32
    and cast to the layer's output dtype, to its output (forward hooks,
    removed on exit). row_ids: (b,) bank rows, one a batch row of each
    hooked call (0 = base, an exact zero delta). The fused path's numerics
    differ from the merged path's by the rounding of W against W + Δ in the
    base product."""
    targets = _checked_targets(module, bank)
    row_ids = torch.as_tensor(row_ids, dtype=torch.long)
    gathered = {}  # key -> (a[ids], b[ids]): one gather a key, not one a call
    handles = []

    def hook(name):
        def add_delta(mod, args, out):
            entry = gathered.get(name)
            if entry is None:
                a, b = bank[name]["a"], bank[name]["b"]
                ids = row_ids.to(a.device)
                entry = gathered[name] = (a[ids], b[ids])
            return out + _delta(args[0], *entry, name).to(out.dtype)

        return add_delta

    try:
        for name in bank:
            handles.append(targets[name].register_forward_hook(hook(name)))
        yield
    finally:
        for h in handles:
            h.remove()
