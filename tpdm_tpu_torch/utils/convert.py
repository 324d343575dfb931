"""Carry weights from the JAX package's Flax parameter trees to the port.

The port's submodules carry the Flax module names, so a parameter's path
maps one to one: ``transformer_blocks_3/attn/to_q/kernel`` becomes
``transformer_blocks.3.attn.to_q.weight``. Leaves change layout:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw);
- GroupNorm / RMSNorm ``scale`` -> ``weight``; ``bias`` stays ``bias``.

The trees are taken as nested dicts of numpy arrays (``jax.device_get`` of
the Flax params, with or without the outer ``{"params": ...}``); nothing
here imports JAX. The state dicts are fp32 torch tensors: cast the module
(e.g. ``.to(torch.bfloat16)``) after loading for the card.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# Flax names that index lists of submodules:
# "up_blocks_0_resnets_1" -> "up_blocks.0.resnets.1"
_INDEXED = re.compile(r"(transformer_blocks|up_blocks|resnets|attentions|upsamplers)_(\d+)_?")


def _leaves(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _flax_to_state_dict(tree: Mapping, drop_prefixes=()) -> Dict[str, torch.Tensor]:
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    out = {}
    for path, value in _leaves(tree):
        if any(path.startswith(p) for p in drop_prefixes):
            continue
        *mods, leaf = path.split("/")
        if leaf == "kernel" and value.ndim == 2:
            leaf, value = "weight", value.T
        elif leaf == "kernel" and value.ndim == 4:
            leaf, value = "weight", value.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"unexpected Flax parameter {path} {value.shape}")
        mods = [_INDEXED.sub(r"\1.\2.", m).rstrip(".") for m in mods]
        name = ".".join(mods + [leaf])
        out[name] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return out


def mmdit_from_jax(flax_params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """State dict for ``models.mmdit.MMDiT(cfg)`` from the JAX MMDiT's params."""
    sd = _flax_to_state_dict(flax_params)
    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("transformer_blocks.")})
    if n_blocks != cfg.num_layers:
        raise ValueError(f"params hold {n_blocks} blocks, config has {cfg.num_layers}")
    return sd


def tpm_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``models.tpm.TimePredictor`` from the JAX TPM's params."""
    return _flax_to_state_dict(flax_params)


def vae_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``models.vae.VAE`` (decoder only) from the JAX VAE's
    params; the encoder's parameters are dropped, it is not ported yet."""
    return _flax_to_state_dict(flax_params, drop_prefixes=("encoder/",))
