"""Carry weights from the JAX package's Flax parameter trees to the port.

The port's submodules carry the Flax module names, so a parameter's path
maps one to one: ``transformer_blocks_3/attn/to_q/kernel`` becomes
``transformer_blocks.3.attn.to_q.weight``. Leaves change layout:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw);
- GroupNorm / RMSNorm / LayerNorm ``scale`` -> ``weight``; ``bias`` stays
  ``bias``; Embed ``embedding`` -> ``weight``; a module's own parameters
  (the ViT's ``cls_token`` and ``pos_embed``, BERT's
  ``position_embeddings``, CLIP's ``position_embedding``, T5's
  ``relative_attention_bias`` and its norms' ``weight``) keep their names
  and layouts;
- a prequantised Dense (``tpdm_tpu/ops/quant.py:prequantize_params``): an
  int8 ``kernel`` -> int8 ``weight`` (out, in); an int4 ``kernel`` ->
  ``weight`` packed two to a byte (uint8 (out, in/2), ``ops/quant.py``);
  ``kernel_scale`` -> fp32 ``weight_scale``.

The trees are taken as nested dicts of numpy arrays (``jax.device_get`` of
the Flax params, with or without the outer ``{"params": ...}``); nothing
here imports JAX. Float leaves become fp32 torch tensors: cast the module
(e.g. ``.to(torch.bfloat16)``) after loading for the card; a quantised
module keeps its scales fp32 through the cast. A float tree for a
``quant_matmuls`` MMDiT loads as it is, and ``ops/quant.py:prequantize_``
then quantises the model once.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from tpdm_tpu_torch.ops.quant import pack_int4

# Flax names that index lists of submodules:
# "up_blocks_0_resnets_1" -> "up_blocks.0.resnets.1"; the ViT's "blocks_3",
# BERT's "layer_3", CLIP's "layers_3" and T5's "block_3" (leftmost match
# first, so "transformer_blocks_3" stays whole)
_INDEXED = re.compile(
    r"(transformer_blocks|up_blocks|resnets|attentions|upsamplers|blocks|block|layers|layer)"
    r"_(\d+)_?")
# parameters that a module declares itself, carried over as they are (CLIP's
# position table among them)
_RAW_LEAVES = ("cls_token", "pos_embed", "position_embeddings", "position_embedding")
# T5's own: its relative-position table and its norms' "weight", accepted
# only by t5_from_jax
_T5_RAW_LEAVES = ("relative_attention_bias", "weight")


def _leaves(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _flax_to_state_dict(tree: Mapping, drop_prefixes=(),
                        raw_leaves=_RAW_LEAVES) -> Dict[str, torch.Tensor]:
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    out = {}
    for path, value in _leaves(tree):
        if any(path.startswith(p) for p in drop_prefixes):
            continue
        *mods, leaf = path.split("/")
        tensor = None
        if leaf == "kernel" and value.ndim == 2:
            leaf = "weight"
            if value.dtype.name == "int4":  # ml_dtypes.int4, from prequantize_params
                q = np.ascontiguousarray(value.astype(np.int8).T)
                tensor = pack_int4(torch.from_numpy(q))
            elif value.dtype == np.int8:
                tensor = torch.from_numpy(np.ascontiguousarray(value.T))
            else:
                value = value.T
        elif leaf == "kernel" and value.ndim == 4:
            leaf, value = "weight", value.transpose(3, 2, 0, 1)
        elif leaf == "kernel_scale":
            leaf = "weight_scale"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        elif leaf != "bias" and leaf not in raw_leaves:
            raise ValueError(f"unexpected Flax parameter {path} {value.shape}")
        mods = [_INDEXED.sub(r"\1.\2.", m).rstrip(".") for m in mods]
        name = ".".join(mods + [leaf])
        if tensor is None:
            tensor = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
        out[name] = tensor
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


def image_reward_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``rewards.image_reward.ImageRewardNet`` from the JAX
    ``ImageRewardNet``'s params (the ViT, BERT-med and MLP trees)."""
    return _flax_to_state_dict(flax_params)


def clip_text_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``models.clip_text.CLIPTextModel`` from the JAX CLIP
    text model's params."""
    return _flax_to_state_dict(flax_params)


def t5_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``models.t5.T5Encoder`` from the JAX T5 encoder's
    params (float only: the port's T5 has no quantised mode yet)."""
    return _flax_to_state_dict(flax_params, raw_leaves=_RAW_LEAVES + _T5_RAW_LEAVES)
