"""Carry weights to the port: from published checkpoints, and from the JAX
package's Flax parameter trees.

Published checkpoints (diffusers / transformers layouts, read from
safetensors files by ``load_safetensors``) go straight to the port's state
dicts through ``convert_mmdit``, ``convert_vae``, ``convert_clip_text``,
``convert_t5``, ``convert_tpm``, the UNets' and ``convert_flux`` (the BFL
layout: each double block's fused ``qkv`` split into three projections),
each with the name and arguments of ``tpdm_tpu/utils/convert.py``'s.
``export_tpm`` writes the TPM back in the reference's layout (JAX's
checkpoint export), ``export_flux`` the BFL layout, and ``export_mmdit``
/ ``export_vae`` the diffusers layout of drawn weights (a local
checkpoint directory for tests and ``chip_smoke.py``). torch keeps the
checkpoints' (out, in) and (out, in, kh, kw) layouts, so each converter is
a table of renames (``to_out.0`` -> ``to_out``, ``net.0.proj`` /
``net.2`` -> ``proj_in`` / ``proj_out``, the towers' prefixes dropped)
that its export inverts; the patchify conv becomes a Linear over (p, p,
c)-ordered patches. ``dtype`` None keeps the stored dtype. Keys a
converter does not use are ignored, as in JAX; a missing one raises
``KeyError``.

From the Flax trees (the ``*_from_jax`` functions), the port's submodules
carry the Flax module names, so a parameter's path maps one to one: ``transformer_blocks_3/attn/to_q/kernel`` becomes
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
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from tpdm_tpu_torch.ops.quant import pack_int4
from tpdm_tpu_torch.utils import safetensors

# Flax names that index lists of submodules:
# "up_blocks_0_resnets_1" -> "up_blocks.0.resnets.1",
# "down_blocks_2_downsamplers_0" -> "down_blocks.2.downsamplers.0"; the ViT's "blocks_3",
# BERT's "layer_3", CLIP's "layers_3" and T5's "block_3" (leftmost match
# first, so "transformer_blocks_3" stays whole)
_INDEXED = re.compile(
    r"(transformer_blocks|up_blocks|down_blocks|resnets|attentions|upsamplers|downsamplers"
    r"|blocks|block|layers|layer)"
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
    """State dict for ``models.vae.VAE`` (decoder and encoder) from the JAX
    VAE's params."""
    return _flax_to_state_dict(flax_params)


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
    params: float, or prequantised for a ``quant_matmuls`` tower (int8 or
    int4 kernels and their scales, no biases)."""
    return _flax_to_state_dict(flax_params, raw_leaves=_RAW_LEAVES + _T5_RAW_LEAVES)


# ---------------------------------------------------------------------------
# LoRA factors (models/lora.py <-> tpdm_tpu/models/lora.py)
# ---------------------------------------------------------------------------


def lora_key_from_jax(path: str) -> str:
    """A JAX LoRA key, the Flax path of a dense kernel
    (``params/transformer_blocks_0/attn/to_q/kernel``), -> the port's module
    name (``transformer_blocks.0.attn.to_q``), by ``_flax_to_state_dict``'s
    rule; the leading ``params/`` is optional."""
    parts = path.split("/")
    if parts and parts[0] == "params":
        parts = parts[1:]
    if len(parts) < 2 or parts[-1] != "kernel":
        raise ValueError(f"LoRA key {path!r} is not the Flax path of a dense kernel "
                         "('params/<module path>/kernel')")
    return ".".join(_INDEXED.sub(r"\1.\2.", m).rstrip(".") for m in parts[:-1])


def lora_key_to_jax(name: str) -> str:
    """The inverse of ``lora_key_from_jax``: an index segment joins the
    module name before it (``transformer_blocks.0`` -> ``transformer_blocks_0``).
    A name that does not map back to itself raises."""
    mods = []
    for seg in name.split("."):
        if seg.isdigit() and mods:
            mods[-1] += f"_{seg}"
        else:
            mods.append(seg)
    path = "params/" + "/".join(mods) + "/kernel"
    if lora_key_from_jax(path) != name:
        raise ValueError(f"module name {name!r} has no Flax path that maps back to it")
    return path


def lora_from_jax(lora: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA tree ({Flax kernel path: {"a", "b"}}) -> the port's LoRA
    dict ({module name: {"a", "b"}}, fp32 CPU tensors in the same (d_in, r)
    / (r, d_out) orientation)."""
    out = {}
    for path, fac in lora.items():
        name = lora_key_from_jax(path)
        if name in out:
            raise ValueError(f"LoRA keys collide on {name!r}")
        out[name] = {k: torch.from_numpy(np.array(fac[k], dtype=np.float32, order="C"))
                     for k in ("a", "b")}
    return out


def lora_to_jax(lora: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's LoRA dict -> a JAX LoRA tree of fp32 numpy factors."""
    return {lora_key_to_jax(name): {k: fac[k].detach().float().cpu().numpy() for k in ("a", "b")}
            for name, fac in lora.items()}


# ---------------------------------------------------------------------------
# published checkpoints (diffusers / transformers layouts)
# ---------------------------------------------------------------------------


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, as CPU torch tensors of the
    stored dtype (``utils/safetensors.py``; no ``safetensors`` package)."""
    return safetensors.load_file(path)


def _tensor(t, dtype=None) -> torch.Tensor:
    """A checkpoint's array as a contiguous torch tensor, cast to ``dtype``
    (None keeps the stored one)."""
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    return (t if dtype is None else t.to(dtype)).contiguous()


def _pairs(src: str, dst: Optional[str] = None, leaves=("weight", "bias")):
    """[(checkpoint key, port key)] for each leaf of one module."""
    dst = src if dst is None else dst
    return [(f"{src}.{leaf}", f"{dst}.{leaf}") for leaf in leaves]


def _renamed(state_dict: Mapping, keys, dtype=None, prefix: str = "") -> Dict[str, torch.Tensor]:
    return {dst: _tensor(state_dict[prefix + src], dtype) for src, dst in keys}


def _mmdit_keys(num_layers: int, dual_attention_layers=(), qk_norm: Optional[str] = None):
    keys = _pairs("pos_embed.proj")  # the conv's weight is reshaped apart
    for name in ("time_text_embed.timestep_embedder.linear_1",
                 "time_text_embed.timestep_embedder.linear_2",
                 "time_text_embed.text_embedder.linear_1",
                 "time_text_embed.text_embedder.linear_2",
                 "context_embedder", "norm_out.linear", "proj_out"):
        keys += _pairs(name)

    def attn(base: str, joint: bool, pre_only: bool):
        out = [p for n in ("to_q", "to_k", "to_v") for p in _pairs(f"{base}.{n}")]
        out += _pairs(f"{base}.to_out.0", f"{base}.to_out")
        norms = ("norm_q", "norm_k")
        if joint:
            out += [p for n in ("add_q_proj", "add_k_proj", "add_v_proj")
                    for p in _pairs(f"{base}.{n}")]
            if not pre_only:
                out += _pairs(f"{base}.to_add_out")
            norms += ("norm_added_q", "norm_added_k")
        if qk_norm == "rms_norm":
            out += [p for n in norms for p in _pairs(f"{base}.{n}", leaves=("weight",))]
        return out

    def ff(base: str):
        return _pairs(f"{base}.net.0.proj", f"{base}.proj_in") + _pairs(
            f"{base}.net.2", f"{base}.proj_out")

    for i in range(num_layers):
        base = f"transformer_blocks.{i}"
        pre_only = i == num_layers - 1
        keys += _pairs(f"{base}.norm1.linear") + _pairs(f"{base}.norm1_context.linear")
        keys += attn(f"{base}.attn", joint=True, pre_only=pre_only) + ff(f"{base}.ff")
        if not pre_only:
            keys += ff(f"{base}.ff_context")
        if i in dual_attention_layers:
            keys += attn(f"{base}.attn2", joint=False, pre_only=False)
    return keys


def convert_mmdit(
    state_dict: Mapping,
    num_layers: int,
    dual_attention_layers=(),
    qk_norm: Optional[str] = None,
    dtype=None,
) -> Dict[str, torch.Tensor]:
    """diffusers ``SD3Transformer2DModel`` state dict (SD3 or SD3.5) ->
    state dict of ``models.mmdit.MMDiT`` with that many layers."""
    out = _renamed(state_dict, _mmdit_keys(num_layers, dual_attention_layers, qk_norm), dtype)
    w = out["pos_embed.proj.weight"]  # (embed, c, p, p), the stride-p conv
    out["pos_embed.proj.weight"] = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()
    return out


def export_mmdit(state_dict: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_mmdit``: an ``MMDiT(cfg)`` state dict (float)
    -> the diffusers layout, contiguous CPU tensors (to write a local
    checkpoint directory)."""
    keys = _mmdit_keys(cfg.num_layers, cfg.dual_attention_layers, cfg.qk_norm)
    out = {src: _tensor(state_dict[dst].detach().cpu()) for src, dst in keys}
    p, c = cfg.patch_size, cfg.in_channels
    w = out["pos_embed.proj.weight"]
    out["pos_embed.proj.weight"] = w.reshape(-1, p, p, c).permute(0, 3, 1, 2).contiguous()
    return out


_TPM_KEYS = [p for n in ("conv1", "conv2", "norm1.linear", "norm1.norm", "fc1", "fc2")
             for p in _pairs(n)]


def convert_tpm(state_dict: Mapping, dtype=None) -> Dict[str, torch.Tensor]:
    """A TPM-only checkpoint -> state dict of ``models.tpm.TimePredictor``.
    Accepts ``agent_model.time_predictor.``-, ``time_predictor.``-prefixed or
    unprefixed keys, as JAX's does."""
    for prefix in ("agent_model.time_predictor.", "time_predictor.", ""):
        if any(k.startswith(prefix + "conv1.") for k in state_dict):
            break
    return _renamed(state_dict, _TPM_KEYS, dtype, prefix)


def export_tpm(tpm_state: Mapping, prefix: str = "agent_model.time_predictor.") -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_tpm``: a ``TimePredictor`` state dict -> the
    reference's layout under ``prefix``, contiguous CPU tensors (a raw
    buffer of a transposed view would be written wrong)."""
    return {prefix + src: _tensor(tpm_state[dst].detach().cpu()) for src, dst in _TPM_KEYS}


def _vae_keys(block_out_channels, layers_per_block: int, encoder: bool = True):
    def resnet(base: str, has_shortcut: bool):
        names = ("norm1", "conv1", "norm2", "conv2") + (("conv_shortcut",) if has_shortcut else ())
        return [p for n in names for p in _pairs(f"{base}.{n}")]

    def mid(base: str):
        keys = resnet(f"{base}.resnets.0", False)
        keys += [p for n in ("group_norm", "to_q", "to_k", "to_v")
                 for p in _pairs(f"{base}.attentions.0.{n}")]
        keys += _pairs(f"{base}.attentions.0.to_out.0", f"{base}.attentions.0.to_out")
        return keys + resnet(f"{base}.resnets.1", False)

    keys = _pairs("decoder.conv_in") + mid("decoder.mid_block")
    ch_up = list(reversed(block_out_channels))
    prev = ch_up[0]
    for i, out_ch in enumerate(ch_up):
        for j in range(layers_per_block + 1):
            in_ch = prev if j == 0 else out_ch
            keys += resnet(f"decoder.up_blocks.{i}.resnets.{j}", in_ch != out_ch)
        if i < len(ch_up) - 1:
            keys += _pairs(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                           f"decoder.up_blocks.{i}.upsamplers.0")
        prev = out_ch
    keys += _pairs("decoder.conv_norm_out") + _pairs("decoder.conv_out")
    if not encoder:
        return keys
    keys += _pairs("encoder.conv_in")
    prev = block_out_channels[0]
    for i, out_ch in enumerate(block_out_channels):
        for j in range(layers_per_block):
            in_ch = prev if j == 0 else out_ch
            keys += resnet(f"encoder.down_blocks.{i}.resnets.{j}", in_ch != out_ch)
        if i < len(block_out_channels) - 1:
            keys += _pairs(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                           f"encoder.down_blocks.{i}.downsamplers.0")
        prev = out_ch
    return keys + mid("encoder.mid_block") + _pairs("encoder.conv_norm_out") + _pairs(
        "encoder.conv_out")


def convert_vae(
    state_dict: Mapping,
    block_out_channels=(128, 256, 512, 512),
    layers_per_block: int = 2,
    dtype=None,
) -> Dict[str, torch.Tensor]:
    """diffusers ``AutoencoderKL`` state dict -> state dict of
    ``models.vae.VAE``: the decoder, and the encoder where the checkpoint
    holds one (``encoder.conv_in.weight``); a decoder-only checkpoint gives
    the state dict of ``VAE(cfg, encoder=False)``."""
    encoder = "encoder.conv_in.weight" in state_dict
    return _renamed(state_dict, _vae_keys(block_out_channels, layers_per_block, encoder), dtype)


def export_vae(state_dict: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_vae``: a ``VAE(cfg)`` state dict (with or
    without its encoder) -> the diffusers layout, contiguous CPU tensors."""
    encoder = "encoder.conv_in.weight" in state_dict
    keys = _vae_keys(cfg.block_out_channels, cfg.layers_per_block, encoder)
    return {src: _tensor(state_dict[dst].detach().cpu()) for src, dst in keys}


def _clip_text_keys(num_layers: int):
    keys = [("text_model.embeddings.token_embedding.weight", "token_embedding.weight"),
            ("text_model.embeddings.position_embedding.weight", "position_embedding"),
            ("text_projection.weight", "text_projection.weight")]
    keys += _pairs("text_model.final_layer_norm", "final_layer_norm")
    for i in range(num_layers):
        src, dst = f"text_model.encoder.layers.{i}", f"layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            keys += _pairs(f"{src}.self_attn.{name}", f"{dst}.self_attn.{name}")
        for name in ("layer_norm1", "layer_norm2"):
            keys += _pairs(f"{src}.{name}", f"{dst}.{name}")
        for name in ("fc1", "fc2"):
            keys += _pairs(f"{src}.mlp.{name}", f"{dst}.{name}")
    return keys


def convert_clip_text(state_dict: Mapping, num_layers: int, dtype=None) -> Dict[str, torch.Tensor]:
    """transformers ``CLIPTextModelWithProjection`` state dict (SD3's CLIP-L
    and CLIP-G, each with its ``text_projection``) -> state dict of
    ``models.clip_text.CLIPTextModel``."""
    return _renamed(state_dict, _clip_text_keys(num_layers), dtype)


def _t5_keys(num_layers: int):
    keys = [("shared.weight", "shared.weight"),
            ("encoder.final_layer_norm.weight", "final_layer_norm.weight")]
    for i in range(num_layers):
        src, dst = f"encoder.block.{i}.layer", f"block.{i}"
        keys += [(f"{src}.0.SelfAttention.{n}.weight", f"{dst}.attention.{n}.weight")
                 for n in ("q", "k", "v", "o")]
        if i == 0:
            keys.append((f"{src}.0.SelfAttention.relative_attention_bias.weight",
                         f"{dst}.attention.relative_attention_bias"))
        keys += [(f"{src}.0.layer_norm.weight", f"{dst}.ln_attn.weight"),
                 (f"{src}.1.layer_norm.weight", f"{dst}.ln_mlp.weight")]
        keys += [(f"{src}.1.DenseReluDense.{n}.weight", f"{dst}.{n}.weight")
                 for n in ("wi_0", "wi_1", "wo")]
    return keys


def convert_t5(state_dict: Mapping, num_layers: int, dtype=None) -> Dict[str, torch.Tensor]:
    """transformers ``T5EncoderModel`` state dict -> state dict of
    ``models.t5.T5Encoder``."""
    return _renamed(state_dict, _t5_keys(num_layers), dtype)


# ---------------------------------------------------------------------------
# SD1.5 UNet (diffusers UNet2DConditionModel <-> models.unet_sd15.UNetSD15)
# ---------------------------------------------------------------------------


def unet_sd15_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``models.unet_sd15.UNetSD15`` from the JAX UNet's
    params (any of its configs: SD1.x, SDXL, the refiner)."""
    return _flax_to_state_dict(flax_params)


_UNET_ATTN_RENAMES = (
    (re.compile(r"^block\.(?:(\d+)\.)?(attn[12])_to_out\."),
     lambda m: f"transformer_blocks.{m[1] or 0}.{m[2]}.to_out.0."),
    (re.compile(r"^block\.(?:(\d+)\.)?(attn[12])_(to_[qkv])\."),
     lambda m: f"transformer_blocks.{m[1] or 0}.{m[2]}.{m[3]}."),
    (re.compile(r"^block\.(?:(\d+)\.)?ff_proj\."),
     lambda m: f"transformer_blocks.{m[1] or 0}.ff.net.0.proj."),
    (re.compile(r"^block\.(?:(\d+)\.)?ff_out\."),
     lambda m: f"transformer_blocks.{m[1] or 0}.ff.net.2."),
    (re.compile(r"^block\.(?:(\d+)\.)?"), lambda m: f"transformer_blocks.{m[1] or 0}."),
)
_UNET_RENAMES = (
    (re.compile(r"^time_linear_(\d)\."), r"time_embedding.linear_\1."),
    (re.compile(r"^add_linear_(\d)\."), r"add_embedding.linear_\1."),
    (re.compile(r"^(down|up)_(\d+)_resnet_(\d+)\."), r"\1_blocks.\2.resnets.\3."),
    (re.compile(r"^mid_resnet_(\d+)\."), r"mid_block.resnets.\1."),
    (re.compile(r"^(down|up)_(\d+)_attn_(\d+)\."), r"\1_blocks.\2.attentions.\3."),
    (re.compile(r"^mid_attn\."), "mid_block.attentions.0."),
    (re.compile(r"^down_(\d+)_downsample\."), r"down_blocks.\1.downsamplers.0.conv."),
    (re.compile(r"^up_(\d+)_upsample\."), r"up_blocks.\1.upsamplers.0.conv."),
)


def _unet_keys(cfg):
    """[(diffusers key, port key)] of a ``UNetSD15(cfg)``: the port's keys
    from the module built on the meta device, each renamed to diffusers'
    layout (a transformer's block ``k`` to ``transformer_blocks.k``)."""
    from tpdm_tpu_torch.models.unet_sd15 import UNetSD15

    with torch.device("meta"):
        port_keys = list(UNetSD15(cfg).state_dict())
    keys = []
    for dst in port_keys:
        src = dst
        for pattern, repl in _UNET_RENAMES:
            m = pattern.match(src)
            if m:
                head, rest = pattern.sub(repl, src[:m.end()]), src[m.end():]
                if "attentions" in head:
                    for p_attn, r_attn in _UNET_ATTN_RENAMES:
                        if p_attn.match(rest):
                            rest = p_attn.sub(r_attn, rest, count=1)
                            break
                src = head + rest
                break
        keys.append((src, dst))
    return keys


def _unet_sd15_keys(block_out_channels, layers_per_block: int):
    """The keys of an SD1.5-topology UNet (one transformer block a level)."""
    from tpdm_tpu_torch.models.unet_sd15 import UNetConfig

    return _unet_keys(UNetConfig(block_out_channels=tuple(block_out_channels),
                                 layers_per_block=layers_per_block))


def convert_unet_sd15(
    state_dict: Mapping,
    block_out_channels=(320, 640, 1280, 1280),
    layers_per_block: int = 2,
    dtype=None,
) -> Dict[str, torch.Tensor]:
    """diffusers SD1.5 ``UNet2DConditionModel`` state dict (3
    CrossAttnDownBlock2D + DownBlock2D, UNetMidBlock2DCrossAttn, UpBlock2D +
    3 CrossAttnUpBlock2D) -> state dict of ``models.unet_sd15.UNetSD15``."""
    return _renamed(state_dict, _unet_sd15_keys(block_out_channels, layers_per_block), dtype)


def export_unet_sd15(state_dict: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_unet_sd15``: a ``UNetSD15(cfg)`` state dict ->
    the diffusers layout, contiguous CPU tensors."""
    keys = _unet_sd15_keys(cfg.block_out_channels, cfg.layers_per_block)
    return {src: _tensor(state_dict[dst].detach().cpu()) for src, dst in keys}


# ---------------------------------------------------------------------------
# SDXL UNet (diffusers UNet2DConditionModel, use_linear_projection)
# ---------------------------------------------------------------------------

_PROJ = re.compile(r"\.proj_(in|out)\.weight$")


def _unet_sdxl_keys(block_out_channels, layers_per_block, transformer_layers_per_block,
                    mid_transformer_layers):
    from tpdm_tpu_torch.models.unet_sd15 import UNetConfig

    return _unet_keys(UNetConfig(
        block_out_channels=tuple(block_out_channels), layers_per_block=layers_per_block,
        transformer_layers_per_block=tuple(transformer_layers_per_block),
        mid_transformer_layers=mid_transformer_layers, addition_embed=True))


def convert_unet_sdxl(
    state_dict: Mapping,
    block_out_channels=(320, 640, 1280),
    layers_per_block: int = 2,
    transformer_layers_per_block=(0, 2, 10),
    mid_transformer_layers: int = 10,
    dtype=None,
) -> Dict[str, torch.Tensor]:
    """diffusers SDXL ``UNet2DConditionModel`` state dict (DownBlock2D and
    CrossAttnDownBlock2D with transformer depths a level, the text_time
    ``add_embedding``) -> state dict of ``models.unet_sd15.UNetSD15``
    (``UNetConfig.sdxl()``; the refiner with its own geometry). The
    transformers' ``proj_in`` / ``proj_out`` may be Linear weights (out,
    in), SDXL's ``use_linear_projection``, or 1 x 1 convs: both become the
    port's 1 x 1 conv, the same map."""
    keys = _unet_sdxl_keys(block_out_channels, layers_per_block, transformer_layers_per_block,
                           mid_transformer_layers)
    out = _renamed(state_dict, keys, dtype)
    for k, w in out.items():
        if _PROJ.search(k) and w.dim() == 2:
            out[k] = w[:, :, None, None].contiguous()
    return out


def export_unet_sdxl(state_dict: Mapping, cfg, linear_projection: bool = True
                     ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_unet_sdxl``: a ``UNetSD15(cfg)`` state dict (an
    SDXL or refiner config) -> the diffusers layout, contiguous CPU tensors;
    ``linear_projection`` writes ``proj_in`` / ``proj_out`` as Linear
    weights (diffusers' SDXL convention), else as 1 x 1 convs."""
    keys = _unet_sdxl_keys(cfg.block_out_channels, cfg.layers_per_block, cfg.depths,
                           cfg.mid_transformer_layers)
    out = {}
    for src, dst in keys:
        w = state_dict[dst].detach().cpu()
        if linear_projection and _PROJ.search(src):
            w = w[:, :, 0, 0]
        out[src] = _tensor(w)
    return out


# ---------------------------------------------------------------------------
# FLUX transformer (BFL checkpoint layout <-> models.flux.Flux)
# ---------------------------------------------------------------------------


def flux_from_jax(flax_params: Mapping, cfg=None) -> Dict[str, torch.Tensor]:
    """State dict for ``models.flux.Flux`` from the JAX Flux's params (float
    or prequantised); with ``cfg``, the block counts are checked."""
    sd = _flax_to_state_dict(flax_params)
    if cfg is not None:
        for kind, depth in (("double", cfg.depth_double), ("single", cfg.depth_single)):
            n = len({k.split(".")[1] for k in sd if k.startswith(f"{kind}_blocks.")})
            if n != depth:
                raise ValueError(f"params hold {n} {kind} blocks, config has {depth}")
    return sd


def _flux_keys(state_keys, guidance: bool):
    """[(BFL key, port key)] of every tensor of a Flux state dict but the
    double blocks' q/k/v, which the BFL layout fuses; the blocks are those
    that ``state_keys`` (port keys) hold. Raises on a module that has no
    BFL name."""
    keys = _pairs("img_in") + _pairs("txt_in") + _pairs("final_layer.linear", "final_proj")
    keys += _pairs("final_layer.adaLN_modulation.1", "final_mod.lin")
    for embed in ("time_in", "vector_in") + (("guidance_in",) if guidance else ()):
        keys += _pairs(f"{embed}.in_layer") + _pairs(f"{embed}.out_layer")
    norms = lambda src, dst: [(f"{src}.query_norm.scale", f"{dst}_q.weight"),
                              (f"{src}.key_norm.scale", f"{dst}_k.weight")]
    blocks = sorted({tuple(k.split(".")[:2]) for k in state_keys
                     if k.startswith(("double_blocks.", "single_blocks."))})
    for kind, i in blocks:
        base = f"{kind}.{i}"
        if kind == "double_blocks":
            for side in ("img", "txt"):
                keys += _pairs(f"{base}.{side}_mod.lin")
                keys += _pairs(f"{base}.{side}_attn.proj", f"{base}.{side}_attn_proj")
                keys += _pairs(f"{base}.{side}_mlp.0", f"{base}.{side}_mlp_0")
                keys += _pairs(f"{base}.{side}_mlp.2", f"{base}.{side}_mlp_2")
                keys += norms(f"{base}.{side}_attn.norm", f"{base}.{side}_attn_norm")
        else:
            keys += _pairs(f"{base}.modulation.lin") + _pairs(f"{base}.linear1")
            keys += _pairs(f"{base}.linear2") + norms(f"{base}.norm", f"{base}.norm")
    known = {"img_in", "txt_in", "time_in", "vector_in", "guidance_in", "final_mod",
             "final_proj", "double_blocks", "single_blocks"}
    for k in state_keys:
        if k.split(".")[0] not in known:
            raise ValueError(f"unmapped Flux module: {k.split('.')[0]}")
    return keys


def convert_flux(
    state_dict: Mapping,
    depth_double: int = 19,
    depth_single: int = 38,
    dtype=None,
) -> Dict[str, torch.Tensor]:
    """BFL flux.1 transformer state dict (img_in / txt_in / time_in /
    vector_in [/ guidance_in], double_blocks.N with fused ``qkv`` and the
    query / key RMSNorm scales, single_blocks.N with the fused ``linear1`` =
    [qkv | mlp], final_layer) -> state dict of ``models.flux.Flux``. The
    fused q/k/v rows split into the port's three projections; everything
    else is a rename. ``guidance_in`` comes along where the checkpoint has
    it (dev, not schnell). A missing key raises ``KeyError``."""
    port_keys = [f"double_blocks.{i}." for i in range(depth_double)]
    port_keys += [f"single_blocks.{i}." for i in range(depth_single)]
    guidance = "guidance_in.in_layer.weight" in state_dict
    out = _renamed(state_dict, _flux_keys(port_keys, guidance), dtype)
    for i in range(depth_double):
        for side in ("img", "txt"):
            src, dst = f"double_blocks.{i}.{side}_attn.qkv", f"double_blocks.{i}.{side}_attn_to_"
            for leaf in ("weight", "bias"):
                for name, part in zip("qkv", _tensor(state_dict[f"{src}.{leaf}"], dtype).chunk(3)):
                    out[f"{dst}{name}.{leaf}"] = part.contiguous()
    return out


def export_flux(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_flux``: a ``Flux`` state dict (float) -> the BFL
    layout, contiguous CPU tensors. A module the BFL layout does not name
    raises ``ValueError``."""
    keys = _flux_keys(list(state_dict), "guidance_in.in_layer.weight" in state_dict)
    out = {src: _tensor(state_dict[dst].detach().cpu()) for src, dst in keys}
    doubles = sorted({k.split(".")[1] for k in state_dict if k.startswith("double_blocks.")},
                     key=int)
    for i in doubles:
        for side in ("img", "txt"):
            base = f"double_blocks.{i}.{side}_attn"
            for leaf in ("weight", "bias"):
                out[f"{base}.qkv.{leaf}"] = torch.cat([
                    state_dict[f"{base}_to_{n}.{leaf}"].detach().cpu() for n in "qkv"]).contiguous()
    return out
