"""Checkpoint save and resume for RLOO training.

Counterpart of ``tpdm_tpu/train/checkpoint.py``'s ``save_checkpoint``,
``latest_checkpoint``, ``restore_checkpoint`` and ``rotate_checkpoints``,
with the same numbered ``checkpoint-N`` directories, in torch's own format:
``trainer_state.pt`` holds the TPM's state dict, the optimizer's state and
the rollout generator's state, ``ema.pt`` the EMA of the TPM when there is
one, and ``trainer_meta.json`` the update, the episode and the numpy RNG's
state. Beside them ``tpm.safetensors`` holds the TPM alone in the
reference's ``agent_model.time_predictor.`` layout (``utils/convert.py:
export_tpm``), as the JAX package writes it, for the inference stacks that
load a TPM; ``load_tpm_safetensors`` reads it back. A TPM of several heads
(the SDXL ensemble's ``nn.ModuleDict`` of "base" and "refiner") writes
one such file a head, ``tpm-base.safetensors`` and
``tpm-refiner.safetensors``, each in that layout. A save is written to
``tmp-checkpoint-N`` and renamed into place, so a kill mid-save leaves no
resumable-looking half checkpoint. The frozen towers are never
checkpointed.

Not ported yet: reading the JAX package's msgpack checkpoints (ROADMAP
queue 1, item 7).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

from tpdm_tpu_torch.utils import safetensors
from tpdm_tpu_torch.utils.convert import convert_tpm, export_tpm

STATE_FILE = "trainer_state.pt"
META_FILE = "trainer_meta.json"
EMA_FILE = "ema.pt"
TPM_FILE = "tpm.safetensors"
TPM_HEAD_FILE = "tpm-{}.safetensors"


def tpm_heads(tpm: dict) -> dict:
    """A TPM state dict by head: ``{"": tpm}`` for one ``TimePredictor``'s,
    ``{name: its state}`` for a ``ModuleDict`` of them (keys
    ``name.conv1.weight``, ...)."""
    if "conv1.weight" in tpm:
        return {"": tpm}
    heads: dict = {}
    for key, value in tpm.items():
        name, _, rest = key.partition(".")
        heads.setdefault(name, {})[rest] = value
    for name, state in heads.items():
        if "conv1.weight" not in state:
            raise ValueError(f"TPM head {name!r} is not a TimePredictor's state dict "
                             f"(keys {sorted(state)[:4]}...)")
    return heads


def save_checkpoint(
    output_dir: str,
    step: int,
    tpm: dict,
    optimizer: dict,
    episode: int = 0,
    np_rng_state: Optional[dict] = None,
    generator_state: Optional[torch.Tensor] = None,
    ema: Optional[dict] = None,
) -> str:
    """Write ``output_dir/checkpoint-{step}`` (replacing one of that step);
    ``tpm`` (a ``TimePredictor``'s or a ``ModuleDict`` of them),
    ``optimizer`` and ``ema`` are state dicts. Returns its path."""
    final = os.path.join(output_dir, f"checkpoint-{step}")
    path = os.path.join(output_dir, f"tmp-checkpoint-{step}")
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save({"tpm": tpm, "optimizer": optimizer, "generator_state": generator_state},
               os.path.join(path, STATE_FILE))
    if ema is not None:
        torch.save(ema, os.path.join(path, EMA_FILE))
    for head, state in tpm_heads(tpm).items():
        name = TPM_HEAD_FILE.format(head) if head else TPM_FILE
        safetensors.save_file(export_tpm(state), os.path.join(path, name))
    meta = {"update": step, "episode": episode}
    if np_rng_state is not None:
        meta["np_rng_state"] = _encode_rng(np_rng_state)
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(path, final)
    return final


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest complete ``checkpoint-N`` directory, or None; directories
    without the state or meta file are skipped."""
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if not m or int(m.group(1)) <= best_step:
            continue
        path = os.path.join(output_dir, name)
        if not (os.path.exists(os.path.join(path, STATE_FILE))
                and os.path.exists(os.path.join(path, META_FILE))):
            continue
        best, best_step = path, int(m.group(1))
    return best


def restore_checkpoint(path: str, map_location="cpu") -> dict:
    """The resume state ``RLOOTrainer.train`` takes: tpm, optimizer,
    update, episode, and where saved np_rng_state, generator_state, ema."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                       weights_only=True)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    out = {
        "tpm": state["tpm"],
        "optimizer": state["optimizer"],
        "generator_state": state.get("generator_state"),
        "update": meta["update"],
        "episode": meta.get("episode", 0),
    }
    if "np_rng_state" in meta:
        out["np_rng_state"] = _decode_rng(meta["np_rng_state"])
    ema_path = os.path.join(path, EMA_FILE)
    if os.path.exists(ema_path):
        out["ema"] = torch.load(ema_path, map_location=map_location, weights_only=True)
    return out


def load_tpm_safetensors(path: str) -> dict:
    """A TPM-only safetensors file (``tpm.safetensors`` or a head's
    ``tpm-<head>.safetensors`` of a checkpoint, or the reference's) as a
    ``TimePredictor`` state dict."""
    return convert_tpm(safetensors.load_file(path))


def rotate_checkpoints(output_dir: str, save_total_limit: Optional[int]) -> list:
    """Delete ``tmp-checkpoint-N`` debris and the oldest ``checkpoint-N``
    directories beyond ``save_total_limit`` (None or < 1 keeps all).
    Returns the deleted paths."""
    pruned = []
    if not os.path.isdir(output_dir):
        return pruned
    found = []
    for name in os.listdir(output_dir):
        p = os.path.join(output_dir, name)
        if re.fullmatch(r"tmp-checkpoint-(\d+)", name):
            shutil.rmtree(p, ignore_errors=True)
            pruned.append(p)
        elif (m := re.fullmatch(r"checkpoint-(\d+)", name)) and os.path.isdir(p):
            found.append((int(m.group(1)), p))
    if not save_total_limit or save_total_limit < 1:
        return pruned
    for _, p in sorted(found)[: max(0, len(found) - save_total_limit)]:
        shutil.rmtree(p, ignore_errors=True)
        pruned.append(p)
    return pruned


def _encode_rng(state: dict) -> dict:
    def enc(v):
        if isinstance(v, np.ndarray):
            return {"__nd__": v.tolist(), "dtype": str(v.dtype)}
        if isinstance(v, dict):
            return {k: enc(x) for k, x in v.items()}
        return v

    return enc(state)


def _decode_rng(state: dict):
    def dec(v):
        if isinstance(v, dict) and "__nd__" in v:
            return np.array(v["__nd__"], dtype=v["dtype"])
        if isinstance(v, dict):
            return {k: dec(x) for k, x in v.items()}
        return v

    return dec(state)
