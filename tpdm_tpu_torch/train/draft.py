"""LoRA files: the port's counterpart of ``tpdm_tpu/train/draft.py``'s
``save_lora``, ``load_lora`` and ``save_rotating_lora``.

This module holds only the (de)serialisation of LoRA factors for now: the
reward-gradient trainer that writes them (``DraftTrainer``) comes with
ROADMAP queue 1, item 9(e). The file format is the JAX package's: a flat
safetensors file of ``"<Flax kernel path>|a"`` and ``"|b"`` fp32 2-D
factors (``params/transformer_blocks_0/attn/to_q/kernel|a``), read and
written by the port's own ``utils/safetensors.py``. In memory the factors
are the port's LoRA dict, keyed by module name (``models/lora.py``); the
keys are mapped by ``utils/convert.py:lora_key_from_jax`` /
``lora_key_to_jax``. A file written by either package loads in the other.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Optional

from tpdm_tpu_torch.utils import safetensors
from tpdm_tpu_torch.utils.convert import lora_key_from_jax, lora_key_to_jax

logger = logging.getLogger(__name__)


def save_lora(path: str, lora: dict) -> None:
    """Write the port's LoRA dict as flat ``"<Flax path>|a"`` / ``"|b"``
    fp32 factors."""
    flat = {}
    for name, fac in lora.items():
        key = lora_key_to_jax(name)
        for which in ("a", "b"):
            flat[f"{key}|{which}"] = fac[which].detach().float()
    safetensors.save_file(flat, path)


def load_lora(path: str) -> dict:
    """The inverse of ``save_lora``: the port's LoRA dict of fp32 CPU
    tensors. A file that is not a LoRA file (a TPM or model checkpoint), or
    whose factors are incomplete or mismatched, raises rather than merge
    nothing."""
    lora: dict = {}
    for key, value in safetensors.load_file(path).items():
        flax_path, sep, which = key.rpartition("|")
        if not sep or which not in ("a", "b") or value.dim() != 2:
            raise ValueError(f"{path} is not a LoRA file: key {key!r} is not "
                             "'<kernel-path>|a' / '|b' with a 2-D factor")
        try:
            name = lora_key_from_jax(flax_path)
        except ValueError as e:
            raise ValueError(f"{path} is not a LoRA file: {e}") from None
        lora.setdefault(name, {})[which] = value.float()
    for name, fac in lora.items():
        if set(fac) != {"a", "b"} or fac["a"].shape[1] != fac["b"].shape[0]:
            raise ValueError(f"{path}: incomplete/mismatched factors for {name!r} (have "
                             f"{sorted(fac)}, shapes {[tuple(v.shape) for v in fac.values()]})")
    return lora


def save_rotating_lora(output_dir: str, update: int, lora: dict,
                       save_total_limit: Optional[int]) -> str:
    """Write ``lora-<update>.safetensors`` into ``output_dir`` and remove
    the oldest such files beyond ``save_total_limit``. Returns the path."""
    path = os.path.join(output_dir, f"lora-{update}.safetensors")
    os.makedirs(output_dir, exist_ok=True)
    save_lora(path, lora)
    logger.info("saved %s", path)
    if save_total_limit and save_total_limit >= 1:
        found = []
        for name in os.listdir(output_dir):
            m = re.fullmatch(r"lora-(\d+)\.safetensors", name)
            if m:
                found.append((int(m.group(1)), name))
        found.sort()
        for _, name in found[: max(0, len(found) - save_total_limit)]:
            os.remove(os.path.join(output_dir, name))
            logger.info("save_total_limit=%d: pruned %s", save_total_limit, name)
    return path
