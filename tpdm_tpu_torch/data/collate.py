"""Batch collators: the port's own copy of ``tpdm_tpu/data/collate.py``."""

from __future__ import annotations

from typing import Sequence


def json_prompt_collate(rows: Sequence[dict]) -> dict:
    """rows -> {"prompt": [...]}, stripping the leading "The image shows "."""
    prompts = []
    for r in rows:
        p = r["prompt"]
        if p.startswith("The image shows "):
            p = p[len("The image shows "):]
        prompts.append(p)
    return {"prompt": prompts}


def webdataset_prompt_collate(
    rows: Sequence[dict], caption_keys: Sequence[str] = ("caption",)
) -> dict:
    """The first of ``caption_keys`` found in each sample's "json" payload."""
    prompts = []
    for r in rows:
        payload = r["json"]
        for key in caption_keys:
            if key in payload:
                prompts.append(payload[key])
                break
        else:
            raise KeyError(f"none of {caption_keys} in sample")
    return {"prompt": prompts}
