"""Prompt datasets: the port's own copy of ``tpdm_tpu/data/datasets.py``.

- JsonlPromptDataset: glob one or more json/jsonl patterns, shuffle the
  FILE list with the seed, load rows, shuffle the rows with the seed.
- WebDatasetPrompts: .tar shards of {key}.json members (COYO/LAION
  style), with a buffered shuffle of 10_000.
- DummyPromptDataset: a fixed tiny prompt set.

- SyntheticPreferencePairs, PreferencePairDataset: preference pairs for
  Diffusion-DPO (``train/dpo.py``), seeded toy latents or a JSONL manifest
  of .npy latents or image files.

The JAX package's C++ readers (``tpdm_tpu/data/native``) are not ported:
its docstring says they behave as the Python readers here.
"""

from __future__ import annotations

import glob
import json
import os
import tarfile
from typing import Iterator, List, Sequence, Union

import numpy as np


def _expand_patterns(patterns: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(patterns, str):
        patterns = [patterns]
    files: List[str] = []
    for p in patterns:
        files.extend(sorted(glob.glob(p)))
    return files


class JsonlPromptDataset:
    """List-like dataset of {"prompt": str} rows from json/jsonl globs."""

    def __init__(
        self,
        data_files: Union[str, Sequence[str]],
        seed: int = 42,
        prompt_key: str = "prompt",
    ):
        files = _expand_patterns(data_files)
        if not files:
            raise FileNotFoundError(f"no files match {data_files}")
        rng = np.random.default_rng(seed)
        files = [files[i] for i in rng.permutation(len(files))]

        rows: List[dict] = []
        for f in files:
            with open(f) as fh:
                text = fh.read()
            try:  # whole-file JSON array
                data = json.loads(text)
                if isinstance(data, list):
                    rows.extend(data)
                    continue
                if isinstance(data, dict):
                    rows.append(data)
                    continue
            except json.JSONDecodeError:
                pass
            for line in text.splitlines():  # JSONL
                line = line.strip()
                if line:
                    rows.append(json.loads(line))

        order = np.random.default_rng(seed).permutation(len(rows))
        self.rows = [rows[int(i)] for i in order]
        self.prompt_key = prompt_key

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> dict:
        return self.rows[i]


class WebDatasetPrompts:
    """Iterable over .tar shards with a buffered shuffle (webdataset-style)."""

    def __init__(
        self,
        data_files: Union[str, Sequence[str]],
        buffer_size: int = 10_000,
        seed: int = 42,
        caption_keys: Sequence[str] = ("caption",),
    ):
        self.files = _expand_patterns(data_files)
        if not self.files:
            raise FileNotFoundError(f"no files match {data_files}")
        self.buffer_size = buffer_size
        self.seed = seed
        self.caption_keys = tuple(caption_keys)

    def _raw_iter(self) -> Iterator[dict]:
        for path in self.files:
            with tarfile.open(path) as tar:
                for member in tar:
                    if member.name.endswith(".json"):
                        payload = json.loads(tar.extractfile(member).read())
                        yield {"json": payload, "__key__": member.name[:-5]}

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        buf: List[dict] = []
        for row in self._raw_iter():
            if len(buf) < self.buffer_size:
                buf.append(row)
                continue
            idx = int(rng.integers(len(buf)))
            yield buf[idx]
            buf[idx] = row
        rng.shuffle(buf)
        yield from buf


class DummyPromptDataset:
    """Fixed tiny prompt set for smoke tests."""

    PROMPTS = [
        "a photo of a cat",
        "an oil painting of a lighthouse at dusk",
        "a robot reading a newspaper",
        "macro shot of a dew drop on a leaf",
        "a city skyline in watercolor",
        "two dogs playing chess",
        "a bowl of ramen, studio lighting",
        "an astronaut riding a horse",
        "a stained glass window of a fox",
        "minimalist poster of a mountain",
    ]

    def __init__(self, n: int = 10):
        self.rows = [{"prompt": p} for p in self.PROMPTS[:n]]

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


class SyntheticPreferencePairs:
    """Seeded toy preference pairs for ``--trainer dpo``: rows of a prompt
    and model-space latents, preferred ``latents_w`` smooth and small
    (N(0, 0.1²)), rejected ``latents_l`` strong noise (N(0, 1.5²)), a
    consistent, learnable ordering. The same numpy draws as
    ``tpdm_tpu/data/datasets.py:SyntheticPreferencePairs``."""

    def __init__(self, n: int = 8, channels: int = 16, size: int = 8, seed: int = 0):
        rng = np.random.default_rng(seed)
        shape = (channels, size, size)
        self.rows = [
            {
                "prompt": f"synthetic preference prompt {i}",
                "latents_w": rng.normal(size=shape).astype(np.float32) * 0.1,
                "latents_l": rng.normal(size=shape).astype(np.float32) * 1.5,
            }
            for i in range(n)
        ]

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


class PreferencePairDataset:
    """Preference pairs from JSONL manifests, for Diffusion-DPO.

    Each row carries "prompt" and ONE pair form: "latents_w" / "latents_l",
    paths to .npy model-space latents (c, h, w); or "image_w" / "image_l",
    image files loaded as uint8 RGB (rows then carry "images_w" /
    "images_l", and the trainer needs an ``encode_fn``; PIL is imported
    only for them). Relative paths resolve against the manifest's
    directory. The files load at ``__getitem__``; the rows are shuffled
    with ``seed``."""

    def __init__(self, data_files: Union[str, Sequence[str]], seed: int = 0):
        self.rows: List[dict] = []
        for path in _expand_patterns(data_files):
            root = os.path.dirname(os.path.abspath(path))
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    row = json.loads(line)
                    if "prompt" not in row:
                        raise ValueError(f"{path}: row missing 'prompt'")
                    has_lat = "latents_w" in row and "latents_l" in row
                    has_img = "image_w" in row and "image_l" in row
                    if not (has_lat or has_img):
                        raise ValueError(f"{path}: row needs latents_w/latents_l or "
                                         f"image_w/image_l; got {sorted(row)}")
                    row["__root__"] = root
                    self.rows.append(row)
        np.random.default_rng(seed).shuffle(self.rows)

    def __len__(self):
        return len(self.rows)

    def _resolve(self, row, key):
        p = row[key]
        return p if os.path.isabs(p) else os.path.join(row["__root__"], p)

    def __getitem__(self, i):
        row = self.rows[i]
        out = {"prompt": row["prompt"]}
        if "latents_w" in row:
            for k in ("latents_w", "latents_l"):
                arr = np.load(self._resolve(row, k))
                if arr.ndim != 3:
                    raise ValueError(f"{row[k]}: expected (c, h, w) latents, got shape "
                                     f"{arr.shape}")
                out[k] = arr.astype(np.float32)
        else:
            from PIL import Image

            for src, dst in (("image_w", "images_w"), ("image_l", "images_l")):
                with Image.open(self._resolve(row, src)) as im:
                    out[dst] = np.asarray(im.convert("RGB"), np.uint8)
        return out
