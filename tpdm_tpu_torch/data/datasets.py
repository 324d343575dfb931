"""Prompt datasets: the port's own copy of ``tpdm_tpu/data/datasets.py``.

- JsonlPromptDataset: glob one or more json/jsonl patterns, shuffle the
  FILE list with the seed, load rows, shuffle the rows with the seed.
- WebDatasetPrompts: .tar shards of {key}.json members (COYO/LAION
  style), with a buffered shuffle of 10_000.
- DummyPromptDataset: a fixed tiny prompt set.

The JAX package's C++ readers (``tpdm_tpu/data/native``) are not ported:
its docstring says they behave as the Python readers here. The
preference-pair datasets wait for the preference trainer (ROADMAP queue 1,
item 9(e)).
"""

from __future__ import annotations

import glob
import json
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
