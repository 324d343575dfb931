"""Pure-Python CLIP BPE tokenizer (no transformers dependency at runtime).

The port's own copy of ``tpdm_tpu/utils/tokenizer.py`` (pure Python,
unchanged), so that the port imports nothing of the JAX package. Ids come
from vocab.json as they stand, so a vocabulary may leave gaps (a toy one
that keeps CLIP's special tokens at 49406 and 49407). Implements the byte-pair-encoding scheme CLIP checkpoints ship
(vocab.json + merges.txt, the `tokenizer/` subfolder of SD checkpoints the
reference loads via transformers, reference: modeling_sd3_pnt.py:176-177).
Output matches transformers `CLIPTokenizer` for the padding="max_length"
/ truncation=True path the pipelines use.
"""

from __future__ import annotations

import functools
import html
import json
import os
import re
from typing import List, Optional

import numpy as np


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2/CLIP byte<->unicode table (standard BPE prelude)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
) if False else re.compile(
    # re module lacks \p classes; the standard CLIP pattern with ASCII-ish
    # approximations (transformers uses regex module; \w covers unicode
    # letters/digits in python re with re.UNICODE default)
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE,
)
# (?:[^\s\w]|_)+ ≡ CLIP's [^\s\p{L}\p{N}]+ — underscore is \w in `re` but
# counts as punctuation for CLIP, so it must be folded into the class.


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Minimal CLIP BPE encoder.

    Args:
        vocab_file: vocab.json path (token -> id).
        merges_file: merges.txt path.
    """

    def __init__(self, vocab_file: str, merges_file: str, max_length: int = 77):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().split("\n")
        # first line is a version header; entries are "tok_a tok_b"
        merges = [
            tuple(m.split()) for m in merges if m and not m.startswith("#version")
        ]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos = self.encoder.get("<|startoftext|>")
        self.eos = self.encoder.get("<|endoftext|>")
        self.max_length = max_length
        self._cache: dict = {}

    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "CLIPTokenizer":
        """Load from a directory holding vocab.json + merges.txt (e.g. an SD
        checkpoint's tokenizer/ subfolder)."""
        return cls(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), **kw
        )

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        self._cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        """Token ids WITHOUT special tokens."""
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        for tok in _PAT.findall(text):
            if tok == "<|startoftext|>":
                ids.append(self.bos)
                continue
            if tok == "<|endoftext|>":
                ids.append(self.eos)
                continue
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[sub] for sub in self._bpe(tok))
        return ids

    def __call__(
        self,
        texts,
        max_length: Optional[int] = None,
        padding: str = "max_length",
        truncation: bool = True,
        return_tensors: str = "np",
    ) -> dict:
        """transformers-compatible surface: returns input_ids (+ mask).
        Output is always numpy; return_tensors is accepted for drop-in
        compatibility with transformers call sites."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.max_length
        out, mask = [], []
        for t in texts:
            ids = [self.bos] + self.encode(t) + [self.eos]
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos]
            m = [1] * len(ids)
            if padding == "max_length":
                pad = max_length - len(ids)
                # CLIPTokenizer pads with eos (pad_token == eos for SD)
                ids = ids + [self.eos] * pad
                m = m + [0] * pad
            out.append(ids)
            mask.append(m)
        return {
            "input_ids": np.array(out, np.int32),
            "attention_mask": np.array(mask, np.int32),
        }
