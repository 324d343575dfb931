"""Native BERT WordPiece tokenizer (uncased), transformers-free.

The port's own copy of ``tpdm_tpu/utils/bert_tokenizer.py`` (pure Python,
unchanged), so that the port imports nothing of the JAX package. The
ImageReward scorer tokenizes prompts with BERT's uncased WordPiece scheme
and encodes with padding="max_length", truncation=True, max_length=35.

Algorithm (the published BERT tokenization, Devlin et al. 2019 §4.1 /
the WordPiece greedy longest-match-first scheme):

1. Basic: clean control chars, isolate CJK ideographs, whitespace-split,
   lowercase + strip combining accents (NFD), split off punctuation.
2. WordPiece: per word, greedily take the longest vocab match, prefixing
   continuation pieces with "##"; words with no match become [UNK].
3. Wrap with [CLS]/[SEP], truncate to max_length, pad with [PAD].
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

_CJK_RANGES = (
    (0x4E00, 0x9FFF),
    (0x3400, 0x4DBF),
    (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F),
    (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF),
    (0x2F800, 0x2FA1F),
)


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric symbols count as punctuation (BERT convention:
    # includes ^, $, ` which Unicode classes as symbols)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """vocab.txt: one token per line, id = line number (HF layout)."""
    vocab: Dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


class BertTokenizer:
    """Uncased BERT tokenizer over a vocab.txt WordPiece vocabulary.

    Mirrors the encode surface the reward path needs:
    ``tok(texts, padding="max_length", truncation=True, max_length=35)``
    returning numpy ``input_ids`` / ``attention_mask``.
    """

    def __init__(
        self,
        vocab: Union[str, Dict[str, int]],
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_input_chars_per_word: int = 100,
    ):
        if isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab = dict(vocab)
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.cls_token = cls_token
        self.sep_token = sep_token
        self.pad_token = pad_token
        self.max_input_chars_per_word = max_input_chars_per_word
        for t in (unk_token, cls_token, sep_token, pad_token):
            if t not in self.vocab:
                raise ValueError(f"special token {t!r} missing from vocab")
        self.unk_id = self.vocab[unk_token]
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]
        self.pad_id = self.vocab[pad_token]

    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "BertTokenizer":
        """Accept a vocab.txt file or an HF-layout directory holding one."""
        if os.path.isdir(path):
            path = os.path.join(path, "vocab.txt")
        return cls(path, **kw)

    # -- basic tokenization ---------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _space_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(token: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", token)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._space_cjk(self._clean(text))
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_punct(tok))
        return [t for t in tokens if t]

    # -- wordpiece -------------------------------------------------------
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        ids = [self.vocab[t] for t in self.tokenize(text)]
        if max_length is not None:
            ids = ids[: max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def __call__(
        self,
        texts: Union[str, Sequence[str]],
        padding: str = "max_length",
        truncation: bool = True,
        max_length: int = 35,
        return_tensors: str = "np",
    ) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        encs = [
            self.encode(t, max_length=max_length if truncation else None)
            for t in texts
        ]
        width = max_length if padding == "max_length" else max(map(len, encs))
        ids = np.full((len(encs), width), self.pad_id, dtype=np.int64)
        mask = np.zeros((len(encs), width), dtype=np.int64)
        for i, e in enumerate(encs):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return {"input_ids": ids, "attention_mask": mask}
