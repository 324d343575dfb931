"""Pure-Python SentencePiece-unigram tokenizer (T5 flavor, no runtime deps).

The port's own copy of ``tpdm_tpu/utils/t5_tokenizer.py`` (pure Python,
unchanged), so that the port imports nothing of the JAX package.

The reference tokenizes T5 prompts through transformers' T5TokenizerFast
(reference: src/models/stable_diffusion_3/modeling_sd3_pnt.py:176-183 loads
`tokenizer_3` from the SD3 checkpoint). This rebuilds the unigram scheme
from scratch so serving needs no transformers/sentencepiece at runtime:

- a minimal protobuf wire-format reader for `spiece.model` (sentencepiece
  ModelProto: field 1 = repeated SentencePiece{piece=1, score=2, type=3}),
- the HF `tokenizer.json` layout as an alternative vocab source,
- unigram Viterbi segmentation with sentencepiece's unknown-token
  semantics (unk penalty = min_score - 10, single-char unk nodes only
  where no single-char piece exists, consecutive unks fused),
- Metaspace pre-tokenization (words prefixed with U+2581, dummy prefix on
  the first word) over NFKC-normalized, whitespace-collapsed text.

Byte-level parity is tested against the `tokenizers` library's Unigram
model (tests/test_t5_tokenizer.py); the one known gap is sentencepiece's
precompiled nmt_nfkc charsmap (exotic control characters), which plain
NFKC approximates.
"""

from __future__ import annotations

import json
import os
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SPACE = "▁"  # ▁
_UNK_PENALTY = 10.0  # sentencepiece kUnkPenalty (normalization of no-path rows)

# SentencePiece piece types (sentencepiece_model.proto)
_TYPE_NORMAL = 1
_TYPE_UNKNOWN = 2
_TYPE_CONTROL = 3
_TYPE_USER_DEFINED = 4
_TYPE_UNUSED = 5
_TYPE_BYTE = 6


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _skip_field(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(data, pos)
        return pos
    if wire_type == 1:  # 64-bit
        return pos + 8
    if wire_type == 2:  # length-delimited
        n, pos = _read_varint(data, pos)
        return pos + n
    if wire_type == 5:  # 32-bit
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def _parse_sentencepiece(data: bytes) -> Tuple[str, float, int]:
    """One SentencePiece message: piece (1, string), score (2, float),
    type (3, enum; absent means NORMAL)."""
    pos = 0
    piece, score, ptype = "", 0.0, _TYPE_NORMAL
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(data, pos)
            piece = data[pos:pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:
            (score,) = struct.unpack("<f", data[pos:pos + 4])
            pos += 4
        elif field == 3 and wire == 0:
            ptype, pos = _read_varint(data, pos)
        else:
            pos = _skip_field(data, pos, wire)
    return piece, score, ptype


def parse_spm_model(data: bytes) -> List[Tuple[str, float, int]]:
    """Parse a sentencepiece ModelProto, returning [(piece, score, type)].

    Only field 1 (the pieces) is consumed; trainer/normalizer specs are
    skipped structurally (their contents are baked into this module's
    fixed T5-style normalization).
    """
    pieces = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(data, pos)
            pieces.append(_parse_sentencepiece(data[pos:pos + n]))
            pos += n
        else:
            pos = _skip_field(data, pos, wire)
    return pieces


def serialize_spm_model(pieces: Sequence[Tuple[str, float, int]]) -> bytes:
    """Inverse of parse_spm_model (testing + exporting converted vocabs)."""
    out = bytearray()

    def varint(v: int) -> bytes:
        b = bytearray()
        while True:
            if v < 0x80:
                b.append(v)
                return bytes(b)
            b.append((v & 0x7F) | 0x80)
            v >>= 7

    for piece, score, ptype in pieces:
        msg = bytearray()
        pb = piece.encode("utf-8")
        msg += b"\x0a" + varint(len(pb)) + pb        # field 1, wire 2
        msg += b"\x15" + struct.pack("<f", score)     # field 2, wire 5
        if ptype != _TYPE_NORMAL:
            msg += b"\x18" + varint(ptype)            # field 3, wire 0
        out += b"\x0a" + varint(len(msg)) + msg       # ModelProto.pieces
    return bytes(out)


class UnigramModel:
    """Viterbi segmentation over a unigram piece vocabulary."""

    def __init__(
        self,
        pieces: Sequence[Tuple[str, float]],
        unk_id: int,
        fuse_unk: bool = True,
        unscorable_ids: Optional[set] = None,
    ):
        self.pieces = list(pieces)
        self.unk_id = unk_id
        self.fuse_unk = fuse_unk
        unscorable = unscorable_ids or set()
        self.vocab: Dict[str, Tuple[int, float]] = {}
        scores = []
        for i, (piece, score) in enumerate(self.pieces):
            if i in unscorable or i == unk_id:
                continue
            self.vocab[piece] = (i, score)
            scores.append(score)
        self.min_score = min(scores) if scores else 0.0
        self.unk_score = self.min_score - _UNK_PENALTY
        self.max_piece_len = max((len(p) for p in self.vocab), default=1)

    def tokenize(self, word: str) -> List[int]:
        """Best segmentation of one pre-token (already ▁-prefixed)."""
        n = len(word)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        for end in range(1, n + 1):
            lo = max(0, end - self.max_piece_len)
            covered = False
            for start in range(lo, end):
                if best[start] == NEG:
                    continue
                sub = word[start:end]
                hit = self.vocab.get(sub)
                if hit is None:
                    continue
                if end - start == 1:
                    covered = True
                cand = best[start] + hit[1]
                if cand > best[end]:
                    best[end] = cand
                    back[end] = (start, hit[0])
            # sentencepiece adds an unk node per character only where no
            # single-character piece covers the position
            if not covered and best[end - 1] != NEG:
                cand = best[end - 1] + self.unk_score
                if cand > best[end]:
                    best[end] = cand
                    back[end] = (end - 1, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            assert back[pos] is not None, "viterbi lattice has a hole"
            start, tid = back[pos]
            ids.append(tid)
            pos = start
        ids.reverse()
        if self.fuse_unk:
            fused: List[int] = []
            for tid in ids:
                if tid == self.unk_id and fused and fused[-1] == self.unk_id:
                    continue
                fused.append(tid)
            ids = fused
        return ids


def _normalize(text: str) -> str:
    """NFKC + whitespace collapse/strip (nmt_nfkc minus the exotic-control
    precompiled charsmap) — sentencepiece remove_extra_whitespaces=true."""
    text = unicodedata.normalize("NFKC", text)
    return " ".join(text.split())


class T5Tokenizer:
    """T5-style unigram tokenizer over a sentencepiece or HF vocab.

    transformers-compatible call surface (the subset the pipelines use:
    padding="max_length", truncation, numpy output).
    """

    def __init__(
        self,
        pieces: Sequence[Tuple[str, float, int]],
        max_length: int = 256,
        extra_special_tokens: Optional[Sequence[str]] = None,
    ):
        self.id_of = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.piece_of = {i: p for p, i in self.id_of.items()}
        unk_id = next(
            (i for i, (_, _, t) in enumerate(pieces) if t == _TYPE_UNKNOWN), 2
        )
        control = {i for i, (_, _, t) in enumerate(pieces) if t == _TYPE_CONTROL}
        unused = {i for i, (_, _, t) in enumerate(pieces) if t == _TYPE_UNUSED}
        self.model = UnigramModel(
            [(p, s) for p, s, _ in pieces],
            unk_id=unk_id,
            unscorable_ids=control | unused,
        )
        # T5 layout: <pad>=0, </s>=1 (both CONTROL in the shipped model)
        self.pad_id = self.id_of.get("<pad>", 0)
        self.eos_id = self.id_of.get("</s>", 1)
        self.unk_id = unk_id
        self.max_length = max_length
        specials = list(extra_special_tokens or [])
        for i in sorted(control):
            specials.append(self.piece_of[i])
        # user_defined pieces (e.g. <extra_id_N>) match greedily pre-split
        for i, (p, _, t) in enumerate(pieces):
            if t == _TYPE_USER_DEFINED:
                specials.append(p)
        # longest-first so overlapping specials resolve deterministically
        self.special_tokens = sorted(set(specials), key=len, reverse=True)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_spm(cls, path: str, **kw) -> "T5Tokenizer":
        with open(path, "rb") as f:
            return cls(parse_spm_model(f.read()), **kw)

    @classmethod
    def from_tokenizer_json(cls, path: str, **kw) -> "T5Tokenizer":
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise ValueError(f"not a unigram tokenizer.json: {model.get('type')}")
        unk_id = model.get("unk_id", 2)
        added = {t["id"]: t for t in spec.get("added_tokens", [])}
        pieces = []
        for i, (piece, score) in enumerate(model["vocab"]):
            if i == unk_id:
                ptype = _TYPE_UNKNOWN
            elif i in added:
                ptype = _TYPE_CONTROL if added[i].get("special") else _TYPE_USER_DEFINED
            else:
                ptype = _TYPE_NORMAL
            pieces.append((piece, score, ptype))
        for i, tok in sorted(added.items()):
            if i >= len(pieces):
                # ids must stay contiguous: a gap between len(pieces) and the
                # declared id would silently shift every later piece's id —
                # fail loudly on malformed tokenizer.json instead
                if i != len(pieces):
                    raise ValueError(
                        f"added token id {i} is non-contiguous (next slot is "
                        f"{len(pieces)}); refusing to mis-number the vocab"
                    )
                pieces.append(
                    (tok["content"], 0.0,
                     _TYPE_CONTROL if tok.get("special") else _TYPE_USER_DEFINED)
                )
        return cls(pieces, **kw)

    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "T5Tokenizer":
        """Load from a checkpoint tokenizer dir (spiece.model or
        tokenizer.json, the files SD3's tokenizer_3/ subfolder ships)."""
        spm = os.path.join(path, "spiece.model")
        if os.path.exists(spm):
            return cls.from_spm(spm, **kw)
        tj = os.path.join(path, "tokenizer.json")
        if os.path.exists(tj):
            return cls.from_tokenizer_json(tj, **kw)
        raise FileNotFoundError(f"no spiece.model / tokenizer.json under {path}")

    # -- encoding ----------------------------------------------------------
    def _split_specials(self, text: str) -> List[Tuple[str, bool]]:
        """[(segment, is_special)] — specials matched verbatim, longest first."""
        segments = [(text, False)]
        for sp in self.special_tokens:
            nxt: List[Tuple[str, bool]] = []
            for seg, is_sp in segments:
                if is_sp or sp not in seg:
                    nxt.append((seg, is_sp))
                    continue
                parts = seg.split(sp)
                for j, part in enumerate(parts):
                    if part:
                        nxt.append((part, False))
                    if j < len(parts) - 1:
                        nxt.append((sp, True))
            segments = nxt
        return segments

    def encode(self, text: str) -> List[int]:
        """Token ids WITHOUT the trailing </s>."""
        ids: List[int] = []
        for seg, is_special in self._split_specials(text):
            if is_special:
                ids.append(self.id_of[seg])
                continue
            norm = _normalize(seg)
            if not norm:
                continue
            # Metaspace: every word gets the ▁ prefix (dummy prefix included)
            for word in norm.split(" "):
                ids.extend(self.model.tokenize(_SPACE + word))
        return ids

    def __call__(
        self,
        texts,
        max_length: Optional[int] = None,
        padding: str = "max_length",
        truncation: bool = True,
        return_tensors: str = "np",
    ) -> dict:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.max_length
        out, mask = [], []
        for t in texts:
            ids = self.encode(t) + [self.eos_id]
            if truncation and len(ids) > max_length:
                # transformers T5 truncates then keeps </s> as final token
                ids = ids[: max_length - 1] + [self.eos_id]
            m = [1] * len(ids)
            if padding == "max_length":
                pad = max_length - len(ids)
                ids = ids + [self.pad_id] * pad
                m = m + [0] * pad
            out.append(ids)
            mask.append(m)
        return {
            "input_ids": np.array(out, np.int32),
            "attention_mask": np.array(mask, np.int32),
        }
