"""Read and write the safetensors format without the ``safetensors`` package.

The JAX package reads checkpoints through the ``safetensors`` library
(``tpdm_tpu/utils/convert.py:load_safetensors``); the port carries its own
reader and writer, so loading a local checkpoint needs torch and numpy only.

The format: an 8-byte little-endian header length n, n bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` and an
optional ``"__metadata__"`` map of strings), then the tensors' raw
little-endian, C-ordered bytes, each at its offsets from the end of the
header. ``load_file`` maps the file and copies out only the tensors asked
for; ``save_file`` writes the layout the ``safetensors`` package writes
(tensors ordered by descending alignment, then by name; the header padded
with spaces to a multiple of 8), so the two agree byte for byte.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

# safetensors dtype tag -> (torch dtype, numpy dtype holding the same bytes);
# bf16 has no numpy dtype: its bytes are read as uint16 and viewed
_DTYPES = {
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.uint16),
    "I64": (torch.int64, np.int64),
    "I32": (torch.int32, np.int32),
    "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8),
    "BOOL": (torch.bool, np.bool_),
}
_TAGS = {torch_dtype: tag for tag, (torch_dtype, _) in _DTYPES.items()}
# the safetensors package's order of its dtypes (the order in which it
# declares them), which sorts the tensors of a file it writes
_RANK = {tag: i for i, tag in enumerate(
    ("BOOL", "U8", "I8", "F8_E5M2", "F8_E4M3", "I16", "U16", "F16", "BF16", "I32", "U32",
     "F32", "F64", "I64", "U64"))}
# the largest header the safetensors package reads
_MAX_HEADER = 100_000_000


def read_header(path: str) -> Dict[str, dict]:
    """The file's JSON header: each tensor's dtype, shape and data_offsets,
    and ``__metadata__`` where the file has one."""
    with open(path, "rb") as f:
        return _header(f.read(8), f, path)[0]


def _header(prefix: bytes, f, path: str):
    if len(prefix) != 8:
        raise ValueError(f"{path}: shorter than a safetensors header")
    (n,) = struct.unpack("<Q", prefix)
    if n > _MAX_HEADER:
        raise ValueError(f"{path}: header of {n} bytes")
    raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: header of {n} bytes, file ends at {len(raw)}")
    return json.loads(raw), 8 + n


def load_file(path: str, keys: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """The file's tensors (or only ``keys``) as CPU torch tensors of the
    stored dtype. The file is memory-mapped and each wanted tensor copied
    out, so the bytes of the others are never read."""
    with open(path, "rb") as f:
        header, start = _header(f.read(8), f, path)
        header.pop("__metadata__", None)
        names = list(header) if keys is None else list(keys)
        missing = [k for k in names if k not in header]
        if missing:
            raise KeyError(f"{path}: no tensor {missing[0]!r}")
        out = {}
        if not names:
            return out
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            for name in names:
                info = header[name]
                tag = info["dtype"]
                if tag not in _DTYPES:
                    raise ValueError(f"{path}: {name} has dtype {tag}, not one of {sorted(_DTYPES)}")
                torch_dtype, np_dtype = _DTYPES[tag]
                begin, end = info["data_offsets"]
                shape = tuple(info["shape"])
                count = int(np.prod(shape, dtype=np.int64))
                if end - begin != count * np.dtype(np_dtype).itemsize or start + end > len(mm):
                    raise ValueError(f"{path}: {name} {tag} {shape} does not fit its offsets "
                                     f"{begin}..{end}")
                stored = np.dtype(np_dtype).newbyteorder("<")
                arr = np.frombuffer(mm, stored, count, start + begin).astype(np_dtype)
                t = torch.from_numpy(arr.reshape(shape))
                out[name] = t.view(torch_dtype) if tag == "BF16" else t
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays, any device and
    strides: each is written from a contiguous CPU copy) to ``path``, with
    ``metadata`` (str -> str) as ``__metadata__``."""
    parts = []
    for name, t in tensors.items():
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        if t.dtype not in _TAGS:
            raise ValueError(f"{name}: dtype {t.dtype} is not one of {sorted(_DTYPES)}")
        parts.append((name, _TAGS[t.dtype], t.detach().cpu().contiguous()))
    parts.sort(key=lambda p: (-_RANK[p[1]], p[0]))
    header = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, tag, t in parts:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": tag, "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, tag, t in parts:
            arr = (t.view(torch.uint16) if tag == "BF16" else t).numpy()
            f.write(arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes())
