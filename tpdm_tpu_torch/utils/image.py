"""Image post- and pre-processing."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

# CLIP's per-channel statistics (the ImageReward preprocessing)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def uint8_images(decoded: torch.Tensor) -> torch.Tensor:
    """VAE output (b, 3, H, W) in [-1, 1] -> uint8 (b, H, W, 3) on its
    device: x/2 + 0.5, clamp, round half to even, as
    ``tpdm_tpu/utils/image.py:postprocess_images``."""
    x = torch.clamp(decoded.float() / 2.0 + 0.5, 0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8).permute(0, 2, 3, 1)


def postprocess_images(decoded: torch.Tensor) -> np.ndarray:
    """``uint8_images`` copied to a host numpy array."""
    return uint8_images(decoded).cpu().numpy()


def preprocess_images(images) -> torch.Tensor:
    """uint8 (b, H, W, 3) -> float32 (b, 3, H, W) in [-1, 1], the VAE
    encode's input, as ``tpdm_tpu/utils/image.py:preprocess_images``.
    ``images``: a numpy array or tensor; the output is on its device."""
    x = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(images))
    x = x.to(torch.float32) / 255.0
    return (x * 2.0 - 1.0).permute(0, 3, 1, 2)


def bicubic_resize_center_crop(images, size: int) -> torch.Tensor:
    """uint8 (b, H, W, 3) -> uint8 (b, size, size, 3): the shorter side
    resized to ``size`` (bicubic), then a centred square crop.

    Counterpart of ``tpdm_tpu/utils/image.py:bicubic_resize_center_crop``,
    which calls PIL. Here ``F.interpolate(mode="bicubic", antialias=True)``
    runs PIL's antialiased filter (a = -0.5, support scaled by the factor)
    on the images' device, in PIL's two passes, horizontal then vertical,
    each result rounded half up and clamped to uint8 as PIL rounds and
    clips it. PIL's coefficients are fixed point, so the two may still
    differ by a level at some pixels. ``images``: a uint8 tensor or numpy
    array; the output is on its device.
    """
    x = torch.as_tensor(images)
    _, h, w, _ = x.shape
    scale = size / min(w, h)
    nw, nh = round(w * scale), round(h * scale)
    y = x.permute(0, 3, 1, 2).float()
    for pass_size in ((h, nw), (nh, nw)):  # a pass at the same size is the identity
        y = F.interpolate(y, size=pass_size, mode="bicubic", antialias=True, align_corners=False)
        y = torch.clamp(torch.floor(y + 0.5), 0.0, 255.0)
    y = y.to(torch.uint8)
    left, top = (nw - size) // 2, (nh - size) // 2
    return y[:, :, top : top + size, left : left + size].permute(0, 2, 3, 1)


def normalize_clip(images: torch.Tensor) -> torch.Tensor:
    """uint8 (b, H, W, 3) -> float32 (b, 3, H, W) normalised with CLIP's
    statistics, as ``tpdm_tpu/utils/image.py:normalize_clip``."""
    x = images.to(torch.float32) / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def png_bytes(image: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W) grey -> the bytes of an 8-bit PNG,
    written with zlib alone (no imaging library): one IDAT chunk of rows
    that each start with filter byte 0 (None)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"a PNG takes uint8 (H, W, 3) or (H, W), got {image.dtype} "
                         f"{image.shape}")
    h, w = image.shape[:2]
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color_type = 2 if image.ndim == 3 else 0
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path, image: np.ndarray, level: int = 6) -> None:
    """``png_bytes(image, level)`` written to ``path``."""
    data = png_bytes(image, level)
    with open(path, "wb") as f:
        f.write(data)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel (gray, RGB, RGBA)


def _png_chunks(data: bytes):
    """(tag, payload) of each chunk, CRCs checked."""
    pos = len(_PNG_SIGNATURE)
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(payload) != n or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + payload) & 0xFFFFFFFF:
            raise ValueError(f"bad CRC in PNG chunk {tag!r}")
        yield tag, payload
        pos += 12 + n
        if tag == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _unfilter(rows: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of (h, w, bpp) uint8 scanlines.

    Filters 0 (None), 1 (Sub) and 2 (Up) reconstruct a row at once (Sub is
    a running sum along the row). Average (3) and Paeth (4) need each
    byte's reconstructed left neighbour; with any such row the image is
    walked by anti-diagonals (row + column constant), whose bytes depend
    only on earlier diagonals, each diagonal at once across the rows."""
    h, w, _ = rows.shape
    if filters.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(filters.max())}")
    if not np.isin(filters, (3, 4)).any():
        out = np.zeros((h, w, bpp), np.uint8)
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            x = rows[r]
            if filters[r] == 1:
                x = np.cumsum(x, axis=0, dtype=np.uint64).astype(np.uint8)
            elif filters[r] == 2:
                x = x + prev  # uint8 arithmetic wraps mod 256
            out[r] = prev = x
        return out
    # one row of zeros above and one column of zeros to the left: the
    # neighbours a (left), b (up) and c (up-left) at the image's edges
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    data = rows.astype(np.int32)
    ft = filters.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ft[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], default=0)
        out[r + 1, x + 1] = (data[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(data: bytes) -> np.ndarray:
    """The uint8 pixels of a PNG, with zlib alone (no imaging library):
    (H, W) for 8-bit gray, (H, W, 3) for RGB, (H, W, 4) for RGBA, each
    non-interlaced, under any of the five row filters. Anything else (other
    bit depths or colour types, interlacing, a bad CRC, truncated or
    undecompressable data) raises ValueError."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG (bad signature)")
    header, idat = None, []
    for tag, payload in _png_chunks(data):
        if tag == b"IHDR":
            header = payload
        elif tag == b"IDAT":
            idat.append(payload)
    if header is None or len(header) != 13 or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, compression, filter_method, interlace = struct.unpack(">IIBBBBB", header)
    if depth != 8 or color not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color} (8-bit gray, "
                         "RGB or RGBA only)")
    if compression or filter_method or interlace:
        raise ValueError("unsupported PNG: interlaced or non-standard compression/filtering")
    if not (w and h):
        raise ValueError("PNG with an empty image")
    bpp = _PNG_CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"bad PNG pixel data: {e}") from None
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"PNG pixel data of {len(raw)} bytes for a {w}x{h}x{bpp} image")
    lines = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp)
    pixels = _unfilter(lines[:, 1:].reshape(h, w, bpp), lines[:, 0], bpp)
    return pixels[:, :, 0] if bpp == 1 else pixels


def read_png_rgb(data: bytes) -> np.ndarray:
    """``read_png`` as uint8 (H, W, 3) RGB: gray repeated in each channel,
    alpha dropped (what an imaging library's RGB conversion gives)."""
    pixels = read_png(data)
    if pixels.ndim == 2:
        return np.repeat(pixels[:, :, None], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])
