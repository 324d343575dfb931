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
