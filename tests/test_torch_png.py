"""The port's stdlib PNG reader (``tpdm_tpu_torch/utils/image.py:read_png``),
which ``python -m tpdm_tpu_torch.serve`` uses for ``init_image_png_base64``:
round trips through ``png_bytes``, a hand-built PNG for each of the five
row filters, and the refusals. No imaging library is used."""

import struct
import zlib

import numpy as np
import pytest

from tpdm_tpu_torch.utils.image import png_bytes, read_png, read_png_rgb

_COLOR = {1: 0, 3: 2, 4: 6}  # samples a pixel -> colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _png(image: np.ndarray, filters, header=None, idat_parts: int = 1) -> bytes:
    """An 8-bit PNG of ``image`` whose row r is written with filter
    ``filters[r % len(filters)]``, the filters applied by the PNG
    specification's definitions; the pixel data split over ``idat_parts``
    IDAT chunks."""
    h, w = image.shape[:2]
    bpp = 1 if image.ndim == 2 else image.shape[2]
    x = image.reshape(h, w * bpp).astype(np.int64)
    lines = []
    for r in range(h):
        cur = x[r]
        up = x[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        f = filters[r % len(filters)]
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        pred = [np.zeros_like(cur), left, up, (left + up) // 2, paeth][f]
        lines.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    data = zlib.compress(b"".join(lines))
    cut = len(data) // idat_parts
    parts = [data[i * cut:(i + 1) * cut if i < idat_parts - 1 else None]
             for i in range(idat_parts)]
    header = header or struct.pack(">IIBBBBB", w, h, 8, _COLOR[bpp], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + b"".join(_chunk(b"IDAT", part) for part in parts) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 9), (1, 1, 3), (33, 17, 3)])
def test_round_trip_through_png_bytes(shape):
    image = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(read_png(png_bytes(image)), image)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("shape", [(7, 5, 3), (6, 9), (5, 4, 4)], ids=["rgb", "gray", "rgba"])
def test_each_filter_type(filters, shape):
    image = np.random.default_rng(len(filters)).integers(0, 256, shape, dtype=np.uint8)
    data = _png(image, filters, idat_parts=2)
    np.testing.assert_array_equal(read_png(data), image)
    rgb = read_png_rgb(data)
    assert rgb.shape == shape[:2] + (3,) and rgb.dtype == np.uint8
    want = np.repeat(image[:, :, None], 3, axis=2) if image.ndim == 2 else image[:, :, :3]
    np.testing.assert_array_equal(rgb, want)


def _refused():
    image = np.zeros((4, 4, 3), np.uint8)
    good = _png(image, (0,))
    head = good[:33]  # the signature and the IHDR chunk
    return {
        "not a PNG": b"GIF89a" + good[6:],
        "16-bit": _png(image, (0,), header=struct.pack(">IIBBBBB", 4, 4, 16, 2, 0, 0, 0)),
        "palette": _png(image, (0,), header=struct.pack(">IIBBBBB", 4, 4, 8, 3, 0, 0, 0)),
        "interlaced": _png(image, (0,), header=struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)),
        "bad CRC": good[:-5] + bytes([good[-5] ^ 1]) + good[-4:],
        "truncated": good[:40],
        "no IEND": good[:-12],
        "bad pixel data": head + _chunk(b"IDAT", b"not zlib") + good[-12:],
        "short pixel data": _png(np.zeros((3, 4, 3), np.uint8), (0,),
                                 header=struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0)),
        "unknown filter": head + _chunk(b"IDAT", zlib.compress(bytes([5] + [0] * 12) * 4))
        + good[-12:],
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_refusals(case):
    with pytest.raises(ValueError):
        read_png(_refused()[case])
