"""24-bit BMP codec, byte-compatible with the reference engine's I/O.

The reference (holoskii/Rendering) has two quirky codecs we must match
exactly so golden-image diffs are bit-level meaningful:

* Writer (`src/util.cpp:15-63`): 54-byte BITMAPINFOHEADER, 24bpp, BGR,
  bottom-up rows, rows padded to 4 bytes, pixel = (u8)(clamp01(f) * 255)
  (truncating cast, NOT rounding).
* Reader (`src/util.cpp:78-113`): reads the 54-byte header, takes width
  at offset 18 and height at offset 22, then reads 3*w*h bytes
  SEQUENTIALLY — it deliberately ignores row padding and never flips
  rows. So the returned array's row 0 is the BOTTOM image row and, if
  width*3 % 4 != 0, the data is sheared exactly like the reference
  sees it. We reproduce both behaviours.

The writer additionally reproduces the reference's header-writing quirk:
the C++ code stores several fields via `*(size_t*)(header + off)` which
writes 8 bytes at offsets 0x2, 0xA, 0xE, 0x12, 0x16, 0x22, 0x26, 0x2A —
later writes clobber the tails of earlier ones, leaving a standard
little-endian layout because the writes happen in increasing offset
order and each logical field is <= 4 bytes in value. The net observable
bytes are those of a standard header with biPlanes at 0x1A=1,
biBitCount at 0x1C=24 and 2835 px/m resolutions, except that the
4 bytes at 0x2E..0x31 (biClrUsed) get the high half of the size_t
written at 0x2A, i.e. zero. We just emit that exact byte layout.
"""

from __future__ import annotations

import struct

import numpy as np

_HEADER_SIZE = 54


def _padding(width: int) -> int:
    # src/util.cpp:27 — int paddingBytes = width % 4 == 0 ? 0 : 4 - width*3 % 4
    # NOTE the reference checks `width % 4` but pads `4 - width*3 % 4`.
    return 0 if width % 4 == 0 else 4 - (width * 3) % 4


def quantize_reference(image: np.ndarray) -> np.ndarray:
    """float -> u8 exactly like the reference writer's
    `static_cast<char>(clamp(0,1,f) * 255)` (src/util.cpp:50) as compiled
    by g++ -O2 on x86-64: the float->signed-char conversion of 255.0
    (i.e. any channel >= 1.0) SATURATES to 127, while in-range values
    truncate and wrap through the byte normally. Verified empirically —
    no reference output ever contains byte 255; fully-saturated channels
    read back as 127.
    """
    clipped = np.clip(image, 0.0, 1.0)
    product = clipped * np.float32(255.0)
    u8 = product.astype(np.uint8)  # truncating cast
    return np.where(product >= 255.0, np.uint8(127), u8)


def encode_bmp(image: np.ndarray) -> bytes:
    """Encode float image (H, W, 3) in [0,1] (row 0 = top) to BMP bytes.

    Matches `saveImage` in the reference `src/util.cpp:15-63` byte for
    byte: clamp01 -> *255 -> truncating u8 cast, BGR order, bottom-up
    rows, rows padded to 4 bytes with zeros.
    """
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) image, got {image.shape}")
    height, width = image.shape[:2]
    pad = _padding(width)
    array_size = height * (width + pad) * 3
    total = _HEADER_SIZE + array_size

    header = bytearray(_HEADER_SIZE)
    header[0:2] = b"BM"
    struct.pack_into("<I", header, 0x2, total)
    struct.pack_into("<I", header, 0xA, _HEADER_SIZE)
    struct.pack_into("<I", header, 0xE, _HEADER_SIZE - 14)
    struct.pack_into("<I", header, 0x12, width)
    struct.pack_into("<I", header, 0x16, height)
    header[0x1A] = 1
    header[0x1C] = 24
    struct.pack_into("<I", header, 0x22, array_size)
    struct.pack_into("<I", header, 0x26, 2835)
    struct.pack_into("<I", header, 0x2A, 2835)

    if image.dtype.kind == "f":
        u8 = quantize_reference(image)
    else:
        u8 = image.astype(np.uint8)
    bgr = u8[::-1, :, ::-1]  # bottom-up rows, BGR channel order
    if pad:
        rows = np.zeros((height, width * 3 + pad), dtype=np.uint8)
        rows[:, : width * 3] = bgr.reshape(height, width * 3)
        body = rows.tobytes()
        # The reference writes arraySize = h*(w+pad)*3 bytes
        # (util.cpp:29,61) from a buffer laid out in h*(w*3+pad) rows —
        # the 2*pad*h tail it emits is uninitialized heap (UB). Match
        # the declared length deterministically with zeros so the file
        # agrees with its own header like the reference's does.
        body += bytes(array_size - len(body))
    else:
        body = bgr.tobytes()
    return bytes(header) + body


def save_bmp(path: str, image: np.ndarray) -> None:
    """Write image to `path` (reference appends `.bmp` itself; we don't)."""
    with open(path, "wb") as fh:
        fh.write(encode_bmp(image))


def decode_bmp(data: bytes) -> np.ndarray:
    """Decode BMP bytes the way the reference `loadBMP` does.

    Returns u8 array of shape (height, width, 3), RGB, laid out exactly
    as the reference's in-memory buffer: the 3*w*h bytes following the
    54-byte header are taken verbatim (padding NOT skipped, rows NOT
    flipped — row 0 is the bottom row), with the per-pixel byte triple
    order swapped BGR->RGB (`src/util.cpp:104-110`).
    """
    if len(data) < _HEADER_SIZE:
        raise ValueError("truncated BMP header")
    width = struct.unpack_from("<i", data, 18)[0]
    height = struct.unpack_from("<i", data, 22)[0]
    size = 3 * width * height
    raw = np.frombuffer(data, dtype=np.uint8, count=size, offset=_HEADER_SIZE)
    arr = raw.reshape(height, width, 3)[:, :, ::-1]
    return np.ascontiguousarray(arr)


def load_bmp(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_bmp(fh.read())


def load_bmp_float(path: str) -> np.ndarray:
    """u8 -> float via /256 — matches the reference's map/skybox decode
    (`src/scene.cpp:353-354`, `src/objects.cpp:409-412`): NOT /255."""
    return load_bmp(path).astype(np.float32) / 256.0


def bmp_to_image(arr: np.ndarray) -> np.ndarray:
    """Convert a `decode_bmp` result (bottom-up rows) to a top-down image.

    Only valid when width*3 % 4 == 0 (no padding shear), which holds for
    every asset the reference ships.
    """
    return arr[::-1]
