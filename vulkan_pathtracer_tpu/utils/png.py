"""PNG IO + the reference's unorm8 present semantics.

The reference stores linear radiance straight into a
``b8g8r8a8_unorm`` storage image (RaytracingPass.zig:154-166, format
from Swapchain.zig:114-141) with **no tonemap**: values clamp at 1.0
and quantize to 8 bits with round-to-nearest-even (Vulkan unorm
conversion).  ``quantize_unorm8`` reproduces that so golden-image
comparisons see the same numbers the reference would present.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> channels (PNG spec §11.2.2).
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def quantize_unorm8(linear_rgb: np.ndarray) -> np.ndarray:
    """float linear [H,W,3] -> uint8 [H,W,3], Vulkan unorm semantics."""
    clamped = np.clip(np.asarray(linear_rgb, dtype=np.float32), 0.0, 1.0)
    # Vulkan spec: round(f * 255) to nearest even on ties.
    scaled = clamped * 255.0
    return np.rint(scaled).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 [H,W,3] (RGB) or [H,W,4] (RGBA) -> PNG bytes (8-bit,
    filter type 0 on every row)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = image.shape
    color_type = {3: 2, 4: 6}[c]
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (spec §9) -> (h, stride) uint8."""
    rows = np.frombuffer(data, np.uint8)[: h * (stride + 1)]
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: running sum per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:      # Up
            cur = (line + prior) & 255
        elif ftype in (3, 4):  # Average / Paeth: serial along the row
            cur = line.copy()
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prior[x])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prior[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 255
        else:
            raise ValueError(f"PNG: bad filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def decode_png(payload: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H,W,4] RGBA (stb_image's forced 4 channels).

    Non-interlaced PNGs of every colour type, at 8 or 16 bits per
    channel (16-bit keeps the high byte) and palette / greyscale at
    1, 2, 4 or 8 bits.  Raises ValueError on anything else.
    """
    if payload[:8] != _SIGNATURE:
        raise ValueError("not a PNG image (only PNG textures are "
                         "supported)")
    pos, idat, palette, trns = 8, [], None, None
    header = None
    while pos + 8 <= len(payload):
        length, kind = struct.unpack(">I4s", payload[pos:pos + 8])
        body = payload[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: missing IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG: unsupported colour type {ctype} or "
                         f"interlace {interlace}")
    ch = _CHANNELS[ctype]
    if depth not in (1, 2, 4, 8, 16) or (depth < 8 and ch != 1):
        raise ValueError(f"PNG: unsupported bit depth {depth}")
    stride = (w * ch * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride,
                     max(1, ch * depth // 8))
    if depth == 16:
        px = rows.reshape(h, w * ch, 2)[:, :, 0].reshape(h, w, ch)
    elif depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        vals = bits @ (1 << np.arange(depth - 1, -1, -1))
        px = vals[:, :w].astype(np.uint8).reshape(h, w, 1)
        if ctype == 0:
            px = (px.astype(np.int32) * 255 // ((1 << depth) - 1)
                  ).astype(np.uint8)
    else:
        px = rows.reshape(h, w, ch)
    out = np.full((h, w, 4), 255, np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        idx = px[..., 0]
        out[..., :3] = palette[np.minimum(idx, palette.shape[0] - 1)]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
            out[..., 3] = alpha[idx]
    elif ctype in (0, 4):
        out[..., :3] = px[..., :1]
        if ctype == 4:
            out[..., 3] = px[..., 1]
    else:
        out[..., :ch] = px
    return out


def write_png(path: str, image: np.ndarray) -> None:
    """Write an image to PNG. Accepts float linear [H,W,3] (quantized
    per the present semantics) or uint8 arrays."""
    if image.dtype != np.uint8:
        image = quantize_unorm8(image)
    with open(path, "wb") as f:
        f.write(encode_png(image))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())[..., :3]
