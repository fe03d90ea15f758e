"""Stdlib PNG codec (utils/png.py): the CLI's writer and the glTF
texture decoder, with no imaging library on the path."""

import struct
import zlib

import numpy as np
import pytest

from vulkan_pathtracer_tpu.utils.png import (
    decode_png,
    encode_png,
    read_png,
    write_png,
)


def _png(raw_rows: bytes, w: int, h: int, depth: int, ctype: int,
         extra=b"", interlace: int = 0) -> bytes:
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                         0, 0, interlace))
            + extra + chunk(b"IDAT", zlib.compress(raw_rows))
            + chunk(b"IEND", b""))


def _filter_rows(img: np.ndarray, ftype: int) -> bytes:
    """Forward PNG filter ``ftype`` on every row (spec §9), written
    independently of the decoder under test."""
    h = img.shape[0]
    rows = img.reshape(h, -1).astype(np.int32)
    bpp = img.shape[2]
    out = []
    prior = np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([ftype]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())
        prior = cur
    return b"".join(out)


@pytest.mark.parametrize("channels", [3, 4])
def test_roundtrip(channels, tmp_path):
    img = np.random.default_rng(channels).integers(
        0, 256, (17, 23, channels), dtype=np.uint8)
    back = decode_png(encode_png(img))
    assert back.shape == (17, 23, 4)
    np.testing.assert_array_equal(back[..., :channels], img)
    if channels == 3:
        assert (back[..., 3] == 255).all()
        path = str(tmp_path / "x.png")
        write_png(path, img)
        np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_every_row_filter(ftype):
    rng = np.random.default_rng(ftype)
    img = np.cumsum(rng.integers(0, 40, (9, 11, 4)), axis=1).astype(np.uint8)
    png = _png(_filter_rows(img, ftype), 11, 9, 8, 6)
    np.testing.assert_array_equal(decode_png(png), img)


def test_grey_palette_and_sixteen_bit():
    grey = np.arange(12, dtype=np.uint8).reshape(3, 4) * 20
    got = decode_png(_png(_filter_rows(grey[..., None], 0), 4, 3, 8, 0))
    np.testing.assert_array_equal(got[..., 0], grey)
    np.testing.assert_array_equal(got[..., 2], grey)

    plte = struct.pack(">I", 6) + b"PLTE" + bytes([10, 20, 30, 40, 50, 60])
    plte += struct.pack(">I", zlib.crc32(b"PLTE" + bytes(
        [10, 20, 30, 40, 50, 60])) & 0xFFFFFFFF)
    # Two 1-bit palette rows: indices 0,1,1,0 and 1,0,0,1.
    rows = bytes([0, 0b01100000, 0, 0b10010000])
    got = decode_png(_png(rows, 4, 2, 1, 3, extra=plte))
    np.testing.assert_array_equal(got[0, :, :3],
                                  [[10, 20, 30], [40, 50, 60],
                                   [40, 50, 60], [10, 20, 30]])

    wide = np.array([[[0x1234, 0xABCD, 0xFF00]]], np.uint16)
    got = decode_png(_png(b"\x00" + wide.astype(">u2").tobytes(),
                          1, 1, 16, 2))
    np.testing.assert_array_equal(got[0, 0], [0x12, 0xAB, 0xFF, 255])


def test_unsupported_inputs_raise():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"\xff\xd8\xff\xe0 jpeg bytes")
    with pytest.raises(ValueError, match="interlace"):
        decode_png(_png(b"\x00\x00\x00\x00", 1, 1, 8, 2, interlace=1))
