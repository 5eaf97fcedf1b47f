"""8-bit PNG through the standard library (utils/image_io.py): round
trips for every channel count, all five scanline filters, 16-bit and
palette files, and no dependence on PIL."""

import struct
import sys
import zlib

import numpy as np
import pytest

from raytracingproject_tpu.utils import image_io


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 1), (7, 5, 2), (7, 5, 3),
                                   (7, 5, 4)])
def test_png_roundtrip_bitexact(shape):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    back = image_io.decode_png(image_io.encode_png(img))
    np.testing.assert_array_equal(back.reshape(img.shape), img)
    assert back.dtype == np.uint8


def _filtered_png(img, ftype):
    """An 8-bit RGB PNG whose rows all use filter `ftype`, encoded with
    the spec's formulas written out pixel by pixel."""
    h, w, c = img.shape
    raw = bytearray()
    prev = [0] * (w * c)
    for y in range(h):
        row = [int(v) for v in img[y].reshape(-1)]
        out = []
        for x in range(w * c):
            a = row[x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                        else cc)
            out.append((row[x] - pred) & 0xFF)
        raw += bytes([ftype] + out)
        prev = row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_decodes_every_filter(ftype):
    img = np.random.default_rng(ftype).integers(0, 256, (6, 9, 3),
                                                dtype=np.uint8)
    np.testing.assert_array_equal(
        image_io.decode_png(_filtered_png(img, ftype)), img)


def test_png_16bit_and_palette():
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))
    sig = b"\x89PNG\r\n\x1a\n"
    g16 = np.array([[0, 1000, 65535]], np.uint16)
    raw = b"\0" + g16.astype(">u2").tobytes()
    blob = (sig + chunk(b"IHDR", struct.pack(">IIBBBBB", 3, 1, 16, 0, 0,
                                              0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(image_io.decode_png(blob)[..., 0], g16)
    plte = bytes([255, 0, 0, 0, 255, 0])
    blob = (sig + chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 1, 8, 3, 0,
                                              0, 0))
            + chunk(b"PLTE", plte) + chunk(b"tRNS", bytes([128]))
            + chunk(b"IDAT", zlib.compress(b"\0\x01\x00"))
            + chunk(b"IEND", b""))
    np.testing.assert_array_equal(
        image_io.decode_png(blob),
        [[[0, 255, 0, 255], [255, 0, 0, 128]]])


def test_png_without_pil(tmp_path, monkeypatch):
    """Writing and reading PNG needs no PIL; other LDR formats say
    clearly that they do."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.random.default_rng(3).random((4, 6, 3)).astype(np.float32)
    p = tmp_path / "x.png"
    image_io.write_png(p, img)
    back = image_io.read_image(p)
    assert back.shape == (4, 6, 3)
    # 8-bit sRGB quantisation is the only loss
    np.testing.assert_allclose(back, img, atol=0.01)
    with pytest.raises(ImportError, match="Pillow"):
        image_io.read_image(tmp_path / "x.jpg")


def test_png_rejects_bad_input():
    with pytest.raises(ValueError):
        image_io.decode_png(b"not a png")
    with pytest.raises(ValueError):
        image_io.encode_png(np.zeros((2, 2, 3), np.float32))
