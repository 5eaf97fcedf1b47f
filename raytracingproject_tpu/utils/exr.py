"""Minimal OpenEXR codec (capability ref: the reference links OpenEXR
via OIIO for multilayer output — render/image_oiio.cpp and the
session's EXR writers; independent implementation of the public OpenEXR
2.0 file format spec, single-part scanline).

Good enough for production interchange of render passes: float32 (and
half on write) channels, single-part scanline images, multilayer via
dotted channel names ("Combined.R", "crypto_object.00.R", ...), with
NO_COMPRESSION, ZIPS (one scanline per chunk) or ZIP (16 scanlines per
chunk) through the standard library's zlib. Any EXR-aware tool
(Blender, Nuke, oiiotool) reads these files.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"
_VERSION = struct.pack("<I", 2)
_PT_HALF, _PT_FLOAT = 1, 2
# compression attribute values and scanlines per chunk
COMP_NONE, COMP_ZIPS, COMP_ZIP = 0, 2, 3
_COMP_BY_NAME = {"none": COMP_NONE, "zips": COMP_ZIPS, "zip": COMP_ZIP}
_LINES_PER_CHUNK = {COMP_NONE: 1, COMP_ZIPS: 1, COMP_ZIP: 16}


def _zip_pack(raw):
    """The spec's ZIP transform (ImfZip.cpp): split even and odd bytes
    into two planes, delta-encode, deflate. Stored raw when deflate
    does not shrink the chunk."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int16)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128) & 0xFF
    z = zlib.compress(d.astype(np.uint8).tobytes())
    return z if len(z) < len(raw) else raw


def _zip_unpack(data, nbytes):
    """Inverse of _zip_pack for a chunk of `nbytes` uncompressed bytes."""
    if len(data) >= nbytes:       # stored raw
        return data[:nbytes]
    d = np.frombuffer(zlib.decompress(data), np.uint8).astype(np.int64)
    if d.size != nbytes:
        raise ValueError("corrupt ZIP chunk")
    d[1:] -= 128
    t = (np.cumsum(d) & 0xFF).astype(np.uint8)
    half = (nbytes + 1) // 2
    raw = np.empty(nbytes, np.uint8)
    raw[0::2] = t[:half]
    raw[1::2] = t[half:]
    return raw.tobytes()


def _attr(name, typ, data):
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<I", len(data)) + data)


def _chlist(channels, pixel_type):
    out = b""
    for name in channels:          # must be alphabetically sorted
        out += (name.encode() + b"\0"
                + struct.pack("<i", pixel_type)
                + struct.pack("<B3x", 0)
                + struct.pack("<ii", 1, 1))
    return out + b"\0"


def write_exr(path, channels, half=False, compression="zip"):
    """channels: {name: (H, W) float32}; all same shape. Layered names
    use dots ("Combined.R"). half=True stores 16-bit floats.
    compression: "zip" | "zips" | "none"."""
    comp = _COMP_BY_NAME[compression]
    names = sorted(channels)
    if not names:
        raise ValueError("no channels")
    arrs = {n: np.asarray(channels[n], np.float32) for n in names}
    h, w = next(iter(arrs.values())).shape
    for n, a in arrs.items():
        if a.shape != (h, w):
            raise ValueError(f"channel {n} shape {a.shape} != {(h, w)}")
    ptype = _PT_HALF if half else _PT_FLOAT
    dtype = np.float16 if half else np.float32

    header = b""
    header += _attr("channels", "chlist", _chlist(names, ptype))
    header += _attr("compression", "compression", bytes([comp]))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")      # INCREASING_Y
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    # (H, C, W): a chunk's bytes are its scanlines, each line holding
    # the channels one after another
    planes = np.stack([arrs[n] for n in names], axis=1).astype(dtype)
    lpc = _LINES_PER_CHUNK[comp]
    chunks = []
    for y0 in range(0, h, lpc):
        raw = planes[y0:y0 + lpc].tobytes()
        data = raw if comp == COMP_NONE else _zip_pack(raw)
        chunks.append(struct.pack("<iI", y0, len(data)) + data)
    pos = len(_MAGIC) + len(_VERSION) + len(header) + 8 * len(chunks)
    offsets = []
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(_MAGIC + _VERSION + header)
        f.write(struct.pack(f"<{len(chunks)}Q", *offsets))
        f.write(b"".join(chunks))
    return path


def _read_attrs(buf, pos):
    attrs = {}
    while buf[pos] != 0:
        e = buf.index(b"\0", pos)
        name = buf[pos:e].decode(); pos = e + 1
        e = buf.index(b"\0", pos)
        typ = buf[pos:e].decode(); pos = e + 1
        size = struct.unpack_from("<I", buf, pos)[0]; pos += 4
        attrs[name] = (typ, buf[pos:pos + size]); pos += size
    return attrs, pos + 1


def _parse_chlist(data):
    chans, pos = [], 0
    while data[pos] != 0:
        e = data.index(b"\0", pos)
        name = data[pos:e].decode(); pos = e + 1
        ptype = struct.unpack_from("<i", data, pos)[0]
        pos += 16
        chans.append((name, ptype))
    return chans


def read_exr(path):
    """Read a single-part scanline EXR with HALF/FLOAT channels,
    NO_COMPRESSION, ZIPS or ZIP. Returns {channel_name: (H, W) float32}."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != _MAGIC:
        raise ValueError("not an EXR file")
    version = struct.unpack_from("<I", buf, 4)[0]
    if version & (0x200 | 0x800 | 0x1000):
        raise NotImplementedError(
            "tiled/deep/multi-part EXR not supported")
    attrs, pos = _read_attrs(buf, 8)
    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_CHUNK:
        raise NotImplementedError(f"compression {comp} not supported")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    chans = _parse_chlist(attrs["channels"][1])
    for n, ptype in chans:
        if ptype not in (_PT_HALF, _PT_FLOAT):
            raise NotImplementedError(f"pixel type {ptype}")
    line_bytes = w * sum(2 if p == _PT_HALF else 4 for _, p in chans)
    lpc = _LINES_PER_CHUNK[comp]
    offsets = struct.unpack_from(f"<{-(-h // lpc)}Q", buf, pos)
    out = {n: np.empty((h, w), np.float32) for n, _ in chans}
    for off in offsets:
        y, nbytes = struct.unpack_from("<iI", buf, off)
        ny = min(lpc, y0 + h - y)
        data = buf[off + 8:off + 8 + nbytes]
        if len(data) != nbytes:
            raise ValueError("truncated EXR chunk")
        want = ny * line_bytes
        if comp != COMP_NONE:
            data = _zip_unpack(data, want)
        if len(data) != want:
            raise ValueError("EXR chunk size mismatch")
        p = 0
        for yy in range(ny):
            for n, ptype in chans:        # alphabetical in-file order
                dt = np.float16 if ptype == _PT_HALF else np.float32
                out[n][y - y0 + yy] = np.frombuffer(data, dt, w, p)
                p += w * np.dtype(dt).itemsize
    return out


def write_multilayer_exr(path, layers, half=False):
    """layers: {name: (H, W, C)} -> channels name.R/G/B/A (C<=4) or
    name.00..name.NN for deep stacks (cryptomatte ranks)."""
    channels = {}
    suffix4 = ["R", "G", "B", "A"]
    for name, arr in layers.items():
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        c = arr.shape[-1]
        for k in range(c):
            suf = suffix4[k] if c <= 4 else f"{k:02d}"
            channels[f"{name}.{suf}"] = arr[..., k]
    return write_exr(path, channels, half=half)


def read_multilayer_exr(path):
    """Inverse of write_multilayer_exr: groups channels by layer."""
    chans = read_exr(path)
    layers = {}
    order = {"R": 0, "G": 1, "B": 2, "A": 3}
    groups = {}
    for full in chans:
        layer, _, suf = full.rpartition(".")
        groups.setdefault(layer, []).append(suf)
    for layer, sufs in groups.items():
        sufs.sort(key=lambda s: order.get(s, 100 + int(s)
                                          if s.isdigit() else 999))
        layers[layer] = np.stack(
            [chans[f"{layer}.{s}"] for s in sufs], -1)
    return layers
