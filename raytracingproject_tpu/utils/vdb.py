"""Minimal OpenVDB (.vdb) I/O — gated loader for volume grids.

Spec-derived subset of the OpenVDB file format (the reference loads
grids through the OpenVDB library, ref: render/image_vdb.cpp,
render/volume.cpp; this implementation is written from the format
layout the library serializes — like utils/exr.py it carries no
third-party code). Scope:

- float grids with the standard Tree4<float, 5, 4, 3> topology
  (root -> 32^3 internal -> 16^3 internal -> 8^3 leaves),
- file versions >= 222 (per-node compression metadata era),
- compression: NONE and ZIP (zlib, stdlib); BLOSC files are *gated* —
  a clear error naming the missing codec, not a crash,
- transforms: AffineMap / TranslationMap / (Uniform)ScaleMap /
  (Uniform)ScaleTranslateMap, decoded to an index->world 4x4.

Grids are returned **dense** (numpy (nx, ny, nz), index order x, y, z)
over the active bounding box — the host-voxelized representation the
device volume path already consumes (ops/texture.py sample_grid3d); VDB's
sparse tree is a CPU pointer structure with no wavefront analog, so density
is resolved at load time, exactly like the reference bakes VDB leaves
into dense tiles for CUDA textures when NanoVDB is off.

write_vdb() emits the same subset (version 224, uncompressed) so
round-trip tests and procedural-smoke assets need no external library.
"""

from __future__ import annotations

import struct
import uuid as _uuid
import zlib

import numpy as np

MAGIC = 0x56444220               # int64 " BDV" little-endian
FILE_VERSION = 224               # written; >= 222 accepted on read

# file-level compression flags (io/Compression.h)
COMPRESS_NONE = 0
COMPRESS_ZIP = 1
COMPRESS_ACTIVE_MASK = 2
COMPRESS_BLOSC = 4

# per-node value-array metadata codes (io/Compression.h)
NO_MASK_OR_INACTIVE_VALS = 0
NO_MASK_AND_MINUS_BG = 1
NO_MASK_AND_ALL_VALS = 2
MASK_AND_NO_INACTIVE_VALS = 3
MASK_AND_ONE_INACTIVE_VAL = 4
MASK_AND_TWO_INACTIVE_VALS = 5
NO_MASK_AND_ONE_INACTIVE_VAL = 6

# Tree4<float, 5, 4, 3>
LOG2 = (5, 4, 3)
DIMS = tuple(1 << b for b in LOG2)            # 32, 16, 8
SIZES = tuple(d ** 3 for d in DIMS)           # 32768, 4096, 512
# total voxel span of a node at each level (leaf=8, mid=128, top=4096)
SPANS = (1 << (5 + 4 + 3), 1 << (4 + 3), 1 << 3)

GRID_TYPE_FLOAT = "Tree_float_5_4_3"


class VdbError(ValueError):
    pass


class VdbGrid:
    """One dense grid: values[(x, y, z)] over ijk0..ijk0+shape, plus the
    index->world transform (4x4, row-vector convention world = M @ ijk)."""

    def __init__(self, name, values, ijk0, index_to_world, background=0.0,
                 meta=None):
        self.name = name
        self.values = values
        self.ijk0 = np.asarray(ijk0, np.int64)
        self.index_to_world = np.asarray(index_to_world, np.float64)
        self.background = background
        self.meta = dict(meta or {})

    @property
    def bbox_world(self):
        """(lo, hi) world AABB of the dense extent (voxel centers at
        ijk + 0.5 map through index_to_world)."""
        n = np.asarray(self.values.shape, np.float64)
        corners = []
        for cx in (0.0, n[0]):
            for cy in (0.0, n[1]):
                for cz in (0.0, n[2]):
                    ijk = self.ijk0 + (cx, cy, cz)
                    corners.append(self._xform(ijk))
        corners = np.stack(corners)
        return corners.min(0), corners.max(0)

    def _xform(self, ijk):
        m = self.index_to_world
        v = np.asarray(ijk, np.float64)
        return m[:3, :3] @ v + m[:3, 3]


# ---------------------------------------------------------------------------
# low-level stream helpers
# ---------------------------------------------------------------------------

class _R:
    def __init__(self, data):
        self.d = data
        self.o = 0

    def raw(self, n):
        if self.o + n > len(self.d):
            raise VdbError("truncated .vdb stream")
        b = self.d[self.o:self.o + n]
        self.o += n
        return b

    def u32(self):
        return struct.unpack("<I", self.raw(4))[0]

    def i32(self):
        return struct.unpack("<i", self.raw(4))[0]

    def i64(self):
        return struct.unpack("<q", self.raw(8))[0]

    def f32(self):
        return struct.unpack("<f", self.raw(4))[0]

    def f64(self, n=1):
        v = struct.unpack(f"<{n}d", self.raw(8 * n))
        return v[0] if n == 1 else np.asarray(v)

    def byte(self):
        return self.raw(1)[0]

    def string(self):
        return self.raw(self.u32()).decode("utf-8", "replace")

    def coord(self):
        return struct.unpack("<3i", self.raw(12))


def _w_string(out, s):
    b = s.encode("utf-8")
    out += struct.pack("<I", len(b)) + b
    return out


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def read_vdb(path_or_bytes):
    """Parse a .vdb file -> list[VdbGrid] (dense, float grids only)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    r = _R(data)

    if r.i64() != MAGIC:
        raise VdbError("not a .vdb file (bad magic)")
    version = r.u32()
    r.u32(), r.u32()                       # library major/minor
    has_offsets = bool(r.byte())
    if version < 222:
        raise VdbError(f"vdb file version {version} < 222 not supported "
                       "(pre-node-mask-compression era)")
    compression = r.u32()
    if compression & COMPRESS_BLOSC:
        raise VdbError(
            "vdb uses BLOSC compression — codec not available in this "
            "environment; re-export with zip or no compression")
    r.raw(36)                              # ascii uuid
    file_meta = _read_metamap(r)

    if not has_offsets:
        raise VdbError("non-seekable (delayed-load-less) .vdb streams "
                       "not supported")
    grids = []
    n_grids = r.u32()
    descs = []
    for _ in range(n_grids):
        name = r.string().split("\x1e")[0]
        gtype = r.string()
        half = gtype.endswith("_HalfFloat")
        base = gtype[:-len("_HalfFloat")] if half else gtype
        r.string()                         # instance parent name
        gpos, bpos, epos = r.i64(), r.i64(), r.i64()
        descs.append((name, base, half, gpos, bpos, epos))

    for name, gtype, half, gpos, bpos, epos in descs:
        if gtype != GRID_TYPE_FLOAT:
            raise VdbError(f"grid '{name}' has type {gtype}; only float "
                           f"({GRID_TYPE_FLOAT}) grids are supported")
        if half:
            raise VdbError(f"grid '{name}' stores half floats — "
                           "unsupported")
        gr = _R(data)
        gr.o = gpos
        grid = _read_grid(gr, name, compression, version)
        grid.meta.setdefault("file_meta", file_meta)
        grids.append(grid)
    return grids


def _read_metamap(r):
    meta = {}
    for _ in range(r.u32()):
        name = r.string()
        typ = r.string()
        val = r.raw(r.u32())
        if typ == "string":
            meta[name] = val.decode("utf-8", "replace")
        elif typ == "int64":
            meta[name] = struct.unpack("<q", val)[0]
        elif typ == "int32":
            meta[name] = struct.unpack("<i", val)[0]
        elif typ == "bool":
            meta[name] = bool(val[0])
        elif typ == "float":
            meta[name] = struct.unpack("<f", val)[0]
        elif typ == "double":
            meta[name] = struct.unpack("<d", val)[0]
        elif typ == "vec3i":
            meta[name] = struct.unpack("<3i", val)
        elif typ == "vec3d":
            meta[name] = struct.unpack("<3d", val)
        else:
            meta[name] = val
    return meta


def _read_transform(r):
    kind = r.string()
    m = np.eye(4)
    if kind == "AffineMap":
        m = np.asarray(r.f64(16)).reshape(4, 4).T  # stored row-vector
    elif kind == "TranslationMap":
        m[:3, 3] = r.f64(3)
    elif kind in ("ScaleMap", "UniformScaleMap"):
        s = r.f64(3)
        r.f64(12)                          # voxel size + cached inverses
        m[0, 0], m[1, 1], m[2, 2] = s
    elif kind in ("ScaleTranslateMap", "UniformScaleTranslateMap"):
        t = r.f64(3)
        s = r.f64(3)
        r.f64(12)
        m[0, 0], m[1, 1], m[2, 2] = s
        m[:3, 3] = t
    else:
        raise VdbError(f"unsupported vdb transform map '{kind}'")
    return m


def _read_values(r, count, compression, background, value_mask=None):
    """io::readCompressedValues — one per-node value array.

    value_mask: the node's own active-value mask; with ACTIVE_MASK
    compression and a mask-less metadata code, inactive slots are not
    stored and are refilled from it."""
    meta = r.byte()      # version >= 222 always writes the code byte
    inactive = background
    if meta in (MASK_AND_ONE_INACTIVE_VAL, MASK_AND_TWO_INACTIVE_VALS,
                NO_MASK_AND_ONE_INACTIVE_VAL):
        inactive = r.f32()
    if meta == MASK_AND_TWO_INACTIVE_VALS:
        raise VdbError("two-inactive-value node compression unsupported")
    if meta == NO_MASK_AND_MINUS_BG:
        inactive = -background

    sel = None           # True = slot NOT stored, refill with `inactive`
    if meta in (MASK_AND_NO_INACTIVE_VALS, MASK_AND_ONE_INACTIVE_VAL):
        sel = _read_mask(r, count)
    elif (compression & COMPRESS_ACTIVE_MASK) \
            and meta != NO_MASK_AND_ALL_VALS:
        # mask-less codes under active-mask compression: only the
        # node's ACTIVE values were stored
        sel = ~value_mask if value_mask is not None \
            else np.zeros(count, bool)
    stored = count - int(sel.sum()) if sel is not None else count

    if compression & COMPRESS_ZIP:
        nb = r.i64()
        if nb <= 0:
            raw = r.raw(-nb)
        else:
            raw = zlib.decompress(r.raw(nb))
        vals = np.frombuffer(raw, "<f4", count=stored).copy() \
            if stored else np.zeros(0, np.float32)
    else:
        vals = np.frombuffer(r.raw(4 * stored), "<f4").copy()

    if sel is None:
        return vals
    out = np.full(count, inactive, np.float32)
    out[~sel] = vals
    return out


def _read_mask(r, nbits):
    raw = np.frombuffer(r.raw((nbits + 7) // 8), np.uint8)
    return np.unpackbits(raw, bitorder="little")[:nbits].astype(bool)


def _read_grid(r, name, compression, version):
    grid_meta = _read_metamap(r)
    # newer archives store per-grid compression in the grid metadata,
    # overriding the file-level flags
    fc = grid_meta.get("file_compression")
    if isinstance(fc, int):
        compression = fc
        if compression & COMPRESS_BLOSC:
            raise VdbError(f"grid '{name}' uses BLOSC compression — "
                           "codec not available; re-export with zip or "
                           "no compression")
    m = _read_transform(r)

    # --- topology ---
    if r.u32() != 1:
        raise VdbError("multi-buffer trees unsupported")
    background = r.f32()
    n_tiles = r.u32()
    n_children = r.u32()

    tiles = []
    for _ in range(n_tiles):
        ijk = r.coord()
        val = r.f32()
        active = bool(r.byte())
        if active:
            tiles.append((ijk, val, SPANS[0]))

    children = []   # (origin, node-record) at top level
    leaf_records = []

    def read_internal(level):
        """Returns (child_entries, value_tiles) for one internal node."""
        size = SIZES[level]
        child_mask = _read_mask(r, size)
        value_mask = _read_mask(r, size)
        values = _read_values(r, size, compression, background, value_mask)
        kids = []
        for idx in np.nonzero(child_mask)[0]:
            if level == 1:
                # child is a leaf: topology = value mask only
                lmask = _read_mask(r, SIZES[2])
                kids.append((int(idx), ("leaf", lmask)))
            else:
                kids.append((int(idx), ("node", read_internal(level + 1))))
        vtiles = [(int(i), float(values[i]))
                  for i in np.nonzero(value_mask & ~child_mask)[0]]
        return kids, vtiles

    for _ in range(n_children):
        origin = r.coord()
        children.append((origin, read_internal(0)))

    # --- leaf buffers (same depth-first order as topology) ---
    def read_leaf_buffers(rec, origin, level):
        kids, vtiles = rec
        for idx, (kind, payload) in kids:
            off = _offset_to_ijk(idx, level)
            corigin = tuple(origin[a] + off[a] * (1 << sum(LOG2[level + 1:]))
                            for a in range(3))
            if kind == "leaf":
                lmask = payload
                vals = _read_values(r, SIZES[2], compression, background,
                                    lmask)
                leaf_records.append((corigin, vals.reshape(8, 8, 8), lmask))
            else:
                read_leaf_buffers(payload, corigin, level + 1)
        for idx, val in vtiles:
            off = _offset_to_ijk(idx, level)
            span = 1 << sum(LOG2[level + 1:])
            torigin = tuple(origin[a] + off[a] * span for a in range(3))
            tiles.append((torigin, val, span))

    for origin, rec in children:
        read_leaf_buffers(rec, origin, 0)

    return _densify(name, leaf_records, tiles, background, m, grid_meta)


def _offset_to_ijk(n, level):
    """Invert InternalNode::offsetToLocalCoord (x-major nesting)."""
    d = DIMS[level]
    x = n >> (2 * LOG2[level])
    n &= (1 << (2 * LOG2[level])) - 1
    y = n >> LOG2[level]
    z = n & (d - 1)
    return (x, y, z)


def _densify(name, leaves, tiles, background, m, meta):
    boxes = [(o, 8) for o, _, _ in leaves] + [(o, s) for o, _, s in tiles]
    if not boxes:
        return VdbGrid(name, np.zeros((1, 1, 1), np.float32), (0, 0, 0),
                       m, background, meta)
    lo = np.min([o for o, _ in boxes], 0).astype(np.int64)
    hi = np.max([np.asarray(o) + s for o, s in boxes], 0).astype(np.int64)
    shape = hi - lo
    if shape.prod() > 512 ** 3:
        raise VdbError(f"grid '{name}' dense extent {tuple(shape)} too "
                       "large to densify (cap 512^3)")
    dense = np.zeros(shape, np.float32)
    for origin, val, span in tiles:
        a = np.asarray(origin) - lo
        dense[a[0]:a[0] + span, a[1]:a[1] + span, a[2]:a[2] + span] = val
    for origin, vals, _mask in leaves:
        a = np.asarray(origin) - lo
        dense[a[0]:a[0] + 8, a[1]:a[1] + 8, a[2]:a[2] + 8] = vals
    return VdbGrid(name, dense, lo, m, background, meta)


# ---------------------------------------------------------------------------
# writer (uncompressed subset — for tests and procedural assets)
# ---------------------------------------------------------------------------

def write_vdb(path, grids, voxel_size=1.0, translate=(0.0, 0.0, 0.0),
              compression="none"):
    """Write {name: dense (nx,ny,nz) float array} as a .vdb
    (version 224, AffineMap transform: index * voxel_size + translate).
    compression: "none" | "zip" (zlib per value array)."""
    if isinstance(grids, VdbGrid):
        grids = [grids]
    if isinstance(grids, dict):
        grids = [VdbGrid(k, np.asarray(v, np.float32), (0, 0, 0),
                         _affine(voxel_size, translate))
                 for k, v in grids.items()]
    comp = {"none": COMPRESS_NONE, "zip": COMPRESS_ZIP}[compression]

    out = bytearray()
    out += struct.pack("<q", MAGIC)
    out += struct.pack("<I", FILE_VERSION)
    out += struct.pack("<II", 10, 0)             # library version
    out += b"\x01"                               # has grid offsets
    out += struct.pack("<I", comp)
    out += str(_uuid.uuid4()).encode("ascii")    # 36 chars
    out += struct.pack("<I", 0)                  # empty file metadata
    out += struct.pack("<I", len(grids))

    # descriptors with placeholder offsets
    offset_slots = []
    for g in grids:
        _w_string(out, g.name)
        _w_string(out, GRID_TYPE_FLOAT)
        _w_string(out, "")                       # instance parent
        offset_slots.append(len(out))
        out += struct.pack("<qqq", 0, 0, 0)

    for g, slot in zip(grids, offset_slots):
        gpos = len(out)
        _write_grid(out, g, comp)
        epos = len(out)
        struct.pack_into("<qqq", out, slot, gpos, epos, epos)

    with open(path, "wb") as f:
        f.write(bytes(out))


def _affine(voxel_size, translate):
    m = np.eye(4)
    m[0, 0] = m[1, 1] = m[2, 2] = float(voxel_size)
    m[:3, 3] = translate
    return m


def _write_metamap(out, meta):
    out += struct.pack("<I", len(meta))
    for k, v in meta.items():
        _w_string(out, k)
        _w_string(out, "string")
        b = str(v).encode("utf-8")
        out += struct.pack("<I", len(b)) + b


def _write_values(out, arr, comp):
    """io::writeCompressedValues — NO_MASK_AND_ALL_VALS, raw or zipped."""
    out.append(NO_MASK_AND_ALL_VALS)
    raw = np.ascontiguousarray(arr, "<f4").tobytes()
    if comp & COMPRESS_ZIP:
        z = zlib.compress(raw)
        if len(z) < len(raw):
            out.extend(struct.pack("<q", len(z)))
            out.extend(z)
        else:       # incompressible: negative count = stored raw
            out.extend(struct.pack("<q", -len(raw)))
            out.extend(raw)
    else:
        out.extend(raw)


def _write_grid(out, g, comp=COMPRESS_NONE):
    dense = np.asarray(g.values, np.float32)
    _write_metamap(out, {"name": g.name})
    # transform: AffineMap stores the 4x4 transposed (row-vector form)
    _w_string(out, "AffineMap")
    out += struct.pack("<16d", *np.asarray(g.index_to_world,
                                           np.float64).T.reshape(-1))

    out += struct.pack("<I", 1)                  # buffer count
    background = np.float32(g.background)
    out += struct.pack("<f", background)

    # place dense volume into top-level nodes aligned to 4096 grid
    ijk0 = np.asarray(g.ijk0, np.int64)
    hi = ijk0 + dense.shape
    top_lo = (ijk0 // SPANS[0]) * SPANS[0]
    tops = []
    for tx in range(int(top_lo[0]), int(hi[0]), SPANS[0]):
        for ty in range(int(top_lo[1]), int(hi[1]), SPANS[0]):
            for tz in range(int(top_lo[2]), int(hi[2]), SPANS[0]):
                tops.append((tx, ty, tz))

    out += struct.pack("<I", 0)                  # root tiles
    out += struct.pack("<I", len(tops))          # root children

    def block_of(corigin):
        """The 8^3 leaf block at corigin (background-padded)."""
        a = np.asarray(corigin) - ijk0
        block = np.full((8, 8, 8), background, np.float32)
        lo_c = np.maximum(a, 0)
        hi_c = np.minimum(a + 8, np.asarray(dense.shape))
        src = dense[lo_c[0]:hi_c[0], lo_c[1]:hi_c[1], lo_c[2]:hi_c[2]]
        block[lo_c[0] - a[0]:hi_c[0] - a[0],
              lo_c[1] - a[1]:hi_c[1] - a[1],
              lo_c[2] - a[2]:hi_c[2] - a[2]] = src
        return block

    def leaves_of(origin, level):
        """(index, child_origin) of occupied child slots, index order.
        Leaf slots whose block is all-background are omitted (sparse)."""
        span = 1 << sum(LOG2[level + 1:])
        hits = []
        rng = []
        for a in range(3):
            s = max(int(ijk0[a]) - origin[a], 0) // span
            e = -(-(min(int(hi[a]), origin[a] + span * DIMS[level])
                    - origin[a]) // span)
            rng.append(range(s, max(e, s)))
        for ox in rng[0]:
            for oy in rng[1]:
                for oz in rng[2]:
                    idx = ((ox << (2 * LOG2[level]))
                           + (oy << LOG2[level]) + oz)
                    corigin = (origin[0] + ox * span,
                               origin[1] + oy * span,
                               origin[2] + oz * span)
                    if level == 1 and not block_of(corigin).any() \
                            and background == 0:
                        continue
                    hits.append((idx, corigin))
        return sorted(hits)

    def write_internal(origin, level):
        size = SIZES[level]
        hits = leaves_of(origin, level)
        child_mask = np.zeros(size, bool)
        for idx, _ in hits:
            child_mask[idx] = True
        _write_mask(out, child_mask)
        _write_mask(out, np.zeros(size, bool))   # value mask (no tiles)
        _write_values(out, np.full(size, background, np.float32), comp)
        for idx, corigin in hits:
            if level == 1:
                _write_mask(out, np.ones(SIZES[2], bool))
            else:
                write_internal(corigin, level + 1)

    def write_leaf_buffers(origin, level):
        for idx, corigin in leaves_of(origin, level):
            if level == 1:
                _write_values(out, block_of(corigin), comp)
            else:
                write_leaf_buffers(corigin, level + 1)

    for t in tops:
        out.extend(struct.pack("<3i", *t))
        write_internal(t, 0)
    for t in tops:
        write_leaf_buffers(t, 0)


def _write_mask(out, bits):
    out += np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()
