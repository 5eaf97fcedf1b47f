"""Binned-SAH BVH2 builder (ref: bvh/bvh_build.cpp BVHBuild::run,
bvh/bvh_binning.cpp; packed layout ref: bvh/bvh2.h, bvh/bvh.h:46-77).

Differences from the reference, driven by wavefront traversal:

- The packed node layout is SoA arrays sized for *batched row gathers*:
    bounds   (M, 12) float32 — child0 lo/hi, child1 lo/hi
    children (M, 2)  int32   — >=0: inner child node index;
                                <0: leaf, encoding (prim_start, count)
  One f32 gather + one i32 gather per traversal step for a whole ray
  wavefront, vs the reference's int4-texture fetches per thread.
- Primitives are reordered so each leaf's primitives are contiguous
  (prim_order), so leaf intersection is a dense slice gather.
- Build runs host-side at scene sync (NumPy vectorized binning; a C++
  builder with identical output is used when available — see
  native/bvh_builder.cpp).

Leaf encoding: child = -(1 + (start << 4) + count), count in [0, 15].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NUM_BINS = 16          # ref: bvh_binning uses up to 32; 16 is plenty
MAX_LEAF_SIZE = 4      # ref: BVHParams::max_triangle_leaf_size = 8
LEAF_SENTINEL = np.int32(-0x7FFFFFFF)


def encode_leaf(start, count):
    return -(1 + (int(start) << 4) + int(count))


def decode_leaf(child):
    v = -int(child) - 1
    return v >> 4, v & 15


def tree_depth(children, root=0):
    """Max node depth reachable from `root` (host-side, vectorized BFS).

    Bounds the far-child stack occupancy of the lockstep traversal —
    the scene packer sizes the device traversal stack from this so
    overflow is impossible by construction (a fixed 48-entry stack
    would silently drop entries on deep trees)."""
    children = np.asarray(children)
    if len(children) == 0:
        return 1
    frontier = np.array([root], np.int64)
    depth = 0
    while len(frontier):
        depth += 1
        nxt = children[frontier].reshape(-1)
        frontier = nxt[nxt >= 0]
        if depth > len(children) + 1:  # cycle guard
            raise ValueError("BVH children contain a cycle")
    return depth


@dataclass
class BVHArrays:
    bounds: np.ndarray     # (M, 12) f32
    children: np.ndarray   # (M, 2) i32
    prim_order: np.ndarray  # (P,) i32 — new position -> original prim index
    root_bound_lo: np.ndarray
    root_bound_hi: np.ndarray

    @property
    def num_nodes(self):
        return len(self.bounds)


def build_bvh(lo, hi, max_leaf_size=MAX_LEAF_SIZE, use_native=None):
    """Build a BVH2 over primitives with AABBs [lo, hi] ((P, 3) each).

    Returns BVHArrays. Works for triangles (BLAS) and object instances
    (TLAS) alike — the caller decides what a 'primitive' is.

    use_native: True/False/None(auto) — the C++ builder
    (native/bvh_builder.cpp) takes over for big prim counts.
    """
    lo = np.asarray(lo, np.float32).reshape(-1, 3)
    hi = np.asarray(hi, np.float32).reshape(-1, 3)
    nprims = len(lo)

    if use_native is None:
        use_native = nprims >= 2048
    if use_native and nprims > 0:
        from raytracingproject_tpu import native
        res = native.build_bvh_native(lo, hi, max_leaf_size)
        if res is not None:
            bounds, children, order = res
            return BVHArrays(bounds, children, order, lo.min(0), hi.max(0))

    cent = 0.5 * (lo + hi)

    if nprims == 0:
        bounds = np.zeros((1, 12), np.float32)
        children = np.full((1, 2), encode_leaf(0, 0), np.int32)
        return BVHArrays(bounds, children, np.zeros(0, np.int32),
                         np.zeros(3, np.float32), np.zeros(3, np.float32))

    order = np.arange(nprims, dtype=np.int32)

    bounds_list = []
    children_list = []
    prim_out = []

    def new_node():
        bounds_list.append(np.zeros(12, np.float32))
        children_list.append(np.zeros(2, np.int32))
        return len(bounds_list) - 1

    def leaf_child(idx_range):
        start = len(prim_out)
        prim_out.extend(order[idx_range].tolist())
        return encode_leaf(start, len(idx_range))

    def range_bounds(idx):
        return lo[idx].min(0), hi[idx].max(0)

    def split_range(idx):
        """Pick SAH binned split; returns (left_idx, right_idx) or None
        for make-leaf. (ref: bvh_binning.cpp bin_splits)"""
        n = len(idx)
        if n <= max_leaf_size:
            return None
        clo = cent[idx].min(0)
        chi = cent[idx].max(0)
        ext = chi - clo
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            # Degenerate centroids: median split to bound leaf size.
            half = n // 2
            return idx[:half], idx[half:]
        # bin primitives along the widest centroid axis
        scale = NUM_BINS * (1.0 - 1e-6) / ext[axis]
        bin_ids = ((cent[idx, axis] - clo[axis]) * scale).astype(np.int32)
        # per-bin counts and bounds via vectorized min/max-at
        counts = np.bincount(bin_ids, minlength=NUM_BINS)
        blo = np.full((NUM_BINS, 3), np.inf, np.float32)
        bhi = np.full((NUM_BINS, 3), -np.inf, np.float32)
        np.minimum.at(blo, bin_ids, lo[idx])
        np.maximum.at(bhi, bin_ids, hi[idx])
        # sweep left->right and right->left for SAH
        def areas(l, h):
            d = np.maximum(h - l, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
        llo = np.minimum.accumulate(blo, 0)
        lhi = np.maximum.accumulate(bhi, 0)
        rlo = np.minimum.accumulate(blo[::-1], 0)[::-1]
        rhi = np.maximum.accumulate(bhi[::-1], 0)[::-1]
        lcount = np.cumsum(counts)
        # split after bin i: left = bins[0..i], right = bins[i+1..]
        rcount = n - lcount[:-1]
        sah = (areas(llo, lhi)[:-1] * lcount[:-1]
               + areas(rlo, rhi)[1:] * rcount)
        valid = (lcount[:-1] > 0) & (rcount > 0)
        if not valid.any():
            half = n // 2
            part = np.argsort(cent[idx, axis], kind="stable")
            return idx[part[:half]], idx[part[half:]]
        sah = np.where(valid, sah, np.inf)
        best = int(np.argmin(sah))
        mask = bin_ids <= best
        left, right = idx[mask], idx[~mask]
        # SAH leaf test (ref: bvh_build.cpp:572-600): compare split cost
        # against leaf cost when the range could still be a leaf.
        # (disabled for max_leaf_size == 1, e.g. TLAS instance leaves)
        if max_leaf_size > 1 and n <= 8:  # LEAF_UNROLL bound
            plo, phi = range_bounds(idx)
            whole = max(areas(plo[None], phi[None])[0], 1e-20)
            leaf_cost = n
            split_cost = 0.125 + (sah[best] / whole)
            if split_cost >= leaf_cost:
                return None
        return left, right

    # iterative top-down build (explicit stack avoids recursion limits)
    root = new_node()
    stack = [(root, order)]
    while stack:
        node_id, idx = stack.pop()
        sp = split_range(idx)
        if sp is None:
            # single-leaf node: child0 = leaf, child1 = empty leaf
            b = np.zeros(12, np.float32)
            plo, phi = range_bounds(idx)
            b[0:3], b[3:6] = plo, phi
            b[6:9], b[9:12] = np.inf, -np.inf  # empty child1 never hits
            bounds_list[node_id] = b
            children_list[node_id] = np.array(
                [leaf_child(idx), encode_leaf(0, 0)], np.int32)
            continue
        left, right = sp
        b = np.zeros(12, np.float32)
        llo_, lhi_ = range_bounds(left)
        rlo_, rhi_ = range_bounds(right)
        b[0:3], b[3:6] = llo_, lhi_
        b[6:9], b[9:12] = rlo_, rhi_
        bounds_list[node_id] = b
        kids = np.zeros(2, np.int32)
        # child creation: leaf if small enough post-split
        for k, part in enumerate((left, right)):
            if len(part) <= max_leaf_size:
                kids[k] = leaf_child(part)
            else:
                cid = new_node()
                kids[k] = cid
                stack.append((cid, part))
        children_list[node_id] = kids

    bounds = np.asarray(bounds_list, np.float32)
    children = np.asarray(children_list, np.int32)
    prim_order = np.asarray(prim_out, np.int32)
    rlo, rhi = lo.min(0), hi.max(0)
    return BVHArrays(bounds, children, prim_order, rlo, rhi)


def triangle_bounds(verts, tris):
    """Per-triangle AABBs from (V, 3) verts and (T, 3) indices."""
    v = verts[tris]  # (T, 3, 3)
    return v.min(1), v.max(1)


# ---------------------------------------------------------------------------
# Host-side reference traversal (golden tests for the device kernels)
# ---------------------------------------------------------------------------

def intersect_ray_np(bvh: BVHArrays, tri_verts, ray_o, ray_d, tmax=1e30):
    """Single-ray NumPy traversal. tri_verts: (P, 3, 3) *already in
    prim_order*. Returns (t, prim, u, v) with prim=-1 for miss."""
    inv_d = np.where(np.abs(ray_d) > 1e-20, 1.0 / ray_d, 1e20)
    best = (np.float32(tmax), -1, 0.0, 0.0)
    stack = [0]
    while stack:
        node = stack.pop()
        if node < 0:
            start, count = decode_leaf(node)
            for i in range(start, start + count):
                t, u, v = _wt_intersect_np(tri_verts[i], ray_o, ray_d)
                if t is not None and 1e-6 < t < best[0]:
                    best = (t, i, u, v)
            continue
        b = bvh.bounds[node]
        c = bvh.children[node]
        for k in range(2):
            blo, bhi = b[6 * k:6 * k + 3], b[6 * k + 3:6 * k + 6]
            t0 = (blo - ray_o) * inv_d
            t1 = (bhi - ray_o) * inv_d
            tn = np.minimum(t0, t1).max()
            tf = np.maximum(t0, t1).min()
            if tn <= tf and tf >= 0 and tn < best[0]:
                stack.append(int(c[k]))
    return best


def _wt_intersect_np(tri, o, d):
    """float32 NumPy twin of ops/intersect.py watertight_setup/_test
    (ref: util/util_math_intersect.h:88) — the golden single-ray
    triangle test. Same shear-basis formulation, same operation order,
    all in np.float32 so results match the device kernel bit-for-bit."""
    f = np.float32
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    tri = np.asarray(tri, np.float32)
    ad = np.abs(d)
    if ad[2] >= ad[0] and ad[2] >= ad[1]:
        kz = 2
    elif ad[1] >= ad[0]:
        kz = 1
    else:
        kz = 0
    if ad.max() == 0.0:
        return None, 0, 0
    if d[kz] < 0.0:
        kx, ky = (kz + 2) % 3, (kz + 1) % 3
    else:
        kx, ky = (kz + 1) % 3, (kz + 2) % 3
    inv_kz = f(1.0) / d[kz]
    sx, sy, sz = d[kx] * inv_kz, d[ky] * inv_kz, inv_kz
    ex = np.zeros(3, np.float32)
    ey = np.zeros(3, np.float32)
    ez = np.zeros(3, np.float32)
    ex[kx] = 1.0
    ey[ky] = 1.0
    ez[kz] = 1.0
    rx = ex - sx * ez
    ry = ey - sy * ez
    rz = sz * ez
    rxo = f(rx[0] * o[0] + rx[1] * o[1] + rx[2] * o[2])
    ryo = f(ry[0] * o[0] + ry[1] * o[1] + ry[2] * o[2])
    rzo = f(rz[0] * o[0] + rz[1] * o[1] + rz[2] * o[2])

    def shear(v):
        return (f(rx[0] * v[0] + rx[1] * v[1] + rx[2] * v[2]) - rxo,
                f(ry[0] * v[0] + ry[1] * v[1] + ry[2] * v[2]) - ryo,
                f(rz[0] * v[0] + rz[1] * v[1] + rz[2] * v[2]) - rzo)

    axs, ays, azs = shear(tri[0])
    bxs, bys, bzs = shear(tri[1])
    cxs, cys, czs = shear(tri[2])
    eps = f(4.0 * 2.0 ** -23)  # = ops/intersect.py _WT_EPS

    def edge(px, py, qx, qy):
        p1, p2 = f(px * qy), f(py * qx)
        return f(p1 - p2), f(eps * (abs(p1) + abs(p2)))

    w_a, tol_a = edge(bxs, bys, cxs, cys)
    w_b, tol_b = edge(cxs, cys, axs, ays)
    w_c, tol_c = edge(axs, ays, bxs, bys)
    sign_ok = (w_a >= -tol_a and w_b >= -tol_b and w_c >= -tol_c) \
        or (w_a <= tol_a and w_b <= tol_b and w_c <= tol_c)
    det = f(w_a + w_b + w_c)
    if not sign_ok or det == 0.0:
        return None, 0, 0
    inv = f(1.0) / det
    t = f(f(w_a * azs + w_b * bzs + w_c * czs) * inv)
    u = min(max(f(w_b * inv), f(0.0)), f(1.0))
    v = min(max(f(w_c * inv), f(0.0)), f(1.0))
    return (t, u, v) if t > 0 else (None, 0, 0)


def refit_bvh(bvh, lo, hi):
    """Refit node bounds in place for deformed primitive AABBs with
    UNCHANGED topology (ref: bvh/bvh.cpp BVH::refit,
    bvh/bvh2.cpp BVH2::refit_node) — the cheap update path for
    animation/deformation between frames.

    Both the NumPy and native builders allocate child nodes after their
    parent, so node ids are topologically sorted and one reverse sweep
    visits children before parents (bottom-up).
    """
    lo = np.asarray(lo, np.float32).reshape(-1, 3)
    hi = np.asarray(hi, np.float32).reshape(-1, 3)
    m = bvh.num_nodes
    node_lo = np.zeros((m, 3), np.float32)
    node_hi = np.zeros((m, 3), np.float32)
    order = bvh.prim_order
    for i in range(m - 1, -1, -1):
        b = bvh.bounds[i]
        for k in (0, 1):
            c = int(bvh.children[i, k])
            if c >= 0:
                clo, chi = node_lo[c], node_hi[c]
            else:
                start, count = decode_leaf(c)
                if count == 0:
                    clo = np.full(3, np.inf, np.float32)
                    chi = np.full(3, -np.inf, np.float32)
                else:
                    prims = order[start:start + count]
                    clo = lo[prims].min(0)
                    chi = hi[prims].max(0)
            b[6 * k:6 * k + 3] = clo
            b[6 * k + 3:6 * k + 6] = chi
        node_lo[i] = np.minimum(b[0:3], b[6:9])
        node_hi[i] = np.maximum(b[3:6], b[9:12])
    if len(lo):
        bvh.root_bound_lo = lo.min(0)
        bvh.root_bound_hi = hi.max(0)
    return bvh


# ---------------------------------------------------------------------------
# spatial splits (ref: bvh/bvh_split.cpp BVHSpatialSplit; enabled per
# BVHParams::use_spatial_split + spatial_split_alpha, bvh_build.cpp:390)
# ---------------------------------------------------------------------------

def _clip_tri_slab_bounds(verts, axis, p_lo, p_hi):
    """Bounds of triangle polygons clipped to the slab
    p_lo <= x[axis] <= p_hi. verts: (M, 3, 3). Returns (lo, hi) (M, 3)
    with +inf/-inf rows when a polygon misses the slab entirely —
    vectorized Sutherland-Hodgman against the two axis planes (ref:
    bvh_split.cpp split_triangle_primitive / clip polygon)."""
    m = len(verts)
    if m == 0:
        return (np.full((0, 3), np.inf, np.float32),
                np.full((0, 3), -np.inf, np.float32))
    # polygon as padded vertex list: after clipping by 2 planes a
    # triangle has at most 5 vertices
    MAXV = 5
    poly = np.full((m, MAXV, 3), np.nan, np.float64)
    poly[:, :3] = verts
    nv = np.full(m, 3, np.int64)

    def clip(poly, nv, keep_ge, plane):
        sd = poly[..., axis] - plane
        if keep_ge:
            inside = sd >= 0.0
        else:
            inside = sd <= 0.0
        out_poly = np.full((m, MAXV, 3), np.nan, np.float64)
        out_nv = np.zeros(m, np.int64)
        # sequential over the (<= 5) polygon slots, vectorized over M
        for i in range(MAXV):
            valid_i = i < nv
            j = np.where(valid_i, (i + 1) % np.maximum(nv, 1), 0)
            cur = poly[np.arange(m), i]
            nxt = poly[np.arange(m), j]
            cur_in = inside[np.arange(m), i] & valid_i
            nxt_in = inside[np.arange(m), j] & valid_i
            # emit cur if inside
            emit_cur = cur_in
            idx = out_nv.copy()
            sel = emit_cur
            out_poly[sel, idx[sel]] = cur[sel]
            out_nv += emit_cur
            # emit intersection if the edge crosses the plane
            cross = valid_i & (cur_in != nxt_in)
            denom = nxt[:, axis] - cur[:, axis]
            tpar = np.where(np.abs(denom) > 1e-30,
                            (plane - cur[:, axis])
                            / np.where(denom == 0, 1.0, denom), 0.0)
            pint = cur + np.clip(tpar, 0.0, 1.0)[:, None] * (nxt - cur)
            pint[:, axis] = plane  # exact on the plane
            idx = out_nv.copy()
            sel = cross
            out_poly[sel, idx[sel]] = pint[sel]
            out_nv += cross
        return out_poly, out_nv

    poly, nv = clip(poly, nv, True, float(p_lo))
    poly, nv = clip(poly, nv, False, float(p_hi))
    slot = np.arange(MAXV)[None, :, None]
    live = slot < nv[:, None, None]
    lo = np.where(live, poly, np.inf).min(1)
    hi = np.where(live, poly, -np.inf).max(1)
    empty = nv == 0
    lo[empty] = np.inf
    hi[empty] = -np.inf
    return lo.astype(np.float32), hi.astype(np.float32)


def _sah_areas(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


def build_bvh_spatial(lo, hi, tri_verts=None, max_leaf_size=MAX_LEAF_SIZE,
                      alpha=1e-5, max_dup_factor=2.0):
    """Reference-based binned-SAH build with SPATIAL splits (ref:
    bvh/bvh_split.cpp BVHSpatialSplit; gate per bvh_build.cpp:390
    `spatial_split_alpha`).

    Straddling primitives may be CLIPPED into both children as separate
    references (duplicated rows in prim_order), so long/diagonal
    triangles stop inflating both child boxes. Child bounds of split
    references are polygon-clipped when tri_verts (P, 3, 3) is given,
    AABB-clipped otherwise. Total references are capped at
    max_dup_factor x P (the reference's duplication budget); past the
    cap nodes fall back to object splits. The reference's "unsplitting"
    refinement (moving a straddler wholly to one side when cheaper) is
    not implemented.
    """
    lo = np.asarray(lo, np.float32).reshape(-1, 3)
    hi = np.asarray(hi, np.float32).reshape(-1, 3)
    nprims = len(lo)
    if nprims == 0:
        return build_bvh(lo, hi, max_leaf_size)
    max_refs = int(max_dup_factor * nprims) + 8

    ref_lo = [lo[i] for i in range(nprims)]
    ref_hi = [hi[i] for i in range(nprims)]
    ref_prim = list(range(nprims))

    root_area = float(_sah_areas(lo.min(0)[None], hi.max(0)[None])[0])
    min_overlap = alpha * max(root_area, 1e-20)

    bounds_list = []
    children_list = []
    prim_out = []

    def new_node():
        bounds_list.append(np.zeros(12, np.float32))
        children_list.append(np.zeros(2, np.int32))
        return len(bounds_list) - 1

    def leaf_child(idx):
        start = len(prim_out)
        prim_out.extend(ref_prim[i] for i in idx)
        return encode_leaf(start, len(idx))

    def node_bounds(idx):
        rl = np.stack([ref_lo[i] for i in idx])
        rh = np.stack([ref_hi[i] for i in idx])
        return rl, rh

    def split_refs(idx):
        """-> None (leaf) or (left_idx, right_idx) over ref ids;
        spatial splits append new refs."""
        n = len(idx)
        if n <= max_leaf_size:
            return None
        rl, rh = node_bounds(idx)
        cent = 0.5 * (rl + rh)
        clo, chi = cent.min(0), cent.max(0)
        ext = chi - clo
        axis = int(np.argmax(ext))
        obj = None            # (cost, mask) object-split candidate
        if ext[axis] > 1e-12:
            scale = NUM_BINS * (1.0 - 1e-6) / ext[axis]
            bin_ids = ((cent[:, axis] - clo[axis]) * scale).astype(np.int32)
            counts = np.bincount(bin_ids, minlength=NUM_BINS)
            blo = np.full((NUM_BINS, 3), np.inf, np.float32)
            bhi = np.full((NUM_BINS, 3), -np.inf, np.float32)
            np.minimum.at(blo, bin_ids, rl)
            np.maximum.at(bhi, bin_ids, rh)
            llo = np.minimum.accumulate(blo, 0)
            lhi = np.maximum.accumulate(bhi, 0)
            rlo = np.minimum.accumulate(blo[::-1], 0)[::-1]
            rhi = np.maximum.accumulate(bhi[::-1], 0)[::-1]
            lcount = np.cumsum(counts)
            rcount = n - lcount[:-1]
            sah = (_sah_areas(llo[:-1], lhi[:-1]) * lcount[:-1]
                   + _sah_areas(rlo[1:], rhi[1:]) * rcount)
            valid = (lcount[:-1] > 0) & (rcount > 0)
            if valid.any():
                sah = np.where(valid, sah, np.inf)
                best = int(np.argmin(sah))
                # overlap gate for trying the spatial split
                olo = np.maximum(llo[best], rlo[best + 1])
                ohi = np.minimum(lhi[best], rhi[best + 1])
                overlap = float(_sah_areas(olo[None], ohi[None])[0]) \
                    if (ohi > olo).all() else 0.0
                obj = (float(sah[best]), bin_ids <= best, overlap)

        spatial = None        # (cost, plane, axis, b0, b1)
        nlo, nhi = rl.min(0), rh.max(0)
        sp_axis = int(np.argmax(nhi - nlo))
        sp_ext = float(nhi[sp_axis] - nlo[sp_axis])
        try_spatial = (obj is None or obj[2] > min_overlap) \
            and sp_ext > 1e-12 and len(ref_prim) < max_refs
        if try_spatial:
            sscale = NUM_BINS * (1.0 - 1e-6) / sp_ext
            b0 = np.clip(((rl[:, sp_axis] - nlo[sp_axis]) * sscale)
                         .astype(np.int32), 0, NUM_BINS - 1)
            b1 = np.clip(((rh[:, sp_axis] - nlo[sp_axis]) * sscale)
                         .astype(np.int32), 0, NUM_BINS - 1)
            sblo = np.full((NUM_BINS, 3), np.inf, np.float32)
            sbhi = np.full((NUM_BINS, 3), -np.inf, np.float32)
            bw = sp_ext / NUM_BINS
            for b in range(NUM_BINS):
                m = (b0 <= b) & (b1 >= b)
                if not m.any():
                    continue
                p_lo = nlo[sp_axis] + b * bw
                p_hi = p_lo + bw
                sub = np.nonzero(m)[0]
                if tri_verts is not None:
                    pr = np.asarray([ref_prim[idx[i]] for i in sub])
                    cl, ch = _clip_tri_slab_bounds(
                        tri_verts[pr], sp_axis, p_lo, p_hi)
                    # stay inside the (possibly already-clipped) ref box
                    cl = np.maximum(cl, rl[sub])
                    ch = np.minimum(ch, rh[sub])
                else:
                    cl, ch = rl[sub].copy(), rh[sub].copy()
                    cl[:, sp_axis] = np.maximum(cl[:, sp_axis], p_lo)
                    ch[:, sp_axis] = np.minimum(ch[:, sp_axis], p_hi)
                ok = (ch >= cl).all(1)
                if ok.any():
                    sblo[b] = np.minimum(sblo[b], cl[ok].min(0))
                    sbhi[b] = np.maximum(sbhi[b], ch[ok].max(0))
            enter = np.bincount(b0, minlength=NUM_BINS)
            exit_ = np.bincount(b1, minlength=NUM_BINS)
            sllo = np.minimum.accumulate(sblo, 0)
            slhi = np.maximum.accumulate(sbhi, 0)
            srlo = np.minimum.accumulate(sblo[::-1], 0)[::-1]
            srhi = np.maximum.accumulate(sbhi[::-1], 0)[::-1]
            lc = np.cumsum(enter)[:-1]
            rc = n - np.cumsum(exit_)[:-1]
            ssah = (_sah_areas(sllo[:-1], slhi[:-1]) * lc
                    + _sah_areas(srlo[1:], srhi[1:]) * rc)
            svalid = (lc > 0) & (rc > 0)
            if svalid.any():
                ssah = np.where(svalid, ssah, np.inf)
                sbest = int(np.argmin(ssah))
                plane = nlo[sp_axis] + (sbest + 1) * bw
                spatial = (float(ssah[sbest]), plane, sp_axis, b0, b1,
                           sbest)

        use_spatial = spatial is not None and \
            (obj is None or spatial[0] < obj[0])
        if use_spatial:
            _, plane, sax, b0, b1, sbest = spatial
            left, right = [], []
            for i_loc, rid in enumerate(idx):
                if b1[i_loc] <= sbest:
                    left.append(rid)
                elif b0[i_loc] > sbest:
                    right.append(rid)
                else:
                    # straddler: clip into both sides
                    if tri_verts is not None:
                        pr = ref_prim[rid]
                        ll, lh = _clip_tri_slab_bounds(
                            tri_verts[pr][None], sax, -np.inf, plane)
                        rll, rlh = _clip_tri_slab_bounds(
                            tri_verts[pr][None], sax, plane, np.inf)
                        ll, lh = ll[0], lh[0]
                        rll, rlh = rll[0], rlh[0]
                        ll = np.maximum(ll, ref_lo[rid])
                        lh = np.minimum(lh, ref_hi[rid])
                        rll = np.maximum(rll, ref_lo[rid])
                        rlh = np.minimum(rlh, ref_hi[rid])
                    else:
                        ll, lh = ref_lo[rid].copy(), ref_hi[rid].copy()
                        lh[sax] = min(lh[sax], plane)
                        rll, rlh = ref_lo[rid].copy(), ref_hi[rid].copy()
                        rll[sax] = max(rll[sax], plane)
                    l_ok = (lh >= ll).all()
                    r_ok = (rlh >= rll).all()
                    if l_ok and r_ok and len(ref_prim) < max_refs:
                        ref_lo[rid], ref_hi[rid] = ll, lh
                        left.append(rid)
                        ref_lo.append(rll)
                        ref_hi.append(rlh)
                        ref_prim.append(ref_prim[rid])
                        right.append(len(ref_prim) - 1)
                    elif r_ok and not l_ok:
                        right.append(rid)
                    else:
                        left.append(rid)
            if left and right:
                return np.asarray(left), np.asarray(right)

        if obj is not None:
            mask = obj[1]
            return idx[mask], idx[~mask]
        # degenerate: median split on the widest axis
        part = np.argsort(cent[:, axis], kind="stable")
        half = n // 2
        return idx[part[:half]], idx[part[half:]]

    root = new_node()
    stack = [(root, np.arange(nprims))]
    while stack:
        node_id, idx = stack.pop()
        idx = np.asarray(idx)
        sp = split_refs(idx)
        if sp is None:
            b = np.zeros(12, np.float32)
            rl, rh = node_bounds(idx)
            b[0:3], b[3:6] = rl.min(0), rh.max(0)
            b[6:9], b[9:12] = np.inf, -np.inf
            bounds_list[node_id] = b
            children_list[node_id] = np.array(
                [leaf_child(idx), encode_leaf(0, 0)], np.int32)
            continue
        left, right = sp
        b = np.zeros(12, np.float32)
        ll_, lh_ = node_bounds(left)
        rl_, rh_ = node_bounds(right)
        b[0:3], b[3:6] = ll_.min(0), lh_.max(0)
        b[6:9], b[9:12] = rl_.min(0), rh_.max(0)
        bounds_list[node_id] = b
        kids = np.zeros(2, np.int32)
        for k, part in enumerate((left, right)):
            if len(part) <= max_leaf_size:
                kids[k] = leaf_child(part)
            else:
                cid = new_node()
                kids[k] = cid
                stack.append((cid, part))
        children_list[node_id] = kids

    return BVHArrays(np.asarray(bounds_list, np.float32),
                     np.asarray(children_list, np.int32),
                     np.asarray(prim_out, np.int32),
                     lo.min(0), hi.max(0))
