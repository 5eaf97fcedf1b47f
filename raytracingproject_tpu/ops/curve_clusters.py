"""Oriented (unaligned) curve-segment clusters — hair traversal.

The analog of the reference's unaligned BVH nodes for hair
(ref: bvh/bvh_unaligned.{h,cpp}, kernel/bvh/bvh_traversal.h): long thin
curve clusters fit axis-aligned boxes terribly, so each cluster of K
consecutive segments (strand order = spatial coherence) carries its own
ROTATED frame — the dominant strand direction as local z — and a tight
local-space AABB dilated by the max radius. The entry test transforms
every ray into the cluster frame (3 dots per axis, dense (C, N) VPU
math — no per-lane divergence) and slab-tests the local box, exactly
how the reference's unaligned nodes test `aligned_space` boxes, but
vectorized cluster-major instead of per-thread.

Traversal mirrors ops/cluster_intersect.py's shortlist walk: per-lane
nearest live cluster by select-reduction, one row gather per iteration,
K in-lane ribbon tests per fetched row. Replaces the dense all-segments sweep of
ops/intersect.py intersect_curves_ribbon above the packing threshold
(models/scene.py CURVE_CLUSTER_MIN_SEGS); both paths share
_curve_block_test-equivalent math, so hits agree.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from raytracingproject_tpu.utils import precision as prec
from raytracingproject_tpu.utils.math import RAY_TMAX

META_COLS = 16   # R (9 row-major) + lo (3) + hi (3) + seg_start (1)
SEG_COLS = 10    # p0 (3) + e (3) + r0 + r1 + obj + vis
INF = np.float32(3e38)


def build_curve_cluster_table(seg_p0, seg_e, seg_r0, seg_r1, seg_object,
                              seg_vis, cluster_segs=16):
    """Host-side packing: consecutive strand-order segments grouped
    into clusters of <= cluster_segs, each with an oriented frame.

    Returns (C, META_COLS + SEG_COLS*K) f32; payloads finite < 2^24."""
    s = len(seg_p0)
    k = int(cluster_segs)
    c = (s + k - 1) // k
    table = np.zeros((c, META_COLS + SEG_COLS * k), np.float32)
    p1 = seg_p0 + seg_e
    for ci in range(c):
        a, b = ci * k, min(ci * k + k, s)
        e = seg_e[a:b]
        # dominant direction; degenerate clusters fall back to +z
        zax = e.sum(0)
        nz = np.linalg.norm(zax)
        zax = zax / nz if nz > 1e-12 else np.array([0.0, 0.0, 1.0])
        up = np.array([1.0, 0.0, 0.0]) if abs(zax[0]) < 0.9 \
            else np.array([0.0, 1.0, 0.0])
        xax = np.cross(up, zax)
        xax /= max(np.linalg.norm(xax), 1e-12)
        yax = np.cross(zax, xax)
        R = np.stack([xax, yax, zax])           # rows: world -> local
        pts = np.concatenate([seg_p0[a:b], p1[a:b]]) @ R.T
        rmax = float(np.maximum(seg_r0[a:b], seg_r1[a:b]).max()
                     if b > a else 0.0)
        lo = pts.min(0) - rmax
        hi = pts.max(0) + rmax
        row = table[ci]
        row[0:9] = R.reshape(-1)
        row[9:12] = lo
        row[12:15] = hi
        row[15] = float(a)
        for j in range(b - a):
            o = META_COLS + SEG_COLS * j
            row[o:o + 3] = seg_p0[a + j]
            row[o + 3:o + 6] = seg_e[a + j]
            row[o + 6] = seg_r0[a + j]
            row[o + 7] = seg_r1[a + j]
            row[o + 8] = float(seg_object[a + j])
            row[o + 9] = float(seg_vis[a + j])
        for j in range(b - a, k):
            o = META_COLS + SEG_COLS * j
            row[o + 8] = -1.0   # padding: never hits
    assert np.isfinite(table).all()
    assert abs(table[:, 15]).max() < (1 << 24) if c else True
    return table


def _entry_table_oriented(ctable, o, d, tmin, tmax):
    """(C, N) entry distance through each cluster's ORIENTED box."""
    c = ctable.shape[0]
    n = o.shape[0]
    tn = jnp.full((c, n), -INF, prec.FT)
    tf = jnp.full((c, n), INF, prec.FT)
    for ax in range(3):
        r0 = ctable[:, 3 * ax + 0, None]
        r1 = ctable[:, 3 * ax + 1, None]
        r2 = ctable[:, 3 * ax + 2, None]
        o_l = r0 * o[None, :, 0] + r1 * o[None, :, 1] \
            + r2 * o[None, :, 2]
        d_l = r0 * d[None, :, 0] + r1 * d[None, :, 1] \
            + r2 * d[None, :, 2]
        inv = jnp.where(jnp.abs(d_l) > 1e-20,
                        1.0 / jnp.where(d_l == 0, 1.0, d_l),
                        jnp.where(d_l >= 0, 1e20, -1e20))
        t0 = (ctable[:, 9 + ax, None] - o_l) * inv
        t1 = (ctable[:, 12 + ax, None] - o_l) * inv
        tn = jnp.maximum(tn, jnp.minimum(t0, t1))
        tf = jnp.minimum(tf, jnp.maximum(t0, t1))
    ok = (tn <= tf) & (tf >= tmin[None]) & (tn <= tmax[None])
    return jnp.where(ok, jnp.maximum(tn, tmin[None]), INF)


def _walk_chunk(ctable, cluster_segs, prim_base, o, d, tmin, tmax,
                visibility, shadow_any_hit, hit0):
    n = o.shape[0]
    c = ctable.shape[0]
    entry = _entry_table_oriented(ctable, o, d, tmin, tmax)
    cids = jax.lax.broadcasted_iota(jnp.int32, (c, 1), 0)
    oc = [o[:, i] for i in range(3)]
    dc = [d[:, i] for i in range(3)]
    a_dd = sum(dc[i] * dc[i] for i in range(3))

    state = (entry, hit0["t"], hit0["prim"], hit0["u"], hit0["v"],
             hit0["object"], jnp.int32(0), jnp.bool_(True))

    def cond(st):
        return st[7] & (st[6] < c)

    def body(st):
        entry, t_best, prim_b, u_b, v_b, obj_b, it, _ = st
        gate = jnp.where(shadow_any_hit & (prim_b >= 0),
                         -INF, jnp.minimum(t_best, INF)) \
            if shadow_any_hit else jnp.minimum(t_best, INF)
        e_min = jnp.min(entry, axis=0)
        win = entry == e_min[None]
        cid = jnp.maximum(jnp.max(jnp.where(win, cids, -1), axis=0), 0)
        active = e_min < gate

        row = ctable[cid].T

        seg_start = row[15]
        for kk in range(cluster_segs):
            base = META_COLS + SEG_COLS * kk
            p0c = [row[base + i] for i in range(3)]
            ec = [row[base + 3 + i] for i in range(3)]
            r0 = row[base + 6]
            r1 = row[base + 7]
            so = row[base + 8]
            sv = row[base + 9].astype(jnp.uint32)
            # per-lane ribbon test (same math as intersect.py
            # _curve_block_test, lane-major: every term is (N,))
            w0c = [p0c[i] - oc[i] for i in range(3)]
            bb = sum(dc[i] * ec[i] for i in range(3))
            cc = sum(ec[i] * ec[i] for i in range(3))
            dw = sum(dc[i] * w0c[i] for i in range(3))
            ew = sum(ec[i] * w0c[i] for i in range(3))
            denom = a_dd * cc - bb * bb
            s_al = jnp.where(denom > 1e-20,
                             (bb * dw - a_dd * ew)
                             / jnp.where(denom > 1e-20, denom, 1.0), 0.0)
            s_al = jnp.clip(s_al, 0.0, 1.0)
            t = (dw + bb * s_al) / a_dd
            Cc = [t * dc[i] - s_al * ec[i] - w0c[i] for i in range(3)]
            dist2 = sum(Cc[i] * Cc[i] for i in range(3))
            r = r0 + (r1 - r0) * s_al
            inside = jnp.maximum(r * r - dist2, 0.0)
            t = t - jnp.sqrt(inside / a_dd)
            hit = (dist2 <= r * r) & (t > tmin) & (t < t_best) \
                & (cc > 1e-20) & active & (so >= 0.0)
            hit &= (sv & visibility) > 0
            nx = dc[1] * ec[2] - dc[2] * ec[1]
            ny = dc[2] * ec[0] - dc[0] * ec[2]
            nz = dc[0] * ec[1] - dc[1] * ec[0]
            nn = jnp.sqrt(jnp.maximum(nx * nx + ny * ny + nz * nz,
                                      1e-30))
            side = (Cc[0] * nx + Cc[1] * ny + Cc[2] * nz) / nn
            va = jnp.clip(side / jnp.maximum(r, 1e-12), -1.0, 1.0)
            t_best = jnp.where(hit, t, t_best)
            prim_b = jnp.where(
                hit,
                prim_base + seg_start.astype(jnp.int32) + kk, prim_b)
            u_b = jnp.where(hit, s_al, u_b)
            v_b = jnp.where(hit, va, v_b)
            obj_b = jnp.where(hit, so.astype(jnp.int32), obj_b)

        # retire the processed cluster per lane, continue while any
        # lane still has a live nearer cluster
        entry = jnp.where(cids == cid[None], INF, entry)
        ngate = jnp.where(shadow_any_hit & (prim_b >= 0),
                          -INF, jnp.minimum(t_best, INF)) \
            if shadow_any_hit else jnp.minimum(t_best, INF)
        alive = jnp.any(jnp.min(entry, axis=0) < ngate)
        return (entry, t_best, prim_b, u_b, v_b, obj_b, it + 1, alive)

    out = jax.lax.while_loop(cond, body, state)
    return {"t": out[1], "prim": out[2], "u": out[3], "v": out[4],
            "object": out[5]}


def intersect_curve_clusters(ctable, cluster_segs, prim_base, o, d,
                             tmin, tmax, visibility, hit0=None,
                             shadow_any_hit=False, chunk=8192):
    """Oriented-cluster curve traversal, merged into hit0 by min-t —
    same contract as intersect.intersect_curves_ribbon. The (C, N)
    entry table bounds memory, so the wavefront is processed in
    lax.map chunks like the triangle cluster path."""
    from raytracingproject_tpu.ops import intersect as isect
    n = o.shape[0]
    if hit0 is None:
        hit0 = isect.empty_hit(n)
        hit0["t"] = jnp.minimum(tmax, RAY_TMAX)
    if ctable.shape[0] == 0:
        return hit0
    pad = (-n) % chunk
    if pad:
        def padv(x, cv=0.0):
            cfg = ((0, pad),) + ((0, 0),) * (x.ndim - 1)
            return jnp.pad(x, cfg, constant_values=cv)
        o2, d2 = padv(o), padv(d, 1.0)
        tmin2, tmax2 = padv(tmin), padv(tmax, -1.0)
        vis2 = padv(visibility)
        h2 = {k: padv(v, -1.0 if k == "t" else 0)
              for k, v in hit0.items()}
    else:
        o2, d2, tmin2, tmax2, vis2, h2 = o, d, tmin, tmax, visibility, \
            hit0
    nn = n + pad
    nchunks = nn // chunk

    def one(args):
        oo, dd, tn, tx, vv, hh = args
        return _walk_chunk(ctable, int(cluster_segs), prim_base,
                           oo, dd, tn, tx, vv, bool(shadow_any_hit), hh)

    shaped = (o2.reshape(nchunks, chunk, 3), d2.reshape(nchunks, chunk, 3),
              tmin2.reshape(nchunks, chunk), tmax2.reshape(nchunks, chunk),
              vis2.reshape(nchunks, chunk),
              {k: v.reshape((nchunks, chunk) + v.shape[1:])
               for k, v in h2.items()})
    out = jax.lax.map(one, shaped)
    return {k: v.reshape(nn)[:n] for k, v in out.items()}
