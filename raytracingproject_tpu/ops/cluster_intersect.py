"""Cluster-shortlist scene intersection in plain XLA.

Replaces the per-lane BVH walk (ref: kernel/bvh/bvh_traversal.h:34-229)
for the 1k-40k-prim regime. The BVH is cut into <= 640 clusters of
<= cluster_tris triangles (bvh/clusters.py) and traversal becomes three
data-parallel steps:

1. one slab-test sweep materializes every lane's entry distance to
   every cluster — a (C, N) pass run ONCE per intersect;
2. each iteration picks each lane's nearest unprocessed cluster by a
   min/select-reduction over that table (front-to-back order for free,
   so closest-hit converges in a few iterations);
3. the chosen cluster row (triangles + prim ids + visibility + w2o,
   all finite f32 payloads) is gathered per lane and intersected with
   dense elementwise math.

Instancing (TLAS/BLAS) is folded in: every instance contributes its
BLAS clusters with world-space bounds and its world->object transform
in the row; rays transform per lane after the fetch, with t preserved
(directions not renormalized) so hit compares stay global — the same
contract as ops/intersect.py.

This is the CPU path and the reference the GPU kernel
(ops/cluster_walk_gpu.py) is tested against: both visit clusters in the
same order.
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import numpy as np
import jax
import jax.numpy as jnp

from raytracingproject_tpu.utils.math import RAY_TMAX
from raytracingproject_tpu.ops import intersect as isect

INF = prec.FT(3e38)
# row layout: [w2o(12), pad(1)] [tris: v0,e1,e2 (9 per tri)]
# [prim id per tri] [object id per tri] [visibility per tri]
META_COLS = 13
# lanes per while_loop chunk: bounds the (C, chunk) entry table; small
# chunks stop worst-lane convergence from holding up many lanes. Set on
# the earlier accelerator (tools/cluster_tune.py); not measured on the
# H100.
DEFAULT_CHUNK = 8192
# clusters fetched+tested per traversal iteration; 1 won on the earlier
# accelerator, not measured on the H100
DEFAULT_FETCH_WIDTH = 1


def row_width(cluster_tris, motion=False):
    # motion rows carry 9 extra delta components per tri (v0/e1/e2 at
    # shutter close minus open), lerped per-lane by ray time
    return META_COLS + cluster_tris * (21 if motion else 12)


def pack_cluster_table(clusters_np):
    """Host-side packing. clusters_np: list of dicts with keys
    verts (ct_i, 3, 3) [object space], prim (ct_i,), obj (ct_i,),
    vis (ct_i,), w2o (3, 4) or None, lo (3,), hi (3,).
    Returns (cluster_bounds (C, 6) f32, cluster_table (C, W) f32,
    cluster_tris)."""
    c = len(clusters_np)
    ct = max((len(cl["prim"]) for cl in clusters_np), default=1)
    ct = max(ct, 1)
    motion = any(cl.get("verts_t1") is not None for cl in clusters_np)
    w = row_width(ct, motion)
    tri_w = 18 if motion else 9
    table = np.zeros((c, w), np.float32)
    bounds = np.zeros((c, 6), np.float32)
    for i, cl in enumerate(clusters_np):
        bounds[i, :3] = cl["lo"]
        bounds[i, 3:] = cl["hi"]
        if cl.get("w2o") is not None:
            table[i, 0:12] = np.asarray(cl["w2o"], np.float32).reshape(12)
        else:
            table[i, 0:12] = np.eye(3, 4, dtype=np.float32).reshape(12)
        k = len(cl["prim"])
        v = np.asarray(cl["verts"], np.float32)
        tri = np.concatenate(
            [v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=1)
        table[i, META_COLS:META_COLS + 9 * k] = tri.reshape(-1)
        if motion:
            v1 = np.asarray(cl.get("verts_t1", cl["verts"]), np.float32)
            tri1 = np.concatenate(
                [v1[:, 0], v1[:, 1] - v1[:, 0], v1[:, 2] - v1[:, 0]],
                axis=1)
            db = META_COLS + 9 * ct
            table[i, db:db + 9 * k] = (tri1 - tri).reshape(-1)
        base = META_COLS + tri_w * ct
        table[i, base:base + ct] = -1.0
        table[i, base:base + k] = np.asarray(cl["prim"], np.float32)
        base2 = base + ct
        table[i, base2:base2 + k] = np.asarray(cl["obj"], np.float32)
        base3 = base2 + ct
        table[i, base3:base3 + k] = np.asarray(cl["vis"], np.float32)
        assert np.all(np.abs(cl["prim"]) < (1 << 24))
    assert np.isfinite(table).all(), "cluster payloads must be finite"
    return bounds, table, ct, motion


def _entry_table(cbounds, o, d, tmin, tmax):
    """(C, N) conservative entry distance per (cluster, lane); INF when
    the segment misses the box. Kept per-axis to avoid (C, N, 3)
    temporaries."""
    inv = jnp.where(jnp.abs(d) > 1e-20,
                    1.0 / jnp.where(d == 0, 1.0, d),
                    jnp.where(d >= 0, 1e20, -1e20))
    tn = jnp.full((cbounds.shape[0], o.shape[0]), -INF)
    tf = jnp.full((cbounds.shape[0], o.shape[0]), INF)
    for ax in range(3):
        t0 = (cbounds[:, ax, None] - o[None, :, ax]) * inv[None, :, ax]
        t1 = (cbounds[:, 3 + ax, None] - o[None, :, ax]) * inv[None, :, ax]
        tn = jnp.maximum(tn, jnp.minimum(t0, t1))
        tf = jnp.minimum(tf, jnp.maximum(t0, t1))
    ok = (tn <= tf) & (tf >= tmin[None]) & (tn <= tmax[None])
    return jnp.where(ok, jnp.maximum(tn, tmin[None]), INF)


def _intersect_chunk(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                     visibility, shadow_any_hit, has_instances,
                     max_iters, fetch_width=1, want_stats=False,
                     time=None, has_motion=False):
    n = o.shape[0]
    c = cbounds.shape[0]
    entry = _entry_table(cbounds, o, d, tmin, tmax)
    cids = jax.lax.broadcasted_iota(jnp.int32, (c, 1), 0)

    t0 = jnp.minimum(tmax, RAY_TMAX)
    state = (entry, t0, jnp.full((n,), -1, jnp.int32),
             jnp.zeros((n,), prec.FT), jnp.zeros((n,), prec.FT),
             jnp.full((n,), -1, jnp.int32), jnp.int32(0), jnp.bool_(True))

    def cond(st):
        return st[7] & (st[6] < max_iters)

    def body(st):
        entry, t_best, prim_b, u_b, v_b, obj_b, it, _ = st
        # per-lane nearest `fetch_width` unprocessed clusters
        # (iterated select-reductions; front-to-back for free)
        cid_list, ent = [], entry
        for _f in range(fetch_width):
            e_min_f = jnp.min(ent, axis=0)
            win = ent == e_min_f[None]
            cidf = jnp.maximum(
                jnp.max(jnp.where(win, cids, -1), axis=0), 0)
            cid_list.append((cidf, e_min_f))
            if _f + 1 < fetch_width:
                ent = jnp.where(cids == cidf[None], INF, ent)
        e_min = cid_list[0][1]
        active = e_min < jnp.minimum(t_best, INF)
        cid = cid_list[0][0]

        # fetch the cluster row(s) for every lane in (W, N) orientation
        # so each component below is a contiguous lane vector
        row_list = [ctable[cl[0]].T for cl in cid_list]

        tri_w = 18 if has_motion else 9
        pbase = META_COLS + tri_w * cluster_tris
        obase = pbase + cluster_tris
        vbase = obase + cluster_tris

        def test_cluster(row, f_active, bt, bp, bu, bv, bo):
            if has_instances:
                m = [row[j] for j in range(12)]             # 3x4 rows
                oxx = m[0] * o[:, 0] + m[1] * o[:, 1] + m[2] * o[:, 2] + m[3]
                oyy = m[4] * o[:, 0] + m[5] * o[:, 1] + m[6] * o[:, 2] + m[7]
                ozz = m[8] * o[:, 0] + m[9] * o[:, 1] + m[10] * o[:, 2] + m[11]
                dxx = m[0] * d[:, 0] + m[1] * d[:, 1] + m[2] * d[:, 2]
                dyy = m[4] * d[:, 0] + m[5] * d[:, 1] + m[6] * d[:, 2]
                dzz = m[8] * d[:, 0] + m[9] * d[:, 1] + m[10] * d[:, 2]
            else:
                oxx, oyy, ozz = o[:, 0], o[:, 1], o[:, 2]
                dxx, dyy, dzz = d[:, 0], d[:, 1], d[:, 2]
            # watertight shear basis from the (possibly object-space)
            # ray of THIS cluster (ref: util_math_intersect.h:88; shared
            # helper so all traversal paths stay bit-exact twins)
            ws = isect.watertight_setup(
                jnp.stack([oxx, oyy, ozz], -1),
                jnp.stack([dxx, dyy, dzz], -1))
            for k in range(cluster_tris):
                b = META_COLS + 9 * k
                v0c = (row[b], row[b + 1], row[b + 2])
                e1c = (row[b + 3], row[b + 4], row[b + 5])
                e2c = (row[b + 6], row[b + 7], row[b + 8])
                if has_motion:
                    # per-lane time lerp of the deform deltas — same
                    # math as ops/intersect.py _motion_components, so
                    # cluster and brute stay exact twins
                    db = META_COLS + 9 * cluster_tris + 9 * k
                    v0c = tuple(v0c[j] + time * row[db + j]
                                for j in range(3))
                    e1c = tuple(e1c[j] + time * row[db + 3 + j]
                                for j in range(3))
                    e2c = tuple(e2c[j] + time * row[db + 6 + j]
                                for j in range(3))
                hit, t, u, v = isect._wt_block(ws, v0c, e1c, e2c, tmin, bt)
                pid = row[pbase + k]
                hit = hit & f_active & (pid >= 0.0)
                if visibility is not None:
                    vis = row[vbase + k].astype(jnp.uint32)
                    hit &= (vis & visibility) > 0
                bt = jnp.where(hit, t, bt)
                bp = jnp.where(hit, pid.astype(jnp.int32), bp)
                bu = jnp.where(hit, u, bu)
                bv = jnp.where(hit, v, bv)
                bo = jnp.where(hit, row[obase + k].astype(jnp.int32), bo)
            return bt, bp, bu, bv, bo

        bt, bp, bu, bv, bo = t_best, prim_b, u_b, v_b, obj_b
        processed = jnp.zeros_like(entry, bool)
        for f, (cidf, e_min_f) in enumerate(cid_list):
            # cluster f is live if still in front of the current best
            # (bt tightens as earlier fetches resolve — identical hit
            # selection to sequential single-fetch iterations)
            act_f = e_min_f < jnp.minimum(bt, INF)
            bt, bp, bu, bv, bo = test_cluster(row_list[f], act_f,
                                              bt, bp, bu, bv, bo)
            processed |= (cids == cidf[None]) & act_f[None]

        # retire the processed clusters; cull clusters behind the best
        entry = jnp.where(processed | (entry >= bt[None]), INF, entry)
        if shadow_any_hit:
            entry = jnp.where((bp >= 0)[None], INF, entry)
        alive = jnp.min(entry, axis=0) < jnp.minimum(bt, INF)
        return (entry, bt, bp, bu, bv, bo, it + 1, jnp.any(alive))

    _, t, prim, u, v, obj, iters, _ = jax.lax.while_loop(cond, body, state)
    hit_mask = prim >= 0
    out = {"t": t, "prim": jnp.where(hit_mask, prim, -1), "u": u, "v": v,
           "object": jnp.where(hit_mask, obj, -1)}
    if want_stats:
        out["iters"] = jnp.broadcast_to(iters, t.shape[:1])
    return out


def intersect_clusters(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                       visibility=None, shadow_any_hit=False,
                       has_instances=False, chunk=DEFAULT_CHUNK,
                       fetch_width=DEFAULT_FETCH_WIDTH, want_stats=False,
                       time=None, has_motion=False):
    """Closest-hit (or any-hit) over the cluster tables.

    o, d: (N, 3); tmin, tmax: (N,); visibility: (N,) uint32 or None.
    Lanes are processed in fixed sub-chunks so the (C, chunk) entry
    table stays small; each chunk converges independently under its own
    while_loop.
    """
    n = o.shape[0]
    c = cbounds.shape[0]
    max_iters = jnp.int32(c)
    if has_motion and time is None:
        time = jnp.zeros((n,), prec.FT)
    if n <= chunk:
        return _intersect_chunk(cbounds, ctable, cluster_tris, o, d,
                                tmin, tmax, visibility, shadow_any_hit,
                                has_instances, max_iters, fetch_width,
                                want_stats=want_stats, time=time,
                                has_motion=has_motion)
    pad = (-n) % chunk
    nc = (n + pad) // chunk

    def prep(x, fill=0):
        x = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                    constant_values=fill)
        return x.reshape((nc, chunk) + x.shape[1:])

    args = [prep(o), prep(d), prep(tmin), prep(tmax, fill=-1.0)]
    if visibility is not None:
        args.append(prep(visibility))
    if has_motion:
        args.append(prep(time))

    def one(xs):
        xs = list(xs)
        tt = xs.pop() if has_motion else None
        if visibility is not None:
            oo, dd, t0, t1, vis = xs
        else:
            (oo, dd, t0, t1), vis = xs, None
        return _intersect_chunk(cbounds, ctable, cluster_tris, oo, dd,
                                t0, t1, vis, shadow_any_hit,
                                has_instances, max_iters, fetch_width,
                                want_stats=want_stats, time=tt,
                                has_motion=has_motion)

    out = jax.lax.map(one, tuple(args))
    return {k: v.reshape(-1)[:n] for k, v in out.items()}
