"""Cluster walk for the GPU: one Pallas kernel through Triton.

Same hit contract and the same tables as the XLA cluster shortlist
(ops/cluster_intersect.py `intersect_clusters`): `cluster_bounds`
(C, 6) and `cluster_table` (C, W), closest-hit or shadow any-hit,
per-lane world->object rows for instancing and per-lane time lerp of
the row deltas for deform motion.

Design (per-lane walk, not a block-shared one). Every lane walks its
own clusters front to back in the shortlist's order — ascending entry
distance, ties by descending cluster id — so both paths visit the same
clusters and pick the same winners:

- A pass sweeps all C cluster boxes for the lane's ray and keeps, in
  registers, the TOPK nearest entries that come after the last cluster
  the lane tested and lie in front of its current best hit. Bounds are
  read as scalars shared by the whole block; entry distances are
  recomputed, never stored, so no (C, N) table exists anywhere.
- The lane then tests those clusters in order. Each row is gathered per
  lane from the table (a few hundred KB for the single-level scenes,
  resident in L2). The first cluster that no longer lies in front of
  the best hit ends the lane's walk.
- A lane that tested all TOPK clusters runs another pass from where it
  stopped. The block loops while any of its lanes is walking.

The whole wavefront is one launch with no state in device memory
between iterations; the shortlist instead runs one `while_loop` per
8192-lane chunk, one chunk after another, and its loop exit is decided
on the host at every iteration.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from raytracingproject_tpu.ops import intersect as isect
from raytracingproject_tpu.ops.cluster_intersect import META_COLS
from raytracingproject_tpu.utils.math import RAY_TMAX

# lanes per program (a power of two, as Triton requires); with 4 warps
# each thread owns one lane
BLOCK = 128
NUM_WARPS = 4
# clusters kept per pass; a pass costs C slab tests per lane
TOPK = 4
INF = 3e38   # python floats: a jnp constant would become a kernel input


def _before(e1, c1, e2, c2):
    """Walk order: nearer entry first, equal entries by higher id (the
    shortlist's tie rule)."""
    return (e1 < e2) | ((e1 == e2) & (c1 > c2))


def _walk_kernel(cb_ref, ct_ref, ray_ref, vis_ref, time_ref,
                 t_ref, prim_ref, u_ref, v_ref, obj_ref, *,
                 n_clusters, cluster_tris, row_w, has_instances,
                 has_motion, has_vis, shadow_any_hit, topk):
    ox, oy, oz = ray_ref[0, :], ray_ref[1, :], ray_ref[2, :]
    dx, dy, dz = ray_ref[3, :], ray_ref[4, :], ray_ref[5, :]
    tmin, tmax = ray_ref[6, :], ray_ref[7, :]
    vis_lane = vis_ref[...] if has_vis else None
    time = time_ref[...] if has_motion else None

    def inv_axis(dax):
        return jnp.where(jnp.abs(dax) > 1e-20,
                         1.0 / jnp.where(dax == 0, 1.0, dax),
                         jnp.where(dax >= 0, 1e20, -1e20))

    inv = (inv_axis(dx), inv_axis(dy), inv_axis(dz))
    orig = (ox, oy, oz)
    tri_w = 18 if has_motion else 9
    pbase = META_COLS + tri_w * cluster_tris
    obase = pbase + cluster_tris
    vbase = obase + cluster_tris
    ws_world = None if has_instances else isect.watertight_setup_c(
        ox, oy, oz, dx, dy, dz)

    def gate(bt, bp):
        # shadow any-hit retires a lane at its first hit
        if shadow_any_hit:
            return jnp.where(bp >= 0, -INF, bt)
        return bt

    def entry_of(c):
        """Entry distance of cluster c for every lane (INF on a miss),
        the shortlist's slab test term for term."""
        tn = jnp.full(tmin.shape, -INF, jnp.float32)
        tf = jnp.full(tmin.shape, INF, jnp.float32)
        for ax in range(3):
            t0 = (cb_ref[ax, c] - orig[ax]) * inv[ax]
            t1 = (cb_ref[3 + ax, c] - orig[ax]) * inv[ax]
            tn = jnp.maximum(tn, jnp.minimum(t0, t1))
            tf = jnp.minimum(tf, jnp.maximum(t0, t1))
        ok = (tn <= tf) & (tf >= tmin) & (tn <= tmax)
        return jnp.where(ok, jnp.maximum(tn, tmin), INF)

    def collect(bt, bp, last_e, last_c, walking):
        """The lane's `topk` next clusters in walk order."""
        g = gate(bt, bp)

        def body(c, slots):
            es, cs = list(slots[0]), list(slots[1])
            e = entry_of(c)
            ok = walking & (e < g) & _before(last_e, last_c, e, c)
            e = jnp.where(ok, e, INF)
            ci = jnp.where(ok, c, -1)
            for k in range(topk):
                ins = _before(e, ci, es[k], cs[k])
                es[k], e = jnp.where(ins, e, es[k]), jnp.where(ins, es[k], e)
                cs[k], ci = (jnp.where(ins, ci, cs[k]),
                             jnp.where(ins, cs[k], ci))
            return tuple(es), tuple(cs)

        init = (tuple(jnp.full(tmin.shape, INF, jnp.float32)
                      for _ in range(topk)),
                tuple(jnp.full(tmin.shape, -1, jnp.int32)
                      for _ in range(topk)))
        return jax.lax.fori_loop(0, n_clusters, body, init)

    def test_cluster(cid, act, hit):
        """Every triangle of cluster `cid` (per lane) against the ray."""
        row = cid * row_w

        def col(j):
            return ct_ref[row + j]

        if has_instances:
            m = [col(j) for j in range(12)]
            ws = isect.watertight_setup_c(
                m[0] * ox + m[1] * oy + m[2] * oz + m[3],
                m[4] * ox + m[5] * oy + m[6] * oz + m[7],
                m[8] * ox + m[9] * oy + m[10] * oz + m[11],
                m[0] * dx + m[1] * dy + m[2] * dz,
                m[4] * dx + m[5] * dy + m[6] * dz,
                m[8] * dx + m[9] * dy + m[10] * dz)
        else:
            ws = ws_world

        def tri(k, h):
            bt, bp, bu, bv, bo = h
            b = META_COLS + 9 * k
            v0c = (col(b), col(b + 1), col(b + 2))
            e1c = (col(b + 3), col(b + 4), col(b + 5))
            e2c = (col(b + 6), col(b + 7), col(b + 8))
            if has_motion:
                db = META_COLS + 9 * cluster_tris + 9 * k
                v0c = tuple(v0c[j] + time * col(db + j) for j in range(3))
                e1c = tuple(e1c[j] + time * col(db + 3 + j)
                            for j in range(3))
                e2c = tuple(e2c[j] + time * col(db + 6 + j)
                            for j in range(3))
            ok, t, u, v = isect._wt_block(ws, v0c, e1c, e2c, tmin, bt)
            pid = col(pbase + k)
            ok = ok & act & (pid >= 0.0)
            if has_vis:
                ok = ok & ((col(vbase + k).astype(jnp.uint32) & vis_lane)
                           != 0)
            return (jnp.where(ok, t, bt),
                    jnp.where(ok, pid.astype(jnp.int32), bp),
                    jnp.where(ok, u, bu), jnp.where(ok, v, bv),
                    jnp.where(ok, col(obase + k).astype(jnp.int32), bo))

        return jax.lax.fori_loop(0, cluster_tris, tri, hit)

    def cond(st):
        return (jnp.max(st[7]) > 0) & (st[8] < n_clusters)

    def body(st):
        bt, bp, bu, bv, bo, last_e, last_c, walking, it = st
        es, cs = collect(bt, bp, last_e, last_c, walking > 0)
        hit = (bt, bp, bu, bv, bo)
        for k in range(topk):
            act = (walking > 0) & (es[k] < gate(hit[0], hit[1]))
            hit = jax.lax.cond(
                jnp.max(act.astype(jnp.int32)) > 0,
                lambda h, act=act, k=k: test_cluster(
                    jnp.maximum(cs[k], 0), act, h),
                lambda h: h, hit)
            last_e = jnp.where(act, es[k], last_e)
            last_c = jnp.where(act, cs[k], last_c)
            # keys only grow along the slots and the gate only shrinks:
            # a slot that fails ends the lane's walk
            walking = jnp.where(act, walking, 0)
        return (*hit, last_e, last_c, walking, it + 1)

    t0 = jnp.minimum(tmax, RAY_TMAX)
    st0 = (t0, jnp.full(t0.shape, -1, jnp.int32),
           jnp.zeros(t0.shape, jnp.float32), jnp.zeros(t0.shape, jnp.float32),
           jnp.full(t0.shape, -1, jnp.int32),
           jnp.full(t0.shape, -INF, jnp.float32),
           jnp.full(t0.shape, n_clusters, jnp.int32),
           jnp.ones(t0.shape, jnp.int32), jnp.int32(0))
    bt, bp, bu, bv, bo = jax.lax.while_loop(cond, body, st0)[:5]
    t_ref[...] = bt
    prim_ref[...] = bp
    u_ref[...] = bu
    v_ref[...] = bv
    obj_ref[...] = bo


@functools.partial(
    jax.jit, static_argnames=("cluster_tris", "shadow_any_hit",
                              "has_instances", "has_motion", "interpret"))
def intersect_clusters_gpu(cbounds, ctable, cluster_tris, o, d, tmin, tmax,
                           visibility=None, shadow_any_hit=False,
                           has_instances=False, time=None, has_motion=False,
                           interpret=False):
    """Closest-hit (or any-hit) over the cluster tables in one launch.

    Same arguments and result as cluster_intersect.intersect_clusters:
    o, d (N, 3); tmin, tmax (N,); visibility (N,) uint32 or None.
    Returns dict(t, prim, u, v, object). `interpret` runs the kernel on
    the CPU (tests); on the GPU it compiles through Triton.
    """
    n = o.shape[0]
    c, row_w = ctable.shape
    pad = (-n) % BLOCK
    np_ = n + pad
    # padded lanes carry an empty window (tmax < tmin), so they never
    # enter a cluster
    ray = jnp.concatenate([
        o.T.astype(jnp.float32), d.T.astype(jnp.float32),
        tmin[None].astype(jnp.float32), tmax[None].astype(jnp.float32)])
    ray = jnp.pad(ray, ((0, 0), (0, pad)))
    ray = ray.at[3:6, n:].set(1.0).at[7, n:].set(-1.0)
    has_vis = visibility is not None
    vis = (jnp.pad(visibility.astype(jnp.uint32), (0, pad))
           if has_vis else jnp.zeros((np_,), jnp.uint32))
    if has_motion and time is None:
        time = jnp.zeros((n,), jnp.float32)
    tvec = (jnp.pad(time.astype(jnp.float32), (0, pad)) if has_motion
            else jnp.zeros((np_,), jnp.float32))

    kern = functools.partial(
        _walk_kernel, n_clusters=int(c), cluster_tris=int(cluster_tris),
        row_w=int(row_w), has_instances=bool(has_instances),
        has_motion=bool(has_motion), has_vis=has_vis,
        shadow_any_hit=bool(shadow_any_hit), topk=TOPK)
    lane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    t, prim, u, v, obj = pl.pallas_call(
        kern,
        grid=(np_ // BLOCK,),
        in_specs=[pl.BlockSpec(), pl.BlockSpec(),
                  pl.BlockSpec((8, BLOCK), lambda i: (0, i)), lane, lane],
        out_specs=[lane] * 5,
        out_shape=[jax.ShapeDtypeStruct((np_,), jnp.float32),
                   jax.ShapeDtypeStruct((np_,), jnp.int32),
                   jax.ShapeDtypeStruct((np_,), jnp.float32),
                   jax.ShapeDtypeStruct((np_,), jnp.float32),
                   jax.ShapeDtypeStruct((np_,), jnp.int32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="cluster_walk",
    )(cbounds.T.astype(jnp.float32), ctable.reshape(-1), ray, vis, tvec)
    hit = prim[:n] >= 0
    return {"t": t[:n], "prim": jnp.where(hit, prim[:n], -1),
            "u": u[:n], "v": v[:n],
            "object": jnp.where(hit, obj[:n], -1)}


def check_parity(ref, got, shadow_any_hit=False):
    """The walk's parity contract with the shortlist (`ref`): hit masks
    (and, for closest-hit, prim and object) identical on >= 99.99% of
    lanes, every disagreement an exact-t tie (t within 1e-4 relative),
    t within rtol 1e-5 and u/v within 1e-5 on the lanes that agree.
    Returns a summary dict; raises AssertionError on a breach."""
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: np.asarray(v) for k, v in got.items()}
    hit_r, hit_g = ref["prim"] >= 0, got["prim"] >= 0
    same = hit_r == hit_g
    if not shadow_any_hit:
        same &= (ref["prim"] == got["prim"]) \
            & (ref["object"] == got["object"])
    frac = float(same.mean())
    both = hit_r & hit_g
    trel = np.abs(ref["t"] - got["t"]) / np.maximum(np.abs(ref["t"]),
                                                    1e-30)
    breaches = []
    if frac < 0.9999:
        breaches.append(f"only {frac:.6f} of lanes agree")
    if np.any(~same & ~both):
        breaches.append("a lane hits in one walk and misses in the other")
    if np.any(trel[~same & both] > 1e-4):
        breaches.append("a lane disagrees on something other than a tie")
    if not shadow_any_hit:
        ok = same & both
        if np.any(trel[ok] > 1e-5):
            breaches.append("t differs beyond rtol 1e-5")
        for k in ("u", "v"):
            if np.any(np.abs(ref[k] - got[k])[ok] > 1e-5):
                breaches.append(f"{k} differs beyond 1e-5")
    if breaches:
        raise AssertionError("; ".join(breaches))
    return {"agree": frac, "hit_frac": float(hit_r.mean()),
            "max_t_rel": float(trel[both].max()) if both.any() else 0.0}
