"""Device intersection kernels (ref: kernel/bvh/bvh.h scene_intersect,
kernel/bvh/bvh_traversal.h:34-229, kernel/geom/geom_triangle_intersect.h).

Wavefront architecture: instead of one traversal stack per GPU thread,
a whole ray wavefront advances in lockstep through a `lax.while_loop`;
per-lane state (current node, stack, best hit) lives in SoA arrays, node
fetches are batched row gathers from the flat BVH arrays (bvh/build.py
layout). This is the standard while-while GPU traversal reshaped for
XLA: no divergent control flow, every lane executes the same fused
elementwise ops under masks.

Two-level instancing (TLAS over object instances -> BLAS per geometry,
ref: bvh/bvh.h pack_instances) is handled in-traversal: instance leaves
swap the lane's ray into object space, push a RESTORE sentinel, and dive
into the BLAS; directions are NOT renormalized so the ray parameter t is
identical in both spaces and hit compares stay global.

For small scenes (<= ~512 triangles, Cornell class) `intersect_brute`
skips the BVH entirely: a `lax.scan` over triangle blocks is pure dense
elementwise math with zero gathers — faster than pointer-style
traversal at these sizes.
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import jax
import jax.numpy as jnp
import numpy as np

from raytracingproject_tpu.utils.math import RAY_TMAX, mat34_point, mat34_dir

STACK_DEPTH = 48
# np (not jnp) so importing this module never initializes the XLA
# backend — jax.distributed.initialize must be able to run afterwards.
DONE = np.int32(0x7FFFFFFF)
RESTORE = np.int32(0x7FFFFFFE)
LEAF_UNROLL = 8  # must cover builder max leaf size

# visibility constants live in models/object.py (PATH_RAY_*)


# sign-test tolerance, in ulps of the edge-function product magnitudes
# (covers one FMA-contraction asymmetry + the two product roundings)
_WT_EPS = np.float32(4.0 * 2.0 ** -23)


def watertight_setup(o, d):
    """Per-ray setup for the watertight triangle test (ref:
    util/util_math_intersect.h:88 ray_triangle_intersect — the
    Woop/Benthin/Wald 2013 shear-basis formulation).

    Redesign: instead of permuting triangle coordinates per lane
    (3-way selects per scalar), the permutation AND the shear are folded
    into three dense per-lane row vectors rx/ry/rz so every transformed
    coordinate is one 3-term dot — pure FMA chains in the tri-major
    sweep. The o-translation folds into per-lane scalars rxo/ryo/rzo.

    For corner V: sheared coords are (rx.V - rxo, ry.V - ryo,
    rz.V - rzo). Returns dict of 12 per-lane (N,) arrays.
    """
    return watertight_setup_c(o[..., 0], o[..., 1], o[..., 2],
                              d[..., 0], d[..., 1], d[..., 2])


def watertight_setup_c(ox, oy, oz, dx, dy, dz):
    """watertight_setup on ray components — the SoA form shared with
    kernels that work on per-lane component vectors
    (ops/cluster_walk_gpu.py). Identical math, bit-for-bit."""
    ax, ay, az = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)
    zmax = (az >= ax) & (az >= ay)
    ymax = ~zmax & (ay >= ax)
    kz = jnp.where(zmax, 2, jnp.where(ymax, 1, 0))
    d_kz = jnp.where(zmax, dz, jnp.where(ymax, dy, dx))
    # winding-preserving cyclic axes; swap when d[kz] < 0. Selects
    # rather than `% 3`, which the GPU kernel route cannot lower.
    neg = d_kz < 0.0
    k1 = jnp.where(kz == 2, 0, kz + 1)      # (kz + 1) % 3
    k2 = jnp.where(kz == 0, 2, kz - 1)      # (kz + 2) % 3
    kx = jnp.where(neg, k2, k1)
    ky = jnp.where(neg, k1, k2)

    def onehot(k):
        return ((k == 0).astype(prec.FT), (k == 1).astype(prec.FT),
                (k == 2).astype(prec.FT))

    ex, ey, ez = onehot(kx), onehot(ky), onehot(kz)

    def pick(e, vx, vy, vz):
        return e[0] * vx + e[1] * vy + e[2] * vz

    d_kx = pick(ex, dx, dy, dz)
    d_ky = pick(ey, dx, dy, dz)
    inv_kz = 1.0 / jnp.where(d_kz == 0, 1.0, d_kz)
    sx = d_kx * inv_kz
    sy = d_ky * inv_kz
    sz = inv_kz
    # dense rows: rx = ex - sx*ez ; ry = ey - sy*ez ; rz = sz*ez
    rx = tuple(ex[i] - sx * ez[i] for i in range(3))
    ry = tuple(ey[i] - sy * ez[i] for i in range(3))
    rz = tuple(sz * ez[i] for i in range(3))
    return {
        "rx": rx, "ry": ry, "rz": rz,
        "rxo": pick(rx, ox, oy, oz),
        "ryo": pick(ry, ox, oy, oz),
        "rzo": pick(rz, ox, oy, oz),
        "degenerate": (ax == 0) & (ay == 0) & (az == 0),
    }


def watertight_test(ws, v0c, v1c, v2c, tmin, tmax):
    """Watertight triangle test on component tuples.

    ws: watertight_setup dict; v0c/v1c/v2c: 3-tuples of corner
    components, each broadcastable against the per-lane arrays in ws
    (e.g. (B, 1) tri-major blocks vs (N,) lanes). tmin/tmax likewise.
    Returns (valid, t, u, v): `valid` is the edge-sign test AND
    t in (tmin, tmax); u is the v1 weight, v the v2 weight
    (P = (1-u-v)*v0 + u*v1 + v*v2), matching the MT convention.

    Watertight because shared edges evaluate the same 2D edge function
    with operands swapped, and the sign test tolerates a few ulps of
    the product magnitudes (see inline note on FMA contraction), so
    adjacent triangles cannot both round a grazing ray to a miss (ref:
    util_math_intersect.h:88; the reference's double-precision re-eval
    of exact zeros is replaced by the tolerance band).
    """
    def shear(vc):
        x = ws["rx"][0] * vc[0] + ws["rx"][1] * vc[1] \
            + ws["rx"][2] * vc[2] - ws["rxo"]
        y = ws["ry"][0] * vc[0] + ws["ry"][1] * vc[1] \
            + ws["ry"][2] * vc[2] - ws["ryo"]
        z = ws["rz"][0] * vc[0] + ws["rz"][1] * vc[1] \
            + ws["rz"][2] * vc[2] - ws["rzo"]
        return x, y, z

    ax, ay, az = shear(v0c)
    bx, by, bz = shear(v1c)
    cx, cy, cz = shear(v2c)
    # Edge functions with a relative tolerance: the exact-negation
    # guarantee of the scalar formulation (shared edge -> identical
    # expression with operands swapped) does NOT survive compilation
    # here, because XLA/LLVM may contract one triangle's mul-sub into
    # an FMA and not the neighbour's (measured: 19/512 edge rays leak
    # on XLA:CPU with the exact test). Instead the sign test accepts
    # |w| within a few ulps of the PRODUCT magnitudes as "on the edge"
    # for BOTH signs — conservative watertightness that is independent
    # of contraction choices; near-edge rays may hit both neighbours,
    # which closest-hit/any-hit handle naturally.
    def edge(px, py, qx, qy):
        p1 = px * qy
        p2 = py * qx
        return p1 - p2, _WT_EPS * (jnp.abs(p1) + jnp.abs(p2))

    w_a, tol_a = edge(bx, by, cx, cy)
    w_b, tol_b = edge(cx, cy, ax, ay)
    w_c, tol_c = edge(ax, ay, bx, by)
    det = w_a + w_b + w_c
    sign_ok = ((w_a >= -tol_a) & (w_b >= -tol_b) & (w_c >= -tol_c)) \
        | ((w_a <= tol_a) & (w_b <= tol_b) & (w_c <= tol_c))
    # a det within the same noise band is a degenerate/edge-on
    # triangle whose w's are pure contraction noise — t would be a
    # noise ratio (measured: zero-area padding tris "hit" at random t)
    det_ok = jnp.abs(det) > tol_a + tol_b + tol_c
    inv = 1.0 / jnp.where(det == 0, 1.0, det)
    t = (w_a * az + w_b * bz + w_c * cz) * inv
    # tolerance-band hits can give u/v a few ulps outside [0,1]; clamp
    # so downstream barycentric interpolation stays in-simplex
    u = jnp.clip(w_b * inv, 0.0, 1.0)
    v = jnp.clip(w_c * inv, 0.0, 1.0)
    valid = sign_ok & det_ok & (t > tmin) & (t < tmax) \
        & ~ws["degenerate"]
    return valid, t, u, v


def ray_triangle_intersect(v0, v1, v2, o, d, tmin, tmax):
    """Batched watertight intersection on (..., 3) vectors (ref:
    util/util_math_intersect.h:88). Returns (hit_mask, t, u, v) with
    the MT barycentric convention. Matches the NumPy golden reference
    (bvh/build.py _wt_intersect_np) bit-for-bit in fp32."""
    ws = watertight_setup(o, d)
    return watertight_test(
        ws, (v0[..., 0], v0[..., 1], v0[..., 2]),
        (v1[..., 0], v1[..., 1], v1[..., 2]),
        (v2[..., 0], v2[..., 1], v2[..., 2]), tmin, tmax)


def _slab_test(blo, bhi, o, inv_d, tmin, tmax):
    """Batched AABB slab test -> (hit, t_near)."""
    t0 = (blo - o) * inv_d
    t1 = (bhi - o) * inv_d
    tn = jnp.max(jnp.minimum(t0, t1), -1)
    tf = jnp.min(jnp.maximum(t0, t1), -1)
    hit = (tn <= tf) & (tf >= tmin) & (tn <= tmax)
    return hit, tn


def _safe_inv(d):
    return jnp.where(jnp.abs(d) > 1e-20,
                     1.0 / jnp.where(d == 0, 1.0, d),
                     jnp.where(d >= 0, 1e20, -1e20))


def empty_hit(n, tmax=RAY_TMAX):
    return {
        "t": jnp.full((n,), tmax, prec.FT),
        "prim": jnp.full((n,), -1, jnp.int32),    # index in prim_order space
        "u": jnp.zeros((n,), prec.FT),
        "v": jnp.zeros((n,), prec.FT),
        "object": jnp.full((n,), -1, jnp.int32),
    }


def _pack_tri_blocks(tri_verts, prim_object, visibility_arr, block):
    """Pad + reshape triangle data to tri-major blocks (nb, B, ...)."""
    p = tri_verts.shape[0]
    pad = (-p) % block
    tv = jnp.pad(tri_verts, ((0, pad), (0, 0), (0, 0)))
    po = jnp.pad(prim_object, (0, pad), constant_values=-1)
    pv = None
    if visibility_arr is not None:
        pv = jnp.pad(visibility_arr, (0, pad))
    nb = (p + pad) // block
    v0 = tv[:, 0].reshape(nb, block, 3)
    e1 = (tv[:, 1] - tv[:, 0]).reshape(nb, block, 3)
    e2 = (tv[:, 2] - tv[:, 0]).reshape(nb, block, 3)
    return nb, v0, e1, e2, po.reshape(nb, block), \
        (pv.reshape(nb, block) if pv is not None else None)


def _motion_components(v0, e1, e2, delta, time):
    """Per-component triangle terms for the MT math, optionally
    interpolated to each ray's time (deforming motion blur, ref:
    kernel/geom motion_triangle_vertices — redesigned: instead of
    gathering per-step vertices, the dense path evaluates the
    piecewise-linear vertex path as a sum of clamped hat-weighted
    per-segment deltas, keeping every term a (B, N) VPU op:

        v(t) = v_0 + sum_k clip(t*(S-1) - k, 0, 1) * (v_{k+1} - v_k)

    delta is a sequence of per-segment (dv0, de1, de2) triples (one
    entry = the classic 2-step lerp, exactly time*delta since
    clip(t, 0, 1) == t on the shutter). Without motion the terms stay
    (B, 1) and broadcast as before. Ref: motion-step references,
    bvh_build.cpp:89-130 semantics."""
    if delta is None:
        return ([v0[:, i, None] for i in range(3)],
                [e1[:, i, None] for i in range(3)],
                [e2[:, i, None] for i in range(3)])
    s1 = len(delta)
    v0c = [v0[:, i, None] for i in range(3)]
    e1c = [e1[:, i, None] for i in range(3)]
    e2c = [e2[:, i, None] for i in range(3)]
    for k, (dv0, de1, de2) in enumerate(delta):
        if s1 == 1:
            w = time[None, :]
        else:
            w = jnp.clip(time[None, :] * s1 - k, 0.0, 1.0)
        v0c = [v0c[i] + w * dv0[:, i, None] for i in range(3)]
        e1c = [e1c[i] + w * de1[:, i, None] for i in range(3)]
        e2c = [e2c[i] + w * de2[:, i, None] for i in range(3)]
    return v0c, e1c, e2c


def _deform_delta_blocks(tri_verts_steps, prim_object, v0b, e1b, e2b,
                         block):
    """Packed per-segment motion deltas for the dense sweeps.

    tri_verts_steps: (T, 3, 3) single extra step (classic 2-step) or
    (S-1, T, 3, 3) uniform multi-step positions after shutter open.
    Returns a flat tuple of 3*(S-1) block arrays (dv0, de1, de2 per
    segment) suitable for lax.scan xs; _unflatten_deltas re-groups."""
    if tri_verts_steps is None:
        return None
    steps = (tri_verts_steps if tri_verts_steps.ndim == 4
             else tri_verts_steps[None])
    prev = (v0b, e1b, e2b)
    flat = []
    for k in range(steps.shape[0]):
        _, vb, f1, f2, _, _ = _pack_tri_blocks(steps[k], prim_object,
                                               None, block)
        flat += [vb - prev[0], f1 - prev[1], f2 - prev[2]]
        prev = (vb, f1, f2)
    return tuple(flat)


def _unflatten_deltas(dflat):
    return [tuple(dflat[3 * k:3 * k + 3])
            for k in range(len(dflat) // 3)]


def _wt_block(ws, v0c, e1c, e2c, tmin, tmax):
    """watertight_test on tri-major (v0, e1, e2) component triples —
    the shared triangle test of every dense sweep (corners rebuilt from
    the edge layout so block packing and motion lerp stay unchanged)."""
    v1c = tuple(v0c[i] + e1c[i] for i in range(3))
    v2c = tuple(v0c[i] + e2c[i] for i in range(3))
    return watertight_test(ws, v0c, v1c, v2c, tmin, tmax)


def intersect_brute(tri_verts, prim_object, o, d, tmin, tmax,
                    visibility=None, object_visibility=None, block=8,
                    tri_verts_t1=None, time=None):
    """Dense all-rays x all-triangles intersection.

    Layout: triangle-major (B, N) blocks — the RAY axis is the minor
    dimension so every MT term is a full-width elementwise op over the
    lanes; the B=8 triangle axis is the major one. Components are kept
    as separate (N,) arrays inside the kernel (SoA) to avoid minor-dim-3
    tensors.

    tri_verts: (P, 3, 3) in prim order (world space — brute path
    requires pre-transformed geometry).
    """
    n = o.shape[0]
    if tri_verts.shape[0] == 0:  # curve-only scenes have no triangles
        h = empty_hit(n)
        h["t"] = jnp.minimum(tmax, RAY_TMAX)  # cap for curve merging
        return h
    if visibility is not None and object_visibility is not None:
        vis_arr = object_visibility[jnp.maximum(prim_object, 0)]
    else:
        vis_arr = None
    nb, v0b, e1b, e2b, pob, pvb = _pack_tri_blocks(
        tri_verts, prim_object, vis_arr, block)
    deltas = _deform_delta_blocks(tri_verts_t1, prim_object,
                                  v0b, e1b, e2b, block)

    ws = watertight_setup(o, d)

    def body(carry, blk):
        t_best, prim_best, u_best, v_best = carry
        delta = None
        if deltas is not None:
            nd = len(deltas)
            blk, delta = blk[:-nd], _unflatten_deltas(blk[-nd:])
        if pvb is not None:
            v0, e1, e2, po, pv, bbase = blk
        else:
            v0, e1, e2, po, bbase = blk
        v0c, e1c, e2c = _motion_components(v0, e1, e2, delta, time)
        hit, t, u, v = _wt_block(ws, v0c, e1c, e2c, tmin[None],
                                 t_best[None])
        hit &= po[:, None] >= 0
        if pvb is not None:
            hit &= (pv[:, None] & visibility[None]) > 0
        t = jnp.where(hit, t, RAY_TMAX)
        # winner within block via select-reductions instead of argmin
        # + take_along_axis
        tk = jnp.min(t, axis=0)            # (N,)
        win = t == tk[None]                # ties resolved by max below
        kidx = jax.lax.broadcasted_iota(jnp.int32, t.shape, 0)
        k = jnp.max(jnp.where(win, kidx, -1), axis=0)
        uk = jnp.max(jnp.where(win, u, -jnp.inf), axis=0)
        vk = jnp.max(jnp.where(win, v, -jnp.inf), axis=0)
        better = tk < t_best
        t_best = jnp.where(better, tk, t_best)
        prim_best = jnp.where(better, bbase + k, prim_best)
        u_best = jnp.where(better, uk, u_best)
        v_best = jnp.where(better, vk, v_best)
        return (t_best, prim_best, u_best, v_best), None

    init = (jnp.minimum(tmax, RAY_TMAX), jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,), prec.FT), jnp.zeros((n,), prec.FT))
    bbase = (jnp.arange(nb, dtype=jnp.int32) * block)
    xs = (v0b, e1b, e2b, pob, pvb, bbase) if pvb is not None \
        else (v0b, e1b, e2b, pob, bbase)
    if deltas is not None:
        xs = xs + deltas
    (t, prim, u, v), _ = jax.lax.scan(body, init, xs)
    hit_mask = (t < jnp.minimum(tmax, RAY_TMAX)) & (prim >= 0)
    prim = jnp.where(hit_mask, prim, -1)
    obj = jnp.where(hit_mask, prim_object[jnp.maximum(prim, 0)], -1)
    return {"t": t, "prim": prim, "u": u, "v": v, "object": obj}


def intersect_bvh(bvh_bounds, bvh_children, tri_verts, prim_object,
                  o, d, tmin, tmax,
                  instance_w2o=None, instance_blas_root=None,
                  instance_object=None,
                  visibility=None, object_visibility=None,
                  shadow_any_hit=False, stack_depth=None):
    """Lockstep wavefront BVH traversal.

    bvh_bounds (M, 12) f32, bvh_children (M, 2) i32 — unified node pool
    (TLAS + all BLAS). tri_verts (P, 3, 3) in prim order; TLAS instance
    'primitives' are rows in instance_* tables (leaf flag bit 30 set by
    the scene packer). Rays: o, d (N, 3); tmin/tmax (N,).

    Returns hit dict. With shadow_any_hit=True lanes terminate on first
    accepted hit (ref: scene_intersect_shadow semantics for opaque
    shadows).
    """
    n = o.shape[0]
    SD = int(stack_depth) if stack_depth else STACK_DEPTH
    has_instances = instance_w2o is not None

    t_best0 = jnp.minimum(tmax, RAY_TMAX)
    state = {
        "node": jnp.zeros((n,), jnp.int32),           # start at root 0
        "sp": jnp.zeros((n,), jnp.int32),
        "stack": jnp.zeros((n, SD), jnp.int32),
        "t": t_best0,
        "prim": jnp.full((n,), -1, jnp.int32),
        "u": jnp.zeros((n,), prec.FT),
        "v": jnp.zeros((n,), prec.FT),
        "obj": jnp.full((n,), -1, jnp.int32),
        "o_cur": o,
        "d_cur": d,
        "cur_obj": jnp.full((n,), -1, jnp.int32),
    }

    def cond(s):
        return jnp.any(s["node"] != DONE)

    def pop(s, lane_mask):
        """Pop next node for masked lanes; DONE when stack empty."""
        sp = s["sp"]
        has = sp > 0
        nsp = jnp.where(lane_mask & has, sp - 1, sp)
        popped = s["stack"][jnp.arange(n), jnp.maximum(nsp, 0)]
        node = jnp.where(lane_mask, jnp.where(has, popped, DONE), s["node"])
        return node, nsp

    def body(s):
        node = s["node"]
        # --- RESTORE sentinel: return lane to world space, then pop ---
        if has_instances:
            restoring = node == RESTORE
            s = dict(s)
            s["o_cur"] = jnp.where(restoring[:, None], o, s["o_cur"])
            s["d_cur"] = jnp.where(restoring[:, None], d, s["d_cur"])
            s["cur_obj"] = jnp.where(restoring, -1, s["cur_obj"])
            node2, nsp = pop(s, restoring)
            s["node"] = node2
            s["sp"] = nsp
            node = node2

        active = node != DONE
        is_inner = active & (node >= 0)
        is_leaf = active & (node < 0)

        safe_node = jnp.clip(node, 0, bvh_bounds.shape[0] - 1)
        nb = bvh_bounds[safe_node]          # (N, 12)
        nc = bvh_children[safe_node]        # (N, 2)

        inv_d = _safe_inv(s["d_cur"])
        h0, t0 = _slab_test(nb[:, 0:3], nb[:, 3:6], s["o_cur"], inv_d,
                            tmin, s["t"])
        h1, t1 = _slab_test(nb[:, 6:9], nb[:, 9:12], s["o_cur"], inv_d,
                            tmin, s["t"])
        h0 &= is_inner
        h1 &= is_inner

        near_first = t0 <= t1
        near = jnp.where(near_first, nc[:, 0], nc[:, 1])
        far = jnp.where(near_first, nc[:, 1], nc[:, 0])
        both = h0 & h1
        one_hit = h0 ^ h1
        only = jnp.where(h0, nc[:, 0], nc[:, 1])

        # push far child when both children hit
        sp = s["sp"]
        stack = s["stack"]
        stack = stack.at[jnp.arange(n), jnp.minimum(sp, SD - 1)].set(
            jnp.where(both, far, stack[jnp.arange(n), jnp.minimum(sp, SD - 1)]))
        sp = jnp.where(both, jnp.minimum(sp + 1, SD), sp)

        next_node = jnp.where(both, near,
                              jnp.where(one_hit, only, DONE))  # DONE -> pop below

        # --- leaf processing ---
        lv = -node - 1
        is_inst_leaf = is_leaf & (lv >= (1 << 30)) if has_instances else jnp.zeros_like(is_leaf)
        lvv = jnp.where(is_inst_leaf, lv - (1 << 30), lv)
        start = lvv >> 4
        count = lvv & 15

        t_best, prim_best = s["t"], s["prim"]
        u_best, v_best, obj_best = s["u"], s["v"], s["obj"]
        tri_leaf = is_leaf & ~is_inst_leaf
        for k in range(LEAF_UNROLL):
            pidx = jnp.clip(start + k, 0, tri_verts.shape[0] - 1)
            m = tri_leaf & (k < count)
            tv = tri_verts[pidx]
            hit, t, u, v = ray_triangle_intersect(
                tv[:, 0], tv[:, 1], tv[:, 2], s["o_cur"], s["d_cur"],
                tmin, t_best)
            hit &= m
            pobj = jnp.where(s["cur_obj"] >= 0, s["cur_obj"],
                             prim_object[pidx])
            if visibility is not None and object_visibility is not None:
                hit &= (object_visibility[jnp.maximum(pobj, 0)]
                        & visibility) > 0
            t_best = jnp.where(hit, t, t_best)
            prim_best = jnp.where(hit, pidx, prim_best)
            u_best = jnp.where(hit, u, u_best)
            v_best = jnp.where(hit, v, v_best)
            obj_best = jnp.where(hit, pobj, obj_best)

        o_cur, d_cur, cur_obj = s["o_cur"], s["d_cur"], s["cur_obj"]
        if has_instances:
            # instance leaves have count == 1 by construction
            iidx = jnp.clip(start, 0, instance_w2o.shape[0] - 1)
            w2o = instance_w2o[iidx]          # (N, 3, 4)
            blas = instance_blas_root[iidx]
            iobj = instance_object[iidx]
            o_l = mat34_point(w2o, o)
            d_l = mat34_dir(w2o, d)
            o_cur = jnp.where(is_inst_leaf[:, None], o_l, o_cur)
            d_cur = jnp.where(is_inst_leaf[:, None], d_l, d_cur)
            cur_obj = jnp.where(is_inst_leaf, iobj, cur_obj)
            # push RESTORE, then continue at BLAS root
            stack = stack.at[jnp.arange(n), jnp.minimum(sp, SD - 1)].set(
                jnp.where(is_inst_leaf, RESTORE,
                          stack[jnp.arange(n), jnp.minimum(sp, SD - 1)]))
            sp = jnp.where(is_inst_leaf, jnp.minimum(sp + 1, SD), sp)
            next_node = jnp.where(is_inst_leaf, blas, next_node)

        # shadow early-out: lane done once any hit recorded
        if shadow_any_hit:
            done_lane = prim_best >= 0
            next_node = jnp.where(done_lane, DONE, next_node)
            sp = jnp.where(done_lane, 0, sp)

        s2 = {"node": next_node, "sp": sp, "stack": stack,
              "t": t_best, "prim": prim_best, "u": u_best, "v": v_best,
              "obj": obj_best, "o_cur": o_cur, "d_cur": d_cur,
              "cur_obj": cur_obj}
        # Lanes whose next node is unresolved (miss-both inners, finished
        # triangle leaves, shadow-terminated lanes with sp=0) pop the
        # stack; empty stack -> DONE.
        needs_pop = active & (next_node == DONE)
        node3, nsp = pop(s2, needs_pop)
        s2["node"] = jnp.where(active, node3, DONE)
        s2["sp"] = jnp.where(active, nsp, s2["sp"])
        return s2

    out = jax.lax.while_loop(cond, body, state)
    hit_mask = out["t"] < t_best0
    return {"t": out["t"],
            "prim": jnp.where(hit_mask, out["prim"], -1),
            "u": out["u"], "v": out["v"],
            "object": jnp.where(hit_mask, out["obj"], -1)}


def shadow_blocked_brute(tri_verts, prim_object, o, d, tmin, tmax,
                         visibility=None, object_visibility=None, block=8,
                         tri_verts_t1=None, time=None):
    """Boolean occlusion (opaque shadows, ref: kernel/kernel_shadow.h
    shadow_blocked fast path). Tri-major like intersect_brute but with a
    pure any-hit reduction — no winner tracking."""
    n = o.shape[0]
    if tri_verts.shape[0] == 0:
        return jnp.zeros((n,), bool)
    if visibility is not None and object_visibility is not None:
        vis_arr = object_visibility[jnp.maximum(prim_object, 0)]
    else:
        vis_arr = None
    nb, v0b, e1b, e2b, pob, pvb = _pack_tri_blocks(
        tri_verts, prim_object, vis_arr, block)
    deltas = _deform_delta_blocks(tri_verts_t1, prim_object,
                                  v0b, e1b, e2b, block)
    ws = watertight_setup(o, d)

    def body(blocked, blk):
        delta = None
        if deltas is not None:
            nd = len(deltas)
            blk, delta = blk[:-nd], _unflatten_deltas(blk[-nd:])
        if pvb is not None:
            v0, e1, e2, po, pv = blk
        else:
            v0, e1, e2, po = blk
        v0c, e1c, e2c = _motion_components(v0, e1, e2, delta, time)
        hit, t, u, v = _wt_block(ws, v0c, e1c, e2c, tmin[None],
                                 tmax[None])
        hit &= po[:, None] >= 0
        if pvb is not None:
            hit &= (pv[:, None] & visibility[None]) > 0
        return blocked | jnp.any(hit, axis=0), None

    xs = (v0b, e1b, e2b, pob, pvb) if pvb is not None \
        else (v0b, e1b, e2b, pob)
    if deltas is not None:
        xs = xs + deltas
    blocked, _ = jax.lax.scan(body, jnp.zeros((n,), bool), xs)
    return blocked


def intersect_brute_occlusion(tri_verts, prim_object, boundary_mask,
                              o, d, tmin, tmax_closest, tmax_any,
                              visibility_closest, visibility_any,
                              object_visibility, block=8,
                              tri_verts_t1=None, time=None):
    """Volume-NEE occlusion sweep with NO winner selection.

    The closest-hit WINNER reduction (min + 3 masked-max chains) costs
    more than the triangle math itself (tools/stage_profile.py measures
    it). Volume NEE never needs u/v/
    prim from the boundary search — only "how far to the first medium
    boundary" vs "is anything solid in front of it". Those are TWO
    masked min-reductions over a host-precomputed per-prim boundary
    mask, plus the shadow any-hit OR — 3 cheap reductions per block
    (ref semantics: kernel_volume.h shadow transmittance +
    kernel_shadow.h shadow_blocked).

    Returns (t_boundary (N,), t_other (N,), blocked (N,)); t_* are
    RAY_TMAX-capped minima over camera-visible boundary / non-boundary
    prims inside [tmin, tmax_closest]; blocked is the any-hit under
    visibility_any inside [tmin, tmax_any].
    """
    n = o.shape[0]
    if tri_verts.shape[0] == 0:
        return (jnp.full((n,), RAY_TMAX, prec.FT),
                jnp.full((n,), RAY_TMAX, prec.FT), jnp.zeros((n,), bool))
    vis_c = object_visibility[jnp.maximum(prim_object, 0)]
    nb, v0b, e1b, e2b, pob, pvb = _pack_tri_blocks(
        tri_verts, prim_object, vis_c, block)
    p = tri_verts.shape[0]
    bm = jnp.pad(boundary_mask, (0, (-p) % block)).reshape(nb, block)
    deltas = _deform_delta_blocks(tri_verts_t1, prim_object,
                                  v0b, e1b, e2b, block)
    ws = watertight_setup(o, d)

    def body(carry, blk):
        t_b, t_o, blocked = carry
        delta = None
        if deltas is not None:
            nd = len(deltas)
            blk, delta = blk[:-nd], _unflatten_deltas(blk[-nd:])
        v0, e1, e2, po, pv, bmk = blk
        v0c, e1c, e2c = _motion_components(v0, e1, e2, delta, time)
        geom, t, u, v = _wt_block(ws, v0c, e1c, e2c, tmin[None],
                                  prec.FT(RAY_TMAX))
        geom &= po[:, None] >= 0
        blocked = blocked | jnp.any(
            geom & (t < tmax_any[None])
            & ((pv[:, None] & visibility_any[None]) > 0), axis=0)
        hit_c = geom & (t < tmax_closest[None]) \
            & ((pv[:, None] & visibility_closest[None]) > 0)
        t_b = jnp.minimum(t_b, jnp.min(
            jnp.where(hit_c & bmk[:, None], t, RAY_TMAX), axis=0))
        t_o = jnp.minimum(t_o, jnp.min(
            jnp.where(hit_c & ~bmk[:, None], t, RAY_TMAX), axis=0))
        return (t_b, t_o, blocked), None

    init = (jnp.full((n,), RAY_TMAX, prec.FT),
            jnp.full((n,), RAY_TMAX, prec.FT),
            jnp.zeros((n,), bool))
    xs = (v0b, e1b, e2b, pob, pvb, bm)
    if deltas is not None:
        xs = xs + deltas
    (t_b, t_o, blocked), _ = jax.lax.scan(body, init, xs)
    return t_b, t_o, blocked


# ===========================================================================
# Packed single-fetch traversal (round-1.5 of the BVH path)
# ===========================================================================
#
# The baseline lockstep traversal costs ~10 dynamic row fetches per
# iteration (bounds, children, 8 leaf triangles). The packed layout
# collapses everything to TWO fetches per iteration:
#
#   nodes_packed (M, 20) f32 : bounds(12) + child0/child1 as EXACT small
#                              floats + per-child instance flags + pad
#   leaf_blocks  (L, 80) f32 : 8 triangles x (v0, e1, e2) + 8 prim ids
#                              as floats; instance leaves reuse the row:
#                              w2o(12) + blas_root + object as floats
#
# All payloads are FINITE floats with magnitude < 2^24 so they survive
# a one-hot lookup (ops/lookup.py; 0 x Inf/NaN would poison the row
# sum). Packed child encoding: >= 0 inner node index; < 0 leaf
# -(1 + leaf_row*16 + count); the instance flag is its own column.

LEAF_BLOCK_TRIS = 8
LEAF_BLOCK_COLS = 80
NODE_COLS = 20
_BIG = 1e30  # finite stand-in for +/-inf bounds


def intersect_bvh_packed(nodes_packed, leaf_blocks, o, d, tmin, tmax,
                         has_instances=False, o_world=None, d_world=None,
                         prim_object=None, visibility=None,
                         object_visibility=None, shadow_any_hit=False,
                         time=None, has_motion=False, stack_depth=None,
                         motion_steps=2):
    """Lockstep traversal over the packed layout: 2 row fetches per
    iteration. Semantics identical to intersect_bvh."""
    n = o.shape[0]
    SD = int(stack_depth) if stack_depth else STACK_DEPTH
    t_best0 = jnp.minimum(tmax, RAY_TMAX)
    state = {
        "node": jnp.zeros((n,), jnp.int32),
        "sp": jnp.zeros((n,), jnp.int32),
        "stack": jnp.zeros((n, SD), jnp.int32),
        "t": t_best0,
        "prim": jnp.full((n,), -1, jnp.int32),
        "u": jnp.zeros((n,), prec.FT),
        "v": jnp.zeros((n,), prec.FT),
        "obj": jnp.full((n,), -1, jnp.int32),
        "o_cur": o, "d_cur": d,
        "cur_obj": jnp.full((n,), -1, jnp.int32),
    }
    # stack entries carry the instance flag at bit 30 of the magnitude
    INST_BIT = jnp.int32(1 << 29)

    def cond(s):
        return jnp.any(s["node"] != DONE)

    def pop(s, lane_mask):
        sp = s["sp"]
        has = sp > 0
        nsp = jnp.where(lane_mask & has, sp - 1, sp)
        popped = s["stack"][jnp.arange(n), jnp.maximum(nsp, 0)]
        node = jnp.where(lane_mask, jnp.where(has, popped, DONE), s["node"])
        return node, nsp

    def body(s):
        node = s["node"]
        if has_instances:
            restoring = node == RESTORE
            s = dict(s)
            s["o_cur"] = jnp.where(restoring[:, None], o_world, s["o_cur"])
            s["d_cur"] = jnp.where(restoring[:, None], d_world, s["d_cur"])
            s["cur_obj"] = jnp.where(restoring, -1, s["cur_obj"])
            node2, nsp = pop(s, restoring)
            s["node"] = node2
            s["sp"] = nsp
            node = node2

        active = node != DONE
        # decode the per-lane node id: bit 29 of magnitude = instance leaf
        neg = node < 0
        mag = jnp.where(neg, -node - 1, 0)
        is_inst_node = (mag & INST_BIT) > 0 if has_instances \
            else jnp.zeros((n,), bool)
        mag = mag & (INST_BIT - 1)
        is_inner = active & ~neg & (node != DONE) & (node != RESTORE)
        is_leaf = active & neg

        from raytracingproject_tpu.ops import lookup as lk
        nrow = lk.lookup_rows(
            nodes_packed,
            jnp.where(is_inner,
                      jnp.clip(node, 0, nodes_packed.shape[0] - 1), 0))
        c0 = jnp.round(nrow[:, 12]).astype(jnp.int32)
        c1 = jnp.round(nrow[:, 13]).astype(jnp.int32)
        c0_inst = nrow[:, 14] > 0.5
        c1_inst = nrow[:, 15] > 0.5

        def child_to_node(c, inst):
            # leaf children carry the instance flag into the node id
            if not has_instances:
                return c
            return jnp.where(inst & (c < 0), -((-c - 1) | INST_BIT) - 1, c)

        c0n = child_to_node(c0, c0_inst)
        c1n = child_to_node(c1, c1_inst)

        inv_d = _safe_inv(s["d_cur"])
        h0, t0 = _slab_test(nrow[:, 0:3], nrow[:, 3:6], s["o_cur"], inv_d,
                            tmin, s["t"])
        h1, t1 = _slab_test(nrow[:, 6:9], nrow[:, 9:12], s["o_cur"], inv_d,
                            tmin, s["t"])
        h0 &= is_inner
        h1 &= is_inner

        near_first = t0 <= t1
        near = jnp.where(near_first, c0n, c1n)
        far = jnp.where(near_first, c1n, c0n)
        both = h0 & h1
        one_hit = h0 ^ h1
        only = jnp.where(h0, c0n, c1n)

        sp = s["sp"]
        stack = s["stack"]
        stack = stack.at[jnp.arange(n), jnp.minimum(sp, SD - 1)].set(
            jnp.where(both, far,
                      stack[jnp.arange(n), jnp.minimum(sp, SD - 1)]))
        sp = jnp.where(both, jnp.minimum(sp + 1, SD), sp)

        next_node = jnp.where(both, near,
                              jnp.where(one_hit, only, DONE))

        # FETCH 2: leaf block row
        leaf_row_idx = mag // 16
        count = mag % 16
        is_inst_leaf = is_leaf & is_inst_node
        lrow = lk.lookup_rows(
            leaf_blocks, jnp.where(is_leaf,
                                   jnp.clip(leaf_row_idx, 0,
                                            leaf_blocks.shape[0] - 1), 0))

        t_best, prim_best = s["t"], s["prim"]
        u_best, v_best, obj_best = s["u"], s["v"], s["obj"]
        tri_leaf = is_leaf & ~is_inst_leaf
        # the current ray changes at instance boundaries, so the shear
        # basis is rebuilt per iteration (cheap next to the row fetches)
        ws = watertight_setup(s["o_cur"], s["d_cur"])
        for k in range(LEAF_BLOCK_TRIS):
            base = k * 9
            v0c = (lrow[:, base], lrow[:, base + 1], lrow[:, base + 2])
            e1c = (lrow[:, base + 3], lrow[:, base + 4], lrow[:, base + 5])
            e2c = (lrow[:, base + 6], lrow[:, base + 7], lrow[:, base + 8])
            hit, tt, uu, vv = _wt_block(ws, v0c, e1c, e2c, tmin, t_best)
            hit &= tri_leaf & (k < count)
            pidx = jnp.round(lrow[:, 72 + k]).astype(jnp.int32)
            pobj = jnp.where(s["cur_obj"] >= 0, s["cur_obj"],
                             prim_object[jnp.maximum(pidx, 0)]
                             if prim_object is not None else -1)
            if visibility is not None and object_visibility is not None:
                hit &= (object_visibility[jnp.maximum(pobj, 0)]
                        & visibility) > 0
            t_best = jnp.where(hit, tt, t_best)
            prim_best = jnp.where(hit, pidx, prim_best)
            u_best = jnp.where(hit, uu, u_best)
            v_best = jnp.where(hit, vv, v_best)
            obj_best = jnp.where(hit, pobj, obj_best)

        o_cur, d_cur, cur_obj = s["o_cur"], s["d_cur"], s["cur_obj"]
        if has_instances:
            w2o = lrow[:, 0:12].reshape(n, 3, 4)
            blas = jnp.round(lrow[:, 12]).astype(jnp.int32)
            iobj = jnp.round(lrow[:, 13]).astype(jnp.int32)
            if has_motion and time is not None:
                # object motion blur: interpolate the decomposed
                # object->world transform at the lane's shutter time and
                # invert on the fly (ref: object_fetch_transform_motion)
                from raytracingproject_tpu.utils import transform as _tfm
                moving = lrow[:, 14] > 0.5
                o2w_t = _tfm.motion_interpolate_steps(
                    lrow[:, 16:16 + 16 * motion_steps], time,
                    motion_steps)
                w2o_t = _tfm.quick_inverse_jnp(o2w_t)
                w2o = jnp.where(moving[:, None, None], w2o_t, w2o)
            o_l = mat34_point(w2o, o_world)
            d_l = mat34_dir(w2o, d_world)
            o_cur = jnp.where(is_inst_leaf[:, None], o_l, o_cur)
            d_cur = jnp.where(is_inst_leaf[:, None], d_l, d_cur)
            cur_obj = jnp.where(is_inst_leaf, iobj, cur_obj)
            stack = stack.at[jnp.arange(n),
                             jnp.minimum(sp, SD - 1)].set(
                jnp.where(is_inst_leaf, RESTORE,
                          stack[jnp.arange(n),
                                jnp.minimum(sp, SD - 1)]))
            sp = jnp.where(is_inst_leaf, jnp.minimum(sp + 1, SD), sp)
            next_node = jnp.where(is_inst_leaf, blas, next_node)

        if shadow_any_hit:
            done_lane = prim_best >= 0
            next_node = jnp.where(done_lane, DONE, next_node)
            sp = jnp.where(done_lane, 0, sp)

        s2 = {"node": next_node, "sp": sp, "stack": stack,
              "t": t_best, "prim": prim_best, "u": u_best, "v": v_best,
              "obj": obj_best, "o_cur": o_cur, "d_cur": d_cur,
              "cur_obj": cur_obj}
        needs_pop = active & (next_node == DONE)
        node3, nsp = pop(s2, needs_pop)
        s2["node"] = jnp.where(active, node3, DONE)
        s2["sp"] = jnp.where(active, nsp, s2["sp"])
        return s2

    out = jax.lax.while_loop(cond, body, state)
    hit_mask = out["t"] < t_best0
    return {"t": out["t"],
            "prim": jnp.where(hit_mask, out["prim"], -1),
            "u": out["u"], "v": out["v"],
            "object": jnp.where(hit_mask, out["obj"], -1)}


def pack_traversal_tables(bvh_bounds, bvh_children, tri_verts,
                          instance_w2o=None, instance_blas_root=None,
                          instance_object=None, instance_motion=None):
    """Host-side repack of (bounds, children, prim-ordered tris) into
    the single-fetch layout consumed by intersect_bvh_packed. Leaf
    references are re-encoded from prim ranges to leaf-block rows; every
    payload is a finite float exactly representable in f32."""
    import numpy as np
    m = len(bvh_bounds)
    nodes = np.zeros((m, NODE_COLS), np.float32)
    b = np.array(bvh_bounds, np.float32, copy=True)
    b = np.clip(np.nan_to_num(b, posinf=_BIG, neginf=-_BIG), -_BIG, _BIG)
    nodes[:, 0:12] = b

    # instance rows carry S decomposed motion steps at 16 + 16*k; the
    # classic 2-step layout (16:32, 32:48) fits the 80-col tri rows,
    # S > 4 widens every row
    obj_steps = 2
    if instance_motion is not None:
        obj_steps = max([len(mo) for mo in instance_motion
                         if mo is not None] + [2])
    row_cols = max(LEAF_BLOCK_COLS, 16 + 16 * obj_steps)

    leaf_rows = []

    def encode_child(child):
        """-> (float code, instance flag float)."""
        child = int(child)
        if child >= 0:
            assert child < (1 << 24)
            return float(child), 0.0
        v = -child - 1
        is_inst = bool(v >> 30)
        v &= (1 << 30) - 1
        start, count = v >> 4, v & 15
        if is_inst:
            row = np.zeros(row_cols, np.float32)
            row[0:12] = np.asarray(instance_w2o[start],
                                   np.float32).reshape(12)
            row[12] = float(int(instance_blas_root[start]))
            row[13] = float(int(instance_object[start]))
            if instance_motion is not None \
                    and instance_motion[start] is not None:
                mo = instance_motion[start]
                row[14] = 1.0
                for k, dk in enumerate(mo):
                    row[16 + 16 * k:32 + 16 * k] = dk
                # objects with fewer steps repeat their last decomp so
                # every segment interpolates validly
                for k in range(len(mo), obj_steps):
                    row[16 + 16 * k:32 + 16 * k] = mo[-1]
            leaf_rows.append(row)
            code = 1 + (len(leaf_rows) - 1) * 16 + 1
            assert code < (1 << 24)
            return float(-code), 1.0
        row = np.zeros(row_cols, np.float32)
        cnt = min(count, LEAF_BLOCK_TRIS)
        for k in range(cnt):
            tv = tri_verts[start + k]
            row[k * 9:k * 9 + 3] = tv[0]
            row[k * 9 + 3:k * 9 + 6] = tv[1] - tv[0]
            row[k * 9 + 6:k * 9 + 9] = tv[2] - tv[0]
            row[72 + k] = float(start + k)
        for k in range(cnt, LEAF_BLOCK_TRIS):
            row[72 + k] = -1.0
        leaf_rows.append(row)
        code = 1 + (len(leaf_rows) - 1) * 16 + cnt
        assert code < (1 << 24)
        return float(-code), 0.0

    for i in range(m):
        nodes[i, 12], nodes[i, 14] = encode_child(bvh_children[i][0])
        nodes[i, 13], nodes[i, 15] = encode_child(bvh_children[i][1])
    if not leaf_rows:
        leaf_rows.append(np.zeros(row_cols, np.float32))
    return nodes, np.asarray(leaf_rows, np.float32)


# ===========================================================================
# Native curve (hair) intersection — ray-facing ribbon segments
# ===========================================================================
#
# The reference intersects hair as curves in-kernel
# (kernel/geom/geom_curve_intersect.h; default shape "ribbon" oriented
# to the ray). The redesign keeps hair OUT of the BVH entirely:
# linear curve segments live in their own dense SoA table and are swept
# tri-major-style after the triangle traversal, then merged by min-t.
# One segment test is ~25 fused VPU flops (line-line closest approach +
# radius compare) with ZERO gathers — ~10x fewer primitives than the
# old twisted-ribbon tessellation for the same strands, each cheaper
# than a triangle test.
#
# Segment tables are packed world-space by models/scene.py (static /
# flattened hair only; instanced or deforming hair falls back to
# tessellation there).


def _pack_curve_blocks(seg_p0, seg_e, seg_r0, seg_r1, seg_object,
                       visibility_arr, block):
    s = seg_p0.shape[0]
    pad = (-s) % block
    p0 = jnp.pad(seg_p0, ((0, pad), (0, 0)))
    e = jnp.pad(seg_e, ((0, pad), (0, 0)))
    r0 = jnp.pad(seg_r0, (0, pad))
    r1 = jnp.pad(seg_r1, (0, pad))
    so = jnp.pad(seg_object, (0, pad), constant_values=-1)
    pv = None
    if visibility_arr is not None:
        pv = jnp.pad(visibility_arr, (0, pad))
    nb = (s + pad) // block
    return (nb, p0.reshape(nb, block, 3), e.reshape(nb, block, 3),
            r0.reshape(nb, block), r1.reshape(nb, block),
            so.reshape(nb, block),
            pv.reshape(nb, block) if pv is not None else None)


def _curve_block_test(p0, e, r0, r1, oc, dc, a, tmin, t_cap):
    """Ribbon test on one (B, 3) segment block vs all rays.

    Returns (hit (B,N), t (B,N), s_along (B,N), v_across (B,N)).
    oc/dc are per-component ray (N,) arrays; a = d.d (N,).

    Closest approach between the ray line and the segment axis; a lane
    hits when the distance at the (clamped) closest point is within the
    lerped radius — the ray-facing ribbon semantic (ref:
    geom_curve_intersect.h ribbon path). t is the axis closest-approach
    t (thin-hair approximation, exact as width -> 0)."""
    p0c = [p0[:, i, None] for i in range(3)]
    ec = [e[:, i, None] for i in range(3)]
    w0c = [p0c[i] - oc[i][None, :] for i in range(3)]
    b = sum(dc[i][None, :] * ec[i] for i in range(3))
    c = sum(ec[i] * ec[i] for i in range(3))
    dw = sum(dc[i][None, :] * w0c[i] for i in range(3))
    ew = sum(ec[i] * w0c[i] for i in range(3))
    denom = a[None, :] * c - b * b
    # parallel ray/axis: pick the segment start (dist test still valid)
    s = jnp.where(denom > 1e-20, (b * dw - a[None, :] * ew)
                  / jnp.where(denom > 1e-20, denom, 1.0), 0.0)
    s = jnp.clip(s, 0.0, 1.0)
    t = (dw + b * s) / a[None, :]
    # closest vector C = t d - s e - w0 and its squared length
    Cc = [t * dc[i][None, :] - s * ec[i] - w0c[i] for i in range(3)]
    dist2 = sum(Cc[i] * Cc[i] for i in range(3))
    r = r0[:, None] + (r1 - r0)[:, None] * s
    # report the FRONT-surface t (cylinder entry), not the axis t:
    # secondary rays spawned from an axis point would sit inside the
    # virtual tube and self-shadow every bounce
    inside = jnp.maximum(r * r - dist2, 0.0)
    t = t - jnp.sqrt(inside / a[None, :])
    hit = (dist2 <= r * r) & (t > tmin) & (t < t_cap) & (c > 1e-20)
    # signed across-ribbon coordinate: C is ~parallel to d x e at the
    # closest approach; its sign against that axis orients u
    nx = dc[1][None, :] * ec[2] - dc[2][None, :] * ec[1]
    ny = dc[2][None, :] * ec[0] - dc[0][None, :] * ec[2]
    nz = dc[0][None, :] * ec[1] - dc[1][None, :] * ec[0]
    nn = jnp.sqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-30))
    side = (Cc[0] * nx + Cc[1] * ny + Cc[2] * nz) / nn
    v_across = jnp.clip(side / jnp.maximum(r, 1e-12), -1.0, 1.0)
    return hit, t, s, v_across


def intersect_curves_ribbon(seg_p0, seg_e, seg_r0, seg_r1, seg_object,
                            prim_base, o, d, tmin, tmax, hit0=None,
                            visibility=None, object_visibility=None,
                            block=8):
    """Dense sweep over curve segments, merged into `hit0` by min-t.

    prim_base: curve prim i reports prim id prim_base + i (segment rows
    are appended after the triangle rows in the prim table)."""
    n = o.shape[0]
    vis_arr = None
    if visibility is not None and object_visibility is not None:
        vis_arr = object_visibility[jnp.maximum(seg_object, 0)]
    nb, p0b, eb, r0b, r1b, sob, pvb = _pack_curve_blocks(
        seg_p0, seg_e, seg_r0, seg_r1, seg_object, vis_arr, block)
    oc = [o[:, i] for i in range(3)]
    dc = [d[:, i] for i in range(3)]
    a = sum(dc[i] * dc[i] for i in range(3))
    if hit0 is None:
        hit0 = empty_hit(n)
        hit0["t"] = jnp.minimum(tmax, RAY_TMAX)

    def body(carry, blk):
        t_best, prim_best, u_best, v_best, obj_best = carry
        if pvb is not None:
            p0, e, r0, r1, so, pv, bbase = blk
        else:
            p0, e, r0, r1, so, bbase = blk
        hit, t, s, va = _curve_block_test(p0, e, r0, r1, oc, dc, a,
                                          tmin[None], t_best[None])
        hit &= so[:, None] >= 0
        if pvb is not None:
            hit &= (pv[:, None] & visibility[None]) > 0
        t = jnp.where(hit, t, RAY_TMAX)
        tk = jnp.min(t, axis=0)
        win = t == tk[None]
        kidx = jax.lax.broadcasted_iota(jnp.int32, t.shape, 0)
        k = jnp.max(jnp.where(win, kidx, -1), axis=0)
        sk = jnp.max(jnp.where(win, s, -jnp.inf), axis=0)
        vk = jnp.max(jnp.where(win, va, -jnp.inf), axis=0)
        ok = jnp.max(jnp.where(win, so[:, None], -1), axis=0)
        better = tk < t_best
        t_best = jnp.where(better, tk, t_best)
        prim_best = jnp.where(better, prim_base + bbase + k, prim_best)
        u_best = jnp.where(better, sk, u_best)
        v_best = jnp.where(better, vk, v_best)
        obj_best = jnp.where(better, ok, obj_best)
        return (t_best, prim_best, u_best, v_best, obj_best), None

    init = (hit0["t"], hit0["prim"], hit0["u"], hit0["v"], hit0["object"])
    bbase = jnp.arange(nb, dtype=jnp.int32) * block
    xs = (p0b, eb, r0b, r1b, sob, pvb, bbase) if pvb is not None \
        else (p0b, eb, r0b, r1b, sob, bbase)
    (t, prim, u, v, obj), _ = jax.lax.scan(body, init, xs)
    return {"t": t, "prim": prim, "u": u, "v": v, "object": obj}


def curves_any_hit(seg_p0, seg_e, seg_r0, seg_r1, seg_object,
                   o, d, tmin, tmax, visibility=None,
                   object_visibility=None, block=8):
    """Boolean shadow any-hit over the curve segment table."""
    vis_arr = None
    if visibility is not None and object_visibility is not None:
        vis_arr = object_visibility[jnp.maximum(seg_object, 0)]
    nb, p0b, eb, r0b, r1b, sob, pvb = _pack_curve_blocks(
        seg_p0, seg_e, seg_r0, seg_r1, seg_object, vis_arr, block)
    oc = [o[:, i] for i in range(3)]
    dc = [d[:, i] for i in range(3)]
    a = sum(dc[i] * dc[i] for i in range(3))
    cap = jnp.minimum(tmax, RAY_TMAX)

    def body(blocked, blk):
        if pvb is not None:
            p0, e, r0, r1, so, pv = blk
        else:
            p0, e, r0, r1, so = blk
        hit, t, s, va = _curve_block_test(p0, e, r0, r1, oc, dc, a,
                                          tmin[None], cap[None])
        hit &= so[:, None] >= 0
        if pvb is not None:
            hit &= (pv[:, None] & visibility[None]) > 0
        return blocked | jnp.any(hit, axis=0), None

    xs = (p0b, eb, r0b, r1b, sob, pvb) if pvb is not None \
        else (p0b, eb, r0b, r1b, sob)
    blocked, _ = jax.lax.scan(body, jnp.zeros(o.shape[:1], bool), xs)
    return blocked
