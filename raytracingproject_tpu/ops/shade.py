"""Shading-point setup + material dispatch (ref: kernel/kernel_shader.h
shader_setup_from_ray, shader_eval_surface; kernel/geom/geom_triangle.h).

`shader_setup` gathers per-primitive data (verts, per-corner normals/UVs,
object transforms) for an entire hit wavefront and builds the ShaderData
SoA view. `eval_shaders` dispatches the scene's traced shader functions
over the wavefront with per-lane selection masks — the stand-in for
SVM bytecode dispatch; material sorting (ops/sort.py) can pre-group lanes
by shader id so each masked eval is dense.
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp

from raytracingproject_tpu.utils import math as um
from raytracingproject_tpu.models.object import (
    PATH_RAY_CAMERA,
)


@dataclass
class ShaderData:
    """Per-lane shading context (ref: ShaderData kernel/kernel_types.h:1151)."""
    P: Any = None            # (N, 3) world hit position
    N: Any = None            # (N, 3) shading normal (world, faced forward)
    Ng: Any = None           # (N, 3) geometric normal (world, faced forward)
    Ns: Any = None           # (N, 3) unflipped smooth normal
    I: Any = None            # (N, 3) toward viewer (= -ray dir)
    uv: Any = None           # (N, 2)
    generated: Any = None    # (N, 3) object-space normalized coords
    P_object: Any = None     # (N, 3) object-space position
    time: Any = None
    ray_length: Any = None
    ray_depth: Any = None
    path_flag: Any = None
    prim: Any = None
    shader: Any = None       # (N,) shader slot
    object_index: Any = None
    object_color: Any = None
    object_location: Any = None
    object_random: Any = None
    backfacing: Any = None
    dPdu: Any = None         # (N, 3) curve tangent (hair; zeros on mesh)
    bary_u: Any = None       # (N,) hit barycentric u (bump differencing)
    bary_v: Any = None
    gen_tfm: Any = None      # (N, 3, 4) world P -> generated coords
    vcol: Any = None         # (N, 4) interpolated vertex color (RGBA);
                             # None when the scene packs no color attr
    ao: Any = None           # (N,) shade-time AO probe result for
                             # AmbientOcclusionNode (integrator fills
                             # it only when the scene has the node)
    bevel_N: Any = None      # (N, 3) probe-averaged normal for
                             # BevelNode; None without the node
    uv_density: Any = None   # (N,) |duv| per world unit at the hit
                             # triangle (auto-mip footprint estimation)
    textures: Any = None
    batch_shape: tuple = field(default_factory=tuple)
    # cached wide-table rows for reuse by light MIS (avoids re-lookup)
    prim_row: Any = None
    object_tfm: Any = None
    object_row: Any = None   # full object_table row (ParticleInfo etc.)


_SD_ARRAY_FIELDS = [
    "P", "N", "Ng", "Ns", "I", "uv", "generated", "P_object", "time",
    "ray_length", "ray_depth", "path_flag", "prim", "shader",
    "object_index", "object_color", "object_location", "object_random",
    "backfacing", "dPdu", "bary_u", "bary_v", "gen_tfm", "vcol",
    "ao", "bevel_N", "uv_density", "prim_row", "object_tfm",
    "object_row"]


def _sd_flatten(sd):
    return tuple(getattr(sd, f) for f in _SD_ARRAY_FIELDS), \
        (sd.textures, sd.batch_shape)


def _sd_unflatten(aux, children):
    sd = ShaderData(**dict(zip(_SD_ARRAY_FIELDS, children)))
    sd.textures, sd.batch_shape = aux
    return sd


jax.tree_util.register_pytree_node(ShaderData, _sd_flatten, _sd_unflatten)


def shader_setup(dscene, hit, ray_o, ray_d, time=None, ray_depth=None,
                 path_flag=None, textures=None):
    """Build ShaderData for hit lanes (missed lanes carry garbage that
    must stay masked by the caller).

    All per-prim / per-object attributes come from TWO wide-table
    lookups (ops/lookup.py) instead of ~12 row gathers."""
    from raytracingproject_tpu.ops import lookup as lk
    n = ray_o.shape[0]
    prim = jnp.maximum(hit["prim"], 0)
    obj = jnp.maximum(hit["object"], 0)

    prow = lk.lookup_rows(dscene["prim_table"], prim)     # (N, 32)
    orow = lk.lookup_rows(dscene["object_table"], obj)    # (N, 48)

    tv = prow[:, lk.PT_V0:lk.PT_V0 + 9].reshape(n, 3, 3)
    vn = prow[:, lk.PT_VN:lk.PT_VN + 9].reshape(n, 3, 3)
    tuv = prow[:, lk.PT_UV:lk.PT_UV + 6].reshape(n, 3, 2)
    shader = prow[:, lk.PT_SHADER].astype(jnp.int32)
    smooth = prow[:, lk.PT_SMOOTH] > 0.5

    otfm = lk.mat34(orow[:, lk.OT_TFM:lk.OT_TFM + 12])
    oitfm = lk.mat34(orow[:, lk.OT_ITFM:lk.OT_ITFM + 12])

    u = hit["u"][:, None]
    v = hit["v"][:, None]
    w = 1.0 - u - v

    # object-space position & normals (barycentric: P = w*v0 + u*v1 + v*v2)
    P_obj = w * tv[:, 0] + u * tv[:, 1] + v * tv[:, 2]
    Ng_obj = um.triangle_normal(tv[:, 0], tv[:, 1], tv[:, 2])
    Ns_obj = um.safe_normalize(w * vn[:, 0] + u * vn[:, 1] + v * vn[:, 2])
    Ns_obj = jnp.where(smooth[:, None], Ns_obj, Ng_obj)

    # to world: P by object tfm; normals by inverse-transpose
    P = um.mat34_point(otfm, P_obj)
    Ng = um.safe_normalize(um.mat33T_dir(oitfm, Ng_obj))
    Ns = um.safe_normalize(um.mat33T_dir(oitfm, Ns_obj))

    # use exact ray equation for P to avoid re-transform rounding
    P = ray_o + hit["t"][:, None] * ray_d

    # texture/generated space: always the ORIGINAL object space, even for
    # world-baked merged geometry (object_itfm_gen keeps the pre-merge
    # inverse; ref: ATTR_STD_GENERATED uses undeformed coords)
    gen_itfm = lk.mat34(orow[:, lk.OT_ITFM_GEN:lk.OT_ITFM_GEN + 12])
    P_gen = um.mat34_point(gen_itfm, P)

    I = -ray_d
    backfacing = um.dot(Ng, I) < 0.0
    Ngf = jnp.where(backfacing[:, None], -Ng, Ng)
    Nf = jnp.where(um.dot(Ns, I)[:, None] < 0.0, -Ns, Ns)

    uv = w * tuv[:, 0] + u * tuv[:, 1] + v * tuv[:, 2]

    # uv density for auto-mip selection (ref: the CPU path derives
    # texture footprints from ray differentials, image.cpp /
    # kernel_differential.h; here: first-hit footprint = ray_length x
    # pixel angle, converted to uv units by the triangle's own
    # |duv|/|dP| ratio — no per-bounce differential state needed)
    ed1 = tv[:, 1] - tv[:, 0]
    ed2 = tv[:, 2] - tv[:, 0]
    uv1 = tuv[:, 1] - tuv[:, 0]
    uv2 = tuv[:, 2] - tuv[:, 0]
    den1 = jnp.sqrt(um.dot(uv1, uv1)) / jnp.maximum(
        jnp.sqrt(um.dot(ed1, ed1)), 1e-12)
    den2 = jnp.sqrt(um.dot(uv2, uv2)) / jnp.maximum(
        jnp.sqrt(um.dot(ed2, ed2)), 1e-12)
    uv_density = jnp.maximum(den1, den2)

    # curve tangent for hair ribbons (ATTR_STD_CURVE_TANGENT packed at
    # PT_TANGENT; zeros on mesh prims — the zero doubles as the
    # is-curve flag). Directions transform by the object linear part.
    tan_obj = prow[:, lk.PT_TANGENT:lk.PT_TANGENT + 3]
    is_curve = um.dot(tan_obj, tan_obj) > 0.25
    tan_w = um.mat34_dir(otfm, tan_obj)
    dPdu = jnp.where(is_curve[:, None], um.safe_normalize(tan_w), 0.0)

    # native curve-segment rows (PT_CURVE layout, ops/lookup.py): the
    # ribbon faces the ray, so Ng is the view direction's component
    # perpendicular to the tangent (ref: geom_curve.h curve ribbon
    # normal); uv = (across in [0,1], strand v lerped from the row)
    if "curve_p0" in dscene:
        ncurve = prow[:, lk.PT_CURVE] > 0.5
        onc = ncurve[:, None]
        ng_c = um.safe_normalize(I - dPdu * um.dot(dPdu, I)[:, None])
        Ng = jnp.where(onc, ng_c, Ng)
        Ns = jnp.where(onc, ng_c, Ns)
        # the ribbon always faces the ray: never backfacing
        backfacing = jnp.where(ncurve, False, backfacing)
        Ngf = jnp.where(onc, ng_c, Ngf)
        Nf = jnp.where(onc, ng_c, Nf)
        s_along = hit["u"]
        v_strand = (prow[:, lk.PT_UV]
                    + (prow[:, lk.PT_UV + 1] - prow[:, lk.PT_UV])
                    * s_along)
        uv = jnp.where(
            onc, jnp.stack([0.5 * (hit["v"] + 1.0), v_strand], -1), uv)

    # per-corner vertex colors (ref: ATTR_STD_VERTEX_COLOR consumed by
    # VertexColorNode/svm_attribute): a separate 12-wide table, gathered
    # only when the scene packs the attribute (scene.py gates it on
    # some shader actually reading it)
    vcol = None
    if "prim_vcol" in dscene:
        vrow = lk.lookup_rows(dscene["prim_vcol"], prim).reshape(n, 3, 4)
        vcol = w * vrow[:, 0] + u * vrow[:, 1] + v * vrow[:, 2]

    # generated coords: object-space position normalized to geometry
    # bounds (ref: ATTR_STD_GENERATED semantics)
    glo = orow[:, lk.OT_BOUNDS_LO:lk.OT_BOUNDS_LO + 3]
    ghi = orow[:, lk.OT_BOUNDS_HI:lk.OT_BOUNDS_HI + 3]
    generated = um.safe_divide(P_gen - glo, jnp.maximum(ghi - glo, 1e-12), 0.5)

    # combined world->generated affine (bump differencing re-evaluates
    # textures at offset positions): gen = S*(gen_itfm @ P - lo)
    inv_ext = 1.0 / jnp.maximum(ghi - glo, 1e-12)
    gen_tfm = jnp.concatenate(
        [gen_itfm[:, :, :3] * inv_ext[:, :, None],
         ((gen_itfm[:, :, 3] - glo) * inv_ext)[:, :, None]], axis=-1)

    sd = ShaderData(
        P=P, N=Nf, Ng=Ngf, Ns=Ns, I=I, uv=uv, generated=generated,
        P_object=P_gen,
        time=time if time is not None else jnp.zeros(n, prec.FT),
        ray_length=hit["t"],
        ray_depth=(ray_depth if ray_depth is not None
                   else jnp.zeros(n, jnp.int32)),
        path_flag=(path_flag if path_flag is not None
                   else jnp.full(n, PATH_RAY_CAMERA, jnp.uint32)),
        prim=hit["prim"], shader=shader,
        object_index=hit["object"],
        object_color=orow[:, lk.OT_COLOR:lk.OT_COLOR + 3],
        object_location=otfm[:, :, 3],
        dPdu=dPdu,
        bary_u=hit["u"], bary_v=hit["v"], gen_tfm=gen_tfm, vcol=vcol,
        uv_density=uv_density,
        object_random=orow[:, lk.OT_RANDOM],
        backfacing=backfacing,
        textures=textures,
        batch_shape=(n,),
        prim_row=prow,
        object_tfm=otfm,
        object_row=orow,
    )
    return sd


def eval_shaders(shaders, sd, shader_id, aov_names=()):
    """Evaluate every scene shader on the wavefront, select per lane.

    shaders: list of models.shader.Shader (slot i == index i).
    Returns the fixed-slot closure union. Cost is O(num_shaders) masked
    evals; keep wavefronts material-sorted for dense lanes.

    aov_names: custom AOV pass names to collect (ref: svm_aov.h) —
    when non-empty, returns (closures, {name: (N, 3)}).
    """
    from raytracingproject_tpu.ops import closures as cl
    out = cl.empty_closures(sd.batch_shape)
    aovs = {nm: jnp.zeros(sd.batch_shape + (3,), prec.FT)
            for nm in aov_names}
    for slot, shader in enumerate(shaders):
        res = shader.graph.evaluate(sd)
        c = res["surface"]
        m = shader_id == slot
        for k in out:
            out[k] = jnp.where(_m(m, out[k]), c[k], out[k])
        for nm in aov_names:
            v = res.get("aov", {}).get(nm)
            if v is not None:
                aovs[nm] = jnp.where(m[..., None], v, aovs[nm])
    if aov_names:
        return out, aovs
    return out


def _m(mask, v):
    return mask[..., None] if v.ndim > mask.ndim else mask


# --- material-sorted shading --------------------------------------------
# (ref: kernel/split/kernel_shader_sort.h — the reference sorts ray
# indices by shader so GPU warps stay coherent. The lockstep-wavefront
# analog: masked eval costs O(num_shaders) FULL-wavefront passes no
# matter the order, so sorting only pays when chunks become UNIFORM and
# can dynamically dispatch ONE shader graph. eval_shaders_sorted:
# argsort lanes by shader id, pack the lane state into one wide matrix
# (one gather), then lax.map over fixed chunks with lax.switch on the
# chunk's id — uniform chunks trace/execute a single graph; only the
# <= num_shaders boundary chunks fall back to the masked loop.)

def _sd_pack(sd):
    """Flatten a ShaderData's per-lane arrays into one (N, K) f32
    matrix + a spec to rebuild it. All int/bool/flag fields are < 2^24
    so the f32 round-trip is exact."""
    import dataclasses
    spec, cols = [], []
    n = sd.batch_shape[0]
    for f in dataclasses.fields(sd):
        name = f.name
        if name in ("textures", "batch_shape"):
            continue
        v = getattr(sd, name)
        if v is None:
            spec.append((name, None, None, 0))
            continue
        tail = v.shape[1:]
        w = 1
        for s in tail:
            w *= int(s)
        spec.append((name, tail, v.dtype, w))
        cols.append(v.reshape(n, w).astype(prec.FT))
    return jnp.concatenate(cols, axis=1), spec


def _sd_unpack(rows, spec, textures):
    kw, off = {}, 0
    for name, tail, dtype, w in spec:
        if tail is None and w == 0:
            kw[name] = None
            continue
        a = rows[:, off:off + w]
        off += w
        a = a.reshape((rows.shape[0],) + tail) if tail else a[:, 0]
        kw[name] = a.astype(dtype)
    return ShaderData(textures=textures,
                      batch_shape=(rows.shape[0],), **kw)


def _pack_closures(c):
    from raytracingproject_tpu.ops import closures as cl
    cols = [c[k].reshape(c[k].shape[0], 3) for k in cl.CLOSURE_VEC_KEYS]
    cols += [c[k][:, None] for k in cl.CLOSURE_SCALAR_KEYS]
    return jnp.concatenate(cols, axis=1)


def _unpack_closures(rows):
    from raytracingproject_tpu.ops import closures as cl
    out, off = {}, 0
    for k in cl.CLOSURE_VEC_KEYS:
        out[k] = rows[:, off:off + 3]
        off += 3
    for k in cl.CLOSURE_SCALAR_KEYS:
        out[k] = rows[:, off]
        off += 1
    return out


def eval_shaders_sorted(shaders, sd, shader_id, chunk=4096):
    """Material-sorted shading: bit-identical to eval_shaders, but
    uniform sorted chunks execute exactly one shader graph."""
    from raytracingproject_tpu.ops import closures as cl
    n = shader_id.shape[0]
    S = len(shaders)
    if S <= 1 or n <= chunk:
        return eval_shaders(shaders, sd, shader_id)
    big, spec = _sd_pack(sd)
    order = jnp.argsort(shader_id)
    big_s = big[order]
    ids_s = shader_id[order].astype(jnp.int32)
    pad = (-n) % chunk
    if pad:
        big_s = jnp.pad(big_s, ((0, pad), (0, 0)))
        ids_s = jnp.pad(ids_s, (0, pad), constant_values=-1)
    nc = (n + pad) // chunk
    K = big_s.shape[1]

    def eval_one(slot, rows):
        sd_c = _sd_unpack(rows, spec, sd.textures)
        return _pack_closures(
            shaders[slot].graph.evaluate(sd_c)["surface"])

    def mixed(rows, ids):
        sd_c = _sd_unpack(rows, spec, sd.textures)
        out = cl.empty_closures((rows.shape[0],))
        for slot, sh in enumerate(shaders):
            c = sh.graph.evaluate(sd_c)["surface"]
            m = ids == slot
            for k in out:
                out[k] = jnp.where(_m(m, out[k]), c[k], out[k])
        return _pack_closures(out)

    branches = [lambda a, s=s: eval_one(s, a[0]) for s in range(S)]
    branches.append(lambda a: mixed(a[0], a[1]))

    def per_chunk(args):
        rows, ids = args
        uniform = jnp.all(ids == ids[0]) & (ids[0] >= 0)
        idx = jnp.where(uniform, jnp.clip(ids[0], 0, S - 1), S)
        return jax.lax.switch(idx, branches, (rows, ids))

    outs = jax.lax.map(per_chunk, (big_s.reshape(nc, chunk, K),
                                   ids_s.reshape(nc, chunk)))
    flat = outs.reshape(nc * chunk, -1)[:n]
    unsorted = jnp.zeros_like(flat).at[order].set(flat)
    return _unpack_closures(unsorted)


def bump_offset_contexts(sd):
    """Finite-difference shading contexts for shade-time bump.

    Returns (ctx_c, ctx_x, ctx_y, dPdx, dPdy): the hit context rebuilt
    at its own barycentrics plus two barycentric-offset twins, and the
    world-space deltas the offsets correspond to. The center context is
    RECONSTRUCTED (triangle lerp) rather than the caller's sd so the
    differencing is consistent — reconstruction error cancels. Returns
    None when sd lacks hit geometry (background/volume contexts), in
    which case bump must pass through.

    Ref: ray-differential dP.dx/dP.dy in kernel/kernel_differential.h;
    here the step rides the triangle's own barycentric frame so no
    extra table fetches are needed."""
    import dataclasses
    from raytracingproject_tpu.ops import lookup as lk
    if not isinstance(sd, ShaderData) \
            or sd.prim_row is None or sd.bary_u is None \
            or sd.object_tfm is None:
        return None
    prow = sd.prim_row
    otfm = sd.object_tfm
    n = prow.shape[0]
    tv = prow[:, lk.PT_V0:lk.PT_V0 + 9].reshape(n, 3, 3)
    tuv = prow[:, lk.PT_UV:lk.PT_UV + 6].reshape(n, 3, 2)

    def ctx_at(uu, vv):
        ww = 1.0 - uu - vv
        P_obj = ww[:, None] * tv[:, 0] + uu[:, None] * tv[:, 1] \
            + vv[:, None] * tv[:, 2]
        P = um.mat34_point(otfm, P_obj)
        uv = ww[:, None] * tuv[:, 0] + uu[:, None] * tuv[:, 1] \
            + vv[:, None] * tuv[:, 2]
        gen = um.mat34_point(sd.gen_tfm, P)
        return dataclasses.replace(sd, P=P, uv=uv, generated=gen,
                                   P_object=P_obj)

    # barycentric step: small against the triangle, bounded away from
    # denormal uv deltas
    DELTA = 1e-3
    u0, v0 = sd.bary_u, sd.bary_v
    ctx0 = ctx_at(u0, v0)
    ctx1 = ctx_at(u0 + DELTA, v0)
    ctx2 = ctx_at(u0, v0 + DELTA)

    # world-space offsets corresponding to the barycentric steps
    e1 = um.mat34_dir(otfm, tv[:, 1] - tv[:, 0]) * DELTA
    e2 = um.mat34_dir(otfm, tv[:, 2] - tv[:, 0]) * DELTA
    return ctx0, ctx1, ctx2, e1, e2


def eval_bump_normals(shaders, sd, shader_id, bump_slots):
    """Shade-time bump mapping (ref: kernel/svm/svm_displace.h
    svm_node_set_bump + ShaderGraph bump duplication, render/graph.cpp).

    The reference differentiates the displacement height with ray
    differentials; here the finite-difference step rides the hit
    triangle's own barycentric frame, rebuilt from the cached prim row
    (no extra table lookups). For each shader whose displacement_method
    requests bump, the displacement graph is evaluated at the hit and
    at two barycentric offsets; the surface gradient of the height
    perturbs N (f(P) = P + h*N  =>  N' ~ N - grad_tangent h). XLA dead-
    code-eliminates the surface closures of the two offset evals, so
    each bump shader costs only its displacement subgraph twice more.

    Returns the per-lane (possibly) bumped shading normal."""
    if not any(bump_slots):
        return sd.N
    off = bump_offset_contexts(sd)
    if off is None:
        return sd.N
    ctx0, ctx1, ctx2, e1, e2 = off

    N = sd.N
    new_N = N
    for slot, shader in enumerate(shaders):
        if not bump_slots[slot]:
            continue
        hs = []
        for cx in (ctx0, ctx1, ctx2):
            disp = shader.graph.evaluate(cx)["displacement"]
            if disp is None:
                disp = jnp.zeros_like(N)
            hs.append(um.dot(disp, N))
        dh1 = hs[1] - hs[0]
        dh2 = hs[2] - hs[0]
        # reciprocal-basis tangent gradient: g.e1 = dh1, g.e2 = dh2,
        # g.N = 0
        det = um.dot(e1, um.cross(e2, N))
        r1 = um.cross(e2, N) * um.safe_divide(1.0, det, 0.0)[:, None]
        r2 = um.cross(N, e1) * um.safe_divide(1.0, det, 0.0)[:, None]
        g = dh1[:, None] * r1 + dh2[:, None] * r2
        Nb = um.safe_normalize(N - g)
        # keep the bumped normal in the visible hemisphere (lift lanes
        # that dipped below the geometric horizon back above it)
        d_ng = um.dot(Nb, sd.Ng)
        Nb = jnp.where((d_ng < 0.0)[:, None],
                       um.safe_normalize(
                           Nb + sd.Ng * (1e-3 - 2.0 * d_ng)[:, None]),
                       Nb)
        m = shader_id == slot
        new_N = jnp.where(m[:, None], Nb, new_N)
    return new_N


def eval_transparency(shaders, sd, shader_id, shader_mask):
    """Per-lane shadow transparency: the shader's transparent-closure
    weight, evaluated only for shaders flagged in shader_mask (the
    shadow-transparent subset). Non-flagged shaders return 0 = opaque
    (ref: shader_bsdf_transparency, kernel/kernel_shader.h)."""
    tp = jnp.zeros(sd.batch_shape + (3,), prec.FT)
    for slot, shader in enumerate(shaders):
        if not shader_mask[slot]:
            continue
        c = shader.graph.evaluate(sd)["surface"]
        m = shader_id == slot
        tp = jnp.where(m[..., None], jnp.abs(c["transparent"]), tp)
    return tp


def eval_background(shaders, background_shader_slot, ray_d, textures=None,
                    path_flag=None):
    """Evaluate the background shader for missed rays
    (ref: indirect_background, kernel/kernel_emission.h:333)."""
    n = ray_d.shape[0]
    zeros = jnp.zeros((n, 3), prec.FT)
    if background_shader_slot < 0:
        return zeros
    sd = ShaderData(
        P=zeros, N=-ray_d, Ng=-ray_d, Ns=-ray_d, I=-ray_d,
        uv=jnp.zeros((n, 2), prec.FT),
        generated=ray_d, P_object=ray_d,
        time=jnp.zeros(n, prec.FT),
        ray_length=jnp.full(n, um.RAY_TMAX, prec.FT),
        ray_depth=jnp.zeros(n, jnp.int32),
        path_flag=(path_flag if path_flag is not None
                   else jnp.full(n, PATH_RAY_CAMERA, jnp.uint32)),
        prim=jnp.full(n, -1, jnp.int32),
        shader=jnp.full(n, background_shader_slot, jnp.int32),
        object_index=jnp.full(n, -1, jnp.int32),
        object_color=zeros, object_location=zeros,
        object_random=jnp.zeros(n, prec.FT),
        backfacing=jnp.zeros(n, bool),
        textures=textures, batch_shape=(n,),
    )
    c = shaders[background_shader_slot].evaluate_surface(sd)
    return c["emission"]
