"""Light sampling, NEE and MIS (ref: kernel/kernel_light.h,
kernel/kernel_emission.h; host CDF build ref: render/light.cpp:277).

The flat light distribution covers lamps AND emissive triangles in one
CDF, selected by a single binary search (`jnp.searchsorted`) over the
wavefront. Per-type sampling is fused branch-free math over all lanes
with per-type masks — point/spot/distant/area lamps and uniform-area
triangle sampling, pdfs converted to solid angle.

For BSDF-sampled rays that hit emissive geometry, `triangle_light_pdf`
returns the pdf NEE would have used so the power heuristic can weight
the two strategies (ref: indirect_primitive_emission,
kernel_emission.h:209-233). Area lamps are virtual (not in the BVH);
`lamp_hits` intersects them analytically for the lamp-MIS path
(ref: indirect_lamp_emission, kernel_path.h lamp loop).
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import jax
import jax.numpy as jnp

from raytracingproject_tpu.utils import math as um

LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_BACKGROUND = 2
LIGHT_AREA = 3
LIGHT_SPOT = 4


def light_distribution_sample(dscene, u):
    """Invert the emission CDF (ref: kernel_light.h:583) with a
    branchless compare-sum (ops/lookup.py). Returns (entry_index,
    entry_row (N, 4): [type, id, pmf, _])."""
    from raytracingproject_tpu.ops import lookup as lk
    cdf = dscene["light_dist_cdf"]  # (D+1,)
    idx = lk.searchsorted_cdf(cdf, u)
    row = lk.lookup_rows(dscene["light_entries"], idx)
    return idx, row




def bg_map_pdf(dscene, D):
    """Importance-map pdf (solid angle) of escaping along D
    (ref: kernel_light.h background_map_pdf); uniform-sphere fallback."""
    bg_h, bg_w = dscene["bg_pdf_map"].shape
    if bg_h <= 1:
        return jnp.full(D.shape[:1], 1.0 / um.M_4PI, prec.FT)
    bu, bvv = um.direction_to_equirectangular(D)
    row = jnp.clip((bvv * bg_h).astype(jnp.int32), 0, bg_h - 1)
    col = jnp.clip((bu * bg_w).astype(jnp.int32), 0, bg_w - 1)
    return dscene["bg_pdf_map"].reshape(-1)[row * bg_w + col]


def portal_pdf(dscene, P, D):
    """Solid-angle pdf of the portal strategy: uniform portal pick x
    uniform rect area -> solid angle (ref: kernel_light.h
    background_portal_pdf). Zero where D misses every portal."""
    pd = dscene["portal_data"]
    k_num = int(pd.shape[0])
    if k_num == 0:
        return jnp.zeros(P.shape[:1], prec.FT)
    total = jnp.zeros(P.shape[:1], prec.FT)
    for k in range(k_num):          # static small loop
        co, au, av = pd[k, 0:3], pd[k, 3:6], pd[k, 6:9]
        nrm = pd[k, 9:12]
        su, sv, area = pd[k, 12], pd[k, 13], pd[k, 14]
        denom = um.dot(D, nrm)
        t = um.safe_divide(um.dot(co[None, :] - P, nrm[None, :])[:, None],
                           denom[:, None], 0.0)[:, 0]
        X = P + D * t[:, None]
        rel = X - co[None, :]
        du = um.dot(rel, au[None, :]) / jnp.maximum(
            um.dot(au[None, :], au[None, :]) * su, 1e-12)
        dv = um.dot(rel, av[None, :]) / jnp.maximum(
            um.dot(av[None, :], av[None, :]) * sv, 1e-12)
        inside = ((t > 1e-5) & (jnp.abs(denom) > 1e-7)
                  & (jnp.abs(du) <= 0.5) & (jnp.abs(dv) <= 0.5))
        pdf_k = um.safe_divide(t * t, area * jnp.abs(denom), 0.0)
        total = total + jnp.where(inside, pdf_k, 0.0)
    return total / k_num


def sample_light(dscene, P, u_sel, u1, u2, time=None, rows=None,
                 tree=None, static_kinds=None):
    """Sample one light point for NEE from shading points P (N, 3).

    Four wide-table lookups total (entries, prim_table, object_table,
    lamp_table) — see ops/lookup.py. The
    light PICK (CDF inversion + all four row fetches) depends only on
    the random numbers, not on P — callers that re-evaluate the same
    sampled light from a second observer point (the equiangular volume
    estimator, ref: kernel_volume.h:978-1050) pass the first call's
    returned `rows` back in and skip every lookup. (With the light
    tree the pick DOES depend on P; the reused `rows` then carry the
    original pick point's pmf, which is exactly the pmf the estimator
    divided by — still consistent.)

    tree: kg["light_tree"] meta — when set, the pick walks the
    bounding-cone hierarchy (ops/light_tree.py) instead of the flat
    power CDF, making the selection pmf receiver-aware.

    Returns dict: valid, delta (no-MIS lanes), D (unit dir to light),
    dist, pdf (solid angle x selection), eval ((N,3) emitted radiance
    toward P), Ng_l (light normal), rows (the fetched tables, for
    reuse).

    static_kinds: HOST tuple of per-entry kinds ("tri" | lamp type int,
    kg["light_kinds"]) — when every entry is a triangle, the lamp-table
    fetch and every lamp-type sampling/pdf/eval branch prune at trace
    time (all selects against them are all-False, so the outputs are
    bit-exact vs the general path; tests/test_light_static.py).
    """
    from raytracingproject_tpu.ops import lookup as lk
    n = P.shape[0]
    if tree is None and static_kinds and set(static_kinds) == {"tri"}:
        return _sample_light_all_tri(dscene, P, u_sel, u1, u2,
                                     rows=rows)
    if rows is None:
        eidx = None
        if tree is not None:
            from raytracingproject_tpu.ops import light_tree as ltree
            erow = ltree.sample_entry(dscene, tree, P, u_sel)
        else:
            eidx, erow = light_distribution_sample(dscene, u_sel)
        if eidx is not None and "le_prim_rows" in dscene:
            # per-entry snapshot tables (models/scene.py _pack_lights):
            # D-row copies fetched by the pick index — bit-exact vs the
            # wide-table path below, ~free for the common tiny D.
            # method="onehot" + optimization_barrier are BOTH required
            # for the bit-exact parity pillar: the default select-chain
            # fetch for tiny D fused INTO the surrounding NEE math,
            # and different drivers (fixed-grid vs regen — different
            # jit graphs) then FMA-contract that math differently,
            # diverging by 1 ulp (the r4 end-of-round regression,
            # tests/test_regen.py test_bit_exact_vs_fixed_grid). The
            # dot is a compilation unit both programs lower identically
            # — the same boundary the wide path's one-hot/gather fetch
            # provided implicitly. Payload finiteness (0*inf = nan) is
            # guaranteed by the packer's isfinite gate.
            erow, prow, orow, lrow = jax.lax.optimization_barrier((
                erow,
                lk.lookup_rows(dscene["le_prim_rows"], eidx,
                               method="onehot"),
                lk.lookup_rows(dscene["le_obj_rows"], eidx,
                               method="onehot"),
                lk.lookup_rows(dscene["le_lamp_rows"], eidx,
                               method="onehot")))
        else:
            prim0 = jnp.maximum(
                jnp.where(erow[:, 0].astype(jnp.int32) == 1,
                          erow[:, 1].astype(jnp.int32), 0), 0)
            prow = lk.lookup_rows(dscene["prim_table"], prim0)
            obj = prow[:, lk.PT_OBJECT].astype(jnp.int32)
            orow = lk.lookup_rows(dscene["object_table"],
                                  jnp.maximum(obj, 0))
            lamp0 = jnp.maximum(
                jnp.where(erow[:, 0].astype(jnp.int32) == 1, 0,
                          erow[:, 1].astype(jnp.int32)), 0)
            lrow = lk.lookup_rows(dscene["lamp_table"], lamp0)
        rows = {"erow": erow, "prow": prow, "orow": orow, "lrow": lrow}
    else:
        erow, prow, orow, lrow = (rows["erow"], rows["prow"],
                                  rows["orow"], rows["lrow"])
    etype = erow[:, 0].astype(jnp.int32)   # 0 lamp, 1 triangle
    eid = erow[:, 1].astype(jnp.int32)
    pmf = erow[:, 2]

    is_tri = etype == 1
    # ---------------- triangle lights (uniform area) ----------------
    prim = jnp.maximum(jnp.where(is_tri, eid, 0), 0)
    tv = prow[:, lk.PT_V0:lk.PT_V0 + 9].reshape(n, 3, 3)
    tri_emission = prow[:, lk.PT_EMISSION:lk.PT_EMISSION + 3]
    otfm = lk.mat34(orow[:, lk.OT_TFM:lk.OT_TFM + 12])
    v0 = um.mat34_point(otfm, tv[:, 0])
    v1 = um.mat34_point(otfm, tv[:, 1])
    v2 = um.mat34_point(otfm, tv[:, 2])
    # uniform barycentric (sqrt warp)
    su = jnp.sqrt(jnp.maximum(u1, 0.0))
    tb_u = 1.0 - su
    tb_v = u2 * su
    P_tri = v0 + (v1 - v0) * tb_u[:, None] + (v2 - v0) * tb_v[:, None]
    Ng_tri = um.triangle_normal(v0, v1, v2)
    area_tri = um.triangle_area(v0, v1, v2)

    # ---------------- lamps ----------------
    ltype = lrow[:, lk.LT_TYPE].astype(jnp.int32)
    lco = lrow[:, lk.LT_CO:lk.LT_CO + 3]
    ldir = lrow[:, lk.LT_DIR:lk.LT_DIR + 3]
    lsize = lrow[:, lk.LT_SIZE]
    laxisu = lrow[:, lk.LT_AXISU:lk.LT_AXISU + 3]
    laxisv = lrow[:, lk.LT_AXISV:lk.LT_AXISV + 3]
    lsizeu = lrow[:, lk.LT_SIZEU]
    lsizev = lrow[:, lk.LT_SIZEV]
    lstrength = lrow[:, lk.LT_STRENGTH:lk.LT_STRENGTH + 3]
    lspot_angle = lrow[:, lk.LT_SPOT_ANGLE]
    lspot_smooth = lrow[:, lk.LT_SPOT_SMOOTH]
    langle = lrow[:, lk.LT_ANGLE]

    is_point = ~is_tri & (ltype == LIGHT_POINT)
    is_spot = ~is_tri & (ltype == LIGHT_SPOT)
    is_area = ~is_tri & (ltype == LIGHT_AREA)
    is_distant = ~is_tri & (ltype == LIGHT_DISTANT)
    is_bg = ~is_tri & (ltype == LIGHT_BACKGROUND)

    # point/spot: sample sphere surface of radius size (delta if size=0)
    sph = um.sample_uniform_sphere(u1, u2)
    P_point = lco + sph * lsize[:, None]

    # area: uniform point on rect
    P_area = (lco + laxisu * ((u1 - 0.5) * lsizeu)[:, None]
              + laxisv * ((u2 - 0.5) * lsizev)[:, None])
    area_lamp = jnp.maximum(
        lsizeu * lsizev * um.length(um.cross(laxisu, laxisv)), 1e-12)

    # distant: sample cone around -dir of half-angle `angle`
    # (ref: kernel_light.h distant_light_sample)
    cos_max = jnp.cos(langle * 0.5)
    zc = 1.0 - u1 * (1.0 - cos_max)
    rc = um.safe_sqrt(1.0 - zc * zc)
    phic = um.M_2PI * u2
    t_d, b_d = um.make_orthonormals(-ldir)
    D_distant = um.normalize(
        (rc * jnp.cos(phic))[:, None] * t_d + (rc * jnp.sin(phic))[:, None] * b_d
        + zc[:, None] * (-ldir))

    # background: equirect importance map when available (ref:
    # kernel_light.h background_map_sample), else uniform sphere;
    # with portals present, a 50/50 MIS mixture of (map|uniform) and
    # portal-rect sampling (ref: background_light_sample portal path)
    bg_h, bg_w = dscene["bg_pdf_map"].shape
    has_bg_map = bg_h > 1
    num_portals = int(dscene["portal_data"].shape[0])
    if num_portals:
        use_portal = u1 >= 0.5
        u1b = jnp.where(use_portal, (u1 - 0.5) * 2.0, u1 * 2.0)
    else:
        use_portal = None
        u1b = u1
    if has_bg_map:
        from raytracingproject_tpu.utils import rng as rngu
        row = lk.searchsorted_cdf(dscene["bg_marginal_cdf"], u1b)
        cond = lk.lookup_rows(dscene["bg_conditional_cdf"], row,
                              method="gather")        # (N, W+1)
        col = jnp.sum(u2[:, None] >= cond[:, 1:-1], -1).astype(jnp.int32)
        # uniform jitter inside the texel (pdf is piecewise constant)
        jbits = rngu.hash_pcg2d(
            jnp.asarray(u1b * 16777216.0, jnp.uint32),
            jnp.asarray(u2 * 16777216.0, jnp.uint32))
        ju = rngu.uint_to_float_01(jbits)
        jv = rngu.uint_to_float_01(rngu.hash_pcg(jbits))
        bu = (col.astype(prec.FT) + ju) / bg_w
        bvv = (row.astype(prec.FT) + jv) / bg_h
        D_bg = um.equirectangular_to_direction(bu, bvv)
    else:
        # fallback uniform sphere MUST consume the remapped u1b —
        # feeding the original u1 here would fold the portal-selection
        # bit into the direction and cover only half the sphere
        D_bg = um.sample_uniform_sphere(u1b, u2) if num_portals else sph
    if num_portals:
        from raytracingproject_tpu.utils import rng as rngu
        pd_ = dscene["portal_data"]
        pick = jnp.clip((u2 * num_portals).astype(jnp.int32), 0,
                        num_portals - 1)
        prow_p = lk.lookup_rows(pd_, pick)
        pbits = rngu.hash_pcg2d(
            jnp.asarray(u1b * 16777216.0, jnp.uint32) ^ jnp.uint32(0xA511),
            jnp.asarray(u2 * 16777216.0, jnp.uint32))
        pu = rngu.uint_to_float_01(pbits)
        pv = rngu.uint_to_float_01(rngu.hash_pcg(pbits))
        X = (prow_p[:, 0:3]
             + prow_p[:, 3:6] * ((pu - 0.5) * prow_p[:, 12])[:, None]
             + prow_p[:, 6:9] * ((pv - 0.5) * prow_p[:, 13])[:, None])
        D_portal = um.safe_normalize(X - P)
        D_bg = jnp.where(use_portal[:, None], D_portal, D_bg)
        # mixture pdf evaluated at the CHOSEN direction (both halves)
        pdf_bg_mix = 0.5 * bg_map_pdf(dscene, D_bg) \
            + 0.5 * portal_pdf(dscene, P, D_bg)
    elif has_bg_map:
        pdf_bg_map = dscene["bg_pdf_map"].reshape(-1)[
            jnp.clip(row * bg_w + col, 0, bg_h * bg_w - 1)]

    # ---------------- combine position-based lights ----------------
    P_l = jnp.where(is_tri[:, None], P_tri,
                    jnp.where(is_area[:, None], P_area, P_point))
    to_l = P_l - P
    dist = jnp.maximum(um.length(to_l), 1e-8)
    D_pos = to_l / dist[:, None]

    D = jnp.where(is_distant[:, None], D_distant,
                  jnp.where(is_bg[:, None], D_bg, D_pos))
    dist = jnp.where(is_distant | is_bg, um.RAY_TMAX, dist)

    # normals and cosine at light
    Ng_l = jnp.where(is_tri[:, None], Ng_tri,
                     jnp.where(is_area[:, None],
                               um.safe_normalize(um.cross(laxisu, laxisv)),
                               -D))
    cos_l = um.dot(Ng_l, -D)

    # ---------------- pdfs (solid angle) ----------------
    d2 = dist * dist
    pdf_tri = um.safe_divide(d2, jnp.abs(cos_l) * area_tri, 0.0)
    pdf_area = um.safe_divide(d2, jnp.maximum(cos_l, 0.0) * area_lamp, 0.0)
    inv_sph_area = 1.0 / (4.0 * um.M_PI * jnp.maximum(lsize * lsize, 1e-12))
    pdf_sphere = d2 * inv_sph_area  # approx: sphere-area pdf to SA
    pdf_distant = 1.0 / (um.M_2PI * jnp.maximum(1.0 - cos_max, 1e-9))
    if num_portals:
        pdf_bg = pdf_bg_mix
    elif has_bg_map:
        pdf_bg = pdf_bg_map
    else:
        pdf_bg = jnp.full_like(dist, 1.0 / um.M_4PI)

    delta_point = is_point & (lsize <= 0.0)
    delta_spot = is_spot & (lsize <= 0.0)
    delta_distant = is_distant & (cos_max >= 1.0 - 1e-9)
    delta = delta_point | delta_spot | delta_distant

    pdf = jnp.where(is_tri, pdf_tri,
                    jnp.where(is_area, pdf_area,
                              jnp.where(is_point | is_spot,
                                        jnp.where(delta, 1.0, pdf_sphere),
                                        jnp.where(is_distant,
                                                  jnp.where(delta, 1.0, pdf_distant),
                                                  pdf_bg))))
    pdf = pdf * pmf

    # ---------------- emission eval toward P ----------------
    # point/spot: radiant intensity = strength / (4 pi); falloff 1/d^2
    eval_point = lstrength * (um.M_1_PI * 0.25) / d2[:, None]
    # spot cone falloff (ref: spot_light_attenuation)
    cos_spot = um.dot(-D, ldir)  # angle between light->P dir and spot axis
    spot_cos_max = jnp.cos(lspot_angle * 0.5)
    spot_att = jnp.clip(
        um.safe_divide(cos_spot - spot_cos_max,
                       lspot_smooth * (1.0 - spot_cos_max) + 1e-9, 1.0),
        0.0, 1.0)
    spot_att = jnp.where(cos_spot > spot_cos_max,
                         jnp.where(lspot_smooth > 0.0, spot_att, 1.0), 0.0)
    eval_spot = eval_point * spot_att[:, None]

    # ---- IES photometric attenuation (ref: kernel_light.h IES path +
    # util_ies.cpp; fixed-grid bilinear fetch — one wide-row lookup,
    # then 4 one-hot reductions, no dynamic gathers) ----
    if dscene["lamp_ies"].shape[0]:
        from raytracingproject_tpu.utils.ies import IES_RES_H, IES_RES_V
        ies_idx = lrow[:, lk.LT_IES].astype(jnp.int32)
        grid = lk.lookup_rows(dscene["lamp_ies"],
                              jnp.maximum(ies_idx - 1, 0))  # (N, H*V)
        to_p = -D                      # direction lamp -> shading point
        tref, bref = um.make_orthonormals(ldir)
        ct = jnp.clip(um.dot(ldir, to_p), -1.0, 1.0)
        theta = jnp.arccos(ct)                     # [0, pi] off lamp axis
        phi = jnp.arctan2(um.dot(bref, to_p), um.dot(tref, to_p))
        phi = jnp.where(phi < 0.0, phi + um.M_2PI, phi)
        fv = theta / um.M_PI * (IES_RES_V - 1)
        fh = phi / um.M_2PI * IES_RES_H
        v0 = jnp.clip(jnp.floor(fv).astype(jnp.int32), 0, IES_RES_V - 1)
        v1 = jnp.minimum(v0 + 1, IES_RES_V - 1)
        wv = fv - v0.astype(prec.FT)
        h0 = jnp.floor(fh).astype(jnp.int32) % IES_RES_H
        h1 = (h0 + 1) % IES_RES_H
        wh = fh - jnp.floor(fh)
        cols = jnp.arange(IES_RES_H * IES_RES_V, dtype=jnp.int32)

        def fetch(hh, vv):
            idx = hh * IES_RES_V + vv
            return jnp.sum(
                jnp.where(cols[None, :] == idx[:, None], grid, 0.0), -1)

        f = ((1 - wv) * ((1 - wh) * fetch(h0, v0) + wh * fetch(h1, v0))
             + wv * ((1 - wh) * fetch(h0, v1) + wh * fetch(h1, v1)))
        ies_att = jnp.where(ies_idx > 0, f, 1.0)
        eval_point = eval_point * ies_att[:, None]
        eval_spot = eval_spot * ies_att[:, None]
    # area: strength is radiance; single-sided
    eval_area = jnp.where((cos_l > 0.0)[:, None], lstrength, 0.0)
    # distant: strength is radiance through the cone
    eval_distant = lstrength
    eval_bg = lstrength  # constant-background fallback; shader eval in caller

    ev = jnp.where(is_tri[:, None], tri_emission,
                   jnp.where(is_area[:, None], eval_area,
                             jnp.where(is_point[:, None], eval_point,
                                       jnp.where(is_spot[:, None], eval_spot,
                                                 jnp.where(is_distant[:, None],
                                                           eval_distant, eval_bg)))))

    valid = (pdf > 1e-12) & (jnp.where(is_tri, jnp.abs(cos_l), 1.0) > 1e-6) \
        & (erow[:, 1] >= 0.0)   # light-tree pad leaves carry id -1
    return {
        "valid": valid, "delta": delta, "D": D, "dist": dist, "pdf": pdf,
        "eval": ev, "Ng_l": Ng_l, "is_tri": is_tri, "tri_prim": prim,
        "tri_u": tb_u, "tri_v": tb_v, "is_bg": is_bg, "P_l": P_l,
        "pmf": pmf, "rows": rows,
    }


def _sample_light_all_tri(dscene, P, u_sel, u1, u2, rows=None):
    """sample_light specialized to all-triangle distributions (static
    host knowledge, kg["light_kinds"]): only the triangle branch of the
    general path survives; every output is the value the general path's
    all-False lamp selects would produce, bit-exactly."""
    from raytracingproject_tpu.ops import lookup as lk
    n = P.shape[0]
    if rows is None:
        eidx, erow = light_distribution_sample(dscene, u_sel)
        if "le_prim_rows" in dscene:
            # same barrier + one-hot as the general path (bit-exact
            # parity pillar — see sample_light)
            erow, prow, orow = jax.lax.optimization_barrier((
                erow,
                lk.lookup_rows(dscene["le_prim_rows"], eidx,
                               method="onehot"),
                lk.lookup_rows(dscene["le_obj_rows"], eidx,
                               method="onehot")))
        else:
            prim0 = jnp.maximum(erow[:, 1].astype(jnp.int32), 0)
            prow = lk.lookup_rows(dscene["prim_table"], prim0)
            obj = prow[:, lk.PT_OBJECT].astype(jnp.int32)
            orow = lk.lookup_rows(dscene["object_table"],
                                  jnp.maximum(obj, 0))
        rows = {"erow": erow, "prow": prow, "orow": orow, "lrow": None}
    else:
        erow, prow, orow = rows["erow"], rows["prow"], rows["orow"]
    eid = erow[:, 1].astype(jnp.int32)
    pmf = erow[:, 2]

    prim = jnp.maximum(eid, 0)
    tv = prow[:, lk.PT_V0:lk.PT_V0 + 9].reshape(n, 3, 3)
    tri_emission = prow[:, lk.PT_EMISSION:lk.PT_EMISSION + 3]
    otfm = lk.mat34(orow[:, lk.OT_TFM:lk.OT_TFM + 12])
    v0 = um.mat34_point(otfm, tv[:, 0])
    v1 = um.mat34_point(otfm, tv[:, 1])
    v2 = um.mat34_point(otfm, tv[:, 2])
    su = jnp.sqrt(jnp.maximum(u1, 0.0))
    tb_u = 1.0 - su
    tb_v = u2 * su
    P_l = v0 + (v1 - v0) * tb_u[:, None] + (v2 - v0) * tb_v[:, None]
    Ng_l = um.triangle_normal(v0, v1, v2)
    area_tri = um.triangle_area(v0, v1, v2)

    to_l = P_l - P
    dist = jnp.maximum(um.length(to_l), 1e-8)
    D = to_l / dist[:, None]
    cos_l = um.dot(Ng_l, -D)
    d2 = dist * dist
    pdf = um.safe_divide(d2, jnp.abs(cos_l) * area_tri, 0.0) * pmf
    valid = (pdf > 1e-12) & (jnp.abs(cos_l) > 1e-6) & (erow[:, 1] >= 0.0)
    false_ = jnp.zeros((n,), bool)
    return {
        "valid": valid, "delta": false_, "D": D, "dist": dist,
        "pdf": pdf, "eval": tri_emission, "Ng_l": Ng_l,
        "is_tri": jnp.ones((n,), bool), "tri_prim": prim,
        "tri_u": tb_u, "tri_v": tb_v, "is_bg": false_, "P_l": P_l,
        "pmf": pmf, "rows": rows,
    }


def triangle_light_pdf(dscene, prim_row, t_hit, cos_hit, tree=None,
                       P_mis=None):
    """pdf (solid angle) with which NEE would sample the emissive
    triangle hit by a BSDF ray (ref: triangle_light_pdf). Takes the
    already-fetched prim_table rows + their object rows to avoid
    re-lookup. With the light tree, the flat pmf column is replaced by
    the P-aware walk pmf re-derived at P_mis — the point the previous
    bounce's NEE sampled from (bit-exact twin of the sample-side pick,
    so the MIS weights sum to one)."""
    from raytracingproject_tpu.ops import lookup as lk
    prow, otfm = prim_row
    if tree is not None:
        from raytracingproject_tpu.ops import light_tree as ltree
        leaf = prow[:, lk.PT_LT_LEAF].astype(jnp.int32)
        pmf = jnp.where(leaf >= 0,
                        ltree.finite_pmf(dscene, tree, P_mis,
                                         jnp.maximum(leaf, 0)),
                        0.0)
    else:
        pmf = prow[:, lk.PT_LIGHT_PMF]
    n = prow.shape[0]
    tv = prow[:, lk.PT_V0:lk.PT_V0 + 9].reshape(n, 3, 3)
    v0 = um.mat34_point(otfm, tv[:, 0])
    v1 = um.mat34_point(otfm, tv[:, 1])
    v2 = um.mat34_point(otfm, tv[:, 2])
    area = um.triangle_area(v0, v1, v2)
    pdf = um.safe_divide(t_hit * t_hit, jnp.abs(cos_hit) * area, 0.0)
    return pdf * pmf


def lamp_hits(dscene, lamp_types, o, d, tmax, accum_fn, tree=None,
              P_mis=None):
    """Analytic area-lamp intersection for BSDF-MIS
    (ref: indirect_lamp_emission). Calls accum_fn(emission, pdf, t, mask)
    once per lamp; cheap since lamp counts are tiny. `lamp_types` is the
    HOST-side python list of lamp type ints (static — device arrays
    become tracers inside jit and cannot steer python control flow).
    With the light tree the static lamp_pmf is replaced by the P-aware
    walk pmf at P_mis (the previous NEE point) for each lamp's static
    leaf slot."""
    if tree is not None:
        from raytracingproject_tpu.ops import light_tree as ltree
        lamp_leaf = tree["lamp_leaf"]
    for li, ltype in enumerate(lamp_types):
        if int(ltype) != LIGHT_AREA:
            continue
        co = dscene["lamp_co"][li]
        axisu = dscene["lamp_axisu"][li]
        axisv = dscene["lamp_axisv"][li]
        sizeu = dscene["lamp_sizeu"][li]
        sizev = dscene["lamp_sizev"][li]
        ng = um.safe_normalize(um.cross(axisu, axisv))
        denom = um.dot(d, ng)
        t = um.safe_divide(um.dot(co - o, jnp.broadcast_to(ng, o.shape)),
                           denom, -1.0)
        P_hit = o + t[:, None] * d
        rel = P_hit - co
        uu = um.dot(rel, um.safe_normalize(axisu)) / (
            jnp.maximum(um.length(axisu), 1e-12) * sizeu)
        vv = um.dot(rel, um.safe_normalize(axisv)) / (
            jnp.maximum(um.length(axisv), 1e-12) * sizev)
        front = denom < 0.0  # ray hits emitting side
        mask = (t > 1e-5) & (t < tmax) & front \
            & (jnp.abs(uu) <= 0.5) & (jnp.abs(vv) <= 0.5)
        area = jnp.maximum(sizeu * sizev * um.length(um.cross(axisu, axisv)),
                           1e-12)
        if tree is not None and lamp_leaf[li] >= 0:
            pmf = ltree.finite_pmf(
                dscene, tree, P_mis,
                jnp.full(o.shape[:1], lamp_leaf[li], jnp.int32))
        else:
            pmf = dscene["lamp_pmf"][li]
        pdf = um.safe_divide(t * t, jnp.abs(denom) * area, 0.0) * pmf
        emission = jnp.broadcast_to(dscene["lamp_strength"][li], o.shape)
        accum_fn(li, emission, pdf, t, mask)
