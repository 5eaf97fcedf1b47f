"""Independent CPU reference path tracer (pure NumPy, float64).

Shares NOTHING with raytracingproject_tpu/ops/: its own intersection,
its own sampling (numpy Philox), its own NEE/MIS estimator. It consumes
only the scene DESCRIPTION (models-level objects: meshes, transforms,
shader node parameters, camera record) and mirrors the transport
conventions that affect the converged expectation:

- Lambert BSDF f = albedo/pi, cosine-hemisphere importance sampling
- two-sided triangle emission; NEE + power-heuristic MIS
- depth truncation: emission+NEE at every bounce 0..max_bounce
- box pixel filter (the RMSE config renders with filter_type=box)
- no clamping, no RR (RR is unbiased, so omitting it changes only
  variance, never the expectation)

Because both renderers are unbiased Monte Carlo estimators of the same
transport, their converged images must agree; the RMSE check
(tools/rmse_check.py) renders both to low noise and compares.

Ref for the capability being validated: the reference's golden-image
test harness (tests/python/cycles_render_tests.py) — replaced by an
independent-implementation cross-check since the prebuilt dependency
tree lacks libIlmImf and cannot link the cycles CLI in this image.
"""

import numpy as np


def extract_scene(scene):
    """Flatten a models.Scene into plain numpy arrays (world space).

    Only supports the diffuse/emission subset used by the RMSE config
    (Cornell box class scenes)."""
    from raytracingproject_tpu.models import shader_nodes as sn
    from raytracingproject_tpu.models.mesh import Hair

    def shader_props(shader):
        albedo = np.zeros(3)
        emission = np.zeros(3)
        g = shader.graph
        link = g.links.get((id(g.output_node), "surface"))
        if link is not None:
            node = link[0]
            if isinstance(node, sn.DiffuseBsdfNode):
                albedo = np.asarray(node.color, np.float64)
                assert float(node.roughness) == 0.0, \
                    "reference tracer supports pure Lambert only"
                assert g.links.get((id(node), "color")) is None, \
                    "reference tracer supports constant albedo only"
            elif isinstance(node, sn.EmissionNode):
                emission = np.asarray(node.color, np.float64) \
                    * float(node.strength)
            else:
                raise AssertionError(f"unsupported shader root {node}")
        return albedo, emission

    verts, albedo, emission = [], [], []
    for obj in scene.objects:
        mesh = obj.geometry
        assert not isinstance(mesh, Hair)
        v = np.asarray(mesh.verts_array, np.float64)
        t = np.asarray(mesh.triangles_array, np.int64)
        m = np.asarray(obj.transform, np.float64)
        vw = v @ m[:, :3].T + m[:, 3]
        tv = vw[t]
        props = [shader_props(sh) for sh in
                 (mesh.used_shaders or [scene.default_surface])]
        sidx = np.asarray(mesh.shader, np.int64)
        verts.append(tv)
        albedo.append(np.array([props[i][0] for i in sidx]))
        emission.append(np.array([props[i][1] for i in sidx]))
    assert not scene.lights, "reference tracer supports mesh lights only"
    assert scene.background.shader is None

    cam = scene.camera.update()
    kint = scene.integrator.kernel_record()
    assert float(kint["sample_clamp_direct"]) == 0.0
    assert float(kint["sample_clamp_indirect"]) == 0.0, \
        "set sample_clamp_indirect=0 for an unbiased comparison"
    return {
        "tri": np.concatenate(verts),
        "albedo": np.concatenate(albedo),
        "emission": np.concatenate(emission),
        "r2c": np.asarray(cam["raster_to_camera"], np.float64),
        "c2w": np.asarray(cam["cam_to_world"], np.float64),
        "nearclip": float(cam["nearclip"]),
        "width": int(cam["width"]),
        "height": int(cam["height"]),
        "max_bounce": int(kint["max_bounce"]),
    }


def _intersect(tri, o, d, tmin=1e-6):
    """Brute closest-hit: tri (P,3,3), o/d (N,3) -> (t, prim) float64."""
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = o.shape[0]
    t_best = np.full(n, np.inf)
    prim = np.full(n, -1, np.int64)
    # block over prims to bound memory
    B = 64
    for s in range(0, len(tri), B):
        V0, E1, E2 = v0[s:s + B], e1[s:s + B], e2[s:s + B]
        p = np.cross(d[:, None, :], E2[None])          # (N, B, 3)
        det = np.einsum('bk,nbk->nb', E1, p)
        inv = np.where(np.abs(det) > 1e-300, 1.0 / np.where(det == 0, 1, det), 0.0)
        tv = o[:, None, :] - V0[None]
        u = np.einsum('nbk,nbk->nb', tv, p) * inv
        q = np.cross(tv, E1[None])
        v = np.einsum('nk,nbk->nb', d, q) * inv
        t = np.einsum('bk,nbk->nb', E2, q) * inv
        hit = ((np.abs(det) > 1e-300) & (u >= 0) & (u <= 1) & (v >= 0)
               & (u + v <= 1) & (t > tmin) & (t < t_best[:, None]))
        t = np.where(hit, t, np.inf)
        k = np.argmin(t, axis=1)
        tk = t[np.arange(n), k]
        better = tk < t_best
        t_best = np.where(better, tk, t_best)
        prim = np.where(better, s + k, prim)
    return t_best, prim


def _occluded(tri, o, d, tmax):
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = o.shape[0]
    blocked = np.zeros(n, bool)
    B = 64
    for s in range(0, len(tri), B):
        V0, E1, E2 = v0[s:s + B], e1[s:s + B], e2[s:s + B]
        p = np.cross(d[:, None, :], E2[None])
        det = np.einsum('bk,nbk->nb', E1, p)
        inv = np.where(np.abs(det) > 1e-300, 1.0 / np.where(det == 0, 1, det), 0.0)
        tv = o[:, None, :] - V0[None]
        u = np.einsum('nbk,nbk->nb', tv, p) * inv
        q = np.cross(tv, E1[None])
        v = np.einsum('nk,nbk->nb', d, q) * inv
        t = np.einsum('bk,nbk->nb', E2, q) * inv
        hit = ((np.abs(det) > 1e-300) & (u >= 0) & (u <= 1) & (v >= 0)
               & (u + v <= 1) & (t > 1e-6) & (t < tmax[:, None]))
        blocked |= hit.any(axis=1)
    return blocked


def _cos_hemisphere(N, u1, u2):
    # build orthonormal basis (independent construction)
    a = np.where(np.abs(N[:, 0:1]) > 0.9, np.array([[0., 1., 0.]]),
                 np.array([[1., 0., 0.]]))
    T = np.cross(a, N)
    T /= np.linalg.norm(T, axis=1, keepdims=True)
    Bv = np.cross(N, T)
    r = np.sqrt(u1)
    phi = 2 * np.pi * u2
    x = r * np.cos(phi)
    y = r * np.sin(phi)
    z = np.sqrt(np.maximum(1 - u1, 0))
    d = x[:, None] * T + y[:, None] * Bv + z[:, None] * N
    return d, z / np.pi


def render_reference(scene, spp, seed=7, log_every=0):
    """Render scene with the independent tracer -> (H, W, 3) float64."""
    sd = extract_scene(scene)
    tri, albedo, emission = sd["tri"], sd["albedo"], sd["emission"]
    W, H, MB = sd["width"], sd["height"], sd["max_bounce"]
    tri_n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    tri_area = 0.5 * np.linalg.norm(tri_n, axis=1)
    tri_ng = tri_n / np.maximum(np.linalg.norm(tri_n, axis=1,
                                               keepdims=True), 1e-300)
    # NEE light list: emissive tris, area-weighted pmf
    lids = np.nonzero(emission.max(axis=1) > 0)[0]
    lpow = tri_area[lids] * emission[lids].mean(axis=1)
    pmf = lpow / lpow.sum()
    pmf_by_prim = np.zeros(len(tri))
    pmf_by_prim[lids] = pmf
    cdf = np.concatenate([[0.0], np.cumsum(pmf)])

    rng = np.random.Generator(np.random.Philox(seed))
    npix = W * H
    yy, xx = np.mgrid[0:H, 0:W]
    # amortize numpy per-op overhead: trace SB samples of every pixel
    # per vectorized pass
    SB = max(1, min(16, spp))
    assert spp % SB == 0, "spp must divide by the sample batch (16)"
    n = npix * SB
    px = np.tile(xx.reshape(-1).astype(np.float64), SB)
    py = np.tile(yy.reshape(-1).astype(np.float64), SB)
    img = np.zeros((npix, 3))

    r2c, c2w = sd["r2c"], sd["c2w"]
    for s in range(spp // SB):
        fx = px + rng.random(n)   # box filter: uniform over the pixel
        fy = py + rng.random(n)
        pc = np.stack([fx, fy, np.ones(n)], 1) @ r2c[:, :3].T + r2c[:, 3]
        dcam = np.stack([pc[:, 0], pc[:, 1], np.ones(n)], 1)
        d = dcam @ c2w[:, :3].T
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.tile(c2w[:, 3], (n, 1)) + d * sd["nearclip"]

        thru = np.ones((n, 3))
        L = np.zeros((n, 3))
        alive = np.ones(n, bool)
        prev_pdf = np.zeros(n)
        for depth in range(MB + 1):
            t, prim = _intersect(tri, o, d)
            found = alive & (prim >= 0)
            if not found.any():
                break
            pi = np.maximum(prim, 0)
            P = o + t[:, None] * d
            Ng = tri_ng[pi]
            Ngf = np.where(np.einsum('nk,nk->n', Ng, d)[:, None] > 0,
                           -Ng, Ng)
            # emission (two-sided) with MIS vs NEE of the previous vertex
            emis = emission[pi]
            if depth == 0:
                w = np.ones(n)
            else:
                cos_hit = np.abs(np.einsum('nk,nk->n', tri_ng[pi], d))
                pdf_l = np.where(
                    cos_hit * tri_area[pi] > 0,
                    t * t / np.maximum(cos_hit * tri_area[pi], 1e-300),
                    0.0) * pmf_by_prim[pi]
                w = prev_pdf ** 2 / np.maximum(prev_pdf ** 2 + pdf_l ** 2,
                                               1e-300)
            L += np.where(found[:, None], thru * emis * w[:, None], 0.0)

            # NEE
            usel = rng.random(n)
            li = lids[np.clip(np.searchsorted(cdf, usel, side="right") - 1,
                              0, len(lids) - 1)]
            u1, u2 = rng.random(n), rng.random(n)
            su = np.sqrt(u1)
            b1, b2 = 1.0 - su, u2 * su
            lv = tri[li]
            Pl = lv[:, 0] + (lv[:, 1] - lv[:, 0]) * b1[:, None] \
                + (lv[:, 2] - lv[:, 0]) * b2[:, None]
            toL = Pl - P
            dist = np.maximum(np.linalg.norm(toL, axis=1), 1e-300)
            Dl = toL / dist[:, None]
            cos_s = np.einsum('nk,nk->n', Ngf, Dl)
            cos_l = np.abs(np.einsum('nk,nk->n', tri_ng[li], Dl))
            pdf_nee = dist ** 2 / np.maximum(cos_l * tri_area[li], 1e-300) \
                * pmf_by_prim[li]
            f = albedo[pi] / np.pi
            can = found & (cos_s > 0) & (cos_l > 1e-6) & (pdf_nee > 1e-12)
            pdf_fwd = cos_s / np.pi           # our bsdf pdf toward light
            wl = pdf_nee ** 2 / np.maximum(pdf_nee ** 2 + pdf_fwd ** 2,
                                           1e-300)
            # visibility from a surface-offset origin; the segment length
            # is recomputed from that origin so the tmax margin (1e-5)
            # clearly exceeds fp error and the light cannot re-block its
            # own sample point
            off = np.where(cos_s[:, None] > 0, Ngf, -Ngf) \
                * 1e-6 * dist[:, None]
            o_sh = P + off
            to2 = Pl - o_sh
            dist2 = np.maximum(np.linalg.norm(to2, axis=1), 1e-300)
            sh_blocked = _occluded(tri, o_sh, to2 / dist2[:, None],
                                   np.where(can, dist2 * (1 - 1e-5), 0.0))
            contrib = thru * f * emission[li] \
                * (cos_s * wl / np.maximum(pdf_nee, 1e-300))[:, None]
            L += np.where((can & ~sh_blocked)[:, None], contrib, 0.0)

            if depth == MB:
                break
            # diffuse bounce
            bu, bv = rng.random(n), rng.random(n)
            nd, pdf = _cos_hemisphere(Ngf, bu, bv)
            thru = thru * albedo[pi]          # f * cos / pdf for Lambert
            alive = found & (pdf > 0) & (albedo[pi].max(axis=1) > 0)
            prev_pdf = pdf
            o = P + Ngf * 1e-6 * np.maximum(t, 1.0)[:, None]
            d = nd
            if not alive.any():
                break
        img += L.reshape(SB, npix, 3).sum(axis=0)
        if log_every and (s + 1) * SB % log_every == 0:
            print(f"  ref {(s+1)*SB}/{spp}", flush=True)
    return (img / spp).reshape(H, W, 3)
