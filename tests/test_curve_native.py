"""Native curve (hair) intersection — ray-facing ribbon segments
(ref: kernel/geom/geom_curve_intersect.h; redesign: dense segment
sweep in ops/intersect.py intersect_curves_ribbon, merged after the
triangle pass)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracingproject_tpu.app import examples
from raytracingproject_tpu.models.mesh import Hair
from raytracingproject_tpu.models import Object
from raytracingproject_tpu.ops import integrator as integ
from raytracingproject_tpu.ops import intersect as isect


def render(scene, w, h, spp):
    scene.device_update()
    kg = scene.make_kernel_globals()
    yy, xx = np.mgrid[0:h, 0:w]
    px = jnp.asarray(xx.reshape(-1), jnp.int32)
    py = jnp.asarray(yy.reshape(-1), jnp.int32)
    out = jax.jit(lambda a, b, c: integ.render_samples(
        kg, a, b, c, 0, spp))(px, py, py * w + px)
    return np.asarray(out[0]).reshape(h, w, 3) / spp


class TestRibbonIntersector:
    """Analytic checks on a single tapered segment."""

    def _hit(self, origins, dirs):
        p0 = jnp.asarray([[0.0, 0.0, 0.0]])
        e = jnp.asarray([[2.0, 0.0, 0.0]])
        r0, r1 = jnp.asarray([0.1]), jnp.asarray([0.3])
        so = jnp.asarray([0])
        o = jnp.asarray(origins, jnp.float32)
        d = jnp.asarray(dirs, jnp.float32)
        n = len(origins)
        return isect.intersect_curves_ribbon(
            p0, e, r0, r1, so, 100, o, d,
            jnp.zeros(n), jnp.full(n, 1e9))

    def test_hits_misses_and_params(self):
        # segment x in [0,2], radius lerps 0.1 -> 0.3; rays shoot +z
        o = [[-1, 0, -5], [0.05, 0, -5], [1.0, 0, -5], [1.95, 0, -5],
             [3, 0, -5], [1.0, 0.15, -5], [1.0, 0.25, -5]]
        d = [[0, 0, 1]] * 7
        h = self._hit(o, d)
        hit = np.asarray(h["prim"]) >= 0
        assert list(hit) == [False, True, True, True, False, True, False]
        # reported t is the front-surface (tube entry) point:
        # t = t_axis - sqrt(r(s)^2 - dist^2)
        r_at = 0.1 + 0.2 * np.array([0.025, 0.5, 0.975])
        np.testing.assert_allclose(np.asarray(h["t"])[[1, 2, 3]],
                                   5.0 - r_at, atol=1e-4)
        np.testing.assert_allclose(
            float(h["t"][5]), 5.0 - np.sqrt(0.2**2 - 0.15**2), atol=1e-4)
        np.testing.assert_allclose(np.asarray(h["u"])[[1, 2, 3]],
                                   [0.025, 0.5, 0.975], atol=1e-4)
        # signed across coordinate: y=+0.15 at r=0.2 -> v = +-0.75
        assert abs(abs(float(h["v"][5])) - 0.75) < 1e-3
        assert int(h["prim"][1]) == 100  # prim_base + segment index

    def test_tmin_tmax_respected(self):
        p0 = jnp.asarray([[0.0, 0.0, 0.0]])
        e = jnp.asarray([[2.0, 0.0, 0.0]])
        r0 = r1 = jnp.asarray([0.2])
        so = jnp.asarray([0])
        o = jnp.asarray([[1, 0, -5]] * 3, jnp.float32)
        d = jnp.asarray([[0, 0, 1]] * 3, jnp.float32)
        h = isect.intersect_curves_ribbon(
            p0, e, r0, r1, so, 0, o, d,
            jnp.asarray([0.0, 6.0, 0.0]),      # tmin past the hit
            jnp.asarray([1e9, 1e9, 4.0]))      # tmax before the hit
        assert list(np.asarray(h["prim"]) >= 0) == [True, False, False]

    def test_any_hit_matches_closest(self):
        rng = np.random.default_rng(3)
        S, N = 40, 256
        p0 = jnp.asarray(rng.uniform(-1, 1, (S, 3)), jnp.float32)
        e = jnp.asarray(rng.normal(0, 0.5, (S, 3)), jnp.float32)
        r0 = jnp.asarray(rng.uniform(0.01, 0.2, S), jnp.float32)
        r1 = jnp.asarray(rng.uniform(0.01, 0.2, S), jnp.float32)
        so = jnp.zeros(S, jnp.int32)
        o = jnp.asarray(rng.uniform(-2, 2, (N, 3)), jnp.float32)
        d = jnp.asarray(rng.normal(0, 1, (N, 3)), jnp.float32)
        tmin = jnp.zeros(N)
        tmax = jnp.full(N, 10.0)
        h = isect.intersect_curves_ribbon(p0, e, r0, r1, so, 0, o, d,
                                          tmin, tmax)
        blocked = isect.curves_any_hit(p0, e, r0, r1, so, o, d, tmin,
                                       tmax)
        np.testing.assert_array_equal(np.asarray(h["prim"]) >= 0,
                                      np.asarray(blocked))


class TestNativeHairScene:
    def test_prim_count_reduction(self):
        """The native path halves the primitive count vs our minimal
        2-triangle-per-segment ribbons (the reference's curve-to-mesh
        export pays 10-16 tris/segment; our tessellator was already
        minimal, so the native win here is 2x rows + a cheaper test:
        ~25 fused flops/segment vs 2 watertight triangle tests)."""
        scene = examples.hair_patch_scene(32, 32, spp=2, n_strands=50)
        scene.device_update()
        ds = scene.dscene["arrays"]
        n_segs = len(ds["curve_p0"])
        hair = [o.geometry for o in scene.objects
                if isinstance(o.geometry, Hair)][0]
        n_tess = hair.tessellate_ribbons().num_triangles
        assert n_segs * 2 <= n_tess, (n_segs, n_tess)

    def _front_facing_scene(self, mode, spp=12):
        """Strands along x viewed from -y: the tessellator's
        rotation-minimizing frame then faces the camera, so the twisted
        ribbons and the ray-facing native ribbons describe the SAME
        surface and the renders must agree (coverage + energy)."""
        from raytracingproject_tpu.app.examples import (
            Scene, background_shader)
        from raytracingproject_tpu.utils import transform as tfm
        rng = np.random.default_rng(7)
        scene = Scene()
        # camera looks DOWN from +z: strands along x get a
        # rotation-minimizing side vector cross(x, z-up) = -y, so the
        # tessellated ribbon's face normal is +z — facing this camera
        scene.camera.set("matrix",
                         tfm.look_at((0, 0, 4), (0, 0, 0), (0, 1, 0)))
        scene.camera.set("fov", 0.6)
        scene.camera.set("width", 48)
        scene.camera.set("height", 48)
        sh = examples.diffuse_shader("hairmat", (0.5, 0.35, 0.2))
        scene.add_shader(sh)
        hair = Hair("strands")
        hair.set("curve_shape", mode)
        for i in range(60):
            y0 = rng.uniform(-1.0, 1.0)
            z0 = rng.uniform(-0.2, 0.2)
            xs = np.linspace(-1.1, 1.1, 6)
            ys = y0 + 0.08 * np.sin(3.0 * xs + i)
            zs = np.full_like(xs, z0)
            hair.add_curve(np.stack([xs, ys, zs], -1),
                           radius=np.full(6, 0.02))
        hair.used_shaders = [sh]
        scene.add_object(Object("hair", hair))
        scene.background.shader = background_shader("bg", (1, 1, 1), 0.6)
        return scene

    def test_parity_native_vs_tessellated(self):
        a = render(self._front_facing_scene("ribbon"), 48, 48, 12)
        b = render(self._front_facing_scene("mesh"), 48, 48, 12)
        assert np.isfinite(a).all() and np.isfinite(b).all()
        assert abs(a.mean() - b.mean()) < 0.05 * b.mean(), \
            (a.mean(), b.mean())
        # per-pixel coverage agreement vs the empty background
        bgimg = 0.6
        ca = np.abs(a.sum(-1) - 3 * bgimg) > 0.15
        cb = np.abs(b.sum(-1) - 3 * bgimg) > 0.15
        union = (ca | cb).sum()
        assert union > 100
        assert (ca & cb).sum() / union > 0.85, \
            ((ca & cb).sum(), union)

    def test_native_covers_at_least_tessellated(self):
        """On the demo patch the fixed-frame ribbons are near edge-on
        to the camera and lose coverage; the ray-facing native path
        must never cover less (the reference ribbon always faces the
        ray)."""
        sh = examples.diffuse_shader("hairmat", (0.5, 0.35, 0.2))
        imgs = {}
        for mode in ("ribbon", "mesh"):
            scene = examples.hair_patch_scene(48, 48, spp=8,
                                              n_strands=120, shader=sh)
            for o in scene.objects:
                if isinstance(o.geometry, Hair):
                    o.geometry.set("curve_shape", mode)
            imgs[mode] = render(scene, 48, 48, 8)
        assert imgs["ribbon"].mean() >= imgs["mesh"].mean() * 0.95

    def test_native_hair_blocks_shadow_rays(self):
        """Shadow segments crossing the strand tube report blocked;
        segments beside it or stopping short do not (drives the same
        _shadow_blocked used by NEE)."""
        import jax.numpy as jnp
        from raytracingproject_tpu.ops import integrator as integ
        from raytracingproject_tpu.app.examples import Scene, \
            background_shader
        scene = Scene()
        scene.camera.set("width", 8)
        scene.camera.set("height", 8)
        sh = examples.diffuse_shader("h", (0.3, 0.2, 0.1))
        scene.add_shader(sh)
        hair = Hair("strand")
        hair.add_curve(np.array([[-1.0, 0, 0], [1.0, 0, 0]]),
                       radius=np.array([0.1, 0.1]))
        hair.used_shaders = [sh]
        scene.add_object(Object("hair", hair))
        scene.background.shader = background_shader("bg", (1, 1, 1), 1.0)
        scene.device_update()
        kg = scene.make_kernel_globals()
        o = jnp.asarray([[0, 0, -2], [0, 0.5, -2], [0, 0, -2]],
                        jnp.float32)
        d = jnp.asarray([[0, 0, 1.0]] * 3, jnp.float32)
        tmin = jnp.full(3, 1e-4)
        tmax = jnp.asarray([4.0, 4.0, 1.0])  # third stops short
        blocked = np.asarray(integ._shadow_blocked(kg, o, d, tmin, tmax))
        assert list(blocked) == [True, False, False]


class TestCurveClusters:
    """Oriented (unaligned) curve clusters vs the dense segment sweep
    (ops/curve_clusters.py; ref bvh/bvh_unaligned.cpp). Same ribbon
    math -> same winners."""

    def _scene(self):
        from raytracingproject_tpu.app import examples
        scene = examples.hair_patch_scene(32, 32, spp=2, n_strands=120)
        scene.device_update()
        kg = scene.make_kernel_globals()
        ds = kg["dscene"]
        assert "curve_cluster_table" in ds, (
            "hair scene too small for clusters "
            f"({ds['curve_p0'].shape[0]} segs)")
        return kg, ds

    def _rays(self, n, seed):
        rng = np.random.default_rng(seed)
        # hair patch spans roughly [-1, 1] x [-0.4, 0.4] x [0, 0.9]
        o = (rng.uniform(-1.3, 1.3, (n, 3))
             * np.array([1.0, 0.5, 0.6]) + np.array([0, 0, 0.4])
             ).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return jnp.asarray(o), jnp.asarray(d)

    def test_closest_parity(self):
        from raytracingproject_tpu.ops import curve_clusters as ccl
        from raytracingproject_tpu.ops import intersect as isect
        kg, ds = self._scene()
        o, d = self._rays(2048, 1)
        n = o.shape[0]
        tmin = jnp.full((n,), 1e-4, jnp.float32)
        tmax = jnp.full((n,), 1e30, jnp.float32)
        vis = jnp.full((n,), 0xFFFFFFFF, jnp.uint32)
        ref = isect.intersect_curves_ribbon(
            ds["curve_p0"], ds["curve_e"], ds["curve_r0"],
            ds["curve_r1"], ds["curve_object"],
            int(kg["curve_prim_base"]), o, d, tmin, tmax,
            visibility=vis, object_visibility=ds["object_visibility"])
        got = ccl.intersect_curve_clusters(
            ds["curve_cluster_table"], int(kg["curve_cluster_segs"]),
            int(kg["curve_prim_base"]), o, d, tmin, tmax, vis)
        ref = {k: np.asarray(v) for k, v in ref.items()}
        got = {k: np.asarray(v) for k, v in got.items()}
        hit_frac = (ref["prim"] >= 0).mean()
        assert hit_frac > 0.05, hit_frac
        np.testing.assert_array_equal(ref["prim"] >= 0, got["prim"] >= 0)
        same = ref["prim"] == got["prim"]
        # overlapping equal-t hairs can tie; require near-total match
        assert same.mean() > 0.999, same.mean()
        m = same & (ref["prim"] >= 0)
        np.testing.assert_allclose(ref["t"][m], got["t"][m],
                           rtol=3e-5)
        np.testing.assert_allclose(ref["u"][m], got["u"][m], atol=1e-5)

    def test_any_hit_parity(self):
        from raytracingproject_tpu.ops import curve_clusters as ccl
        from raytracingproject_tpu.ops import intersect as isect
        kg, ds = self._scene()
        o, d = self._rays(2048, 2)
        n = o.shape[0]
        tmin = jnp.full((n,), 1e-4, jnp.float32)
        tmax = jnp.full((n,), 10.0, jnp.float32)
        vis = jnp.full((n,), 0xFFFFFFFF, jnp.uint32)
        ref = isect.curves_any_hit(
            ds["curve_p0"], ds["curve_e"], ds["curve_r0"],
            ds["curve_r1"], ds["curve_object"], o, d, tmin, tmax,
            visibility=vis, object_visibility=ds["object_visibility"])
        h = ccl.intersect_curve_clusters(
            ds["curve_cluster_table"], int(kg["curve_cluster_segs"]),
            int(kg["curve_prim_base"]), o, d, tmin, tmax, vis,
            shadow_any_hit=True)
        np.testing.assert_array_equal(np.asarray(ref),
                                      np.asarray(h["prim"]) >= 0)

    def test_merge_keeps_nearer_triangle_hits(self):
        from raytracingproject_tpu.ops import curve_clusters as ccl
        kg, ds = self._scene()
        n = 256
        rng = np.random.default_rng(3)
        # rays start 5 units ABOVE the patch: no curve is within the
        # pre-existing t=0.05 triangle hit, so nothing may replace it
        o = jnp.asarray(np.stack([rng.uniform(-1, 1, n),
                                  rng.uniform(-0.4, 0.4, n),
                                  np.full(n, 5.0)], -1), jnp.float32)
        d = jnp.asarray(np.tile([0.0, 0.0, -1.0], (n, 1)), jnp.float32)
        tmin = jnp.full((n,), 1e-4, jnp.float32)
        tmax = jnp.full((n,), 1e30, jnp.float32)
        vis = jnp.full((n,), 0xFFFFFFFF, jnp.uint32)
        # synthetic pre-existing hits at t=0.05: nothing may replace them
        hit0 = {"t": jnp.full((n,), 0.05, jnp.float32),
                "prim": jnp.zeros((n,), jnp.int32),
                "u": jnp.zeros((n,), jnp.float32),
                "v": jnp.zeros((n,), jnp.float32),
                "object": jnp.zeros((n,), jnp.int32)}
        out = ccl.intersect_curve_clusters(
            ds["curve_cluster_table"], int(kg["curve_cluster_segs"]),
            int(kg["curve_prim_base"]), o, d, tmin, tmax, vis, hit0=hit0)
        np.testing.assert_array_equal(np.asarray(out["prim"]),
                                      np.zeros(n, np.int32))
        np.testing.assert_allclose(np.asarray(out["t"]), 0.05)

    def test_render_parity_end_to_end(self):
        import jax
        from raytracingproject_tpu.ops import integrator as integ
        from raytracingproject_tpu.app import examples
        scene = examples.hair_patch_scene(24, 24, spp=2, n_strands=120)
        scene.device_update()
        kg = scene.make_kernel_globals()
        yy, xx = np.mgrid[0:24, 0:24]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        pidx = py * 24 + px

        def render(kg2):
            L, _ = jax.jit(lambda a, b, c: integ.render_samples(
                kg2, a, b, c, 0, 2))(px, py, pidx)
            return np.asarray(L).reshape(24, 24, 3) / 2

        dense = render({**kg, "curve_clusters": False})
        clus = render({**kg, "curve_clusters": True})
        assert np.isfinite(clus).all()
        # equal-t tie-breaks between overlapping hairs can flip single
        # stochastic samples; images must agree essentially everywhere
        close = np.isclose(dense, clus, atol=5e-3, rtol=1e-3).mean()
        assert close > 0.995, close
        assert abs(dense.mean() - clus.mean()) < 5e-4 + 0.01 * dense.mean()
