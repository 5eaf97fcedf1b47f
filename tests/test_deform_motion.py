"""Deforming-vertex motion blur (ref: ATTR_STD_MOTION_VERTEX_POSITION,
kernel/geom motion triangles — redesigned as per-ray time lerp of the
dense tri-major blocks)."""

import numpy as np
import jax.numpy as jnp

from raytracingproject_tpu.ops import intersect as isect
from raytracingproject_tpu.models import Scene, Object
from raytracingproject_tpu.models import film as fm
from raytracingproject_tpu.models.mesh import make_plane_mesh
from raytracingproject_tpu.session import Session, SessionParams
from raytracingproject_tpu.utils import transform as tfm
from raytracingproject_tpu.app.examples import (diffuse_shader,
                                                emission_shader)


class TestOps:
    def test_brute_interpolates_to_ray_time(self):
        # unit quad at x=0 at t=0 sliding to x=10 at t=1
        tv0 = np.array([[[-1, -1, 0], [1, -1, 0], [1, 1, 0]],
                        [[-1, -1, 0], [1, 1, 0], [-1, 1, 0]]], np.float32)
        tv1 = tv0 + np.array([10.0, 0.0, 0.0], np.float32)
        po = np.zeros(2, np.int32)
        n = 8
        times = np.linspace(0.0, 1.0, n).astype(np.float32)
        # rays aimed at where the quad sits at each ray's own time
        o = np.stack([times * 10.0,
                      np.zeros(n), np.full(n, 5.0)], -1).astype(np.float32)
        d = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (n, 1))
        hit = isect.intersect_brute(
            jnp.asarray(tv0), jnp.asarray(po), jnp.asarray(o),
            jnp.asarray(d), jnp.zeros(n), jnp.full(n, 100.0),
            tri_verts_t1=jnp.asarray(tv1), time=jnp.asarray(times))
        assert (np.asarray(hit["prim"]) >= 0).all()
        np.testing.assert_allclose(np.asarray(hit["t"]), 5.0, atol=1e-4)
        # rays aimed at the t=0 position but fired at t=1 must miss
        hit2 = isect.intersect_brute(
            jnp.asarray(tv0), jnp.asarray(po),
            jnp.asarray(np.array([[0.0, 0.0, 5.0]] * n, np.float32)),
            jnp.asarray(d), jnp.zeros(n), jnp.full(n, 100.0),
            tri_verts_t1=jnp.asarray(tv1),
            time=jnp.ones(n, jnp.float32))
        assert (np.asarray(hit2["prim"]) < 0).all()

    def test_shadow_blocked_interpolates(self):
        tv0 = np.array([[[-1, -1, 0], [1, -1, 0], [1, 1, 0]],
                        [[-1, -1, 0], [1, 1, 0], [-1, 1, 0]]], np.float32)
        tv1 = tv0 + np.array([10.0, 0.0, 0.0], np.float32)
        po = np.zeros(2, np.int32)
        o = jnp.asarray([[0.0, 0.0, 5.0], [0.0, 0.0, 5.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
        blocked = isect.shadow_blocked_brute(
            jnp.asarray(tv0), jnp.asarray(po), o, d,
            jnp.zeros(2), jnp.full(2, 100.0),
            tri_verts_t1=jnp.asarray(tv1),
            time=jnp.asarray([0.0, 1.0]))
        assert bool(blocked[0]) and not bool(blocked[1])


class TestScene:
    def _scene(self, deform):
        scene = Scene()
        scene.camera.set("matrix", tfm.look_at(
            (10, 0, 60), (10, 0, 0), (0, 1, 0)))
        scene.camera.set("fov", 0.9)
        scene.camera.set("width", 24)
        scene.camera.set("height", 24)
        scene.camera.set("shuttertime", 1.0)
        white = diffuse_shader("w", (0.8, 0.8, 0.8))
        lamp = emission_shader("e", (1, 1, 1), 40.0)
        scene.add_shader(white)
        scene.add_shader(lamp)
        # small quad that slides +x by 20 over the shutter
        m = make_plane_mesh((-2, -2, 0), (4, 0, 0), (0, 4, 0))
        m.used_shaders = [white]
        if deform:
            v1 = m.verts_array + np.array([20.0, 0.0, 0.0], np.float32)
            m.attribute_set("std_motion_vertex_position", "vertex", v1)
        scene.add_object(Object("mover", m))
        # emissive backdrop BEHIND the mover: the quad silhouettes
        # against it, so its (possibly smeared) footprint is measurable
        lm = make_plane_mesh((-50, -50, -10), (120, 0, 0), (0, 120, 0))
        lm.used_shaders = [lamp]
        scene.add_object(Object("backdrop", lm))
        return scene

    def test_deform_blur_widens_footprint(self):
        scene_s = self._scene(False)
        ss = Session(scene_s, SessionParams(samples=32))
        ss.reset()
        img_s = ss.render()

        scene_d = self._scene(True)
        assert scene_d._pack_lights is not None  # touch to silence lint
        sd = Session(scene_d, SessionParams(samples=32))
        sd.reset()
        img_d = sd.render()
        # where the quad occludes/reflects, brightness differs from the
        # empty-background columns; measure the lit-footprint width
        lum_s = img_s[..., :3].mean(-1)
        lum_d = img_d[..., :3].mean(-1)
        bright = np.percentile(lum_s, 90)   # lit backdrop level
        # unoccluded pixels see the emissive backdrop with ZERO variance,
        # so any occluded sample shows as a dip; the smear spreads
        # partial occlusion across many more columns
        cols_s = (lum_s < 0.97 * bright).any(0).sum()
        cols_d = (lum_d < 0.97 * bright).any(0).sum()
        assert cols_s > 1                    # static quad visible
        assert cols_d > cols_s * 1.5  # smeared across more columns
        # and the static quad blocks harder than any smeared pixel
        assert lum_s.min() < lum_d.min() + 1e-6
        # kernel flags actually engaged
        assert sd._kg["has_deform_motion"]
        assert not ss._kg["has_deform_motion"]


class TestClusterMotion:
    def test_cluster_matches_brute_bitexact(self):
        """Deform-motion clusters (per-tri shutter deltas lerped by ray
        time) must pick the same winners as the dense lerp path — same
        watertight math, same lerp (deforming geometry escapes the
        brute path)."""
        import jax
        from raytracingproject_tpu.bvh import build as bvh_build
        from raytracingproject_tpu.bvh import clusters as cl_mod
        from raytracingproject_tpu.ops import cluster_intersect as ci
        rng = np.random.default_rng(5)
        P = 1500
        centers = rng.uniform(-5, 5, (P, 3)).astype(np.float32)
        tv0 = (centers[:, None, :]
               + rng.normal(0, 0.4, (P, 3, 3))).astype(np.float32)
        tv1 = (tv0 + rng.normal(0, 0.6, (P, 1, 3))).astype(np.float32)
        po = np.zeros(P, np.int32)
        lo = np.minimum(tv0.min(1), tv1.min(1))
        hi = np.maximum(tv0.max(1), tv1.max(1))
        b = bvh_build.build_bvh(lo, hi)
        order = b.prim_order
        v0o, v1o = tv0[order], tv1[order]
        cuts = cl_mod.cut_clusters(b.children, 16)
        cds = []
        for (s, c) in cuts:
            allv = np.concatenate([v0o[s:s + c],
                                   v1o[s:s + c]]).reshape(-1, 3)
            cds.append({"verts": v0o[s:s + c], "verts_t1": v1o[s:s + c],
                        "prim": np.arange(s, s + c),
                        "obj": po[s:s + c],
                        "vis": np.full(c, 0xFFFFFFFF, np.uint32),
                        "w2o": None,
                        "lo": allv.min(0), "hi": allv.max(0)})
        cb, ctab, ct, motion = ci.pack_cluster_table(cds)
        assert motion
        N = 2048
        o = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
        d = rng.normal(0, 1, (N, 3)).astype(np.float32)
        t = rng.random(N).astype(np.float32)
        tmin = np.zeros(N, np.float32)
        tmax = np.full(N, 50.0, np.float32)
        hb = isect.intersect_brute(
            jnp.asarray(v0o), jnp.asarray(po), jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
            tri_verts_t1=jnp.asarray(v1o), time=jnp.asarray(t))
        hc = ci.intersect_clusters(
            jnp.asarray(cb), jnp.asarray(ctab), ct, jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
            time=jnp.asarray(t), has_motion=True)
        frac_hit = float((np.asarray(hb["prim"]) >= 0).mean())
        assert frac_hit > 0.2  # the test actually exercises hits
        # winner selection is identical; t/u agree to FMA-contraction
        # noise (XLA fuses the time lerp differently per program, so
        # true bit-exactness is not guaranteed across the two kernels)
        np.testing.assert_array_equal(np.asarray(hb["prim"]),
                                      np.asarray(hc["prim"]))
        np.testing.assert_allclose(np.asarray(hb["t"]),
                                   np.asarray(hc["t"]), atol=1e-5)
        np.testing.assert_allclose(np.asarray(hb["u"]),
                                   np.asarray(hc["u"]), atol=1e-4)

    def test_deform_scene_dispatches_to_cluster(self):
        """A >1024-prim deforming mesh gets cluster tables and leaves
        the brute path; the render stays finite and matches the brute
        render closely."""
        from raytracingproject_tpu.models.mesh import make_sphere_mesh
        import raytracingproject_tpu.models.scene as scene_mod
        from raytracingproject_tpu.app import examples
        import jax
        from raytracingproject_tpu.ops import integrator as integ

        def build():
            scene = Scene()
            scene.camera.set("matrix",
                             tfm.look_at((0, -6, 0), (0, 0, 0),
                                         (0, 0, 1)))
            scene.camera.set("fov", 0.6)
            scene.camera.set("width", 24)
            scene.camera.set("height", 24)
            sh = diffuse_shader("m", (0.7, 0.6, 0.5))
            scene.add_shader(sh)
            sph = make_sphere_mesh((0, 0, 0), 1.0, 0, nlat=30, nlon=40)
            v = sph.verts_array
            sph.attribute_set(
                "std_motion_vertex_position", "vertex",
                (v * 1.25 + np.array([0.5, 0, 0],
                                     np.float32)).astype(np.float32))
            sph.used_shaders = [sh]
            scene.add_object(Object("ball", sph))
            scene.background.shader = examples.background_shader(
                "bg", (1, 1, 1), 1.0)
            scene.camera.set("shuttertime", 1.0)
            return scene

        scene = build()
        scene.device_update()
        assert scene.dscene["has_deform_motion"]
        assert "cluster_bounds" in scene.dscene["arrays"]
        assert not scene.dscene["use_brute"]
        kg = scene.make_kernel_globals()
        w = h = 24
        yy, xx = np.mgrid[0:h, 0:w]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        img = np.asarray(jax.jit(lambda a, b, c: integ.render_samples(
            kg, a, b, c, 0, 8))(px, py, py * w + px)[0]).reshape(
                h, w, 3) / 8
        assert np.isfinite(img).all()
        # force the brute path on the identical scene: images must agree
        old = scene_mod.BRUTE_VS_CLUSTER_PRIMS
        scene_mod.BRUTE_VS_CLUSTER_PRIMS = 10 ** 9
        try:
            s2 = build()
            s2.device_update()
            assert s2.dscene["use_brute"]
            kg2 = s2.make_kernel_globals()
            img2 = np.asarray(jax.jit(
                lambda a, b, c: integ.render_samples(
                    kg2, a, b, c, 0, 8))(px, py, py * w + px)[0]
            ).reshape(h, w, 3) / 8
        finally:
            scene_mod.BRUTE_VS_CLUSTER_PRIMS = old
        np.testing.assert_allclose(img, img2, atol=1e-5)


class TestMultiStep:
    """Multi-step deform motion (>2 shutter samples; ref:
    bvh_build.cpp:89-130 motion-step references — redesigned as a
    hat-weighted piecewise-linear evaluation in the dense sweeps)."""

    def _quad(self):
        tv0 = np.array([[[-1, -1, 0], [1, -1, 0], [1, 1, 0]],
                        [[-1, -1, 0], [1, 1, 0], [-1, 1, 0]]], np.float32)
        return tv0, np.zeros(2, np.int32)

    def test_collinear_steps_match_two_step_lerp(self):
        """Steps on a straight line reduce exactly to the 2-step path:
        same hits, same t (float-associativity tolerance)."""
        tv0, po = self._quad()
        shift = np.array([10.0, 0.0, 0.0], np.float32)
        steps = np.stack([tv0 + 0.5 * shift, tv0 + shift])  # (2,T,3,3)
        n = 16
        rng = np.random.default_rng(0)
        times = rng.uniform(0, 1, n).astype(np.float32)
        o = np.stack([times * 10.0, rng.uniform(-0.9, 0.9, n),
                      np.full(n, 5.0)], -1).astype(np.float32)
        d = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (n, 1))
        args = (jnp.asarray(po), jnp.asarray(o), jnp.asarray(d),
                jnp.zeros(n), jnp.full(n, 100.0))
        h2 = isect.intersect_brute(jnp.asarray(tv0), *args,
                                   tri_verts_t1=jnp.asarray(tv0 + shift),
                                   time=jnp.asarray(times))
        h3 = isect.intersect_brute(jnp.asarray(tv0), *args,
                                   tri_verts_t1=jnp.asarray(steps),
                                   time=jnp.asarray(times))
        np.testing.assert_array_equal(np.asarray(h2["prim"]),
                                      np.asarray(h3["prim"]))
        np.testing.assert_allclose(np.asarray(h2["t"]),
                                   np.asarray(h3["t"]), rtol=1e-5)

    def test_nonlinear_path_hits_true_midpoint(self):
        """A quad bouncing up then back (V path) sits at z=+2 at
        t=0.5 — a 2-step blur would put it at z=0 there."""
        tv0, po = self._quad()
        steps = np.stack([tv0 + np.array([0, 0, 2.0], np.float32),
                          tv0])                      # up at 0.5, back at 1
        n = 4
        times = np.full(n, 0.5, np.float32)
        o = np.array([[0.0, 0.0, 5.0]] * n, np.float32)
        d = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (n, 1))
        h = isect.intersect_brute(
            jnp.asarray(tv0), jnp.asarray(po), jnp.asarray(o),
            jnp.asarray(d), jnp.zeros(n), jnp.full(n, 100.0),
            tri_verts_t1=jnp.asarray(steps), time=jnp.asarray(times))
        assert (np.asarray(h["prim"]) >= 0).all()
        np.testing.assert_allclose(np.asarray(h["t"]), 3.0, atol=1e-4)
        # 2-step endpoints-only misses the mid excursion entirely
        h2 = isect.intersect_brute(
            jnp.asarray(tv0), jnp.asarray(po), jnp.asarray(o),
            jnp.asarray(d), jnp.zeros(n), jnp.full(n, 100.0),
            tri_verts_t1=jnp.asarray(steps[-1]), time=jnp.asarray(times))
        np.testing.assert_allclose(np.asarray(h2["t"]), 5.0, atol=1e-4)

    def test_occlusion_sweep_multi_step(self):
        tv0, po = self._quad()
        steps = np.stack([tv0 + np.array([0, 0, 2.0], np.float32), tv0])
        n = 2
        o = jnp.asarray([[0.0, 0.0, 1.0]] * n)   # between z=0 and z=2
        d = jnp.asarray([[0.0, 0.0, 1.0]] * n)   # looking up
        tb, to_, blk = isect.intersect_brute_occlusion(
            jnp.asarray(tv0), jnp.asarray(po),
            jnp.zeros(2, bool), o, d, jnp.full((n,), 1e-5),
            tmax_closest=jnp.full((n,), 100.0),
            tmax_any=jnp.full((n,), 100.0),
            visibility_closest=jnp.full((n,), 0xFFFFFFFF, jnp.uint32),
            visibility_any=jnp.full((n,), 0xFFFFFFFF, jnp.uint32),
            object_visibility=jnp.full((1,), 0xFFFFFFFF, jnp.uint32),
            tri_verts_t1=jnp.asarray(steps),
            time=jnp.asarray([0.5, 1.0]))
        # at t=0.5 the quad is at z=2 -> blocked above; at t=1 it is
        # back at z=0 -> nothing above
        assert bool(blk[0]) and not bool(blk[1])

    def test_scene_packs_multi_step_and_renders(self):
        scene = Scene()
        scene.camera.set("matrix",
                         tfm.look_at((0, -6, 1), (0, 0, 0), (0, 0, 1)))
        scene.camera.set("width", 24)
        scene.camera.set("height", 24)
        scene.camera.set("shuttertime", 1.0)
        m = make_plane_mesh((-1, -1, 0), (2, 0, 0), (0, 2, 0))
        v = np.asarray(m.verts, np.float32).reshape(-1, 3)
        steps = np.stack([v + np.array([0, 0, 1.5], np.float32), v])
        m.attribute_set("std_motion_vertex_position", "vertex", steps)
        m.set("use_motion_blur", True)
        m.used_shaders = [diffuse_shader("w", (0.8, 0.8, 0.8))]
        scene.add_shader(m.used_shaders[0])
        scene.add_object(Object("p", m))
        from raytracingproject_tpu.app.examples import background_shader
        scene.background.shader = background_shader("bg", (1, 1, 1), 1.0)
        scene.add_shader(scene.background.shader)
        scene.device_update()
        assert scene.dscene["deform_steps"] == 3
        assert scene.dscene["use_brute"]
        arr = scene.dscene["arrays"]["tri_verts_world_steps"]
        assert arr.shape[0] == 2
        sess = Session(scene, SessionParams(samples=4))
        sess.reset()
        img = sess.render()
        assert np.isfinite(img).all() and img[..., :3].mean() > 0.1

    def test_resample_nested_grids_exact(self):
        from raytracingproject_tpu.models.scene import \
            _resample_motion_steps
        rng = np.random.default_rng(2)
        v0 = rng.standard_normal((5, 3)).astype(np.float32)
        v1 = rng.standard_normal((5, 3)).astype(np.float32)
        # 2-step mesh resampled onto 4 extra steps: midpoints exact
        out = _resample_motion_steps(v0, v1[None], 4)
        assert out.shape == (4, 5, 3)
        np.testing.assert_array_equal(out[-1], v1)
        np.testing.assert_allclose(out[1], 0.5 * (v0 + v1), atol=1e-6)


class TestObjectMultiStep:
    """Multi-step object-transform motion (ref: Object::motion array —
    packed leaf rows carry S decomposed steps, the traversal picks the
    lane's segment and slerps inside it)."""

    def _scene(self, path):
        from raytracingproject_tpu.app.examples import background_shader
        scene = Scene()
        scene.camera.set("matrix",
                         tfm.look_at((0, -6, 1), (0, 0, 0), (0, 0, 1)))
        scene.camera.set("width", 16)
        scene.camera.set("height", 16)
        scene.camera.set("shuttertime", 1.0)
        m = make_plane_mesh((-1, -1, 0), (2, 0, 0), (0, 2, 0))
        m.used_shaders = [diffuse_shader("w", (0.8, 0.8, 0.8))]
        scene.add_shader(m.used_shaders[0])
        o = Object("mover", m)
        o.set_motion(path)
        scene.add_object(o)
        scene.background.shader = background_shader("bg", (1, 1, 1), 1.0)
        scene.add_shader(scene.background.shader)
        scene.device_update()
        return scene

    def _hit_t(self, kg, time):
        import jax.numpy as jnp
        from raytracingproject_tpu.ops import integrator as integ
        n = 4
        o = jnp.asarray([[0.0, 0.0, 5.0]] * n)
        d = jnp.asarray([[0.0, 0.0, -1.0]] * n)
        hit = integ._scene_intersect(
            kg, o, d, jnp.full((n,), 1e-4), jnp.full((n,), 100.0),
            jnp.full((n,), 0xFFFFFFFF, jnp.uint32),
            time=jnp.full((n,), time, jnp.float32))
        return np.asarray(hit["t"])[0], int(np.asarray(hit["prim"])[0])

    def test_v_path_hits_mid_excursion(self):
        ident = tfm.identity()
        up = np.array(ident, np.float32).copy()
        up[2, 3] = 2.0
        scene = self._scene([ident, up, ident])
        kg = scene.make_kernel_globals()
        assert kg["obj_motion_steps"] == 3
        t_mid, prim_mid = self._hit_t(kg, 0.5)
        assert prim_mid >= 0 and abs(t_mid - 3.0) < 1e-3  # plane at z=2
        t_end, prim_end = self._hit_t(kg, 1.0)
        assert prim_end >= 0 and abs(t_end - 5.0) < 1e-3  # back at z=0
        # classic 2-step endpoints-only never leaves z=0
        scene2 = self._scene([ident, ident])
        kg2 = scene2.make_kernel_globals()
        t2, p2 = self._hit_t(kg2, 0.5)
        assert p2 >= 0 and abs(t2 - 5.0) < 1e-3

    def test_two_step_layout_unchanged(self):
        ident = tfm.identity()
        shift = np.array(ident, np.float32).copy()
        shift[0, 3] = 3.0
        scene = self._scene([ident, shift])
        kg = scene.make_kernel_globals()
        assert kg["obj_motion_steps"] == 2
        # at t=1 the quad is at x=3: the straight-down ray misses
        t1, p1 = self._hit_t(kg, 1.0)
        assert p1 < 0
        t0, p0 = self._hit_t(kg, 0.0)
        assert p0 >= 0 and abs(t0 - 5.0) < 1e-3

    def test_interp_steps_matches_two_step(self):
        import jax.numpy as jnp
        rng = np.random.default_rng(4)
        a = tfm.identity().copy(); a[:3, 3] = rng.standard_normal(3)
        b = tfm.identity().copy(); b[:3, 3] = rng.standard_normal(3)
        da, db = tfm.decompose(a), tfm.decompose(b)
        row = jnp.asarray(np.concatenate([da, db])[None])
        for t in (0.0, 0.3, 1.0):
            m2 = tfm.motion_interpolate(jnp.asarray(da)[None],
                                        jnp.asarray(db)[None],
                                        jnp.asarray([t]))
            ms = tfm.motion_interpolate_steps(row, jnp.asarray([t]), 2)
            np.testing.assert_allclose(np.asarray(m2), np.asarray(ms),
                                       atol=1e-7)

    def test_resample_decomps_exact_at_grid(self):
        a = tfm.identity().copy(); a[:3, 3] = [1, 0, 0]
        b = tfm.identity().copy(); b[:3, 3] = [3, 0, 0]
        out = tfm.resample_motion_decomps([a, b], 3)
        assert len(out) == 3
        np.testing.assert_allclose(out[1][4:7], [2, 0, 0], atol=1e-6)
        np.testing.assert_allclose(out[2][4:7], [3, 0, 0], atol=1e-6)


class TestCameraMultiStep:
    def test_camera_v_path(self):
        """Camera bouncing up and back: a t=0.5 ray originates from the
        raised position; endpoints-only motion would not move it."""
        import jax
        from raytracingproject_tpu.ops import camera as cam_ops
        from raytracingproject_tpu.models.camera import Camera
        base = tfm.look_at((0, -5, 0), (0, 0, 0), (0, 0, 1))
        up = np.array(base, np.float32).copy()
        up[2, 3] += 2.0
        cam = Camera()
        cam.set("matrix", base)
        cam.set("width", 8)
        cam.set("height", 8)
        cam.set("shuttertime", 1.0)
        cam.set_motion([base, up, base])
        rec = cam.update()
        assert int(rec["motion_steps"]) == 3

        def rays(tu):
            return cam_ops.camera_sample_ray(
                rec, jnp.asarray([4.0]), jnp.asarray([4.0]),
                jnp.asarray([0.5]), jnp.asarray([0.5]),
                jnp.asarray([tu]))
        r_mid = rays(0.5)
        r_end = rays(1.0)
        z_mid = float(np.asarray(r_mid["o"])[0, 2])
        z_end = float(np.asarray(r_end["o"])[0, 2])
        assert abs(z_mid - z_end - 2.0) < 1e-3


class TestMotionStaleness:
    def test_socket_edit_invalidates_cached_path(self):
        from raytracingproject_tpu.models import Object as Obj
        ident = tfm.identity()
        up = np.array(ident, np.float32).copy()
        up[2, 3] = 2.0
        end = np.array(ident, np.float32).copy()
        end[0, 3] = 7.0
        o = Obj("m")
        o.set_motion([ident, up, ident])
        assert len(o.motion_transforms()) == 3
        o.set("motion_end", end)   # classic 2-step API edit
        path = o.motion_transforms()
        assert len(path) == 2
        np.testing.assert_allclose(path[1], end)
