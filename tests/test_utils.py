"""Unit tests for the foundation layer (ref: intern/cycles/test/util_*_test.cpp)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracingproject_tpu.utils import math as um
from raytracingproject_tpu.utils import rng
from raytracingproject_tpu.utils import transform as tfm


class TestMath:
    def test_normalize(self):
        v = jnp.array([[3.0, 0.0, 4.0], [0.0, 2.0, 0.0]])
        n = um.normalize(v)
        np.testing.assert_allclose(um.length(n), [1.0, 1.0], atol=1e-6)

    def test_reflect(self):
        # Cycles convention: incident points away from surface.
        i = um.normalize(jnp.array([[1.0, -1.0, 0.0]]))
        n = jnp.array([[0.0, 1.0, 0.0]])
        r = um.reflect(i, n)
        np.testing.assert_allclose(
            np.asarray(r), um.normalize(jnp.array([[1.0, 1.0, 0.0]])), atol=1e-6)

    def test_make_orthonormals(self):
        key = jax.random.PRNGKey(0)
        n = um.normalize(jax.random.normal(key, (64, 3)))
        t, b = um.make_orthonormals(n)
        np.testing.assert_allclose(um.dot(t, n), np.zeros(64), atol=1e-5)
        np.testing.assert_allclose(um.dot(b, n), np.zeros(64), atol=1e-5)
        np.testing.assert_allclose(um.dot(t, b), np.zeros(64), atol=1e-5)
        np.testing.assert_allclose(um.length(t), np.ones(64), atol=1e-5)
        # right-handed: t x b == n
        np.testing.assert_allclose(np.asarray(um.cross(t, b)), np.asarray(n),
                                   atol=1e-5)

    def test_local_frame_roundtrip(self):
        key = jax.random.PRNGKey(1)
        n = um.normalize(jax.random.normal(key, (16, 3)))
        v = um.normalize(jax.random.normal(jax.random.PRNGKey(2), (16, 3)))
        t, b = um.make_orthonormals(n)
        lv = um.to_local(v, t, b, n)
        wv = um.from_local(lv, t, b, n)
        np.testing.assert_allclose(np.asarray(wv), np.asarray(v), atol=1e-5)

    def test_cosine_hemisphere_distribution(self):
        n = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (4096, 1))
        u = np.random.default_rng(0).random((2, 4096)).astype(np.float32)
        d, pdf = um.sample_cos_hemisphere(n, jnp.array(u[0]), jnp.array(u[1]))
        cos = np.asarray(um.dot(d, n))
        assert (cos >= 0).all()
        np.testing.assert_allclose(np.asarray(pdf), cos / np.pi, atol=1e-5)
        # Mean cos of cosine-weighted samples is 2/3.
        assert abs(cos.mean() - 2.0 / 3.0) < 0.02

    def test_concentric_disk(self):
        u = np.random.default_rng(1).random((2, 8192)).astype(np.float32)
        x, y = um.concentric_sample_disk(jnp.array(u[0]), jnp.array(u[1]))
        r2 = np.asarray(x) ** 2 + np.asarray(y) ** 2
        assert r2.max() <= 1.0 + 1e-6
        # Uniform on disk: E[r^2] = 1/2.
        assert abs(r2.mean() - 0.5) < 0.02

    def test_refract_tir(self):
        i = um.normalize(jnp.array([[1.0, -0.05, 0.0]]))  # grazing
        n = jnp.array([[0.0, 1.0, 0.0]])
        _, tir = um.refract(i, n, eta=1.5)  # dense -> sparse
        assert bool(tir[0])

    def test_fresnel_range(self):
        cosi = jnp.linspace(0.0, 1.0, 32)
        f = um.fresnel_dielectric_cos(cosi, 1.45)
        assert float(jnp.min(f)) >= 0.0 and float(jnp.max(f)) <= 1.0 + 1e-6
        np.testing.assert_allclose(float(f[0]), 1.0, atol=1e-5)

    def test_power_heuristic(self):
        assert float(um.power_heuristic(jnp.float32(1.0), jnp.float32(1.0))) == pytest.approx(0.5)
        assert float(um.power_heuristic(jnp.float32(0.0), jnp.float32(0.0))) == 0.0

    def test_equirect_roundtrip(self):
        d = um.normalize(jnp.array(np.random.default_rng(3).normal(size=(128, 3)),
                                   dtype=jnp.float32))
        u, v = um.direction_to_equirectangular(d)
        d2 = um.equirectangular_to_direction(u, v)
        np.testing.assert_allclose(np.asarray(d2), np.asarray(d), atol=1e-4)


class TestTransform:
    def test_compose_inverse(self):
        t = tfm.compose(tfm.translate(1, 2, 3),
                        tfm.compose(tfm.rotate(0.7, (0, 0, 1)), tfm.scale(2.0)))
        ti = tfm.inverse(t)
        p = np.array([0.3, -1.2, 2.5], np.float32)
        p2 = tfm.transform_point(ti, tfm.transform_point(t, p))
        np.testing.assert_allclose(p2, p, atol=1e-5)

    def test_look_at(self):
        t = tfm.look_at((0, 0, 5), (0, 0, 0), (0, 1, 0))
        # camera-space forward (+z) should map to world -z direction
        d = tfm.transform_direction(t, np.array([0.0, 0.0, 1.0], np.float32))
        np.testing.assert_allclose(d, [0, 0, -1], atol=1e-6)
        np.testing.assert_allclose(t[:, 3], [0, 0, 5], atol=1e-6)

    def test_decompose_interpolate_endpoints(self):
        a = tfm.compose(tfm.translate(0, 0, 0), tfm.rotate(0.3, (0, 1, 0)))
        b = tfm.compose(tfm.translate(4, 0, 0), tfm.rotate(1.2, (0, 1, 0)))
        da, db = tfm.decompose(a), tfm.decompose(b)
        m0 = np.asarray(tfm.motion_interpolate(jnp.array(da), jnp.array(db), 0.0))
        m1 = np.asarray(tfm.motion_interpolate(jnp.array(da), jnp.array(db), 1.0))
        np.testing.assert_allclose(m0, a, atol=1e-4)
        np.testing.assert_allclose(m1, b, atol=1e-4)


class TestRng:
    def test_sobol_first_points(self):
        # Dim 0 is van der Corput: unscrambled values are exact.
        idx = np.arange(8, dtype=np.uint32)
        v = rng._sobol_eval(0, idx)
        got = v.astype(np.float64) / 2**32
        np.testing.assert_allclose(
            got, [0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875])

    def test_sobol_dim1_stratified(self):
        # First 2^k points of any Sobol dim are stratified in 2^k bins.
        for k in (3, 5, 8):
            n = 1 << k
            idx = np.arange(n, dtype=np.uint32)
            v = rng._sobol_eval(1, idx).astype(np.float64) / 2**32
            bins = np.floor(v * n).astype(int)
            assert len(np.unique(bins)) == n

    def test_owen_scramble_preserves_stratification(self):
        n = 256
        idx = np.arange(n, dtype=np.uint32)
        u, v = rng.sobol_burley_2d(idx, np.uint32(7), np.uint32(123))
        bu = np.floor(np.asarray(u, np.float64) * n).astype(int)
        bv = np.floor(np.asarray(v, np.float64) * n).astype(int)
        # 1D projections of a (0,2)-sequence stay one-per-bin after
        # Owen scrambling + index shuffling.
        assert len(np.unique(bu)) == n
        assert len(np.unique(bv)) == n

    def test_mean_and_range(self):
        idx = np.arange(4096, dtype=np.uint32)
        u, v = rng.sobol_burley_2d(idx, np.uint32(3), np.uint32(99))
        for a in (u, v):
            a = np.asarray(a)
            assert a.min() >= 0.0 and a.max() < 1.0
            assert abs(a.mean() - 0.5) < 0.01

    def test_decorrelated_across_dims_and_seeds(self):
        idx = np.arange(4096, dtype=np.uint32)
        u0, _ = rng.sobol_burley_2d(idx, np.uint32(0), np.uint32(1))
        u1, _ = rng.sobol_burley_2d(idx, np.uint32(1), np.uint32(1))
        u2, _ = rng.sobol_burley_2d(idx, np.uint32(0), np.uint32(2))
        c01 = np.corrcoef(np.asarray(u0), np.asarray(u1))[0, 1]
        c02 = np.corrcoef(np.asarray(u0), np.asarray(u2))[0, 1]
        assert abs(c01) < 0.05 and abs(c02) < 0.05

    def test_jax_numpy_parity(self):
        """Device kernels and host golden tests must agree bit-exactly."""
        idx = np.arange(257, dtype=np.uint32)
        un, vn = rng.sobol_burley_2d(idx, np.uint32(5), np.uint32(42))
        uj, vj = jax.jit(rng.sobol_burley_2d)(
            jnp.asarray(idx), jnp.uint32(5), jnp.uint32(42))
        np.testing.assert_array_equal(np.asarray(uj), un)
        np.testing.assert_array_equal(np.asarray(vj), vn)

    def test_pcg_sampler(self):
        idx = np.arange(1024, dtype=np.uint32)
        u, v = rng.pcg_2d(idx, np.uint32(0), np.uint32(7))
        assert abs(np.asarray(u).mean() - 0.5) < 0.03
        assert abs(np.corrcoef(np.asarray(u), np.asarray(v))[0, 1]) < 0.1


class TestImageIO:
    def test_png_roundtrip(self, tmp_path):
        from raytracingproject_tpu.utils import image_io
        img = np.random.default_rng(0).random((16, 24, 3)).astype(np.float32)
        p = tmp_path / "t.png"
        image_io.write_png(p, img)
        back = image_io.read_image(p)
        assert back.shape == (16, 24, 3)
        np.testing.assert_allclose(back, img, atol=0.02)  # 8-bit quantization

    def test_multilayer_roundtrip(self, tmp_path):
        from raytracingproject_tpu.utils import image_io
        layers = {
            "combined": np.random.default_rng(1).random((8, 8, 4)).astype(np.float32),
            "depth": np.random.default_rng(2).random((8, 8, 1)).astype(np.float32),
        }
        p = tmp_path / "t.npz"
        image_io.write_multilayer(p, layers, {"spp": 64})
        back = image_io.read_multilayer(p)
        for k in layers:
            np.testing.assert_array_equal(back[k], layers[k])
        assert image_io.read_multilayer_metadata(p)["spp"] == 64

    def test_hdr_roundtrip(self, tmp_path):
        """Radiance RGBE: the shared exponent gives each channel ~1/512
        precision relative to the pixel's MAX channel; HDR range must
        survive."""
        from raytracingproject_tpu.utils import image_io
        rng = np.random.default_rng(3)
        img = (rng.random((12, 20, 3)).astype(np.float32)
               * np.float32(10.0) ** rng.integers(-3, 4, (12, 20, 1)))
        p = tmp_path / "t.hdr"
        image_io.write_hdr(p, img)
        back = image_io.read_image(p)
        assert back.shape == (12, 20, 3)
        maxc = img.max(axis=-1, keepdims=True)
        assert (np.abs(back - img) <= maxc / 256.0 + 1e-7).all()

    def test_hdr_rle_decode(self, tmp_path):
        """New-RLE scanlines (runs + literals) decode correctly."""
        from raytracingproject_tpu.utils import image_io
        W, H = 64, 4
        img = np.ones((H, W, 3), np.float32) * 0.5
        img[:, 32:] = [2.0, 0.25, 8.0]  # constant runs per component
        rgbe = image_io._rgbe_encode(img)
        with open(tmp_path / "rle.hdr", "wb") as f:
            f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
            f.write(f"-Y {H} +X {W}\n".encode())
            for y in range(H):
                f.write(bytes([2, 2, W >> 8, W & 0xFF]))
                for c in range(4):
                    # two runs of 32 + a literal span of 0 guard
                    f.write(bytes([128 + 32, rgbe[y, 0, c]]))
                    f.write(bytes([128 + 32, rgbe[y, 32, c]]))
        back = image_io.read_hdr(tmp_path / "rle.hdr")
        np.testing.assert_allclose(back, img, rtol=0.01)

    def test_pfm_roundtrip(self, tmp_path):
        from raytracingproject_tpu.utils import image_io
        img = np.random.default_rng(4).random((9, 7, 3)).astype(np.float32)
        p = tmp_path / "t.pfm"
        image_io.write_pfm(p, img)
        np.testing.assert_array_equal(image_io.read_image(p), img)
        g = img[..., :1]
        image_io.write_pfm(tmp_path / "g.pfm", g)
        np.testing.assert_array_equal(
            image_io.read_pfm(tmp_path / "g.pfm"), g)

    def test_write_image_by_extension(self, tmp_path):
        from raytracingproject_tpu.utils import image_io
        img = np.random.default_rng(5).random((6, 6, 3)).astype(np.float32)
        for ext in ("png", "hdr", "pfm", "exr"):
            p = tmp_path / f"t.{ext}"
            image_io.write_image(p, img)
            back = image_io.read_image(p)
            tol = 0.03 if ext == "png" else 0.01
            np.testing.assert_allclose(back[..., :3], img, atol=tol,
                                       rtol=tol)


class TestCMJ:
    """Correlated multi-jitter (ref: kernel_jitter.h, Kensler 2013)."""

    def test_grid_stratification(self):
        from raytracingproject_tpu.utils import rng as R
        N = 64
        s = np.arange(N, dtype=np.uint32)
        x, y = R.cmj_2d(s, np.uint32(3), np.uint32(7), N)
        x, y = np.asarray(x), np.asarray(y)
        assert (x >= 0).all() and (x < 1).all()
        assert (y >= 0).all() and (y < 1).all()
        # one sample per m x n grid cell
        m = n = 8
        cells = set(zip((x * m).astype(int).tolist(),
                        (y * n).astype(int).tolist()))
        assert len(cells) == N
        # fy is an N-strata latin projection: one per 1/N slab
        assert len(set((y * N).astype(int).tolist())) == N

    def test_patterns_decorrelate_and_mean(self):
        from raytracingproject_tpu.utils import rng as R
        N = 256
        s = np.arange(N, dtype=np.uint32)
        xs = []
        for dp in range(8):
            x, y = R.cmj_2d(s, np.uint32(dp), np.uint32(11), N)
            xs.append(np.asarray(x))
            assert abs(np.asarray(x).mean() - 0.5) < 0.02
            assert abs(np.asarray(y).mean() - 0.5) < 0.02
        assert not np.allclose(xs[0], xs[1])

    def test_wraps_past_num_samples(self):
        from raytracingproject_tpu.utils import rng as R
        N = 16
        a = R.cmj_2d(np.arange(N, dtype=np.uint32), np.uint32(1),
                     np.uint32(2), N)
        b = R.cmj_2d(np.arange(N, 2 * N, dtype=np.uint32), np.uint32(1),
                     np.uint32(2), N)
        assert not np.allclose(np.asarray(a[0]), np.asarray(b[0]))

    def test_permute_is_bijection(self):
        from raytracingproject_tpu.utils import rng as R
        for l in (7, 16, 100, 1000):
            out = np.asarray(R.cmj_permute(
                np.arange(l, dtype=np.uint32), l, np.uint32(0xABCD)))
            assert sorted(out.tolist()) == list(range(l)), l


class TestPMJ02:
    """Progressive multi-jitter (0,2) tables (ref: render/jitter.cpp;
    built as Owen-scrambled (0,2)-sequences — every power-of-two
    prefix must be (0,2)-stratified)."""

    def test_prefixes_are_02_stratified(self):
        from raytracingproject_tpu.utils import rng as R
        tabs = R._pmj02_tables()
        for pat in (0, 5, 11):
            pts = tabs[pat]
            for k in (2, 4, 6, 8):   # prefix sizes 4..256
                npts = 1 << k
                p = pts[:npts]
                for a in range(k + 1):
                    b = k - a
                    cells = set(zip((p[:, 0] * (1 << a)).astype(int)
                                    .tolist(),
                                    (p[:, 1] * (1 << b)).astype(int)
                                    .tolist()))
                    assert len(cells) == npts, (pat, k, a, b)

    def test_sampler_wrap_rotation(self):
        from raytracingproject_tpu.utils import rng as R
        n = R.PMJ02_NUM_SAMPLES
        s0 = np.arange(8, dtype=np.uint32)
        a = R.pmj02_2d(s0, np.uint32(1), np.uint32(2))
        b = R.pmj02_2d(s0 + np.uint32(n), np.uint32(1), np.uint32(2))
        assert not np.allclose(np.asarray(a[0]), np.asarray(b[0]))
        assert (np.asarray(b[0]) >= 0).all() \
            and (np.asarray(b[0]) < 1).all()


class TestPatternFurnace:
    def test_all_patterns_unit_furnace(self):
        """Every sampling pattern must keep the furnace at 1.0 —
        unbiasedness of the pattern plumbing end-to-end."""
        import jax
        import jax.numpy as jnp
        from raytracingproject_tpu.app import examples
        from raytracingproject_tpu.ops import integrator as integ
        for pattern in ("cmj", "pmj02"):
            scene = examples.furnace_scene(16, 16, albedo=1.0,
                                           bounces=16)
            scene.integrator.set("sampling_pattern", pattern)
            scene.device_update()
            kg = scene.make_kernel_globals()
            yy, xx = np.mgrid[0:16, 0:16]
            px = jnp.asarray(xx.reshape(-1), jnp.int32)
            py = jnp.asarray(yy.reshape(-1), jnp.int32)
            L, _ = jax.jit(lambda a, b, c: integ.render_samples(
                kg, a, b, c, 0, 32))(px, py, py * 16 + px)
            img = np.asarray(L).reshape(16, 16, 3) / 32
            assert np.isfinite(img).all(), pattern
            assert abs(float(img.mean()) - 1.0) < 0.02, (
                pattern, img.mean())
