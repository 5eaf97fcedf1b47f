"""OpenEXR codec tests (utils/exr.py — independent implementation of
the public OpenEXR 2.0 scanline format; capability ref: the
reference's OIIO/OpenEXR multilayer writers, render/image_oiio.cpp)."""

import struct

import numpy as np

from raytracingproject_tpu.utils import exr


class TestRoundTrip:
    def test_float_roundtrip_bitexact(self, tmp_path):
        rng = np.random.default_rng(0)
        chans = {"Combined.R": rng.standard_normal((7, 13)),
                 "Combined.G": rng.standard_normal((7, 13)) * 1e6,
                 "Combined.B": np.zeros((7, 13)),
                 "depth.Z": rng.random((7, 13)) * 1e4}
        chans = {k: v.astype(np.float32) for k, v in chans.items()}
        p = tmp_path / "t.exr"
        exr.write_exr(p, chans)
        back = exr.read_exr(p)
        assert sorted(back) == sorted(chans)
        for k in chans:
            np.testing.assert_array_equal(back[k], chans[k])

    def test_half_roundtrip(self, tmp_path):
        a = np.linspace(0, 4, 64, dtype=np.float32).reshape(8, 8)
        p = tmp_path / "h.exr"
        exr.write_exr(p, {"R": a}, half=True)
        back = exr.read_exr(p)["R"]
        np.testing.assert_allclose(back, a, rtol=1e-3)

    def test_multilayer_grouping(self, tmp_path):
        layers = {"Combined": np.random.rand(5, 6, 4).astype(np.float32),
                  "mist": np.random.rand(5, 6).astype(np.float32),
                  "normal": np.random.rand(5, 6, 3).astype(np.float32)}
        p = tmp_path / "ml.exr"
        exr.write_multilayer_exr(p, layers)
        back = exr.read_multilayer_exr(p)
        np.testing.assert_array_equal(back["Combined"],
                                      layers["Combined"])
        np.testing.assert_array_equal(back["mist"][..., 0],
                                      layers["mist"])
        np.testing.assert_array_equal(back["normal"], layers["normal"])


class TestFormatCompliance:
    """Byte-level checks against the OpenEXR spec so third-party
    readers accept the files."""

    def test_magic_version_and_attrs(self, tmp_path):
        p = tmp_path / "c.exr"
        exr.write_exr(p, {"R": np.zeros((3, 4), np.float32)})
        buf = open(p, "rb").read()
        assert buf[:4] == b"\x76\x2f\x31\x01"
        assert struct.unpack_from("<I", buf, 4)[0] == 2
        for required in (b"channels", b"compression", b"dataWindow",
                         b"displayWindow", b"lineOrder",
                         b"pixelAspectRatio", b"screenWindowCenter",
                         b"screenWindowWidth"):
            assert required + b"\0" in buf

    def test_offset_table_points_at_scanlines(self, tmp_path):
        h, w = 5, 3
        p = tmp_path / "o.exr"
        exr.write_exr(p, {"R": np.arange(15, dtype=np.float32)
                          .reshape(h, w)})
        buf = open(p, "rb").read()
        # locate offset table: header ends at double-NUL before it;
        # read the y field each offset points to — must be 0..h-1
        chans = exr.read_exr(p)  # reader validates offsets implicitly
        assert chans["R"].shape == (h, w)

    def test_third_party_reader_if_available(self, tmp_path):
        try:
            import OpenEXR  # noqa: F401
        except ImportError:
            import pytest
            pytest.skip("OpenEXR module not installed")
        p = tmp_path / "x.exr"
        a = np.random.rand(4, 4).astype(np.float32)
        exr.write_exr(p, {"R": a})
        import Imath
        f = OpenEXR.InputFile(str(p))
        raw = f.channel("R", Imath.PixelType(Imath.PixelType.FLOAT))
        np.testing.assert_array_equal(
            np.frombuffer(raw, np.float32).reshape(4, 4), a)


class TestSessionOutput:
    def test_session_writes_exr_with_passes(self, tmp_path):
        from raytracingproject_tpu.app import examples
        from raytracingproject_tpu.session import Session, SessionParams
        from raytracingproject_tpu.models import film as fm
        scene = examples.cornell_box(16, 16, spp=2)
        scene.film.set_passes(["combined", "depth", "normal"])
        sess = Session(scene, SessionParams(samples=2))
        sess.reset()
        sess.render()
        p = tmp_path / "out.exr"
        sess.write_output(str(p))
        layers = exr.read_multilayer_exr(p)
        assert "Combined" in layers
        assert layers["Combined"].shape == (16, 16, 4)
        assert "depth" in layers and "normal" in layers
        assert np.isfinite(layers["Combined"]).all()


class TestNativeCodec:
    """ZIP/ZIPS compression (stdlib zlib with the spec's byte-plane and
    delta transform): bit-exact round trips, real compression, and
    every compression mode read back by the same reader."""

    def _chans(self, seed=0, h=33, w=21, n=3):
        rng = np.random.default_rng(seed)
        return {f"L.{s}": rng.standard_normal((h, w)).astype(np.float32)
                for s in "RGBA"[:n]}

    def test_native_available(self):
        # the native library now holds only the BVH builder
        from raytracingproject_tpu import native as nat
        assert nat.get_lib() is not None

    def test_zip_roundtrip_bitexact(self, tmp_path):
        ch = self._chans()
        for comp in ("none", "zips", "zip"):
            p = tmp_path / f"c{comp}.exr"
            exr.write_exr(p, ch, compression=comp)
            out = exr.read_exr(p)
            for k in ch:
                np.testing.assert_array_equal(out[k], ch[k])

    def test_zip_actually_compresses(self, tmp_path):
        import os
        img = np.full((64, 64), 0.25, np.float32)
        p0, p1 = tmp_path / "n.exr", tmp_path / "z.exr"
        exr.write_exr(p0, {"A": img}, compression="none")
        exr.write_exr(p1, {"A": img}, compression="zip")
        assert os.path.getsize(p1) < os.path.getsize(p0) / 10
        out = exr.read_exr(p1)
        np.testing.assert_array_equal(out["A"], img)

    def test_python_writer_native_reader(self, tmp_path):
        # the header's compression byte names what the chunks hold
        ch = self._chans(1)
        for comp, code in (("none", 0), ("zips", 2), ("zip", 3)):
            p = tmp_path / f"p{comp}.exr"
            exr.write_exr(p, ch, compression=comp)
            blob = open(p, "rb").read()
            at = blob.index(b"compression\0compression\0")
            assert blob[at + 28] == code
            out = exr.read_exr(p)
            for k in ch:
                np.testing.assert_array_equal(out[k], ch[k])

    def test_native_writer_python_reader(self, tmp_path):
        # incompressible noise is stored raw inside a ZIP chunk
        rng = np.random.default_rng(2)
        ch = {"R": rng.integers(0, 2**32, (17, 9), dtype=np.uint32)
              .view(np.float32)}
        ch["R"] = np.where(np.isfinite(ch["R"]), ch["R"], 0.0)
        p = tmp_path / "n.exr"
        exr.write_exr(p, ch, compression="zips")
        out = exr.read_exr(p)
        np.testing.assert_array_equal(out["R"], ch["R"])

    def test_half_zip(self, tmp_path):
        ch = self._chans(3)
        p = tmp_path / "h.exr"
        exr.write_exr(p, ch, half=True, compression="zip")
        out = exr.read_exr(p)
        for k in ch:
            np.testing.assert_allclose(
                out[k], ch[k].astype(np.float16).astype(np.float32),
                rtol=0)

    def test_half_specials(self, tmp_path):
        # inf/nan/subnormal survive the half conversion
        vals = np.array([[0.0, -0.0, np.inf, -np.inf],
                         [np.nan, 1e-7, 65504.0, -65504.0]], np.float32)
        p = tmp_path / "s.exr"
        exr.write_exr(p, {"A": vals}, half=True, compression="zip")
        out = exr.read_exr(p)["A"]
        ref = vals.astype(np.float16).astype(np.float32)
        np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
        m = ~np.isnan(ref)
        np.testing.assert_array_equal(out[m], ref[m])

    def test_multilayer_through_native(self, tmp_path):
        # multilayer files go through the default (ZIP) writer
        rng = np.random.default_rng(5)
        layers = {"Combined": rng.random((9, 7, 4)).astype(np.float32),
                  "Depth": rng.random((9, 7)).astype(np.float32)}
        p = tmp_path / "m.exr"
        exr.write_multilayer_exr(p, layers)
        out = exr.read_multilayer_exr(p)
        np.testing.assert_array_equal(out["Combined"],
                                      layers["Combined"])
        np.testing.assert_array_equal(out["Depth"][..., 0],
                                      layers["Depth"])


class TestNativeRobustness:
    def test_truncated_file_fails_cleanly(self, tmp_path):
        p = tmp_path / "t.exr"
        a = np.random.rand(8, 8).astype(np.float32)
        exr.write_exr(p, {"R": a})
        blob = open(p, "rb").read()
        for cut in (5, 9, 40, len(blob) // 2, len(blob) - 3):
            q = tmp_path / f"cut{cut}.exr"
            open(q, "wb").write(blob[:cut])
            import pytest
            with pytest.raises(Exception):
                exr.read_exr(q)

    def test_multipart_flag_falls_back_cleanly(self, tmp_path):
        import struct as st
        import pytest
        p = tmp_path / "m.exr"
        a = np.random.rand(4, 4).astype(np.float32)
        exr.write_exr(p, {"R": a}, compression="none")
        blob = bytearray(open(p, "rb").read())
        ver = st.unpack_from("<I", blob, 4)[0]
        st.pack_into("<I", blob, 4, ver | 0x1000)  # multi-part flag
        open(p, "wb").write(blob)
        # outside the supported subset: a clean NotImplementedError,
        # never garbage pixels
        with pytest.raises(NotImplementedError):
            exr.read_exr(p)
