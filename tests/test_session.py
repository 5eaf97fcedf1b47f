"""Session, tiles, resumable chunks, and multi-device sharding tests
(ref: render/session.cpp control flow; multi-device ref:
device_multi.cpp semantics now provided by shard_map)."""

import numpy as np
import pytest

from raytracingproject_tpu.app import examples
from raytracingproject_tpu.session import Session, SessionParams
from raytracingproject_tpu.session.tiles import TileManager


class TestTileManager:
    def test_whole_frame(self):
        tm = TileManager(64, 48, num_samples=8, progressive_chunk=4)
        s1 = tm.next()
        assert s1.start_sample == 0 and s1.num_samples == 4
        assert len(s1.tiles) == 1
        s2 = tm.next()
        assert s2.start_sample == 4
        assert tm.next() is None

    def test_tiles_cover_frame(self):
        tm = TileManager(70, 50, tile_size=32, num_samples=1)
        cover = np.zeros((50, 70), bool)
        for t in tm.tiles:
            assert not cover[t.y:t.y + t.h, t.x:t.x + t.w].any()
            cover[t.y:t.y + t.h, t.x:t.x + t.w] = True
        assert cover.all()

    def test_center_order_first_tile_is_central(self):
        tm = TileManager(100, 100, tile_size=25, num_samples=1,
                         order="center")
        t = tm.tiles[0]
        cx = t.x + t.w / 2
        cy = t.y + t.h / 2
        assert abs(cx - 50) <= 15 and abs(cy - 50) <= 15

    def test_resumable_range(self):
        # ref: TileManager range_start_sample/range_num_samples
        tm = TileManager(8, 8, num_samples=64, range_start_sample=16,
                         range_num_samples=8, progressive_chunk=8)
        s = tm.next()
        assert s.start_sample == 16 and s.num_samples == 8
        assert tm.next() is None


class TestSession:
    def test_full_render(self, tmp_path):
        scene = examples.cornell_box(24, 24, spp=4)
        sess = Session(scene, SessionParams(samples=4,
                                            progressive_refine_chunk=2))
        sess.reset()
        updates = []
        sess.update_render_cb = lambda img, s: updates.append(s)
        rgba = sess.render()
        assert rgba.shape == (24, 24, 4)
        assert np.isfinite(rgba).all()
        assert updates == [2, 4]  # progressive chunks
        p = sess.write_output(tmp_path / "out.png")
        assert p.exists()

    def test_background_thread(self):
        scene = examples.cornell_box(16, 16, spp=2)
        sess = Session(scene, SessionParams(samples=2))
        sess.reset()
        sess.start()
        sess.wait()
        assert sess.buffers.num_samples == 2
        assert not sess.progress.error

    def test_cancel(self):
        scene = examples.cornell_box(16, 16, spp=2)
        sess = Session(scene, SessionParams(samples=2))
        sess.reset()
        sess.progress.set_cancel("stop")
        sess.start()
        sess.wait()
        assert sess.buffers is None or sess.buffers.num_samples == 0

    def test_resumable_chunks_merge(self, tmp_path):
        """Two half-range renders must merge to the full render
        (ref: resumable chunks + ImageMerger)."""
        full_scene = examples.cornell_box(16, 16, spp=8)
        full = Session(full_scene, SessionParams(samples=8))
        full.reset()
        img_full = full.render()

        parts = []
        for start in (0, 4):
            sc = examples.cornell_box(16, 16, spp=8)
            se = Session(sc, SessionParams(samples=8,
                                           range_start_sample=start,
                                           range_num_samples=4))
            se.reset()
            se.render()
            parts.append((se.buffers.buffer.copy(), se.buffers.num_samples))
        merged = (parts[0][0] + parts[1][0])
        n = parts[0][1] + parts[1][1]
        rgb = merged[..., :3] / n
        np.testing.assert_allclose(rgb, img_full[..., :3], atol=1e-5)

    def test_tiled_matches_whole_frame(self):
        scene = examples.cornell_box(20, 20, spp=2)
        s1 = Session(scene, SessionParams(samples=2))
        s1.reset()
        a = s1.render()
        scene2 = examples.cornell_box(20, 20, spp=2)
        s2 = Session(scene2, SessionParams(samples=2, tile_size=8))
        s2.reset()
        b = s2.render()
        np.testing.assert_allclose(a, b, atol=1e-5)


class TestSharding:
    def test_pixel_sharding_matches_single(self):
        import jax
        from raytracingproject_tpu.parallel.mesh import (
            make_device_mesh, render_frame_sharded)
        assert len(jax.devices()) >= 8, "conftest must fake 8 cpu devices"
        scene = examples.cornell_box(16, 16, spp=2)
        scene.device_update()
        kg = scene.make_kernel_globals()
        mesh8 = make_device_mesh(8)
        L8, A8 = render_frame_sharded(kg, 16, 16, 2, mesh=mesh8)
        mesh1 = make_device_mesh(1)
        L1, A1 = render_frame_sharded(kg, 16, 16, 2, mesh=mesh1)
        np.testing.assert_allclose(np.asarray(L8), np.asarray(L1), atol=1e-5)

    def test_sample_sharding_matches_sequential(self):
        from raytracingproject_tpu.parallel.mesh import (
            make_device_mesh, render_frame_sharded)
        scene = examples.cornell_box(12, 12, spp=8)
        scene.device_update()
        kg = scene.make_kernel_globals()
        mesh8 = make_device_mesh(8)
        Ls, _ = render_frame_sharded(kg, 12, 12, 8, mesh=mesh8,
                                     mode="sample")
        mesh1 = make_device_mesh(1)
        Lp, _ = render_frame_sharded(kg, 12, 12, 8, mesh=mesh1,
                                     mode="pixel")
        np.testing.assert_allclose(np.asarray(Ls), np.asarray(Lp),
                                   rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("mode", ["pixel", "sample"])
    def test_mesh_session_compiles_once(self, mode):
        """--device mesh: a progressive render reuses one compiled
        sharded step for every chunk (the sample start is an argument)
        and matches the single-device session."""
        scene = examples.cornell_box(12, 12, spp=16)
        ref = Session(scene, SessionParams(samples=16,
                                           progressive_refine_chunk=8))
        ref.reset()
        a = ref.render()
        # the test mesh has 8 devices: 1 sample each per chunk in
        # sample mode
        scene2 = examples.cornell_box(12, 12, spp=16)
        sess = Session(scene2, SessionParams(
            samples=16, progressive_refine_chunk=8, use_mesh=True,
            shard_mode=mode))
        sess.reset()
        b = sess.render()
        assert list(sess._render_fns) == [("mesh", 8, mode)]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)

    def test_graft_entry(self):
        import __graft_entry__ as ge
        fn, args = ge.entry()
        import jax
        L, A = jax.jit(fn)(*args)
        assert np.isfinite(np.asarray(L)).all()

    def test_graft_dryrun_multichip(self):
        import __graft_entry__ as ge
        ge.dryrun_multichip(8)


class TestBranchedSession:
    def test_branched_method_renders(self):
        scene = examples.cornell_box(16, 16, spp=8)
        scene.integrator.set("method", "branched_path")
        scene.integrator.set("diffuse_samples", 4)
        sess = Session(scene, SessionParams(samples=8,
                                            progressive_refine_chunk=8))
        sess.reset()
        img = sess.render()
        assert np.isfinite(img).all()
        assert img[..., :3].mean() > 0.02


class TestPause:
    def test_pause_blocks_then_resumes(self):
        import threading, time
        scene = examples.cornell_box(12, 12, spp=4)
        sess = Session(scene, SessionParams(samples=4,
                                            progressive_refine_chunk=2))
        sess.reset()
        first_chunk = threading.Event()
        sess.update_render_cb = lambda img, s: first_chunk.set()
        sess.set_pause(False)
        sess.start()
        assert first_chunk.wait(timeout=120)
        sess.set_pause(True)
        # give the loop a moment to reach the pause gate
        deadline = time.monotonic() + 30
        while (sess.progress.status != "Paused"
               and time.monotonic() < deadline
               and sess.buffers.num_samples < 4):
            time.sleep(0.02)
        paused_at = sess.buffers.num_samples
        time.sleep(0.3)
        assert sess.buffers.num_samples == paused_at  # no progress paused
        sess.set_pause(False)
        sess.wait()
        assert sess.buffers.num_samples == 4
        assert not sess.progress.error


class TestPreview:
    def test_preview_refines_to_full_res(self):
        scene = examples.cornell_box(24, 24, spp=4)
        sess = Session(scene, SessionParams(samples=4))
        frames = list(sess.render_preview(dividers=(4, 1)))
        assert len(frames) == 2
        # every level is presented at full display size
        assert frames[0].shape == (24, 24, 4)
        assert frames[1].shape == (24, 24, 4)
        assert np.isfinite(frames[0]).all()
        # coarse level is blocky: fewer unique rows than the final
        u0 = len(np.unique(frames[0][..., 0].round(4), axis=0))
        u1 = len(np.unique(frames[1][..., 0].round(4), axis=0))
        assert u0 < u1
        # camera restored
        assert int(scene.camera.width) == 24
        assert sess.params.samples == 4


class TestShaderProfiling:
    def test_profile_shaders_names_costs(self):
        """Per-shader device-time attribution (ref: util_profiling.h
        per-shader histograms): every scene shader gets a measured
        wavefront-eval time and the report names them."""
        from raytracingproject_tpu.app import examples
        from raytracingproject_tpu.session.session import Session
        scene = examples.cornell_box(16, 16, spp=2)
        s = Session(scene)
        times = s.profile_shaders(lanes=2048, repeats=1)
        assert len(times) == len(scene.shaders)
        assert all(t >= 0.0 for t in times.values())
        rep = s.stats.full_report()
        assert "Device shader cost" in rep
        top = max(times, key=times.get)
        assert top in rep


class TestFailureRecovery:
    """A device fault fails the render at once, with the device's own
    error: no chunk is retried, so an out-of-memory or a kernel fault
    never re-runs the compile behind it (the reference cancels through
    Progress the same way, session.cpp:250-263)."""

    def _session(self):
        from raytracingproject_tpu.app import examples
        scene = examples.cornell_box(12, 12, spp=4)
        return Session(scene, SessionParams(samples=4))

    def test_persistent_fault_propagates(self):
        import pytest

        class FakeXlaRuntimeError(Exception):
            pass
        FakeXlaRuntimeError.__name__ = "XlaRuntimeError"

        sess = self._session()
        sess.reset()

        def dead(*a, **kw):
            raise FakeXlaRuntimeError("INTERNAL: CUDA error")

        sess._render_pixel_list = dead
        with pytest.raises(Exception, match="INTERNAL"):
            sess.render()

    def test_programming_error_not_retried(self):
        import pytest
        sess = self._session()
        sess.reset()
        calls = {"n": 0}

        def buggy(*a, **kw):
            calls["n"] += 1
            raise ValueError("plain bug")

        sess._render_pixel_list = buggy
        with pytest.raises(ValueError):
            sess.render()
        assert calls["n"] == 1  # never retried
