"""Render session (ref: render/session.cpp Session).

Drives the render: scene sync -> sample-chunk loop -> buffer write-back,
with progress/cancel, resumable sample ranges (ref: resumable chunks,
blender_python.cpp:871-947), optional multi-device mesh, and progressive
callbacks for viewport-style consumers. The control loop runs
synchronously or in a background thread (`start()`/`wait()`), mirroring
Session::start (session.cpp:138).
"""

from __future__ import annotations

import threading

import numpy as np

from raytracingproject_tpu.models import film as film_mod
from raytracingproject_tpu.session.buffers import BufferParams, RenderBuffers
from raytracingproject_tpu.session.tiles import TileManager
from raytracingproject_tpu.utils.progress import Progress, CancelledError
from raytracingproject_tpu.utils import log


class SessionParams:
    """ref: render/session.h:44 SessionParams."""

    def __init__(self, samples=128, tile_size=0, progressive=True,
                 progressive_refine_chunk=16, use_mesh=False,
                 shard_mode="pixel", time_limit=0.0,
                 range_start_sample=-1, range_num_samples=-1,
                 background=True, denoise_offload=True):
        self.samples = samples
        self.tile_size = tile_size
        self.progressive = progressive
        self.progressive_refine_chunk = progressive_refine_chunk
        self.use_mesh = use_mesh          # shard over all local devices
        self.shard_mode = shard_mode
        self.time_limit = time_limit
        self.range_start_sample = range_start_sample
        self.range_num_samples = range_num_samples
        self.background = background
        # heterogeneous offload: pin denoise to the last local device
        # when more than one exists (parallelism strategy 7)
        self.denoise_offload = denoise_offload

    def modified(self, other):
        return vars(self) != vars(other)


class Session:
    def __init__(self, scene, params=None):
        self.scene = scene
        self.params = params or SessionParams()
        self.progress = Progress()
        self._crypto = None
        self._denoised = None
        self.buffers = None
        self.tile_manager = None
        self.write_render_cb = None      # cb(rgba (H,W,4), sample)
        self.update_render_cb = None
        self._thread = None
        self._kg = None
        self._render_fns = {}
        from raytracingproject_tpu.utils.stats import RenderStats
        self.stats = RenderStats()

    # ------------------------------------------------------------------
    def reset(self, width=None, height=None, samples=None):
        cam = self.scene.camera
        if width:
            cam.set("width", width)
        if height:
            cam.set("height", height)
        if samples is not None:
            self.params.samples = samples
        w, h = int(cam.width), int(cam.height)
        bp = BufferParams(w, h, passes=self.scene.film.passes)
        self.buffers = RenderBuffers(bp)
        crypto_depth = int(self.scene.film.cryptomatte_depth)
        chunk = self.params.progressive_refine_chunk
        if crypto_depth > 0:
            # cryptomatte needs per-sample id planes: 1-sample chunks
            # (ref: kernel_write_id_slots — redesigned host-side, see
            # session/crypto.py)
            chunk = 1
        self.tile_manager = TileManager(
            w, h, tile_size=self.params.tile_size,
            progressive=self.params.progressive,
            num_samples=self.params.samples,
            range_start_sample=self.params.range_start_sample,
            range_num_samples=self.params.range_num_samples,
            progressive_chunk=chunk)
        if crypto_depth > 0:
            from raytracingproject_tpu.session.crypto import \
                CryptoAccumulator
            self._crypto = {
                "object": CryptoAccumulator(h, w, crypto_depth),
                "material": CryptoAccumulator(h, w, crypto_depth)}
        else:
            self._crypto = None
        self.progress.reset()
        self.progress.total_pixel_samples = w * h * (
            self.tile_manager.end_sample - self.tile_manager.start_sample)
        self.progress.time_limit = self.params.time_limit

    # ------------------------------------------------------------------
    def start(self):
        """Spawn the render thread (ref: session.cpp:138-143)."""
        self._thread = threading.Thread(target=self._run_safe, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def set_pause(self, pause=True):
        """Pause/resume the render between progressive chunks
        (ref: session.cpp set_pause + pause_cond wait loop)."""
        self.progress.set_pause(pause)

    def render(self):
        """Synchronous full render; returns display RGBA (H, W, 4)."""
        self._run()
        return self.buffers.get_display_rgba(
            exposure=float(self.scene.film.exposure))

    def render_range(self, start, count):
        """Render a different sample range of the SAME scene without
        re-syncing or re-jitting — the dynamic chunk queue's hot loop
        (parallel/multihost.py DynamicMultiHostSession): the scene sync
        and kernel compile are paid once, then every chunk is pure
        device time (ref: the reference's tile server re-renders ranges
        against one persistent device, device_network.cpp)."""
        self.params.range_start_sample = int(start)
        self.params.range_num_samples = int(count)
        self.reset()
        self._run(update_scene=self._kg is None)
        return self.buffers.get_display_rgba(
            exposure=float(self.scene.film.exposure))

    def _run_safe(self):
        try:
            self._run()
        except CancelledError:
            pass
        except Exception as e:  # ref: Progress error propagation
            log.log_error("render error: %s", e)
            self.progress.set_error(str(e))
            raise

    # ------------------------------------------------------------------
    def _update_scene(self):
        """ref: Session::update_scene -> Scene::device_update."""
        import time as _time
        self.progress.set_status("Updating Scene")
        t0 = _time.monotonic()
        with self.stats.profiler.scope("scene_update"):
            self.scene.device_update(self.progress)
        with self.stats.profiler.scope("device_upload"):
            self._kg = self.scene.make_kernel_globals()
        self.stats.sync_time = _time.monotonic() - t0
        self.stats.collect_scene_memory(self.scene.dscene["arrays"])
        # request aux passes when the film wants data passes
        from raytracingproject_tpu.models import film as fm
        aux_wanted = {fm.PASS_NORMAL, fm.PASS_DEPTH, fm.PASS_OBJECT_ID,
                      fm.PASS_MATERIAL_ID, fm.PASS_EMISSION,
                      fm.PASS_BACKGROUND, fm.PASS_DENOISING_NORMAL,
                      fm.PASS_DENOISING_ALBEDO, fm.PASS_AO,
                      fm.PASS_MIST}
        aov_pass_names = [p.name for p in self.scene.film.passes
                          if p.type in (fm.PASS_AOV_COLOR,
                                        fm.PASS_AOV_VALUE)]
        if any(p.type in aux_wanted for p in self.scene.film.passes)                 or aov_pass_names                 or int(self.scene.film.cryptomatte_depth) > 0:
            aux = ["normal", "albedo", "depth", "object_id",
                   "material_id", "emission", "background"]
            if any(p.type == fm.PASS_AO for p in self.scene.film.passes):
                aux.append("ao")
            if any(p.type == fm.PASS_MIST for p in self.scene.film.passes):
                aux.append("mist")
                film = self.scene.film
                self._kg["mist"] = (
                    float(film.mist_start),
                    1.0 / max(float(film.mist_depth), 1e-12),
                    float(film.mist_falloff))
            aux += ["aov:" + nm for nm in aov_pass_names]
            self._kg["aux_passes"] = tuple(aux)
        light_pass_types = {
            fm.PASS_DIFFUSE_DIRECT, fm.PASS_DIFFUSE_INDIRECT,
            fm.PASS_DIFFUSE_COLOR, fm.PASS_GLOSSY_DIRECT,
            fm.PASS_GLOSSY_INDIRECT, fm.PASS_GLOSSY_COLOR,
            fm.PASS_TRANSMISSION_DIRECT, fm.PASS_TRANSMISSION_INDIRECT,
            fm.PASS_TRANSMISSION_COLOR, fm.PASS_VOLUME_DIRECT,
            fm.PASS_VOLUME_INDIRECT}
        if any(p.type in light_pass_types for p in self.scene.film.passes):
            self._kg["light_passes"] = True
        self._render_fns = {}
        self.progress.set_render_start_time()

    _AUX_TO_PASS = {
        "normal": "normal", "depth": "depth", "object_id": "object_id",
        "material_id": "material_id", "emission": "emission",
        "background": "background",
        "ao": "ao",
        "mist": "mist",
        "diffuse_direct": "diffuse_direct",
        "diffuse_indirect": "diffuse_indirect",
        "diffuse_color": "diffuse_color",
        "glossy_direct": "glossy_direct",
        "glossy_indirect": "glossy_indirect",
        "glossy_color": "glossy_color",
        "transmission_direct": "transmission_direct",
        "transmission_indirect": "transmission_indirect",
        "transmission_color": "transmission_color",
        "volume_direct": "volume_direct",
        "volume_indirect": "volume_indirect",
    }

    def _store_aux(self, aux_np, ys, xs):
        """Scatter aux pass sums into the pass buffer."""
        from raytracingproject_tpu.models import film as fm
        bp = self.buffers.params
        for name, ptype in self._AUX_TO_PASS.items():
            off = bp.pass_offset(ptype)
            if off < 0 or name not in aux_np:
                continue
            data = aux_np[name]
            if data.ndim == 1:
                data = data[:, None]
            c = min(data.shape[-1], fm.PASS_CHANNELS[ptype])
            self.buffers.buffer[ys, xs, off:off + c] += data[:, :c]
        for name, ptype in (("normal", fm.PASS_DENOISING_NORMAL),
                            ("albedo", fm.PASS_DENOISING_ALBEDO)):
            off = bp.pass_offset(ptype)
            if off >= 0 and name in aux_np:
                self.buffers.buffer[ys, xs, off:off + 3] += aux_np[name]
        # custom AOV passes, matched by pass *name* (ref: svm_aov.h)
        for name in aux_np:
            if not name.startswith("aov:"):
                continue
            off, ch = bp.pass_offset_name(name[4:])
            if off < 0:
                continue
            data = aux_np[name]
            self.buffers.buffer[ys, xs, off:off + ch] += data[:, :ch]

    def _get_render_fn(self, num_samples, args):
        """The compiled render function for this chunk size and lane
        count. Compiled ahead of time so the compile time and the
        compiler's memory analysis land in self.stats."""
        import time as _time
        import jax
        from raytracingproject_tpu.ops import integrator as integ
        key = (num_samples, args[0].shape[0])
        if key not in self._render_fns:
            kg = self._kg
            branched = int(kg["kint"]["method"]) == 1
            if branched:
                branch = max(int(self.scene.integrator.diffuse_samples),
                             int(self.scene.integrator.glossy_samples),
                             int(self.scene.integrator.mesh_light_samples))
                branch = max(min(branch, num_samples), 1)

                def fn(px, py, pidx, start):
                    num_aa = max(num_samples // branch, 1)
                    return integ.render_samples_branched(
                        kg, px, py, pidx, start, num_aa, branch)
            else:
                # path regeneration keeps lanes occupied; aux/light
                # passes merge per sample inside the regen loop too
                def fn(px, py, pidx, start):
                    return integ.render_samples_regen(
                        kg, px, py, pidx, start, num_samples)
            t0 = _time.monotonic()
            compiled = jax.jit(fn).lower(*args).compile()
            self.stats.compile_time += _time.monotonic() - t0
            self.stats.compiled_memory = compiled.memory_analysis()
            self._render_fns[key] = compiled
        return self._render_fns[key]

    def _render_pixel_list(self, xs, ys, start_sample, num_samples):
        """Render an arbitrary pixel list (padded to a lane multiple);
        returns (L (n,3), A (n,), aux dict) as numpy, unpadded."""
        import jax.numpy as jnp
        n = len(xs)
        pad = (-n) % 1024 if n > 1024 else (-n) % 128
        xs_p = np.pad(xs, (0, pad))
        ys_p = np.pad(ys, (0, pad))
        px = jnp.asarray(xs_p, jnp.int32)
        py = jnp.asarray(ys_p, jnp.int32)
        pidx = py * self.buffers.params.full_width + px
        args = (px, py, pidx, jnp.uint32(start_sample))
        out = self._get_render_fn(num_samples, args)(*args)
        if len(out) == 3:
            L, A, aux = out
            aux = {k: np.asarray(v)[:n] for k, v in aux.items()}
        else:
            L, A = out
            aux = {}
        return np.asarray(L)[:n], np.asarray(A)[:n], aux

    # --- adaptive sampling (ref: kernel_adaptive_sampling.h redesigned
    # as host-side pixel-list compaction between sample chunks) ---
    def _adaptive_error(self, ys, xs):
        """Per-pixel error estimate from the all-sample and half-sample
        accumulators (ref: kernel_adaptive_sampling.h error metric)."""
        n = max(self.buffers.num_samples, 1)
        A = self.buffers.buffer[ys, xs, 0:3]
        E = self._even_accum[ys, xs]
        mean = A / n
        err = np.abs(A - 2.0 * E).sum(-1) / (
            n * np.sqrt(np.maximum(mean.sum(-1), 1e-4)))
        return err

    def _run(self, update_scene=True):
        import jax.numpy as jnp
        if self.buffers is None:
            self.reset()
        if update_scene or self._kg is None:
            self._update_scene()

        # zero buffers only at range start (ref: session.cpp:1055-1058)
        if self.tile_manager.sample == self.tile_manager.start_sample:
            self.buffers.zero()

        use_mesh = self.params.use_mesh
        if use_mesh:
            from raytracingproject_tpu.parallel.mesh import (
                make_device_mesh, render_frame_sharded, sharded_render_fn)
            mesh = make_device_mesh()

        # adaptive sampling state
        adaptive = (float(self.scene.integrator.adaptive_threshold) > 0.0
                    or bool(self.scene.film.use_adaptive_sampling)) \
            and not use_mesh
        if adaptive:
            bp = self.buffers.params
            self._even_accum = np.zeros((bp.height, bp.width, 3), np.float32)
            self._sample_count = np.zeros((bp.height, bp.width), np.int32)
            threshold = float(self.scene.integrator.adaptive_threshold) or 0.01
            min_samples = int(self.scene.integrator.adaptive_min_samples) \
                or max(self.params.samples // 8, 8)
            active = None  # (ys, xs) or None = all

        chunk_parity = 0
        while True:
            self.progress.check_cancel()
            self.progress.wait_if_paused()
            ts = self.tile_manager.next()
            if ts is None:
                break
            self.progress.set_status(
                "Rendering", f"sample {ts.start_sample + ts.num_samples}"
                f"/{self.tile_manager.end_sample}")
            for tile in ts.tiles:
                self.progress.check_cancel()
                if use_mesh:
                    key = ("mesh", ts.num_samples, self.params.shard_mode)
                    if key not in self._render_fns:
                        self._render_fns[key] = sharded_render_fn(
                            self._kg, ts.num_samples, mesh,
                            self.params.shard_mode)
                    L, A = render_frame_sharded(
                        self._kg, tile.w, tile.h, ts.num_samples, mesh=mesh,
                        sample_start=ts.start_sample,
                        mode=self.params.shard_mode,
                        full_width=self.buffers.params.full_width,
                        fn=self._render_fns[key])
                    self.buffers.buffer[tile.y:tile.y + tile.h,
                                        tile.x:tile.x + tile.w, 0:3] \
                        += np.asarray(L)
                    self.buffers.buffer[tile.y:tile.y + tile.h,
                                        tile.x:tile.x + tile.w, 3] \
                        += np.asarray(A)
                    self.progress.add_samples(
                        tile.w * tile.h * ts.num_samples,
                        ts.start_sample + ts.num_samples)
                    continue
                yy, xx = np.mgrid[tile.y:tile.y + tile.h,
                                  tile.x:tile.x + tile.w]
                ys = yy.reshape(-1)
                xs = xx.reshape(-1)
                if adaptive and active is not None:
                    in_tile = ((active[0] >= tile.y)
                               & (active[0] < tile.y + tile.h)
                               & (active[1] >= tile.x)
                               & (active[1] < tile.x + tile.w))
                    ys, xs = active[0][in_tile], active[1][in_tile]
                    if len(ys) == 0:
                        continue
                L, A, aux = self._render_pixel_list(
                    xs, ys, ts.start_sample, ts.num_samples)
                self.buffers.buffer[ys, xs, 0:3] += L
                self.buffers.buffer[ys, xs, 3] += A
                if aux:
                    self._store_aux(aux, ys, xs)
                    if self._crypto is not None and ts.num_samples == 1:
                        self._crypto["object"].add_plane(
                            aux["object_id"], ys, xs)
                        self._crypto["material"].add_plane(
                            aux["material_id"], ys, xs)
                if adaptive:
                    if chunk_parity % 2 == 0:
                        self._even_accum[ys, xs] += L
                    self._sample_count[ys, xs] += ts.num_samples
                self.progress.add_samples(len(ys) * ts.num_samples,
                                          ts.start_sample + ts.num_samples)
            self.buffers.num_samples = ts.start_sample + ts.num_samples \
                - self.tile_manager.start_sample
            chunk_parity += 1
            if adaptive and self.buffers.num_samples >= min_samples:
                bp = self.buffers.params
                yy, xx = np.mgrid[0:bp.height, 0:bp.width]
                err = self._adaptive_error(yy.reshape(-1), xx.reshape(-1))
                unconverged = err >= threshold
                active = (yy.reshape(-1)[unconverged],
                          xx.reshape(-1)[unconverged])
                log.vlog(1, "adaptive: %d/%d pixels active",
                         len(active[0]), bp.width * bp.height)
                if len(active[0]) == 0:
                    break
            if self.update_render_cb is not None:
                self.update_render_cb(
                    self.buffers.get_display_rgba(
                        float(self.scene.film.exposure)),
                    self.buffers.num_samples)

        if adaptive:
            self.buffers.per_pixel_samples = self._sample_count
            from raytracingproject_tpu.models import film as fm
            off = self.buffers.params.pass_offset(fm.PASS_SAMPLE_COUNT)
            if off >= 0:
                self.buffers.buffer[..., off] = self._sample_count
        total, rt = self.progress.get_time()
        self.stats.render_time = rt
        self.stats.samples_rendered = self.progress.pixel_samples
        self.stats.collect_device_memory()
        log.vlog(1, "render done: %.2fs total, %.2fs render", total, rt)
        if self.write_render_cb is not None:
            self.write_render_cb(
                self.buffers.get_display_rgba(float(self.scene.film.exposure)),
                self.buffers.num_samples)

    # ------------------------------------------------------------------
    def render_preview(self, dividers=(8, 4, 2, 1), samples_per_level=None):
        """Viewport-style progressive preview (ref: session.cpp draw /
        update loop with BufferParams resolution dividers): render the
        frame at descending resolution dividers, yielding an upscaled
        (H, W, 4) display image after each level. The final level runs
        at full resolution with the session's sample count.

        Generator — iterate to drive the refinement loop:
            for img in session.render_preview(): show(img)
        """
        import numpy as np
        cam = self.scene.camera
        full_w, full_h = int(cam.width), int(cam.height)
        full_samples = self.params.samples
        try:
            for div in dividers:
                self.progress.check_cancel()
                w = max(full_w // div, 8)
                h = max(full_h // div, 8)
                spp = samples_per_level or max(full_samples // div, 1)
                if div == 1:
                    w, h, spp = full_w, full_h, full_samples
                cam.set("width", w)
                cam.set("height", h)
                self.params.samples = spp
                self.reset()
                rgba = self.render()
                if div != 1:
                    rgba = np.repeat(np.repeat(rgba, full_h // h, axis=0),
                                     full_w // w, axis=1)
                    rgba = rgba[:full_h, :full_w]
                    pad_h = full_h - rgba.shape[0]
                    pad_w = full_w - rgba.shape[1]
                    if pad_h or pad_w:
                        rgba = np.pad(rgba, ((0, pad_h), (0, pad_w),
                                             (0, 0)), mode="edge")
                yield rgba
        finally:
            cam.set("width", full_w)
            cam.set("height", full_h)
            self.params.samples = full_samples

    def get_cryptomatte(self, kind="object"):
        """(H, W, depth*2) interleaved [name-hash, coverage] planes,
        ranked by coverage (ref: cryptomatte spec / film.cpp
        cryptomatte passes). kind: "object" | "material"."""
        if self._crypto is None:
            return None
        from raytracingproject_tpu.session.crypto import name_hash
        if kind == "object":
            lut = {float(i): name_hash(o.name)
                   for i, o in enumerate(self.scene.objects)}
        else:
            lut = {float(i): name_hash(sh.name)
                   for i, sh in enumerate(self.scene.shaders)}
        lut[-1.0] = 0.0  # background
        return self._crypto[kind].ranked(
            max(self.buffers.num_samples, 1), lut)

    def denoise(self):
        """Denoise the combined pass using the denoising-feature passes
        (ref: Session denoise scheduling + DenoisingTask). Returns the
        denoised display RGBA and stores it for write_output."""
        from raytracingproject_tpu.models import film as fm
        from raytracingproject_tpu.ops import denoise as dn
        rgba = self.buffers.get_display_rgba(float(self.scene.film.exposure))
        albedo = self.buffers.get_pass_rect(fm.PASS_DENOISING_ALBEDO)
        normal = self.buffers.get_pass_rect(fm.PASS_DENOISING_NORMAL)
        depth = self.buffers.get_pass_rect(fm.PASS_DEPTH)
        self._denoised = dn.denoise_buffers(
            rgba, albedo=albedo, normal=normal,
            depth=None if depth is None else depth[..., 0],
            device=self._denoise_device())
        return self._denoised

    def _denoise_device(self):
        """Heterogeneous offload device for the denoise filter (pinned
        off the render chip when more than one device is local)."""
        from raytracingproject_tpu.ops import denoise as dn
        if not getattr(self.params, "denoise_offload", True):
            return None
        return dn.pick_denoise_device()

    def denoise_tile(self, x, y, w, h, overscan=8):
        """Per-tile denoise state (ref: Session tile denoising with
        RenderBuffers neighbor copy): denoise only a tile rect, reading
        an overscanned neighborhood so patches at tile borders see
        their full search window, then write back the inner rect.
        Marks the tile finished+denoised on the progress tracker."""
        import numpy as np
        from raytracingproject_tpu.models import film as fm
        from raytracingproject_tpu.ops import denoise as dn
        H, W = self.buffers.params.height, self.buffers.params.width
        x0, y0 = max(x - overscan, 0), max(y - overscan, 0)
        x1, y1 = min(x + w + overscan, W), min(y + h + overscan, H)
        rgba = self.buffers.get_display_rgba(
            float(self.scene.film.exposure))[y0:y1, x0:x1]
        albedo = self.buffers.get_pass_rect(fm.PASS_DENOISING_ALBEDO)
        normal = self.buffers.get_pass_rect(fm.PASS_DENOISING_NORMAL)
        depth = self.buffers.get_pass_rect(fm.PASS_DEPTH)
        out = dn.denoise_buffers(
            rgba,
            albedo=None if albedo is None else albedo[y0:y1, x0:x1],
            normal=None if normal is None else normal[y0:y1, x0:x1],
            depth=None if depth is None else depth[y0:y1, x0:x1, 0],
            device=self._denoise_device())
        if self._denoised is None:
            self._denoised = np.asarray(self.buffers.get_display_rgba(
                float(self.scene.film.exposure))).copy()
        self._denoised[y:y + h, x:x + w] = out[
            y - y0:y - y0 + h, x - x0:x - x0 + w]
        self.progress.add_finished_tile(denoised=True)
        return self._denoised[y:y + h, x:x + w]

    # ------------------------------------------------------------------
    def write_output(self, path, srgb=True):
        """Write the display image; multilayer passes go through
        utils/image_io.write_multilayer (resumable chunks use this,
        merged later by session/merge.py)."""
        from raytracingproject_tpu.utils import image_io
        rgba = self.buffers.get_display_rgba(float(self.scene.film.exposure))
        # raster y=0 is the bottom row; image files are top-down
        img = rgba[::-1]
        if str(path).endswith(".exr"):
            # real multilayer OpenEXR (utils/exr.py): Combined plus
            # every configured pass under its name (ref: the
            # reference's OIIO/OpenEXR multilayer output)
            from raytracingproject_tpu.utils import exr as exr_mod
            layers = {"Combined": np.asarray(img)}
            exposure = float(self.scene.film.exposure)
            for p in self.buffers.params.passes:
                if p.type == "combined":
                    continue
                layers[p.type] = np.asarray(
                    self.buffers.get_pass_rect(p.type, exposure))[::-1]
            exr_mod.write_multilayer_exr(path, layers)
        elif str(path).endswith((".npz", ".mlx")):
            layers = {"combined": self.buffers.buffer[::-1]}
            if self._crypto is not None:
                layers["crypto_object"] = self.get_cryptomatte(
                    "object")[::-1]
                layers["crypto_material"] = self.get_cryptomatte(
                    "material")[::-1]
            image_io.write_multilayer(path, layers, {
                "num_samples": self.buffers.num_samples,
                "pass_types": [p.type for p in self.buffers.params.passes],
                "range_start": self.tile_manager.start_sample,
            })
        else:
            image_io.write_png(path, img, srgb=srgb)
        return path

    def profile_shaders(self, lanes=65536, repeats=3):
        """Per-shader DEVICE-time attribution (ref: util_profiling.h
        per-shader histograms surfaced in render/session.cpp:1205-1211).

        The reference samples worker threads; here each shader's masked
        full-wavefront eval is timed in its own dispatch over a
        representative batch (real camera-ray hits, so the texture/prim
        mix matches the scene). Results land in stats.shader_times and
        full_report() names the most expensive shaders."""
        import time as _time
        import jax
        import jax.numpy as jnp
        import numpy as np
        from raytracingproject_tpu.ops import camera as cam_ops
        from raytracingproject_tpu.ops import integrator as integ
        from raytracingproject_tpu.ops import shade as shade_ops
        from raytracingproject_tpu.models import object as ob

        if self._kg is None:
            self._update_scene()
        kg = self._kg
        W = int(self.scene.camera.width)
        H = int(self.scene.camera.height)
        n = int(lanes)
        idx = np.arange(n) % (W * H)
        rx = jnp.asarray(idx % W + 0.5, jnp.float32)
        ry = jnp.asarray(idx // W + 0.5, jnp.float32)
        half = jnp.full((n,), 0.5)
        ray = cam_ops.camera_sample_ray(kg["cam"], rx, ry, half, half,
                                        half)
        vis = jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32)
        hit = jax.jit(lambda o, d, a, b: integ._scene_intersect(
            kg, o, d, a, b, vis))(ray["o"], ray["d"], ray["tmin"],
                                  ray["tmax"])
        sd = shade_ops.shader_setup(kg["dscene"], hit, ray["o"],
                                    ray["d"], textures=kg["textures"])
        times = {}
        for slot, sh in enumerate(kg["shaders"]):
            fn = jax.jit(lambda s, slot=slot: shade_ops.eval_shaders(
                kg["shaders"], s, jnp.full((n,), slot, jnp.int32)))
            out = fn(sd)  # compile + warm
            jax.tree_util.tree_map(
                lambda x: x.block_until_ready()
                if hasattr(x, "block_until_ready") else x, out)
            t0 = _time.monotonic()
            for _ in range(repeats):
                out = fn(sd)
            jax.tree_util.tree_map(
                lambda x: x.block_until_ready()
                if hasattr(x, "block_until_ready") else x, out)
            times[sh.name or f"shader_{slot}"] = \
                (_time.monotonic() - t0) / repeats
        self.stats.shader_times = times
        return times
