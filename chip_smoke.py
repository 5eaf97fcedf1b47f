"""Bring-up check of the path tracer on an NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-5 below
    python chip_smoke.py --four-cards  # the 4-card mesh path only

One process drives the card(s). Phases, in order; the first failure
ends the run with a non-zero exit and no result line:

1. device: JAX's platform must be "gpu"; prints the device kind and
   count, the card's name and power limit (nvidia-smi, in a child that
   stays off JAX), the JAX version and XLA_FLAGS.
2. main path at 1920x1080: the CLI (`app.cli.main`) renders
   scenes/cornell.xml at 16 spp to a PNG; `Session` renders
   glossy_nee_mis (cluster walk) and big_instanced (packed BVH walk).
   Images must be finite with a plausible mean; prints sync, compile and
   render times, the device's peak memory and the compiler's memory
   analysis.
3. accuracy: the five BASELINE scenes in the twin recipe
   (app/accuracy.py: 64x64, 128 spp) against the stored float64 twin.
   RMSE <= 1e-3, or else the scene diverged on f32 decisions: its mean
   within 0.5% of the twin's and, for Cornell, an RMSE against the
   32k-spp reference no worse than the CPU float32 render's.
4. kernel: the Triton cluster walk against the XLA shortlist on
   glossy_nee_mis and textured_instanced at 65,536 and 262,144 lanes,
   closest-hit and any-hit: parity, median device time of each, and one
   in-context render chunk with each.
5. the last line: {"ok": true, "device": {...}}.

--four-cards renders glossy_nee_mis at 1920x1080, 8 spp through
`parallel.mesh.render_frame_sharded` on a 4-card mesh in pixel and
sample mode, and compares each with the same frame on one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

FRAME = (1920, 1080)
CLI_SPP = 16
SESSION_SPP = {"glossy_nee_mis": 16, "big_instanced": 4}
MESH_SPP = 8
KERNEL_LANES = (65536, 262144)
# in-context chunks: the bench's (W, H, chunk) for each scene
KERNEL_CONTEXT = {"glossy_nee_mis": (512, 512, 16),
                  "textured_instanced": (256, 256, 32)}
RMSE_BOUND = 1e-3          # BASELINE.md accuracy target
MEAN_REL_BOUND = 5e-3      # a diverged scene's mean vs the twin's
OUT_DIR = os.path.join("chiprun_out", "smoke")
# kg overrides that select the two traversals in the integrator
WALK_KG = {}
XLA_KG = {"pallas_clusters": False}
INTERPRET = False          # Pallas interpret mode (CPU rehearsals only)

SCENES = {
    "glossy_nee_mis": ("cornell_box", {"spheres": "glossy"}),
    "textured_instanced": ("instanced_scene", {}),
    "big_instanced": ("instanced_scene", {"grid": 8}),
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def require_gpu():
    import jax
    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"JAX's default device is '{dev.platform}', not a GPU")
    return dev


def _mib(n):
    return f"{n / 2**20:.1f} MiB"


def _peak_bytes():
    import jax
    ms = jax.devices()[0].memory_stats() or {}
    return ms.get("peak_bytes_in_use", 0)


def _scene(name, w, h, spp):
    from raytracingproject_tpu.app import examples
    factory, kw = SCENES[name]
    return getattr(examples, factory)(w, h, spp=spp, **kw)


# ---------------------------------------------------------------- phase 1
def phase_device(expect_count=None):
    import jax
    dev = require_gpu()
    n = len(jax.devices())
    print(f"[device] platform={dev.platform} kind={dev.device_kind} "
          f"count={n}", flush=True)
    if expect_count is not None:
        check(n >= expect_count, f"need {expect_count} devices, found {n}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f"[device] jax {jax.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    return dev


# ---------------------------------------------------------------- phase 2
def _check_image(label, rgb, lo=0.02, hi=0.9):
    rgb = np.asarray(rgb, np.float64)
    check(np.isfinite(rgb).all(), f"{label}: non-finite pixels")
    m = float(rgb.mean())
    check(lo < m < hi, f"{label}: mean {m:.4f} outside ({lo}, {hi})")
    return m


def phase_main_path():
    from raytracingproject_tpu.app import cli
    from raytracingproject_tpu.session import Session, SessionParams
    from raytracingproject_tpu.utils import image_io
    w, h = FRAME
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, "cornell.png")
    t0 = time.monotonic()
    rc = cli.main(["scenes/cornell.xml", "--width", str(w), "--height",
                   str(h), "--samples", str(CLI_SPP), "--output", png])
    wall = time.monotonic() - t0
    check(rc == 0, f"CLI exited {rc}")
    img = image_io.read_image(png)
    check(img.shape[:2] == (h, w), f"CLI image shape {img.shape}")
    m = _check_image("cli cornell", img[..., :3])
    print(f"[main] cli cornell.xml {w}x{h}@{CLI_SPP}spp wall {wall:.2f}s "
          f"(compile and render split above) mean {m:.4f} peak device "
          f"memory so far {_mib(_peak_bytes())}", flush=True)

    for name, spp in SESSION_SPP.items():
        scene = _scene(name, w, h, spp)
        sess = Session(scene, SessionParams(samples=spp))
        sess.reset()
        t0 = time.monotonic()
        rgba = sess.render()
        wall = time.monotonic() - t0
        m = _check_image(f"session {name}", rgba[..., :3])
        st = sess.stats
        print(f"[main] session {name} {w}x{h}@{spp}spp wall {wall:.2f}s "
              f"mean {m:.4f}; {st.device_report()}", flush=True)


# ---------------------------------------------------------------- phase 3
def phase_accuracy():
    from raytracingproject_tpu.app import accuracy
    twin = np.load(accuracy.TWIN_F64)
    for name, factory, kwargs in accuracy.TWIN_SCENES:
        t0 = time.monotonic()
        img = accuracy.render_twin(factory, kwargs)
        st = accuracy.compare(img, twin[name])
        print(f"[accuracy] {name}: rmse {st['rmse']:.3e} bias "
              f"{st['bias']:.3e} max_abs {st['max_abs']:.3e} mean "
              f"{st['mean']:.6f} (f64 {st['mean_ref']:.6f}) "
              f"{time.monotonic() - t0:.1f}s", flush=True)
        if st["rmse"] <= RMSE_BOUND:
            continue
        # only path divergence may miss the bound: the image must still
        # converge to the same mean
        rel = abs(st["mean"] - st["mean_ref"]) / st["mean_ref"]
        print(f"[accuracy] {name}: over the RMSE bound; mean differs by "
              f"{rel:.2e} (bound {MEAN_REL_BOUND})", flush=True)
        check(rel <= MEAN_REL_BOUND,
              f"{name}: RMSE {st['rmse']:.3e} and mean off by {rel:.2e}")
        if name == "cornell_diffuse":
            conv = np.load(accuracy.CONVERGED)
            ours = accuracy.render_regen(
                accuracy.converged_cornell_scene(seed=3), 128, 128)
            r_gpu = accuracy.compare(ours, conv["ref"])["rmse"]
            r_cpu = accuracy.compare(conv["ours_128"], conv["ref"])["rmse"]
            print(f"[accuracy] cornell vs 32k-spp reference: rmse "
                  f"{r_gpu:.4e} here, {r_cpu:.4e} on the CPU", flush=True)
            check(r_gpu <= r_cpu,
                  "cornell: worse than the CPU against the reference")


# ---------------------------------------------------------------- phase 4
def _probe_rays(ds, n):
    """bench.py's probe: half parallel rays, half random directions,
    from origins spread over the cluster bounds."""
    import jax.numpy as jnp
    cb = np.asarray(ds["cluster_bounds"])
    lo, hi = cb[:, :3].min(0), cb[:, 3:].max(0)
    span = np.maximum(hi - lo, 1e-3)
    rng = np.random.default_rng(0)
    o = (lo - 0.25 * span) + rng.uniform(0, 1, (n, 3)) * 1.5 * span
    d = rng.normal(size=(n, 3))
    d[: n // 2] = [0.577, 0.577, 0.577]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _median_time(fn, *args, reps=5):
    import jax
    out = jax.block_until_ready(fn(*args))      # compile + warm-up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def phase_kernel():
    import jax
    import jax.numpy as jnp
    from raytracingproject_tpu.models import object as ob
    from raytracingproject_tpu.ops import cluster_intersect as ci
    from raytracingproject_tpu.ops import cluster_walk_gpu as cwg
    from raytracingproject_tpu.ops import integrator as integ
    for name, (w, h, chunk) in KERNEL_CONTEXT.items():
        scene = _scene(name, w, h, chunk * 4)
        scene.device_update()
        kg = scene.make_kernel_globals()
        ds = kg["dscene"]
        check("cluster_bounds" in ds, f"{name}: no cluster tables")
        ct = int(kg["cluster_tris"])
        inst = bool(kg.get("has_instances", False))
        args = (ds["cluster_bounds"], ds["cluster_table"], ct)
        print(f"[kernel] {name}: {ds['cluster_bounds'].shape[0]} clusters "
              f"x {ct} tris", flush=True)
        for n in KERNEL_LANES:
            o, d = _probe_rays(ds, n)
            tmin = jnp.full((n,), 1e-4, jnp.float32)
            tmax = jnp.full((n,), 1e30, jnp.float32)
            vis = jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32)
            for shadow in (False, True):
                kw = dict(visibility=vis, shadow_any_hit=shadow,
                          has_instances=inst)
                f_xla = jax.jit(lambda o, d, kw=kw: ci.intersect_clusters(
                    *args, o, d, tmin, tmax, **kw))
                f_walk = jax.jit(
                    lambda o, d, kw=kw: cwg.intersect_clusters_gpu(
                        *args, o, d, tmin, tmax, interpret=INTERPRET, **kw))
                r_xla, t_xla = _median_time(f_xla, o, d)
                r_walk, t_walk = _median_time(f_walk, o, d)
                par = cwg.check_parity(r_xla, r_walk, shadow)
                mode = "any-hit" if shadow else "closest"
                print(f"[kernel] {name} n={n} {mode}: xla "
                      f"{t_xla * 1e3:.3f} ms, walk {t_walk * 1e3:.3f} ms "
                      f"({t_xla / t_walk:.2f}x); agree {par['agree']:.6f} "
                      f"hit {par['hit_frac']:.3f} max t rel "
                      f"{par['max_t_rel']:.2e}", flush=True)
        yy, xx = np.mgrid[0:h, 0:w]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        pidx = py * w + px
        ctx = {}
        for label, over in (("xla", XLA_KG), ("walk", WALK_KG)):
            kgv = {**kg, **over}
            fn = jax.jit(lambda a, b, c, s, kgv=kgv:
                         integ.render_samples_regen(kgv, a, b, c, s, chunk))
            t0 = time.monotonic()
            L, _ = jax.block_until_ready(fn(px, py, pidx, jnp.uint32(0)))
            comp = time.monotonic() - t0
            ts = []
            for i in range(1, 4):
                t0 = time.perf_counter()
                L, _ = jax.block_until_ready(
                    fn(px, py, pidx, jnp.uint32(i * chunk)))
                ts.append(time.perf_counter() - t0)
            ctx[label] = (float(np.median(ts)), np.asarray(L) / chunk)
            print(f"[kernel] {name} in-context {label}: {w}x{h}, chunk "
                  f"{chunk} spp: compile {comp:.1f}s, median chunk "
                  f"{ctx[label][0] * 1e3:.1f} ms", flush=True)
        mx, mw = float(ctx["xla"][1].mean()), float(ctx["walk"][1].mean())
        check(abs(mx - mw) <= 1e-3 * max(mx, 1e-6),
              f"{name}: in-context means differ ({mx} vs {mw})")
        print(f"[kernel] {name} in-context: walk {ctx['xla'][0] / ctx['walk'][0]:.2f}x "
              f"the shortlist; image means {mx:.6f} vs {mw:.6f}",
              flush=True)


# ----------------------------------------------------------- four cards
def phase_four_cards():
    import jax
    from raytracingproject_tpu.parallel.mesh import (
        make_device_mesh, render_frame_sharded, sharded_render_fn)
    w, h = FRAME
    scene = _scene("glossy_nee_mis", w, h, MESH_SPP)
    scene.device_update()
    kg = scene.make_kernel_globals()

    def run(mesh, mode):
        """(image, compile + first call, median of 3 more calls)."""
        fn = sharded_render_fn(kg, MESH_SPP, mesh, mode)

        def once():
            L, _ = jax.block_until_ready(render_frame_sharded(
                kg, w, h, MESH_SPP, mesh=mesh, mode=mode, fn=fn))
            return L

        t0 = time.monotonic()
        L = once()
        comp = time.monotonic() - t0
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            L = once()
            ts.append(time.perf_counter() - t0)
        return np.asarray(L, np.float64) / MESH_SPP, comp, \
            float(np.median(ts))

    ref, comp, t_one = run(make_device_mesh(1), "pixel")
    _check_image("one card", ref)
    print(f"[mesh] one card: {w}x{h}@{MESH_SPP}spp compile+first "
          f"{comp:.1f}s, median render {t_one:.3f}s", flush=True)
    mesh4 = make_device_mesh(4)
    for mode in ("pixel", "sample"):
        img, comp, t = run(mesh4, mode)
        d = np.abs(img - ref)
        # same per-pixel sample sequence on both sides; what differs is
        # the compiled graph (FMA contraction can flip a rare f32 path
        # decision) and, in sample mode, the psum's order of addition
        off = d > 1e-4 * np.abs(ref) + 1e-5
        rel_mean = abs(img.mean() - ref.mean()) / ref.mean()
        print(f"[mesh] 4 cards {mode}: compile+first {comp:.1f}s, median "
              f"render {t:.3f}s ({t_one / t:.2f}x one card); max |diff| "
              f"{d.max():.3e}, pixels off rtol 1e-4/atol 1e-5 "
              f"{off.mean():.2e}, mean rel diff {rel_mean:.2e}", flush=True)
        check(off.mean() <= 1e-3, f"{mode}: too many pixels differ")
        check(rel_mean <= 1e-4, f"{mode}: image mean differs")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    unknown = [a for a in argv if a != "--four-cards"]
    if unknown:
        print(f"unknown arguments {unknown}", file=sys.stderr)
        return 2
    import jax
    from raytracingproject_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    t_start = time.monotonic()
    try:
        dev = phase_device(expect_count=4 if four else None)
        if four:
            phase_four_cards()
        else:
            for phase in (phase_main_path, phase_accuracy, phase_kernel):
                t0 = time.monotonic()
                phase()
                print(f"[{phase.__name__}] done in "
                      f"{time.monotonic() - t0:.1f}s", flush=True)
    except (PhaseError, AssertionError) as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[smoke] all phases passed in {time.monotonic() - t_start:.1f}s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
