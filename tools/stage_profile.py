"""Per-stage device-time attribution for the bench configs.

Times render_samples_regen under each debug_ablate setting; the delta
vs the full pipeline is that stage's in-context cost (the analog of
the reference's per-stage profiler, ref: util/util_profiling.h:28-129).
Also times the isolated hot primitives (intersect sweep, shadow sweep,
light sample, shader setup/eval) on the same wavefront.

Usage: python tools/stage_profile.py [config ...]
  configs: cornell_diffuse glossy_nee_mis textured_instanced
           dof_motion_adaptive volume_sss   (default: all slow ones)
Env:
  STAGE_FIXED=1     time the fixed-grid kernel (precise per-iter deltas)
  STAGE_ABLATIONS=shadow,nee  comma-joined subset ("" = FULL only)
  STAGE_OUT=path    also write a JSON artifact (per-config stage table)
"""
import json
import sys
import os
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np

RESULTS = {}

CONFIGS = {
    "cornell_diffuse": ("cornell_box", {}, 512, 512, 32),
    "glossy_nee_mis": ("cornell_box", {"spheres": "glossy"}, 512, 512, 16),
    "textured_instanced": ("instanced_scene", {}, 256, 256, 16),
    "dof_motion_adaptive": ("dof_motion_scene", {}, 256, 256, 16),
    "volume_sss": ("volume_sss_scene", {}, 256, 256, 16),
}

ABLATIONS = [
    (),                      # full pipeline
    ("shadow",),             # no shadow rays (NEE assumed unblocked)
    ("volatten",),           # skip volume-NEE boundary sweeps
    ("shadow", "volatten"),  # NEE with free visibility
    ("nee",),                # no NEE at all
    ("equiangular",),        # volume: skip the equiangular estimator
    ("volume",),
    ("sss",),
    ("shade",),              # fixed diffuse closure, no graph eval
]


def timeit(fn, *args, iters=5):
    """MEDIAN of `iters` individually-synced reps (a single-run
    ablation profile can produce NEGATIVE stage deltas larger than real
    stages — timing noise, not signal; the median of 5 synced reps is
    robust to the occasional 2x outlier)."""
    import jax

    def sync(x):
        return jax.tree_util.tree_map(
            lambda y: y.block_until_ready()
            if hasattr(y, "block_until_ready") else y, x)

    sync(fn(*args))  # warm/compile
    ts = []
    for _ in range(iters):
        t0 = time.time()
        sync(fn(*args))
        ts.append(time.time() - t0)
    return float(np.median(ts))


def profile_config(name, chunk=16):
    import jax
    import jax.numpy as jnp
    from raytracingproject_tpu.app import examples
    from raytracingproject_tpu.ops import integrator as integ
    from raytracingproject_tpu.models import object as ob

    factory, kwargs, W, H, spp = CONFIGS[name]
    scene = getattr(examples, factory)(W, H, spp=spp, **kwargs)
    scene.device_update()
    kg = scene.make_kernel_globals()
    n = W * H
    print(f"\n=== {name} {W}x{H} prims={kg['dscene']['prim_table'].shape[0]} "
          f"use_brute={kg['use_brute']} cluster_tris={kg.get('cluster_tris', 0)} "
          f"features={ {k: v for k, v in (kg.get('features') or {}).items() if v} }",
          flush=True)

    yy, xx = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xx.reshape(-1), jnp.int32)
    py = jnp.asarray(yy.reshape(-1), jnp.int32)
    pidx = py * W + px

    # STAGE_FIXED=1: time the fixed-grid kernel instead — EXACTLY
    # (max_bounce+1) bounce iterations per sample, so ablation deltas
    # divide into precise per-iteration stage costs (no regen logic,
    # no data-dependent iteration count).
    fixed = bool(int(os.environ.get("STAGE_FIXED", "0")))
    iters_per = (int(kg["kint"]["max_bounce"]) + 1) * chunk if fixed else 0
    base_t = None
    ablations = ABLATIONS
    if os.environ.get("STAGE_ABLATIONS") is not None:
        want = [a for a in os.environ["STAGE_ABLATIONS"].split(",") if a]
        ablations = [()] + [tuple(a.split("+")) for a in want]
    rec = RESULTS.setdefault(name, {"W": W, "H": H, "chunk": chunk,
                                    "stages_ms": {}})
    for ab in ablations:
        kg2 = dict(kg)
        kg2["debug_ablate"] = ab
        if fixed:
            fn = jax.jit(lambda a, b, c, s, _kg=kg2: integ.render_samples(
                _kg, a, b, c, s, chunk))
        else:
            fn = jax.jit(
                lambda a, b, c, s, _kg=kg2: integ.render_samples_regen(
                    _kg, a, b, c, s, chunk))
        try:
            t0 = time.time()
            L, A = fn(px, py, pidx, jnp.uint32(0))
            L.block_until_ready()
            compile_t = time.time() - t0
            t = timeit(lambda s: fn(px, py, pidx, s), jnp.uint32(chunk),
                       iters=5)
        except Exception as e:  # noqa
            print(f"  ablate={ab or 'none'}: FAILED {e}")
            continue
        msps = n * chunk / t / 1e6
        lbl = ",".join(ab) if ab else "FULL"
        rec["stages_ms"][lbl] = round(t * 1e3, 1)
        extra = ""
        if base_t is None and not ab:
            base_t = t
            rec["full_msps"] = round(msps, 2)
        elif base_t is not None:
            rec["stages_ms"][lbl + "_delta"] = round(1e3 * (base_t - t), 1)
            extra = f"  delta={1e3 * (base_t - t):+.1f}ms " \
                    f"({100 * (base_t - t) / base_t:+.0f}%)"
            if fixed:
                extra += f"  {1e3 * (base_t - t) / iters_per:+.3f}ms/iter"
        per_it = f"  {1e3 * t / iters_per:.3f}ms/iter" if fixed else ""
        print(f"  ablate={lbl:<14} t={t * 1e3:8.1f}ms  msps={msps:7.2f} "
              f"compile={compile_t:.1f}s{per_it}{extra}", flush=True)

    if fixed:
        return  # isolated-primitive timings are misleading; skip

    # isolated primitives on a camera wavefront
    from raytracingproject_tpu.ops import camera as cam_ops
    from raytracingproject_tpu.ops import shade as shade_ops
    from raytracingproject_tpu.ops import light as light_ops
    from raytracingproject_tpu.utils import rng as rngu

    ray = cam_ops.camera_sample_ray(
        kg["cam"], px.astype(jnp.float32) + 0.5, py.astype(jnp.float32) + 0.5,
        jnp.full((n,), 0.5), jnp.full((n,), 0.5), jnp.zeros((n,)))
    vis = jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32)

    isect_fn = jax.jit(lambda o, d, t0, t1: integ._scene_intersect(
        kg, o, d, t0, t1, vis))
    t = timeit(isect_fn, ray["o"], ray["d"], ray["tmin"], ray["tmax"])
    print(f"  [prim] scene_intersect (camera wavefront): {t * 1e3:.2f}ms")

    hit = isect_fn(ray["o"], ray["d"], ray["tmin"], ray["tmax"])
    shadow_fn = jax.jit(lambda o, d, t0, t1: integ._shadow_transmittance(
        kg, o, d, t0, t1))
    up = jnp.tile(jnp.asarray([[0., 0., 1.]]), (n, 1))
    t = timeit(shadow_fn, ray["o"] + ray["d"] * (hit["t"][:, None] * 0.95),
               up, jnp.full((n,), 1e-4), jnp.full((n,), 100.0))
    print(f"  [prim] shadow_transmittance: {t * 1e3:.2f}ms")

    setup_fn = jax.jit(lambda h, o, d: shade_ops.shader_setup(
        kg["dscene"], h, o, d, textures=kg["textures"]))
    t = timeit(setup_fn, hit, ray["o"], ray["d"])
    print(f"  [prim] shader_setup: {t * 1e3:.2f}ms")

    sd = setup_fn(hit, ray["o"], ray["d"])
    eval_fn = jax.jit(lambda s: shade_ops.eval_shaders(
        kg["shaders"], s, s.shader))
    t = timeit(eval_fn, sd)
    print(f"  [prim] eval_shaders ({len(kg['shaders'])} shaders): "
          f"{t * 1e3:.2f}ms")

    if int(kg["dscene"]["light_dist_type"].shape[0]) > 0:
        u = jnp.linspace(0.01, 0.99, n)
        light_fn = jax.jit(lambda P, a, b, c: light_ops.sample_light(
            kg["dscene"], P, a, b, c))
        t = timeit(light_fn, sd.P, u, u, u)
        print(f"  [prim] sample_light: {t * 1e3:.2f}ms")

    rng_hash = rngu.pixel_rng_hash(pidx.astype(jnp.uint32), jnp.uint32(0))
    dims = jnp.asarray([2, 4, 6, 8], jnp.uint32)[:, None]
    rng_fn = jax.jit(lambda s: rngu.path_rng_2d(
        rng_hash[None, :], s[None, :], dims,
        int(kg["kint"]["sampling_pattern"])))
    t = timeit(rng_fn, jnp.zeros((n,), jnp.uint32))
    print(f"  [prim] rng 4-pair batch: {t * 1e3:.2f}ms", flush=True)


if __name__ == "__main__":
    import jax
    from raytracingproject_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    names = sys.argv[1:] or ["volume_sss", "glossy_nee_mis",
                             "textured_instanced", "dof_motion_adaptive"]
    print(f"device={jax.devices()[0].platform}", flush=True)
    for nm in names:
        profile_config(nm)
    out = os.environ.get("STAGE_OUT")
    if out:
        RESULTS["device"] = jax.devices()[0].platform
        with open(out, "w") as f:
            json.dump(RESULTS, f, indent=1)
        print(f"wrote {out}", flush=True)
