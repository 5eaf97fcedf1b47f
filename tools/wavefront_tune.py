"""A/B (chunk, lanes_per_pixel) for the regen driver on the bench
configs, in-context on the attached chip.

The 256^2 configs ship lpp=4 chunk=16 (one 262k wavefront, 4 samples
per lane per dispatch) — chosen in the XLA-walk era when per-iteration
cost was fixed-latency dominated. With the per-lane Pallas walks the
cost is compute-scaled (CLAUDE.md round-4 lessons), so the regen TAIL
(iterations where most lanes idle waiting for stragglers) is paid per
DISPATCH and amortizes over per_lane = chunk/lpp samples: small
per_lane wastes a large fraction. This sweeps the grid and prints
Msps per variant.

Usage: python tools/wavefront_tune.py <config> [chunk,lpp ...]
"""
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np

CONFIGS = {
    "glossy_nee_mis": ("cornell_box", {"spheres": "glossy"}, 512, 512),
    "cornell_diffuse": ("cornell_box", {}, 512, 512),
    "textured_instanced": ("instanced_scene", {}, 256, 256),
    "dof_motion_adaptive": ("dof_motion_scene", {}, 256, 256),
    "volume_sss": ("volume_sss_scene", {}, 256, 256),
    "big_instanced": ("instanced_scene", {"grid": 8}, 256, 256),
}


def main():
    import jax
    from raytracingproject_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from raytracingproject_tpu.app import examples
    from raytracingproject_tpu.ops import integrator as integ

    name = sys.argv[1]
    variants = [tuple(int(x) for x in a.split(","))
                for a in sys.argv[2:]] or [(16, 4), (32, 4), (32, 2),
                                           (32, 1), (64, 4)]
    factory, kwargs, W, H = CONFIGS[name]
    scene = getattr(examples, factory)(W, H, spp=64)
    scene.device_update()
    kg = scene.make_kernel_globals()
    print(f"{name} {W}x{H} prims={kg['dscene']['prim_table'].shape[0]} "
          f"backend={jax.default_backend()}", flush=True)

    results = {}
    for chunk, lpp in variants:
        yy, xx = np.mgrid[0:H, 0:W]
        px = jnp.asarray(np.tile(xx.reshape(-1), lpp), jnp.int32)
        py = jnp.asarray(np.tile(yy.reshape(-1), lpp), jnp.int32)
        pidx = py * W + px
        fn = jax.jit(lambda a, b, c, s, _c=chunk, _l=lpp:
                     integ.render_samples_regen(kg, a, b, c, s, _c,
                                                lanes_per_pixel=_l))
        try:
            t0 = time.time()
            L, A = fn(px, py, pidx, jnp.uint32(0))
            L.block_until_ready()
            compile_t = time.time() - t0
            best = float("inf")
            for r in range(3):
                t0 = time.time()
                L, A = fn(px, py, pidx, jnp.uint32((r + 1) * chunk))
                L.block_until_ready()
                best = min(best, time.time() - t0)
        except Exception as e:
            print(f"  chunk={chunk} lpp={lpp}: FAILED {type(e).__name__}: "
                  f"{e}", flush=True)
            continue
        msps = W * H * chunk / best / 1e6
        results[f"{chunk},{lpp}"] = round(msps, 3)
        print(f"  chunk={chunk} lpp={lpp}: {best*1e3:8.1f}ms  "
              f"msps={msps:6.2f}  (compile {compile_t:.0f}s)", flush=True)
    print(json.dumps({name: results}))


if __name__ == "__main__":
    main()
