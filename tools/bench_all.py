"""Render + time all five BASELINE.json benchmark configs; writes a
gallery of PNGs to artifacts/ and per-config throughput lines."""

import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time
import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from raytracingproject_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    from raytracingproject_tpu.app import examples
    from raytracingproject_tpu.ops import integrator as integ
    from raytracingproject_tpu.utils.image_io import write_png

    outdir = os.path.join(os.path.dirname(__file__), "..", "artifacts")
    os.makedirs(outdir, exist_ok=True)

    W = H = 256
    SPP = 64
    configs = [
        ("cornell_diffuse", lambda: examples.cornell_box(W, H, SPP)),
        ("glossy_nee_mis", lambda: examples.cornell_box(W, H, SPP,
                                                        spheres="glossy")),
        ("textured_instanced", lambda: examples.instanced_scene(W, H, SPP)),
        ("dof_motion_adaptive", lambda: examples.dof_motion_scene(W, H, SPP)),
        ("volume_smoke", lambda: examples.smoke_cornell(W, H, SPP,
                                                        density=0.004)),
        ("sss_wax", lambda: examples.sss_cornell(W, H, SPP)),
    ]
    for name, make in configs:
        t0 = time.time()
        scene = make()
        scene.device_update()
        kg = scene.make_kernel_globals()
        sync = time.time() - t0
        yy, xx = np.mgrid[0:H, 0:W]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        pidx = py * W + px
        chunk = 16
        fn = jax.jit(lambda a, b, c, s: integ.render_samples_regen(
            kg, a, b, c, s, chunk))
        t0 = time.time()
        L, A = fn(px, py, pidx, jnp.uint32(0))
        L.block_until_ready()
        compile_t = time.time() - t0
        acc = np.asarray(L)
        t0 = time.time()
        for i in range(1, SPP // chunk):
            L, A = fn(px, py, pidx, jnp.uint32(i * chunk))
            acc = acc + np.asarray(L)
        render_t = time.time() - t0 + 1e-9
        msps = W * H * (SPP - chunk) / render_t / 1e6
        img = acc.reshape(H, W, 3) / SPP
        write_png(os.path.join(outdir, f"{name}.png"), img[::-1])
        print(f"{name:>22}: {msps:7.2f} Msamples/s "
              f"(sync {sync:.2f}s compile {compile_t:.1f}s) "
              f"mean={img.mean():.4f} brute={kg['use_brute']}", flush=True)


if __name__ == "__main__":
    main()
