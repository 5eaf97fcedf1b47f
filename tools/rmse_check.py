"""Accuracy north-star: RMSE of the renderer vs the independent
NumPy reference tracer (tools/reference_tracer.py) on the Cornell box.

Both are unbiased estimators of the same transport, so the converged
images must agree. Reports:
  - rmse_converged: ours @ HI_SPP vs reference @ REF_SPP (the
    implementation-accuracy number; target <= 1e-3)
  - rmse_128spp: ours @ 128 spp vs the converged reference (the
    BASELINE.json protocol number; dominated by MC noise at 128 spp)
  - self-noise floors for both, so the numbers can be read fairly.

Writes artifacts/RMSE.json + the images. Run from the repo root.
"""

import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import time
import numpy as np

HI_SPP = 131072
REF_SPP = 32768
W = H = 64


def make_scene(seed=0):
    from raytracingproject_tpu.app import accuracy
    return accuracy.converged_cornell_scene(W, H, spp=128, seed=seed)


def render_ours(spp, seed=0):
    from raytracingproject_tpu.app import accuracy
    return accuracy.render_regen(make_scene(seed), spp, min(spp, 512))


def rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def main():
    import jax
    from tools.reference_tracer import render_reference
    print(f"device={jax.devices()[0].platform}", flush=True)

    t0 = time.time()
    ours_hi = render_ours(HI_SPP, seed=0)
    ours_hi2 = render_ours(HI_SPP, seed=99)
    ours_128 = render_ours(128, seed=3)
    t_ours = time.time() - t0
    print(f"ours done in {t_ours:.1f}s", flush=True)

    t0 = time.time()
    ref = render_reference(make_scene(), REF_SPP, seed=7, log_every=1024)
    ref2 = render_reference(make_scene(), REF_SPP // 4, seed=11, log_every=4096)
    t_ref = time.time() - t0
    print(f"reference done in {t_ref:.1f}s", flush=True)

    out = {
        "config": f"cornell {W}x{H}, box filter, clamp off, "
                  f"max_bounce=4",
        "rmse_converged": rmse(ours_hi, ref),
        "rmse_128spp_vs_ref": rmse(ours_128, ref),
        "ours_noise_floor": rmse(ours_hi, ours_hi2) / np.sqrt(2),
        "ref_noise_floor": rmse(ref, ref2) / np.sqrt(1 + 4),
        "rmse_converged_ds4": rmse(ours_hi.reshape(16, 4, 16, 4, 3).mean((1, 3)),
                                   ref.reshape(16, 4, 16, 4, 3).mean((1, 3))),
        "ours_spp": HI_SPP, "ref_spp": REF_SPP,
        "mean_ours": float(ours_hi.mean()), "mean_ref": float(ref.mean()),
    }
    os.makedirs("artifacts", exist_ok=True)
    np.savez("artifacts/rmse_images.npz", ours=ours_hi, ref=ref,
             ours_128=ours_128)
    with open("artifacts/RMSE.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
