"""Accuracy recipes shared by tools/rmse_twin.py, tools/rmse_check.py
and chip_smoke.py.

Twin recipe: the five BASELINE scenes at 64x64, 128 spp in chunks of
16, indirect clamp off, rendered through `render_samples_regen`. The
stored float64 twin (artifacts/twin_f64_r04.npz) is the same integrator
traced at float64 on the same scene bits and sample sequence, so the
residual of a float32 render against it is rounding error plus the
rare path that diverges on an f32 decision, with no Monte-Carlo noise.
"""

from __future__ import annotations

import numpy as np

TWIN_W = TWIN_H = 64
TWIN_SPP = 128
TWIN_CHUNK = 16
TWIN_F64 = "artifacts/twin_f64_r04.npz"
# the 32k-spp converged Cornell reference (tools/rmse_check.py) and the
# CPU float32 render of the same scene at 128 spp
CONVERGED = "artifacts/rmse_images.npz"

# the five BASELINE bench configs (bench.py CONFIGS) at twin resolution
TWIN_SCENES = [
    ("cornell_diffuse", "cornell_box", {}),
    ("glossy_nee_mis", "cornell_box", {"spheres": "glossy"}),
    ("textured_instanced", "instanced_scene", {}),
    ("dof_motion_adaptive", "dof_motion_scene", {}),
    ("volume_sss", "volume_sss_scene", {}),
]


def render_regen(scene, spp, chunk, kg_overrides=None):
    """Sync `scene` and render it with render_samples_regen in chunks of
    `chunk` samples; returns the (H, W, 3) float64 mean image."""
    import jax
    import jax.numpy as jnp
    from raytracingproject_tpu.ops import integrator as integ
    scene.device_update()
    kg = {**scene.make_kernel_globals(), **(kg_overrides or {})}
    w, h = int(scene.camera.width), int(scene.camera.height)
    yy, xx = np.mgrid[0:h, 0:w]
    px = jnp.asarray(xx.reshape(-1), jnp.int32)
    py = jnp.asarray(yy.reshape(-1), jnp.int32)
    pidx = py * w + px
    fn = jax.jit(lambda a, b, c, s: integ.render_samples_regen(
        kg, a, b, c, s, chunk))
    acc = None
    for i in range(spp // chunk):
        L, _ = fn(px, py, pidx, jnp.uint32(i * chunk))
        acc = L if acc is None else acc + L
    return np.asarray(acc, np.float64).reshape(h, w, 3) / spp


def twin_scene(factory, kwargs):
    from raytracingproject_tpu.app import examples
    scene = getattr(examples, factory)(TWIN_W, TWIN_H, spp=TWIN_SPP,
                                       **kwargs)
    scene.integrator.set("sample_clamp_indirect", 0.0)
    return scene


def render_twin(factory, kwargs, kg_overrides=None):
    """One scene of the twin recipe, on the default device."""
    return render_regen(twin_scene(factory, kwargs), TWIN_SPP, TWIN_CHUNK,
                        kg_overrides)


def converged_cornell_scene(w=64, h=64, spp=128, seed=0):
    """The Cornell box of the 32k-spp reference: box filter of width 1,
    indirect clamp off."""
    from raytracingproject_tpu.app import examples
    scene = examples.cornell_box(w, h, spp=spp)
    scene.integrator.set("sample_clamp_indirect", 0.0)
    scene.integrator.set("seed", seed)
    scene.film.set("filter_type", "box")
    scene.film.set("filter_width", 1.0)
    return scene


def compare(img, ref):
    """Residual statistics of `img` against `ref` ((H, W, 3) each)."""
    d = np.asarray(img, np.float64) - np.asarray(ref, np.float64)
    return {"rmse": float(np.sqrt(np.mean(d * d))),
            "bias": float(np.abs(d.mean(axis=(0, 1))).max()),
            "max_abs": float(np.abs(d).max()),
            "frac_gt_1e3": float((np.abs(d).sum(-1) > 1e-3).mean()),
            "mean": float(np.mean(img)),
            "mean_ref": float(np.mean(ref))}
