"""Feature-guided non-local-means denoiser (ref: the reference's NLM
denoising pipeline — device/device_denoising.h DenoisingTask +
kernel/filter/* prefilter/construct/reconstruct stages).

Redesign: instead of per-tile pointer-walking filter kernels, the
whole frame is denoised as a batch of shifted-image operations — for
every offset in the search window the patch distance is a box-filtered
squared difference (pure convolutions/rolls, no gathers), optionally
guided by albedo/normal/depth feature distances like the reference's
feature-space transform. O(search^2) fused passes over the image.
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import jax
import jax.numpy as jnp


def _box_filter(x, r):
    """Box filter of radius r over (H, W, C) via separable cumsum."""
    if r <= 0:
        return x
    k = 2 * r + 1
    xp = jnp.pad(x, ((r, r), (0, 0), (0, 0)), mode="edge")
    c = jnp.cumsum(xp, axis=0)
    v = (c[k - 1:] - jnp.concatenate([jnp.zeros_like(c[:1]), c[:-k]], 0))
    xp = jnp.pad(v, ((0, 0), (r, r), (0, 0)), mode="edge")
    c = jnp.cumsum(xp, axis=1)
    h = (c[:, k - 1:] - jnp.concatenate(
        [jnp.zeros_like(c[:, :1]), c[:, :-k]], 1))
    return h / (k * k)


def _shift2(x, dy, dx):
    return jnp.roll(x, (dy, dx), axis=(0, 1))


def nlm_denoise(color, albedo=None, normal=None, depth=None,
                search_radius=5, patch_radius=2, strength=0.4,
                feature_strength=0.2):
    """Denoise (H, W, 3) radiance.

    color: noisy linear radiance; albedo/normal: optional (H, W, 3)
    feature passes; depth (H, W). Returns denoised (H, W, 3).
    ref: NLM weights w = exp(-max(0, dist)/k^2) with feature guidance.
    """
    color = jnp.asarray(color, prec.FT)
    eps = 1e-4
    k2 = jnp.maximum(strength, 1e-3) ** 2
    fk2 = jnp.maximum(feature_strength, 1e-3) ** 2

    acc = jnp.zeros_like(color)
    wsum = jnp.zeros(color.shape[:2] + (1,), prec.FT)

    # luminance-normalized color for distance (reduces halo around
    # bright lights; ref: filter_nlm_calc_difference scaling)
    def dist_img(a, b, k):
        d = (a - b) ** 2 / (k * (eps + a ** 2 + b ** 2))
        return jnp.mean(d, axis=-1, keepdims=True)

    for dy in range(-search_radius, search_radius + 1):
        for dx in range(-search_radius, search_radius + 1):
            shifted = _shift2(color, dy, dx)
            d = dist_img(color, shifted, k2)
            if albedo is not None:
                d = d + dist_img(albedo, _shift2(albedo, dy, dx), fk2)
            if normal is not None:
                nd = 1.0 - jnp.sum(normal * _shift2(normal, dy, dx), -1,
                                   keepdims=True)
                d = d + nd / fk2
            if depth is not None:
                dd = depth[..., None]
                d = d + (dd - _shift2(dd, dy, dx)) ** 2 \
                    / (fk2 * (eps + dd ** 2))
            d = _box_filter(d, patch_radius)
            w = jnp.exp(-jnp.maximum(d, 0.0))
            acc = acc + w * shifted
            wsum = wsum + w
    return acc / jnp.maximum(wsum, 1e-8)


@jax.jit
def denoise_rgb(color, albedo, normal, depth):
    return nlm_denoise(color, albedo, normal, depth)


def pick_denoise_device():
    """Heterogeneous denoise offload (ref: the reference's strategy of
    running denoise on a different device than the render — multi-GPU
    DenoisingTask scheduling): pick the LAST local device so the filter
    runs off the primary render chip and overlaps with the next sample
    chunk (JAX dispatch is async; computation follows data placement).
    Returns None when there is only one device (denoise stays local)."""
    ds = jax.devices()
    return ds[-1] if len(ds) > 1 else None


def denoise_buffers(combined_rgba, albedo=None, normal=None, depth=None,
                    device=None, block=True, method="auto", **kw):
    """Denoise a display-scaled RGBA image, preserving alpha.

    device: optional jax.Device to pin the filter to (heterogeneous
    offload — see pick_denoise_device). block=False returns the result
    as a device array still in flight on that device so the caller can
    keep rendering on the primary device; np.asarray() it to wait.

    method: "nlm" | "kpcn" | "auto". "kpcn" is the learned
    kernel-predicting denoiser (ops/kpcn.py; the analog of
    the reference's OptiX/OIDN backends, device_optix.cpp:669 /
    device_cpu.cpp:952). "auto" currently resolves to NLM: the round-5
    held-out A/B (tools/kpcn_train.py, dof scene vs 1024 spp) measured
    noisy 0.0109 / kpcn 0.0061 / nlm 0.0054 MSE — the net denoises
    well but NLM still edges it at this training scale, so the
    measured winner stays the default."""
    def put(x):
        if x is None:
            return None
        x = jnp.asarray(x)
        return x if device is None else jax.device_put(x, device)

    if method == "auto":
        method = "nlm"
    if method == "kpcn":
        from raytracingproject_tpu.ops import kpcn as _kp
        rgb = _kp.kpcn_denoise(put(combined_rgba[..., :3]),
                               put(albedo), put(normal))
    else:
        rgb = nlm_denoise(put(combined_rgba[..., :3]), put(albedo),
                          put(normal), put(depth), **kw)
    alpha = put(combined_rgba[..., 3:])
    out = jnp.concatenate([rgb, alpha], axis=-1)
    if not block:
        return out
    import numpy as np
    return np.asarray(out)


def nlm_denoise_temporal(colors, target, albedo=None, normal=None,
                         depth=None, search_radius=4, patch_radius=2,
                         strength=0.4, feature_strength=0.2):
    """Cross-frame NLM (ref: the reference's animation denoising —
    standalone denoiser consuming neighbor frames; DenoisingTask
    tile_info frames). Same shifted-image machinery as nlm_denoise,
    with every neighbor frame contributing its own candidate patches
    weighted against the TARGET frame's patch/feature distances.

    colors: list of (H, W, 3) frames (temporal window, any length);
    target: index of the frame to denoise. Features are the target
    frame's guides (camera assumed static-ish across the window, like
    the reference's per-frame guided weighting).
    """
    tgt = jnp.asarray(colors[target], prec.FT)
    eps = 1e-4
    k2 = jnp.maximum(strength, 1e-3) ** 2
    fk2 = jnp.maximum(feature_strength, 1e-3) ** 2
    acc = jnp.zeros_like(tgt)
    wsum = jnp.zeros(tgt.shape[:2] + (1,), prec.FT)

    def dist_img(a, b, k):
        d = (a - b) ** 2 / (k * (eps + a ** 2 + b ** 2))
        return jnp.mean(d, axis=-1, keepdims=True)

    for src in colors:
        src = jnp.asarray(src, prec.FT)
        for dy in range(-search_radius, search_radius + 1):
            for dx in range(-search_radius, search_radius + 1):
                shifted = _shift2(src, dy, dx)
                d = dist_img(tgt, shifted, k2)
                if albedo is not None:
                    d = d + dist_img(albedo, _shift2(albedo, dy, dx), fk2)
                if normal is not None:
                    nd = 1.0 - jnp.sum(normal * _shift2(normal, dy, dx),
                                       -1, keepdims=True)
                    d = d + nd / fk2
                if depth is not None:
                    dd = depth[..., None]
                    d = d + (dd - _shift2(dd, dy, dx)) ** 2 \
                        / (fk2 * (eps + dd ** 2))
                d = _box_filter(d, patch_radius)
                w = jnp.exp(-jnp.maximum(d, 0.0))
                acc = acc + w * shifted
                wsum = wsum + w
    return acc / jnp.maximum(wsum, 1e-8)
