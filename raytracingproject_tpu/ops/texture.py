"""Texture sampling + procedural fields (ref: kernel/kernels/cpu/
kernel_cpu_image.h samplers; kernel/svm/svm_noise.h, svm_voronoi.h).

Image data lives in a packed store (models/image.py ImageManager): one
(slots, Hmax, Wmax, 4) float32 array. Shader nodes reference slots with
*static* Python ints, so slot indexing is a static slice and only the
(u, v) gather is dynamic — the XLA-friendly layout.
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import jax.numpy as jnp
import numpy as np

from raytracingproject_tpu.utils import rng as rngu

# interpolation (ref: device_memory.h InterpolationType)
INTERPOLATION_CLOSEST = 0
INTERPOLATION_LINEAR = 1

# extension (ref: ExtensionType)
EXTENSION_REPEAT = 0
EXTENSION_EXTEND = 1
EXTENSION_CLIP = 2


def _wrap(idx, n, extension):
    if extension == EXTENSION_REPEAT:
        return jnp.mod(idx, n)
    return jnp.clip(idx, 0, n - 1)


def sample_image(data, height, width, u, v, interpolation=INTERPOLATION_LINEAR,
                 extension=EXTENSION_REPEAT):
    """Sample one image (H, W, 4) at normalized (u, v); v=0 is bottom.

    `height`/`width` are static ints (actual image size inside a padded
    slot). Returns (..., 4) RGBA.
    """
    h, w = int(height), int(width)
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5  # image rows are top-down
    if extension == EXTENSION_CLIP:
        inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    if interpolation == INTERPOLATION_CLOSEST:
        xi = _wrap(jnp.floor(x + 0.5).astype(jnp.int32), w, extension)
        yi = _wrap(jnp.floor(y + 0.5).astype(jnp.int32), h, extension)
        out = data[yi, xi]
    else:
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0w = _wrap(x0, w, extension)
        x1w = _wrap(x0 + 1, w, extension)
        y0w = _wrap(y0, h, extension)
        y1w = _wrap(y0 + 1, h, extension)
        c00 = data[y0w, x0w]
        c01 = data[y0w, x1w]
        c10 = data[y1w, x0w]
        c11 = data[y1w, x1w]
        out = ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
               + (c10 * (1 - fx) + c11 * fx) * fy)
    if extension == EXTENSION_CLIP:
        out = jnp.where(inside[..., None], out, 0.0)
    return out


# ---------------------------------------------------------------------------
# Procedural noise (ref: kernel/svm/svm_noise.h — Perlin with hash grads)
# ---------------------------------------------------------------------------

def _hash3_to_u32(xi, yi, zi):
    return rngu.hash_pcg3d(xi.astype(jnp.uint32), yi.astype(jnp.uint32),
                           zi.astype(jnp.uint32))


def _grad_dot(hash_u32, fx, fy, fz):
    """Gradient dot product via 12-direction hash (Perlin improved)."""
    h = (hash_u32 & jnp.uint32(15)).astype(jnp.int32)
    u = jnp.where(h < 8, fx, fy)
    v = jnp.where(h < 4, fy, jnp.where((h == 12) | (h == 14), fx, fz))
    return (jnp.where(h & 1 == 0, u, -u) + jnp.where(h & 2 == 0, v, -v))


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin_3d(p):
    """Perlin noise in [-1, 1] for (..., 3) points."""
    pi = jnp.floor(p)
    pf = p - pi
    xi = pi[..., 0].astype(jnp.int32)
    yi = pi[..., 1].astype(jnp.int32)
    zi = pi[..., 2].astype(jnp.int32)
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]
    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def corner(dx, dy, dz):
        h = _hash3_to_u32(xi + dx, yi + dy, zi + dz)
        return _grad_dot(h, fx - dx, fy - dy, fz - dz)

    def lerp(a, b, t):
        return a + (b - a) * t

    c = lerp(
        lerp(lerp(corner(0, 0, 0), corner(1, 0, 0), u),
             lerp(corner(0, 1, 0), corner(1, 1, 0), u), v),
        lerp(lerp(corner(0, 0, 1), corner(1, 0, 1), u),
             lerp(corner(0, 1, 1), corner(1, 1, 1), u), v),
        w)
    return c


def fractal_noise_3d(p, octaves, roughness=0.5):
    """fBm over Perlin octaves; `octaves` static float like the
    reference's detail param (fractional last octave blended)."""
    octaves = float(octaves)
    n = int(np.floor(octaves))
    fscale, amp, maxamp, s = 1.0, 1.0, 0.0, 0.0
    for _ in range(n + 1):
        s = s + amp * perlin_3d(p * fscale)
        maxamp += amp
        amp *= float(roughness)
        fscale *= 2.0
    rmd = octaves - n
    if rmd > 0.0:
        s2 = s + amp * perlin_3d(p * fscale)
        return (0.5 + 0.5 * ((1.0 - rmd) * s / maxamp
                             + rmd * s2 / (maxamp + amp)))
    return 0.5 + 0.5 * (s / maxamp)


def voronoi_f1_3d(p, randomness=1.0):
    """Voronoi F1: distance + cell color + position
    (ref: svm_voronoi.h, euclidean metric)."""
    pi = jnp.floor(p)
    pf = p - pi
    min_d = jnp.full(p.shape[:-1], 1e10, prec.FT)
    min_off = jnp.zeros_like(p)
    min_hash = jnp.zeros(p.shape[:-1], jnp.uint32)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cell = pi + jnp.asarray([dx, dy, dz], prec.FT)
                h = _hash3_to_u32(cell[..., 0].astype(jnp.int32),
                                  cell[..., 1].astype(jnp.int32),
                                  cell[..., 2].astype(jnp.int32))
                ox = rngu.uint_to_float_01(h)
                oy = rngu.uint_to_float_01(rngu.hash_pcg(h))
                oz = rngu.uint_to_float_01(rngu.hash_pcg(rngu.hash_pcg(h)))
                off = jnp.stack([ox, oy, oz], -1) * randomness \
                    + jnp.asarray([dx, dy, dz], prec.FT)
                d = jnp.linalg.norm(off - pf, axis=-1)
                closer = d < min_d
                min_d = jnp.where(closer, d, min_d)
                min_off = jnp.where(closer[..., None], off + pi, min_off)
                min_hash = jnp.where(closer, h, min_hash)
    color = jnp.stack([
        rngu.uint_to_float_01(min_hash),
        rngu.uint_to_float_01(rngu.hash_pcg(min_hash)),
        rngu.uint_to_float_01(rngu.hash_pcg(rngu.hash_pcg(min_hash)))], -1)
    return min_d, color, min_off


def build_point_density_grid(points, radius, resolution, bounds=None):
    """Host-side voxelization of a point cloud into a (R, R, R) density
    grid (ref: render/nodes.cpp PointDensityTextureNode +
    util_texture.h 3D texture build; splatting redesigned as a
    vectorized numpy histogram with a radius-sized tophat).

    Returns (grid (R,R,R) float32, lo (3,), inv_extent (3,))."""
    import numpy as np
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    r = int(resolution)
    if bounds is None:
        lo = pts.min(0) - radius
        hi = pts.max(0) + radius
    else:
        lo, hi = (np.asarray(b, np.float32) for b in bounds)
    extent = np.maximum(hi - lo, 1e-12)
    grid = np.zeros((r, r, r), np.float32)
    # splat: accumulate into every voxel whose center is within radius
    # (vectorized over points per offset; offsets bounded by radius)
    vox = extent / r
    reach = np.maximum((radius / vox).astype(int), 0)
    base = ((pts - lo) / extent * r - 0.5)
    base_i = np.floor(base).astype(int)
    rx, ry, rz = (int(min(k, r)) for k in reach)
    for dx in range(-rx, rx + 1):
        for dy in range(-ry, ry + 1):
            for dz in range(-rz, rz + 1):
                idx = base_i + (dx, dy, dz)
                ok = ((idx >= 0) & (idx < r)).all(-1)
                centers = lo + (idx + 0.5) * vox
                d2 = ((centers - pts) ** 2).sum(-1)
                ok &= d2 <= radius * radius
                if ok.any():
                    np.add.at(grid, tuple(idx[ok].T), 1.0)
    if grid.max() > 0:
        grid /= grid.max()
    return grid, lo.astype(np.float32), (1.0 / extent).astype(np.float32)


def sample_grid3d(grid, lo, inv_extent, P):
    """Trilinear 3D grid sample at world/object points P (..., 3).
    grid: (RX, RY, RZ) — non-cubic supported (VDB grids). NOTE perf:
    8 dynamic gathers per call — fine for surface shading; inside a
    Woodcock loop prefer lowering `steps`."""
    rx, ry, rz = grid.shape
    r3 = jnp.asarray([rx, ry, rz], jnp.float32)
    q = (P - lo) * inv_extent * r3 - 0.5
    q0 = jnp.floor(q).astype(jnp.int32)
    f = q - q0
    flat = grid.reshape(-1)

    def at(ix, iy, iz):
        ok = ((ix >= 0) & (ix < rx) & (iy >= 0) & (iy < ry)
              & (iz >= 0) & (iz < rz))
        lin = jnp.clip((ix * ry + iy) * rz + iz, 0, rx * ry * rz - 1)
        return jnp.where(ok, flat[lin], 0.0)

    x0, y0, z0 = q0[..., 0], q0[..., 1], q0[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c = 0.0
    for ddx in (0, 1):
        for ddy in (0, 1):
            for ddz in (0, 1):
                w = ((fx if ddx else 1 - fx) * (fy if ddy else 1 - fy)
                     * (fz if ddz else 1 - fz))
                c = c + w * at(x0 + ddx, y0 + ddy, z0 + ddz)
    return c
