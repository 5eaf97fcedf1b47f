"""Vector math over batched (..., 3) arrays.

Analog of the reference float3/float4 math headers
(ref: util/util_math_float3.h, util/util_math.h). Instead of a scalar
float3 type, every helper operates on arrays whose last axis is the
vector axis, so the same code path serves a single vector, an (N, 3) SoA
ray wavefront, or an (H, W, 3) image. All math is float32: the renderer's
accuracy contract (RMSE <= 1e-3 vs the CPU reference) requires fp32
accumulation; bf16 is used only in explicitly opted-in kernels.
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import jax
import jax.numpy as jnp

# ref: util/util_math.h constants
M_PI = 3.14159265358979323846
M_2PI = 2.0 * M_PI
M_4PI = 4.0 * M_PI
M_PI_2 = M_PI / 2.0
M_1_PI = 1.0 / M_PI
M_1_2PI = 1.0 / M_2PI

# Large-but-finite ray distance (fp32 safe).
RAY_TMAX = 1e30


def make_float3(x, y, z):
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, prec.FT),
        jnp.asarray(y, prec.FT),
        jnp.asarray(z, prec.FT)), axis=-1)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def dot3(a, b):
    """Dot product keeping the trailing axis (shape (..., 1))."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(dot(a, a))


def length_squared(a):
    return dot(a, a)


def normalize(a):
    # ref: util_math_float3.h normalize; rsqrt keeps it fused on the VPU.
    return a * jax.lax.rsqrt(jnp.maximum(dot3(a, a), 1e-38))


def safe_normalize(a):
    """Normalize; returns input unchanged for (near-)zero vectors.

    ref: util_math_float3.h safe_normalize.
    """
    t = dot3(a, a)
    return jnp.where(t > 1e-38, a * jax.lax.rsqrt(jnp.maximum(t, 1e-38)), a)


def normalize_len(a):
    """Returns (normalized, length). ref: normalize_len."""
    l = length(a)
    return a * (1.0 / jnp.maximum(l, 1e-38))[..., None], l


def distance(a, b):
    return length(a - b)


def reflect(incident, normal):
    """Mirror reflection of *incoming-to-surface* direction.

    ref: util_math_float3.h reflect (Cycles convention: both the incident
    and reflected vectors point away from the surface).
    """
    return incident - 2.0 * dot3(incident, normal) * normal


def refract(incident, normal, eta):
    """Refract direction (incident pointing toward surface); returns
    (refracted_dir, total_internal_reflection_mask).
    """
    cos_i = -dot(incident, normal)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    k = jnp.maximum(k, 0.0)
    t = eta * incident + (eta * cos_i - jnp.sqrt(k))[..., None] * normal
    return t, tir


def faceforward(n, i):
    """Flip n so it faces against direction i (dot(n, i) < 0)."""
    return jnp.where(dot3(n, i) > 0.0, -n, n)


def lerp(a, b, t):
    return a + (b - a) * t


def clamp(x, lo, hi):
    return jnp.clip(x, lo, hi)


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def mix3(a, b, t):
    """Lerp with scalar t broadcast over trailing vector axis."""
    return a + (b - a) * jnp.asarray(t)[..., None]


def average(a):
    return jnp.mean(a, axis=-1)


def is_zero(a):
    return jnp.all(a == 0.0, axis=-1)


def max_component(a):
    return jnp.max(a, axis=-1)


def safe_divide(a, b, fallback=0.0):
    return jnp.where(b != 0.0, a / jnp.where(b == 0.0, 1.0, b), fallback)


def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def safe_acos(x):
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


def safe_asin(x):
    return jnp.arcsin(jnp.clip(x, -1.0, 1.0))


def rotate_around_axis(v, axis, angle):
    """Rodrigues rotation of v about unit axis by angle (radians)."""
    c = jnp.cos(angle)[..., None]
    s = jnp.sin(angle)[..., None]
    d = dot(axis, v)[..., None]
    return v * c + cross(axis, v) * s + axis * d * (1.0 - c)


def sqr(x):
    return x * x


# --- exact small-matrix transforms -----------------------------------
# A batched (..., 3, 3) @ (..., 3, 1) float32 matmul at default
# precision may run in TF32 on the GPU (about three decimal digits; a
# reduced-precision matmul once measured 1.3e-3 relative error in
# camera ray directions, enough to shift silhouettes by ~0.05 px).
# Geometry transforms therefore use explicit component math: exact
# f32 elementwise ops that fuse with their neighbours.

def mat34_point(m, p):
    """(..., 3, 4) affine transform applied to points (..., 3)."""
    return jnp.stack(
        [m[..., i, 0] * p[..., 0] + m[..., i, 1] * p[..., 1]
         + m[..., i, 2] * p[..., 2] + m[..., i, 3] for i in range(3)], -1)


def mat34_dir(m, d):
    """(..., 3, 4) (or (..., 3, 3)) rotation part applied to vectors."""
    return jnp.stack(
        [m[..., i, 0] * d[..., 0] + m[..., i, 1] * d[..., 1]
         + m[..., i, 2] * d[..., 2] for i in range(3)], -1)


def mat33T_dir(m, n):
    """Transpose of the 3x3 part applied to vectors (normal transform:
    pass the inverse matrix)."""
    return jnp.stack(
        [m[..., 0, i] * n[..., 0] + m[..., 1, i] * n[..., 1]
         + m[..., 2, i] * n[..., 2] for i in range(3)], -1)


def make_orthonormals(n):
    """Build a (t, b) tangent frame for unit normal n.

    Branch-free Duff et al. / Pixar orthonormal basis — unlike the
    reference's branchy version (ref: util_math.h make_orthonormals) this
    maps to pure VPU select ops.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], axis=-1)
    bt = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return t, bt


def to_local(v, t, b, n):
    """World direction -> tangent-space (t, b, n) coordinates."""
    return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)


def from_local(v, t, b, n):
    """Tangent-space direction -> world."""
    return (v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n)


def sample_cos_hemisphere(n, u1, u2):
    """Cosine-weighted hemisphere sample around n -> (dir, pdf).

    ref: kernel/kernel_montecarlo.h sample_cos_hemisphere.
    """
    r = jnp.sqrt(u1)
    phi = M_2PI * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = safe_sqrt(1.0 - u1)
    t, b = make_orthonormals(n)
    d = x[..., None] * t + y[..., None] * b + z[..., None] * n
    return d, z * M_1_PI


def sample_uniform_sphere(u1, u2):
    """Uniform direction on the sphere. ref: sample_uniform_sphere."""
    z = 1.0 - 2.0 * u1
    r = safe_sqrt(1.0 - z * z)
    phi = M_2PI * u2
    return make_float3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def sample_uniform_hemisphere(n, u1, u2):
    """Uniform hemisphere around n -> (dir, pdf)."""
    z = u1
    r = safe_sqrt(1.0 - z * z)
    phi = M_2PI * u2
    t, b = make_orthonormals(n)
    d = (r * jnp.cos(phi))[..., None] * t + (r * jnp.sin(phi))[..., None] * b \
        + z[..., None] * n
    return d, jnp.full_like(u1, M_1_2PI)


def concentric_sample_disk(u1, u2):
    """Concentric (Shirley) unit-disk mapping -> (x, y).

    ref: kernel/kernel_montecarlo.h concentric_sample_disk. Branch-free.
    """
    a = 2.0 * u1 - 1.0
    b = 2.0 * u2 - 1.0
    use_a = jnp.abs(a) > jnp.abs(b)
    r = jnp.where(use_a, a, b)
    safe = jnp.where(use_a, jnp.where(a == 0.0, 1.0, a),
                     jnp.where(b == 0.0, 1.0, b))
    phi = jnp.where(use_a, (M_PI / 4.0) * (b / safe),
                    (M_PI / 2.0) - (M_PI / 4.0) * (a / safe))
    zero = (a == 0.0) & (b == 0.0)
    r = jnp.where(zero, 0.0, r)
    return r * jnp.cos(phi), r * jnp.sin(phi)


def regular_polygon_sample(corners, rotation, u1, u2):
    """Sample a regular polygon with `corners` sides (bokeh blades).

    ref: kernel/kernel_montecarlo.h regular_polygon_sample.
    """
    u = u1 * corners
    side = jnp.floor(u)
    u = u - side
    v = u2
    # Map (u, v) uniformly onto triangle fan sector.
    flip = u + v > 1.0
    u = jnp.where(flip, 1.0 - u, u)
    v = jnp.where(flip, 1.0 - v, v)
    angle0 = (side / corners) * M_2PI + rotation
    angle1 = ((side + 1.0) / corners) * M_2PI + rotation
    p0 = jnp.stack([jnp.cos(angle0), jnp.sin(angle0)], axis=-1)
    p1 = jnp.stack([jnp.cos(angle1), jnp.sin(angle1)], axis=-1)
    p = u[..., None] * p0 + v[..., None] * p1
    return p[..., 0], p[..., 1]


def power_heuristic(a, b):
    """MIS power heuristic (beta = 2). ref: kernel/kernel_emission.h:135."""
    t = a * a
    return safe_divide(t, t + b * b, 0.0)


def balance_heuristic(a, b):
    return safe_divide(a, a + b, 0.0)


def direction_to_equirectangular(d):
    """Unit direction -> (u, v) in [0,1]^2 equirect.

    ref: kernel/kernel_projection.h direction_to_equirectangular_range.
    """
    u = -jnp.arctan2(d[..., 1], d[..., 0]) * M_1_2PI + 0.5
    v = jnp.arctan2(d[..., 2], jnp.hypot(d[..., 0], d[..., 1])) * M_1_PI + 0.5
    return u, v


def equirectangular_to_direction(u, v):
    """Inverse of direction_to_equirectangular."""
    phi = M_PI * (1.0 - 2.0 * u)
    theta = M_PI * (v - 0.5)
    ct = jnp.cos(theta)
    return make_float3(ct * jnp.cos(phi), ct * jnp.sin(phi), jnp.sin(theta))


def triangle_area(v0, v1, v2):
    return 0.5 * length(cross(v1 - v0, v2 - v0))


def triangle_normal(v0, v1, v2):
    return safe_normalize(cross(v1 - v0, v2 - v0))


def luminance(rgb):
    """Rec.709 luminance. ref: util_color.h linear_rgb_to_gray."""
    return (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
            + 0.0722 * rgb[..., 2])


def linear_to_srgb(c):
    """ref: util_color.h color_linear_to_srgb."""
    c = jnp.maximum(c, 0.0)
    return jnp.where(c < 0.0031308, c * 12.92,
                     1.055 * jnp.power(jnp.maximum(c, 1e-10), 1.0 / 2.4) - 0.055)


def srgb_to_linear(c):
    c = jnp.maximum(c, 0.0)
    return jnp.where(c < 0.04045, c / 12.92,
                     jnp.power((c + 0.055) / 1.055, 2.4))


def fresnel_dielectric_cos(cosi, eta):
    """Dielectric Fresnel from cos(theta_i). ref: kernel/closure/bsdf_util.h."""
    c = jnp.abs(cosi)
    g2 = eta * eta - 1.0 + c * c
    g = safe_sqrt(g2)
    a = safe_divide(g - c, g + c, 1.0)
    b = safe_divide(c * (g + c) - 1.0, c * (g - c) + 1.0, 0.0)
    f = 0.5 * a * a * (1.0 + b * b)
    return jnp.where(g2 > 0.0, f, 1.0)  # total internal reflection


def fresnel_schlick(f0, cos_theta):
    m = jnp.clip(1.0 - cos_theta, 0.0, 1.0)
    m2 = m * m
    return f0 + (1.0 - f0) * (m2 * m2 * m)
