"""Affine transforms as 3x4 matrices (ref: util/util_transform.h).

Host-side construction/composition uses NumPy (scene flattening runs on
host at sync time, like the reference's ObjectManager); device-side
application helpers accept jnp arrays of packed (..., 3, 4) transforms so
instanced geometry can transform ray batches with one einsum.

Also implements motion-blur transform decomposition
(ref: util_transform.cpp transform_motion_decompose): a transform is
split into (rotation quaternion, translation, scale/shear 4x4-lite) so
per-ray time interpolation slerps rotations instead of blending matrices.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

IDENTITY = np.array([[1, 0, 0, 0],
                     [0, 1, 0, 0],
                     [0, 0, 1, 0]], dtype=np.float32)


def identity():
    return IDENTITY.copy()


def translate(x, y=None, z=None):
    if y is None:
        x, y, z = x
    t = identity()
    t[:, 3] = (x, y, z)
    return t


def scale(x, y=None, z=None):
    if y is None:
        if np.isscalar(x):
            x = (x, x, x)
        x, y, z = x
    t = identity()
    t[0, 0], t[1, 1], t[2, 2] = x, y, z
    return t


def rotate(angle, axis):
    """Rotation by `angle` radians about `axis`. ref: transform_rotate."""
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0.0:
        return identity()
    x, y, z = axis / n
    s, c = np.sin(angle), np.cos(angle)
    t = 1.0 - c
    m = np.array([
        [x * x * t + c, x * y * t - z * s, x * z * t + y * s, 0.0],
        [y * x * t + z * s, y * y * t + c, y * z * t - x * s, 0.0],
        [z * x * t - y * s, z * y * t + x * s, z * z * t + c, 0.0],
    ], dtype=np.float32)
    return m


def compose(a, b):
    """Return transform applying b first, then a (a @ b)."""
    a4 = to_4x4(a)
    b4 = to_4x4(b)
    return (a4 @ b4)[:3].astype(np.float32)


def to_4x4(t):
    m = np.eye(4, dtype=np.float64)
    m[:3] = np.asarray(t, np.float64)
    return m


def inverse(t):
    """Invert a 3x4 affine transform. ref: transform_inverse."""
    m = np.linalg.inv(to_4x4(t))
    return m[:3].astype(np.float32)


def look_at(position, look, up):
    """Camera-style look-at matrix (ref: app/cycles_xml.cpp:89 transform
    convention: camera looks down +z with y up in camera space)."""
    position = np.asarray(position, np.float64)
    direction = np.asarray(look, np.float64) - position
    direction /= max(np.linalg.norm(direction), 1e-12)
    up = np.asarray(up, np.float64)
    right = np.cross(direction, up)
    nr = np.linalg.norm(right)
    if nr < 1e-9:
        right = np.array([1.0, 0.0, 0.0])
    else:
        right /= nr
    new_up = np.cross(right, direction)
    m = np.stack([right, new_up, direction, position], axis=1)
    return m.astype(np.float32)


def _xp(*arrays):
    """np for pure-host inputs, jnp when any operand is a jax array —
    the component math below must NOT use batched `@`: at default
    precision a float32 matmul may run in TF32 on the GPU (see
    utils/math.py mat34_point)."""
    import jax
    return jnp if any(isinstance(a, jax.Array) for a in arrays) else np


def transform_point(t, p):
    """Apply (..., 3, 4) transform(s) to (..., 3) point(s) — jnp or np."""
    xp = _xp(t, p)
    return xp.stack(
        [t[..., i, 0] * p[..., 0] + t[..., i, 1] * p[..., 1]
         + t[..., i, 2] * p[..., 2] + t[..., i, 3] for i in range(3)], -1)


def transform_direction(t, d):
    xp = _xp(t, d)
    return xp.stack(
        [t[..., i, 0] * d[..., 0] + t[..., i, 1] * d[..., 1]
         + t[..., i, 2] * d[..., 2] for i in range(3)], -1)


def transform_normal(t_inv, n):
    """Normals transform by the inverse transpose: pass the *inverse*."""
    xp = _xp(t_inv, n)
    return xp.stack(
        [t_inv[..., 0, i] * n[..., 0] + t_inv[..., 1, i] * n[..., 1]
         + t_inv[..., 2, i] * n[..., 2] for i in range(3)], -1)


# ---------------------------------------------------------------------------
# Motion decomposition (host side; ref: util_transform.cpp)
# ---------------------------------------------------------------------------

def matrix_to_quat(m):
    """Rotation 3x3 -> quaternion (w, x, y, z)."""
    m = np.asarray(m, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0.0:
        s = np.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([w, x, y, z])


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xnp = jnp if hasattr(q, "device") or isinstance(q, jnp.ndarray) else np
    r0 = xnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1)
    r1 = xnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1)
    r2 = xnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1)
    return xnp.stack([r0, r1, r2], axis=-2)


def decompose(t):
    """3x4 -> (quat[4], translation[3], scale 3x3 flattened[9]).

    ref: transform_decompose. Returns a flat float32[16] record so motion
    steps pack into one device row.
    """
    t = np.asarray(t, np.float64)
    rot_scale = t[:3, :3]
    # Polar-ish decomposition via SVD: R = U V^T, S = V diag(s) V^T
    u, s, vt = np.linalg.svd(rot_scale)
    r = u @ vt
    if np.linalg.det(r) < 0.0:
        u[:, -1] = -u[:, -1]
        s[-1] = -s[-1]
        r = u @ vt
    scale_m = vt.T @ np.diag(s) @ vt
    q = matrix_to_quat(r)
    out = np.zeros(16, np.float32)
    out[0:4] = q
    out[4:7] = t[:3, 3]
    out[7:16] = scale_m.reshape(-1)
    return out


def motion_interpolate(decomp_a, decomp_b, t):
    """Interpolate two decomposed transforms at time t in [0,1] -> (...,3,4).

    jnp, batched. ref: kernel/kernel_compat transform_motion_interpolate.
    """
    qa, qb = decomp_a[..., 0:4], decomp_b[..., 0:4]
    # slerp with fallback to nlerp for near-parallel quats
    d = jnp.sum(qa * qb, axis=-1, keepdims=True)
    qb = jnp.where(d < 0.0, -qb, qb)
    d = jnp.abs(d)
    theta = jnp.arccos(jnp.clip(d, -1.0, 1.0))
    sin_theta = jnp.sin(theta)
    use_slerp = sin_theta > 1e-5
    tt = jnp.asarray(t)[..., None]
    wa = jnp.where(use_slerp, jnp.sin((1.0 - tt) * theta) / jnp.where(use_slerp, sin_theta, 1.0), 1.0 - tt)
    wb = jnp.where(use_slerp, jnp.sin(tt * theta) / jnp.where(use_slerp, sin_theta, 1.0), tt)
    q = wa * qa + wb * qb
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    trans = (1.0 - tt) * decomp_a[..., 4:7] + tt * decomp_b[..., 4:7]
    sm = ((1.0 - tt) * decomp_a[..., 7:16] + tt * decomp_b[..., 7:16])
    sm = sm.reshape(sm.shape[:-1] + (3, 3))
    rot = quat_to_matrix(q)
    # precision='highest': the default float32 matmul may run in TF32
    # on the GPU, which breaks the fp32 accuracy contract for transforms.
    m = jnp.matmul(rot, sm, precision="highest")
    return jnp.concatenate([m, trans[..., None]], axis=-1)


def quick_inverse_jnp(m):
    """Batched inverse of affine (..., 3, 4) transforms (jnp).
    ref: transform_quick_inverse — adjugate/determinant 3x3 + -R^-1 t."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    c00 = r[..., 1, 1] * r[..., 2, 2] - r[..., 1, 2] * r[..., 2, 1]
    c01 = r[..., 1, 2] * r[..., 2, 0] - r[..., 1, 0] * r[..., 2, 2]
    c02 = r[..., 1, 0] * r[..., 2, 1] - r[..., 1, 1] * r[..., 2, 0]
    det = r[..., 0, 0] * c00 + r[..., 0, 1] * c01 + r[..., 0, 2] * c02
    inv_det = jnp.where(jnp.abs(det) > 1e-18,
                        1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    adj = jnp.stack([
        jnp.stack([c00,
                   r[..., 0, 2] * r[..., 2, 1] - r[..., 0, 1] * r[..., 2, 2],
                   r[..., 0, 1] * r[..., 1, 2] - r[..., 0, 2] * r[..., 1, 1]],
                  -1),
        jnp.stack([c01,
                   r[..., 0, 0] * r[..., 2, 2] - r[..., 0, 2] * r[..., 2, 0],
                   r[..., 0, 2] * r[..., 1, 0] - r[..., 0, 0] * r[..., 1, 2]],
                  -1),
        jnp.stack([c02,
                   r[..., 0, 1] * r[..., 2, 0] - r[..., 0, 0] * r[..., 2, 1],
                   r[..., 0, 0] * r[..., 1, 1] - r[..., 0, 1] * r[..., 1, 0]],
                  -1),
    ], -2)
    rinv = adj * inv_det[..., None, None]
    tinv = -(rinv @ t[..., None])[..., 0]
    return jnp.concatenate([rinv, tinv[..., None]], -1)


def _np_quat_slerp(qa, qb, t):
    """NumPy quaternion slerp (shortest arc), matching the jnp
    motion_interpolate quat handling."""
    qa = np.asarray(qa, np.float64)
    qb = np.asarray(qb, np.float64)
    d = float(np.dot(qa, qb))
    if d < 0.0:
        qb, d = -qb, -d
    d = min(d, 1.0)
    theta = np.arccos(d)
    if np.sin(theta) > 1e-5:
        wa = np.sin((1.0 - t) * theta) / np.sin(theta)
        wb = np.sin(t * theta) / np.sin(theta)
    else:
        wa, wb = 1.0 - t, t
    q = wa * qa + wb * qb
    return q / max(np.linalg.norm(q), 1e-12)


def decomp_interp(da, db, t):
    """Interpolate two decomposed transforms (flat 16-float records
    from decompose) at t in [0,1] — quat slerp + linear trans/scale.
    NumPy host-side twin of motion_interpolate's per-step math."""
    out = np.zeros(16, np.float32)
    out[0:4] = _np_quat_slerp(da[0:4], db[0:4], t)
    out[4:16] = (1.0 - t) * np.asarray(da[4:16]) \
        + t * np.asarray(db[4:16])
    return out


def resample_motion_decomps(tfms, steps):
    """Resample an object's transform path (list of 3x4 at uniform
    times) onto `steps` uniform decomposed steps (ref: the motion-step
    arrays of object.cpp — objects with fewer declared steps are
    slerp-resampled onto the scene-wide grid; exact at shared grid
    points)."""
    base = [decompose(t) for t in tfms]
    if len(base) == steps:
        return base
    s_in = len(base) - 1
    out = []
    for j in range(steps):
        tt = j / (steps - 1) * s_in
        k = min(int(np.floor(tt)), s_in - 1)
        f = tt - k
        out.append(base[k] if f == 0.0
                   else decomp_interp(base[k], base[k + 1], f))
    return out


def motion_interpolate_steps(decomps, time, steps):
    """Piecewise interpolation over S decomposed steps packed in one
    row (..., S*16): pick the lane's segment with a select chain (the
    steps are already in-lane after the row fetch — no extra gathers),
    then slerp inside it. steps == 2 is exactly motion_interpolate."""
    if steps == 2:
        return motion_interpolate(decomps[..., 0:16],
                                  decomps[..., 16:32], time)
    s1 = steps - 1
    tt = jnp.asarray(time) * s1
    j = jnp.clip(jnp.floor(tt), 0.0, float(s1 - 1))
    frac = tt - j
    da = jnp.zeros(decomps.shape[:-1] + (16,), decomps.dtype)
    db = da
    for k in range(s1):
        sel = (j == k)[..., None]
        da = jnp.where(sel, decomps[..., 16 * k:16 * k + 16], da)
        db = jnp.where(sel, decomps[..., 16 * (k + 1):16 * (k + 2)], db)
    return motion_interpolate(da, db, frac)
