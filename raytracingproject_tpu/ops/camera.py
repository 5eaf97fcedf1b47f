"""Camera ray generation (ref: kernel/kernel_camera.h).

Batched over a raster-position wavefront: perspective (DoF aperture with
bokeh blades, focal plane), orthographic, panorama (equirect/fisheye/
mirrorball), camera motion blur (decomposed-transform slerp) and rolling
shutter — the reference's camera_sample_* suite as fused VPU math.
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import jax.numpy as jnp

from raytracingproject_tpu.utils import math as um
from raytracingproject_tpu.utils import transform as tfm

CAMERA_PERSPECTIVE = 0
CAMERA_ORTHOGRAPHIC = 1
CAMERA_PANORAMA = 2

PANORAMA_EQUIRECTANGULAR = 0
PANORAMA_FISHEYE_EQUIDISTANT = 1
PANORAMA_FISHEYE_EQUISOLID = 2
PANORAMA_MIRRORBALL = 3


def _apply_t(m, p):
    # exact component math — a batched tiny float32 @ may run in TF32
    # on the GPU (see utils/math.py mat34_point)
    return um.mat34_point(m[..., :3, :4], p)


def _apply_d(m, d):
    return um.mat34_dir(m[..., :3, :4], d)


def camera_sample_ray(cam, raster_x, raster_y, lens_u, lens_v, time_u):
    """Generate world-space rays.

    cam: flattened camera record (models/camera.py Camera.update()).
    raster_x/y: (N,) raster coords (already filter-jittered).
    lens_u/v: (N,) DoF aperture samples; time_u: (N,) shutter sample.
    Returns dict(o, d, tmin, tmax, time).
    """
    ctype = int(cam["type"])
    r2c = cam["raster_to_camera"]
    ones = jnp.ones_like(raster_x)
    praster = jnp.stack([raster_x, raster_y, ones], -1)

    if ctype == CAMERA_PERSPECTIVE:
        pcam = _apply_t(r2c, praster)
        d = jnp.concatenate([pcam[..., 0:2], ones[..., None]], -1)
        o = jnp.zeros_like(d)
        aperture = float(cam["aperturesize"])
        if aperture > 0.0:
            # DoF (ref: kernel_camera.h camera_sample_perspective dof)
            blades = int(cam["blades"])
            if blades >= 3:
                lx, ly = um.regular_polygon_sample(
                    float(blades), float(cam["bladesrotation"]), lens_u, lens_v)
            else:
                lx, ly = um.concentric_sample_disk(lens_u, lens_v)
            ratio = float(cam["aperture_ratio"])
            lx = lx * aperture
            ly = ly * aperture / max(ratio, 1e-6)
            ft = float(cam["focaldistance"]) / jnp.maximum(d[..., 2], 1e-8)
            pfocus = d * ft[..., None]
            o = jnp.stack([lx, ly, jnp.zeros_like(lx)], -1)
            d = pfocus - o
        d = um.normalize(d)
    elif ctype == CAMERA_ORTHOGRAPHIC:
        pcam = _apply_t(r2c, praster)
        o = jnp.concatenate([pcam[..., 0:2],
                             jnp.zeros_like(ones)[..., None]], -1)
        d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], prec.FT), o.shape)
    else:  # panorama
        uvw = _apply_t(r2c, praster)
        u, v = uvw[..., 0], uvw[..., 1]
        ptype = int(cam["panorama_type"])
        if ptype == PANORAMA_EQUIRECTANGULAR:
            lo_min, lo_max, la_min, la_max = [float(x) for x in cam["eq_bounds"]]
            phi = lo_min + u * (lo_max - lo_min)
            theta = la_min + v * (la_max - la_min)
            # Cycles camera space: z forward, x right, y up
            d = jnp.stack([jnp.cos(theta) * jnp.sin(phi),
                           jnp.sin(theta),
                           jnp.cos(theta) * jnp.cos(phi)], -1)
        elif ptype in (PANORAMA_FISHEYE_EQUIDISTANT, PANORAMA_FISHEYE_EQUISOLID):
            x = 2.0 * u - 1.0
            y = 2.0 * v - 1.0
            r = jnp.sqrt(x * x + y * y)
            if ptype == PANORAMA_FISHEYE_EQUIDISTANT:
                theta = r * float(cam["fisheye_fov"]) * 0.5
            else:
                lens = float(cam["fisheye_lens"])
                theta = 2.0 * jnp.arcsin(jnp.clip(r / (2.0 * max(lens, 1e-5)),
                                                  -1.0, 1.0))
            valid = r <= 1.0
            phi = jnp.arctan2(y, x)
            st = jnp.sin(theta)
            d = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi),
                           jnp.cos(theta)], -1)
            d = jnp.where(valid[..., None], d, 0.0)
            # fisheye camera looks down +z with screen xy
        else:  # mirrorball
            x = 2.0 * u - 1.0
            y = 2.0 * v - 1.0
            rho2 = x * x + y * y
            valid = rho2 <= 1.0
            z = um.safe_sqrt(1.0 - rho2)
            n = jnp.stack([x, y, z], -1)
            i = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0], prec.FT),
                                 n.shape)
            d = um.reflect(-i, n)
            d = jnp.where(valid[..., None], d, 0.0)
        o = jnp.zeros_like(d)

    # shutter time (ref: kernel_camera.h camera_sample with rolling shutter)
    time = time_u
    if int(cam["rolling_shutter_type"]) == 1:
        dur = float(cam["rolling_shutter_duration"])
        h = float(cam["height"])
        scan = 1.0 - raster_y / jnp.maximum(h, 1.0)
        time = scan * (1.0 - dur) + time_u * dur

    # camera -> world (motion-aware; piecewise over S decomposed steps,
    # ref: Camera::motion array)
    if int(cam["use_motion"]) == 1:
        c2w = tfm.motion_interpolate_steps(
            jnp.asarray(cam["motion_decomps"]), time,
            int(cam.get("motion_steps", 2)))
        o_w = _apply_t(c2w, o)
        d_w = um.normalize(_apply_d(c2w, d))
    else:
        c2w = cam["cam_to_world"]
        o_w = _apply_t(c2w, o)
        d_w = um.normalize(_apply_d(c2w, d))

    nearclip = float(cam["nearclip"])
    if ctype == CAMERA_PERSPECTIVE and nearclip > 0.0:
        o_w = o_w + d_w * nearclip
    cliplen = float(cam["cliplength"])
    tmax = jnp.full_like(raster_x, cliplen if cliplen > 0 else um.RAY_TMAX)
    return {"o": o_w, "d": d_w,
            "tmin": jnp.zeros_like(raster_x), "tmax": tmax, "time": time}
