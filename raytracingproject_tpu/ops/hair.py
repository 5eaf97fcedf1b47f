"""Principled hair BSDF (capability ref: kernel/closure/
bsdf_hair_principled.h; the model itself is re-implemented from the
published paper: Chiang, Bitterli, Tappan, Burley, "A Practical and
Controllable Hair and Fur Model for Production Path Tracing",
EGSR 2016 — R/TT/TRT lobes + a closed-form residual lobe, longitudinal
spherical-Gaussian M_p, azimuthal trimmed-logistic N_p).

Everything is batched SoA over the wavefront: the four lobes are
evaluated densely with select-reductions (no per-lane branching), which
is the wavefront shape — ~60 fused elementwise ops per lane, no
gathers.

Conventions: the local hair frame is X = curve tangent, (Y, Z) the
normal plane with Z along the faced ribbon normal; sin(theta) = w.x;
h in [-1, 1] is the cross-fiber offset (from the ribbon u coordinate).
`hair_eval` returns f*|cos| matching ops/bsdf.py's convention: the
energy estimator is f_cos / pdf. Energy conservation: with sigma_a = 0
the attenuations telescope to exactly 1 (residual lobe carries the
geometric tail), so a white furnace stays at 1 for any roughness.
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import jax.numpy as jnp

from raytracingproject_tpu.utils import math as um

SQRT_PI_OVER_8 = 0.626657069


def roughness_to_v(beta_m):
    """Longitudinal roughness -> M_p variance (paper eq. 7 fit)."""
    t = 0.726 * beta_m + 0.812 * beta_m ** 2 + 3.7 * beta_m ** 20
    return jnp.maximum(t * t, 1e-7)


def roughness_to_s(beta_n):
    """Azimuthal roughness -> logistic scale (paper eq. 8 fit)."""
    return jnp.maximum(
        SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n ** 2
                          + 5.372 * beta_n ** 22), 1e-7)


def _i0(x):
    """Modified Bessel I0, power series (accurate for the |x| <= 12
    range used by the non-log branch)."""
    val = jnp.ones_like(x)
    x2 = x * x
    term = jnp.ones_like(x)
    for i in range(1, 10):
        term = term * x2 / (4.0 * i * i)
        val = val + term
    return val


def _log_i0(x):
    """log I0(x), stable for large x (asymptotic expansion)."""
    x = jnp.abs(x)
    big = x > 12.0
    asym = x + 0.5 * (-jnp.log(2.0 * jnp.pi)
                      - jnp.log(jnp.maximum(x, 1e-6)) + 1.0 / (8.0 * x + 1e-6))
    return jnp.where(big, asym, jnp.log(_i0(jnp.minimum(x, 12.0))))


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering M_p (paper eq. 11; log-space for small
    variance to avoid sinh overflow)."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small = v <= 0.1
    v_c = jnp.maximum(v, 1e-7)
    mp_small = jnp.exp(_log_i0(a) - b - 1.0 / v_c + 0.6931
                       + jnp.log(1.0 / (2.0 * v_c)))
    big_v = jnp.maximum(v, 0.05)  # clamp the non-selected branch
    mp_big = jnp.exp(-jnp.minimum(b, 80.0)) * _i0(jnp.clip(a, -12.0, 12.0)) \
        / (jnp.sinh(1.0 / big_v) * 2.0 * big_v)
    return jnp.where(small, mp_small, mp_big)


def _logistic(x, s):
    x = jnp.abs(x) / s
    e = jnp.exp(-jnp.minimum(x, 80.0))
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + jnp.exp(-jnp.clip(x / s, -80.0, 80.0)))


def _trimmed_logistic(x, s):
    """Logistic normalized on [-pi, pi] (paper: azimuthal detector)."""
    norm = _logistic_cdf(jnp.pi, s) - _logistic_cdf(-jnp.pi, s)
    return _logistic(x, s) / jnp.maximum(norm, 1e-9)


def _sample_trimmed_logistic(u, s):
    k = _logistic_cdf(jnp.pi, s) - _logistic_cdf(-jnp.pi, s)
    c = u * k + _logistic_cdf(-jnp.pi, s)
    x = -s * jnp.log(jnp.maximum(1.0 / jnp.maximum(c, 1e-9) - 1.0, 1e-9))
    return jnp.clip(x, -jnp.pi, jnp.pi)


def _wrap_phi(dphi):
    """Wrap an angle difference to [-pi, pi]."""
    return dphi - 2.0 * jnp.pi * jnp.floor((dphi + jnp.pi)
                                           / (2.0 * jnp.pi))


def _fresnel_dielectric(cos_i, eta):
    """Unpolarized Fresnel for external incidence (scalar eta)."""
    cos_i = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)
    sin2_t = jnp.maximum(1.0 - cos_i * cos_i, 0.0) / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    rs = (cos_i - eta * cos_t) / jnp.maximum(cos_i + eta * cos_t, 1e-9)
    rp = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, 1e-9)
    f = 0.5 * (rs * rs + rp * rp)
    return jnp.where(tir, 1.0, jnp.clip(f, 0.0, 1.0))


def _hair_geometry(h, sin_to, cos_to, sigma_a, eta):
    """Shared per-lane geometry: gamma_o/t, transmittance T, and the
    four lobe attenuations A_p (N, 4, 3)."""
    h = jnp.clip(h, -0.9999, 0.9999)
    gamma_o = jnp.arcsin(h)
    # modified index for the inclined ray (paper eq. 4)
    etap = jnp.sqrt(jnp.maximum(eta * eta - sin_to * sin_to, 1e-9)) \
        / jnp.maximum(cos_to, 1e-6)
    sin_gt = jnp.clip(h / etap, -0.9999, 0.9999)
    cos_gt = jnp.sqrt(jnp.maximum(1.0 - sin_gt * sin_gt, 0.0))
    gamma_t = jnp.arcsin(sin_gt)
    # refracted longitudinal angle
    sin_tt = sin_to / eta
    cos_tt = jnp.sqrt(jnp.maximum(1.0 - sin_tt * sin_tt, 1e-6))
    # single-pass transmittance through the pigment (paper eq. 5)
    T = jnp.exp(-sigma_a * (2.0 * cos_gt / cos_tt)[..., None])
    # Fresnel at the actual incidence (both inclination and offset)
    cos_go = jnp.sqrt(jnp.maximum(1.0 - h * h, 0.0))
    f = _fresnel_dielectric(cos_to * cos_go, eta)[..., None]
    a0 = jnp.broadcast_to(f, T.shape)
    one_mf2 = (1.0 - f) * (1.0 - f)
    a1 = one_mf2 * T
    a2 = a1 * T * f
    # residual lobe: closed-form geometric tail keeps Sum A_p exact
    tf = jnp.clip(T * f, 0.0, 0.9999)
    a3 = a2 * tf / (1.0 - tf)
    ap = jnp.stack([a0, a1, a2, a3], axis=-2)   # (N, 4, 3)
    return gamma_o, gamma_t, ap


def _tilted_sincos(sin_to, cos_to, alpha):
    """Per-lobe cuticle-tilt rotations of theta_o: R by -2a, TT by +a,
    TRT by +4a (paper sec. 4.1). Returns lists indexed by lobe."""
    s1, c1 = jnp.sin(alpha), jnp.cos(alpha)
    s2, c2 = 2.0 * s1 * c1, c1 * c1 - s1 * s1            # 2a
    s4, c4 = 2.0 * s2 * c2, c2 * c2 - s2 * s2            # 4a
    sins = [sin_to * c2 - cos_to * s2,    # p=0: -2a ... sign via minus
            sin_to * c1 + cos_to * s1,    # p=1: +a
            sin_to * c4 + cos_to * s4,    # p=2: +4a
            sin_to]                       # residual: untitled
    coss = [cos_to * c2 + sin_to * s2,
            cos_to * c1 - sin_to * s1,
            cos_to * c4 - sin_to * s4,
            cos_to]
    return sins, [jnp.abs(c) for c in coss]


def _lobe_v(v):
    return [v, 0.25 * v, 4.0 * v, 4.0 * v]


def _frame(T, Zf):
    """Hair local frame: X along the fiber, Z along the faced ribbon
    normal (orthogonalized), Y = Z x X."""
    X = um.safe_normalize(T)
    Z = um.safe_normalize(Zf - X * um.dot(Zf, X)[..., None])
    Y = um.cross(Z, X)
    return X, Y, Z


def _angles(w, X, Y, Z):
    sin_t = jnp.clip(um.dot(w, X), -1.0, 1.0)
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t * sin_t, 1e-7))
    phi = jnp.arctan2(um.dot(w, Z), um.dot(w, Y))
    return sin_t, cos_t, phi


def hair_eval(T, Zf, h, I, omega_in, sigma_a, v, s, alpha, eta):
    """Evaluate the 4-lobe sum. Returns (f_cos (N,3), pdf (N,))."""
    X, Y, Z = _frame(T, Zf)
    sin_to, cos_to, phi_o = _angles(I, X, Y, Z)
    sin_ti, cos_ti, phi_i = _angles(omega_in, X, Y, Z)
    gamma_o, gamma_t, ap = _hair_geometry(h, sin_to, cos_to, sigma_a, eta)
    sins, coss = _tilted_sincos(sin_to, cos_to, alpha)
    vs = _lobe_v(v)
    phi = phi_i - phi_o

    # lobe pick pdf from attenuation luminance (matches hair_sample)
    ap_lum = jnp.mean(ap, -1)                              # (N, 4)
    ap_pdf = ap_lum / jnp.maximum(jnp.sum(ap_lum, -1, keepdims=True),
                                  1e-12)

    f = jnp.zeros(T.shape[:-1] + (3,), prec.FT)
    pdf = jnp.zeros(T.shape[:-1], prec.FT)
    for p in range(4):
        mp = _mp(cos_ti, coss[p], sin_ti, sins[p], vs[p])
        if p < 3:
            phi_p = 2.0 * p * gamma_t - 2.0 * gamma_o + p * jnp.pi
            np_ = _trimmed_logistic(_wrap_phi(phi - phi_p), s)
        else:
            np_ = jnp.full_like(pdf, 1.0 / (2.0 * jnp.pi))
        f = f + mp[..., None] * ap[..., p, :] * np_[..., None]
        pdf = pdf + mp * np_ * ap_pdf[..., p]
    return f, pdf


def hair_sample(T, Zf, h, I, u1, u2, sigma_a, v, s, alpha, eta):
    """Sample an incident direction. Returns (omega (N,3), f_cos (N,3),
    pdf (N,), valid (N,))."""
    X, Y, Z = _frame(T, Zf)
    sin_to, cos_to, phi_o = _angles(I, X, Y, Z)
    gamma_o, gamma_t, ap = _hair_geometry(h, sin_to, cos_to, sigma_a, eta)
    sins, coss = _tilted_sincos(sin_to, cos_to, alpha)
    vs = _lobe_v(v)

    # demux the two uniforms into four (pbrt-style bit split; fine at
    # the stratification level the hash sampler provides)
    u_p = jnp.minimum(u1 * 16.0 - jnp.floor(u1 * 16.0), 0.999999)
    u_lobe = jnp.floor(u1 * 16.0) / 16.0 + 1.0 / 32.0
    u_t2 = jnp.minimum(u2 * 16.0 - jnp.floor(u2 * 16.0), 0.999999)
    u_phi = jnp.floor(u2 * 16.0) / 16.0 + 1.0 / 32.0

    ap_lum = jnp.mean(ap, -1)
    ap_pdf = ap_lum / jnp.maximum(jnp.sum(ap_lum, -1, keepdims=True),
                                  1e-12)
    cdf1 = ap_pdf[..., 0]
    cdf2 = cdf1 + ap_pdf[..., 1]
    cdf3 = cdf2 + ap_pdf[..., 2]
    p_sel = (u_lobe >= cdf1).astype(jnp.int32) \
        + (u_lobe >= cdf2).astype(jnp.int32) \
        + (u_lobe >= cdf3).astype(jnp.int32)

    def pick(lst):
        out = lst[0]
        for p in range(1, 4):
            out = jnp.where(p_sel == p, lst[p], out)
        return out

    v_p = pick([jnp.broadcast_to(jnp.asarray(x), sin_to.shape)
                for x in vs])
    sin_top = pick(sins)
    cos_top = pick(coss)

    # longitudinal sampling (paper appendix A)
    u_eps = jnp.clip(u_p, 1e-6, 1.0 - 1e-6)
    cos_theta = 1.0 + v_p * jnp.log(
        u_eps + (1.0 - u_eps) * jnp.exp(-2.0 / v_p))
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta ** 2, 0.0))
    cos_phi_l = jnp.cos(2.0 * jnp.pi * u_t2)
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi_l * cos_top
    sin_ti = jnp.clip(sin_ti, -1.0, 1.0)
    cos_ti = jnp.sqrt(jnp.maximum(1.0 - sin_ti * sin_ti, 1e-7))

    # azimuthal sampling
    dphi_log = _sample_trimmed_logistic(u_phi, s)
    phi_sel = jnp.zeros_like(sin_to)
    for p in range(3):
        phi_p = 2.0 * p * gamma_t - 2.0 * gamma_o + p * jnp.pi
        phi_sel = jnp.where(p_sel == p, phi_p + dphi_log, phi_sel)
    phi_sel = jnp.where(p_sel == 3,
                        2.0 * jnp.pi * u_phi - jnp.pi, phi_sel)
    phi_i = phi_o + phi_sel

    omega = sin_ti[..., None] * X \
        + (cos_ti * jnp.cos(phi_i))[..., None] * Y \
        + (cos_ti * jnp.sin(phi_i))[..., None] * Z
    omega = um.safe_normalize(omega)

    f, pdf = hair_eval(T, Zf, h, I, omega, sigma_a, v, s, alpha, eta)
    valid = (pdf > 1e-12) & (um.dot(T, T) > 0.25)
    return omega, f, pdf, valid
