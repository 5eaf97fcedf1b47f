"""BSDF sampling/evaluation over the closure union
(ref: kernel/closure/bsdf.h bsdf_sample/bsdf_eval dispatch,
kernel/kernel_shader.h shader_bsdf_sample/_shader_bsdf_multi_eval).

Lobes: Lambert diffuse (Oren-Nayar when roughness > 0), GGX microfacet
reflection with VNDF sampling, GGX microfacet refraction, and delta
transparent. Sampling follows the reference's multi-closure scheme:
pick a lobe proportional to its mean weight, sample a direction from
it, then evaluate ALL lobes at that direction and combine pdfs by the
pick probabilities — an unbiased mixture estimator that also yields the
pdf needed for MIS against light sampling.

Delta lobes (roughness ~ 0 and transparent) are flagged SINGULAR: their
contribution never appears in `bsdf_eval` (NEE cannot hit a delta), and
paths continuing through them skip MIS emission weighting, matching
PATH_RAY_SINGULAR semantics (ref: kernel_path_surface.h).

All directions follow the Cycles convention: I points from the surface
toward the viewer, omega_in toward the light.
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import numpy as np
import jax.numpy as jnp

from raytracingproject_tpu.utils import math as um

# sampled-lobe labels (ref: LABEL_* kernel/kernel_types.h)
LABEL_DIFFUSE = 1
LABEL_GLOSSY = 2
LABEL_TRANSMIT = 4
LABEL_SINGULAR = 8
LABEL_TRANSPARENT = 16
LABEL_VOLUME_SCATTER = 32

SHARP_ROUGHNESS = 1e-4  # below this a lobe is a delta


def _ggx_smith_lambda(cos_t, alpha2):
    c2 = cos_t * cos_t
    t2 = jnp.maximum(1.0 - c2, 0.0) / jnp.maximum(c2, 1e-12)
    return 0.5 * (jnp.sqrt(1.0 + alpha2 * t2) - 1.0)


def _ggx_d(cos_h, alpha2):
    c2 = cos_h * cos_h
    den = c2 * (alpha2 - 1.0) + 1.0
    return alpha2 / jnp.maximum(um.M_PI * den * den, 1e-12)


def _sample_ggx_vndf(v_local, alpha, u1, u2):
    """Heitz 2018 visible-normal GGX sampling; v_local in tangent frame
    (z up), returns half-vector h in tangent frame."""
    vh = um.normalize(jnp.stack([alpha * v_local[..., 0],
                                 alpha * v_local[..., 1],
                                 v_local[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = jnp.where(lensq > 1e-12,
                    1.0 / jnp.sqrt(jnp.maximum(lensq, 1e-12)), 0.0)
    t1 = jnp.where(lensq[..., None] > 1e-12,
                   jnp.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                              jnp.zeros_like(inv)], -1),
                   jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], prec.FT),
                                    vh.shape))
    t2 = jnp.cross(vh, t1)
    r = jnp.sqrt(u1)
    phi = um.M_2PI * u2
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * um.safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = um.safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    h = um.normalize(jnp.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                                jnp.maximum(nh[..., 2], 1e-6)], -1))
    return h


def _sample_ggx_vndf_aniso(v_local, ax, ay, u1, u2):
    """Anisotropic VNDF sampling (Heitz 2018): stretch by (ax, ay),
    sample the iso hemisphere, unstretch."""
    vh = um.normalize(jnp.stack([ax * v_local[..., 0],
                                 ay * v_local[..., 1],
                                 v_local[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = jnp.where(lensq > 1e-12,
                    1.0 / jnp.sqrt(jnp.maximum(lensq, 1e-12)), 0.0)
    t1 = jnp.where(lensq[..., None] > 1e-12,
                   jnp.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                              jnp.zeros_like(inv)], -1),
                   jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], prec.FT),
                                    vh.shape))
    t2 = jnp.cross(vh, t1)
    r = jnp.sqrt(u1)
    phi = um.M_2PI * u2
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * um.safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = um.safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    return um.normalize(jnp.stack([ax * nh[..., 0], ay * nh[..., 1],
                                   jnp.maximum(nh[..., 2], 1e-6)], -1))


def _ggx_lambda_aniso(v, ax, ay):
    """Smith Lambda for anisotropic GGX, v in tangent space."""
    vz2 = jnp.maximum(v[..., 2] * v[..., 2], 1e-12)
    a2 = (ax * ax * v[..., 0] ** 2 + ay * ay * v[..., 1] ** 2) / vz2
    return 0.5 * (jnp.sqrt(1.0 + a2) - 1.0)


def _ggx_reflect_eval_aniso(wo, wi, ax, ay):
    """Anisotropic GGX reflection f*cos and pdf in tangent space
    (ref: bsdf_microfacet.h GGX aniso branch — Heitz 2014 D/G)."""
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    valid = (cos_o > 1e-6) & (cos_i > 1e-6)
    h = um.normalize(wo + wi)
    hh = (h[..., 0] / ax) ** 2 + (h[..., 1] / ay) ** 2 + h[..., 2] ** 2
    d = 1.0 / jnp.maximum(um.M_PI * ax * ay * hh * hh, 1e-12)
    lam_o = _ggx_lambda_aniso(wo, ax, ay)
    lam_i = _ggx_lambda_aniso(wi, ax, ay)
    g = 1.0 / (1.0 + lam_o + lam_i)
    g1_o = 1.0 / (1.0 + lam_o)
    f_cos = jnp.where(valid, d * g / jnp.maximum(4.0 * cos_o, 1e-12), 0.0)
    pdf = jnp.where(valid, g1_o * d / jnp.maximum(4.0 * cos_o, 1e-12), 0.0)
    return f_cos, pdf


def _aniso_glossy_alphas(c):
    """(alpha_x, alpha_y) from roughness + anisotropy (ref:
    svm_closure.h:535-542 anisotropic GGX setup semantics)."""
    alpha = jnp.maximum(c["glossy_roughness"] ** 2, 1e-7)
    a = jnp.clip(c["glossy_aniso"], -0.99, 0.99)
    ax = jnp.where(a < 0.0, alpha / (1.0 + a), alpha * (1.0 - a))
    ay = jnp.where(a < 0.0, alpha * (1.0 + a), alpha / (1.0 - a))
    return jnp.maximum(ax, 1e-7), jnp.maximum(ay, 1e-7)


def _aniso_frame(c, N):
    """Shading frame with x along the closure tangent where one is set
    (projected to the shading plane); the default frame elsewhere.
    Isotropic lobes are frame-rotation invariant, so sharing one frame
    across the whole stack is exact."""
    t0, b0 = um.make_orthonormals(N)
    T = c["glossy_tangent"]
    tp = T - N * um.dot(T, N)[..., None]
    ok = um.dot(tp, tp) > 1e-12
    t = jnp.where(ok[..., None], um.safe_normalize(tp), t0)
    b = jnp.cross(N, t)
    return t, b


def _chair_frame(T, I):
    """Classic-hair shared geometry (ref: bsdf_hair.h): local frame
    around the curve tangent with y toward the viewer projection, and
    the viewer inclination theta_r measured from the normal plane."""
    Tn = um.safe_normalize(T)
    Iz = um.dot(Tn, I)
    locy = um.safe_normalize(I - Tn * Iz[..., None])
    locx = jnp.cross(locy, Tn)
    theta_r = um.M_PI * 0.5 - jnp.arccos(jnp.clip(Iz, -1.0, 1.0))
    return Tn, locx, locy, theta_r


def _chair_angles(Tn, locy, omega_in):
    wz = um.dot(Tn, omega_in)
    wy = um.safe_normalize(omega_in - Tn * wz[..., None])
    theta_i = um.M_PI * 0.5 - jnp.arccos(jnp.clip(wz, -1.0, 1.0))
    cosphi_i = um.dot(wy, locy)
    return theta_i, cosphi_i


def _chair_theta_pdf(theta_i, theta_r, r1, off, a, b):
    t = (theta_i + theta_r) * 0.5 - off
    costheta_i = jnp.cos(theta_i)
    return r1 / jnp.maximum(
        2.0 * (t * t + r1 * r1) * (a - b) * costheta_i, 1e-12)


def _chair_ab(theta_r, r1, off):
    inv = 1.0 / r1
    a = jnp.arctan(((um.M_PI * 0.5 + theta_r) * 0.5 - off) * inv)
    b = jnp.arctan(((-um.M_PI * 0.5 + theta_r) * 0.5 - off) * inv)
    return a, b


def _chair_refl_eval(T, I, omega_in, r1, r2, off):
    """Classic hair reflection R lobe pdf (= grayscale eval; ref:
    bsdf_hair.h bsdf_hair_reflection_eval_reflect)."""
    Tn, _locx, locy, theta_r = _chair_frame(T, I)
    theta_i, cosphi_i = _chair_angles(Tn, locy, omega_in)
    grazing = um.M_PI * 0.5 - jnp.abs(theta_i) < 0.001
    phi_i = jnp.minimum(
        jnp.arccos(jnp.clip(cosphi_i, -1.0, 1.0)) / r2, um.M_PI)
    a, b = _chair_ab(theta_r, r1, off)
    theta_pdf = _chair_theta_pdf(theta_i, theta_r, r1, off, a, b)
    phi_pdf = jnp.cos(phi_i * 0.5) * 0.25 / r2
    pdf = jnp.where(grazing | (cosphi_i < 0.0), 0.0,
                    jnp.abs(phi_pdf * theta_pdf))
    return pdf


def _chair_trans_eval(T, I, omega_in, r1, r2, off):
    """Classic hair transmission TT lobe pdf (ref: bsdf_hair.h
    bsdf_hair_transmission_eval_transmit)."""
    Tn, _locx, locy, theta_r = _chair_frame(T, I)
    theta_i, cosphi_i = _chair_angles(Tn, locy, omega_in)
    grazing = um.M_PI * 0.5 - jnp.abs(theta_i) < 0.001
    phi_i = jnp.arccos(jnp.clip(cosphi_i, -1.0, 1.0))
    a, b = _chair_ab(theta_r, r1, off)
    c_tt = 2.0 * jnp.arctan(um.M_PI * 0.5 / r2)
    theta_pdf = _chair_theta_pdf(theta_i, theta_r, r1, off, a, b)
    p = um.M_PI - jnp.abs(phi_i)
    phi_pdf = r2 / jnp.maximum(c_tt * (p * p + r2 * r2), 1e-12)
    # transmission exits the far side only (cosphi <= 0) — the
    # reference reaches this eval through its eval_transmit dispatch;
    # gating here keeps the eval support equal to the sample support
    # (the sampled phi = p + pi never leaves the back half), so the
    # pdf integrates to exactly 1 over the sphere
    return jnp.where(grazing | (cosphi_i > 0.0), 0.0,
                     jnp.abs(phi_pdf * theta_pdf))


def _chair_sample(T, I, r1, r2, off, u1, u2, transmit):
    """Sample the classic-hair R (or TT) lobe; returns (omega, pdf)
    (ref: bsdf_hair.h bsdf_hair_{reflection,transmission}_sample)."""
    Tn, locx, locy, theta_r = _chair_frame(T, I)
    a, b = _chair_ab(theta_r, r1, off)
    t = r1 * jnp.tan(u1 * (a - b) + b)
    theta_h = t + off
    theta_i = 2.0 * theta_h - theta_r
    costheta_i = jnp.cos(theta_i)
    sintheta_i = jnp.sin(theta_i)
    if transmit:
        c_tt = 2.0 * jnp.arctan(um.M_PI * 0.5 / r2)
        p = r2 * jnp.tan(c_tt * (u2 - 0.5))
        phi = p + um.M_PI
        phi_pdf = r2 / jnp.maximum(c_tt * (p * p + r2 * r2), 1e-12)
    else:
        phi = 2.0 * um.safe_asin(1.0 - 2.0 * u2) * r2
        phi_pdf = jnp.cos(phi * 0.5) * 0.25 / r2
    theta_pdf = r1 / jnp.maximum(
        2.0 * (t * t + r1 * r1) * (a - b) * costheta_i, 1e-12)
    omega = (jnp.cos(phi) * costheta_i)[..., None] * locy \
        - (jnp.sin(phi) * costheta_i)[..., None] * locx \
        + sintheta_i[..., None] * Tn
    pdf = jnp.where(um.M_PI * 0.5 - jnp.abs(theta_i) < 0.001, 0.0,
                    jnp.abs(phi_pdf * theta_pdf))
    return omega, pdf


def _ggx_reflect_eval(wo, wi, alpha):
    """GGX reflection f*cos and pdf in tangent space (z = normal)."""
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    valid = (cos_o > 1e-6) & (cos_i > 1e-6)
    h = um.normalize(wo + wi)
    cos_h = h[..., 2]
    alpha2 = alpha * alpha
    d = _ggx_d(cos_h, alpha2)
    lam_o = _ggx_smith_lambda(cos_o, alpha2)
    lam_i = _ggx_smith_lambda(cos_i, alpha2)
    g = 1.0 / (1.0 + lam_o + lam_i)
    g1_o = 1.0 / (1.0 + lam_o)
    f_cos = jnp.where(valid, d * g / jnp.maximum(4.0 * cos_o, 1e-12), 0.0)
    # VNDF pdf: G1(o) D |o.h| / cos_o / (4 |o.h|) = G1 D / (4 cos_o)
    pdf = jnp.where(valid, g1_o * d / jnp.maximum(4.0 * cos_o, 1e-12), 0.0)
    return f_cos, pdf


def _ggx_refract_eval(wo, wi, alpha, eta):
    """GGX refraction f*cos and pdf; eta = ior_in/ior_out along wo side.
    wo on +z side, wi must be on -z side."""
    cos_o = wo[..., 2]
    cos_i = -wi[..., 2]
    valid = (cos_o > 1e-6) & (cos_i > 1e-6)
    # half vector for refraction
    ht = -(eta[..., None] * wo + wi)
    h = um.normalize(ht)
    h = h * jnp.sign(h[..., 2:3])  # orient to +z
    cos_ho = jnp.sum(wo * h, -1)
    cos_hi = jnp.sum(wi * h, -1)
    alpha2 = alpha * alpha
    d = _ggx_d(h[..., 2], alpha2)
    lam_o = _ggx_smith_lambda(cos_o, alpha2)
    lam_i = _ggx_smith_lambda(cos_i, alpha2)
    g = 1.0 / (1.0 + lam_o + lam_i)
    g1_o = 1.0 / (1.0 + lam_o)
    denom = eta * cos_ho + cos_hi
    denom2 = jnp.maximum(denom * denom, 1e-12)
    jac = jnp.abs(cos_hi) / denom2
    f_cos = jnp.where(valid & (jnp.abs(cos_ho) > 1e-8),
                      (jnp.abs(cos_ho) * jac * d * g
                       / jnp.maximum(cos_o, 1e-12)), 0.0)
    pdf = jnp.where(valid, g1_o * d * jnp.abs(cos_ho) * jac
                    / jnp.maximum(cos_o, 1e-12), 0.0)
    return f_cos, pdf


def _oren_nayar_factor(wo, wi, roughness):
    """Oren-Nayar qualitative model (ref: bsdf_oren_nayar.h), relative to
    Lambert (factor multiplying albedo/pi*cos)."""
    sigma2 = roughness * roughness
    a = 1.0 - 0.5 * sigma2 / (sigma2 + 0.33)
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    cos_o, cos_i = wo[..., 2], wi[..., 2]
    sin_o = um.safe_sqrt(1.0 - cos_o * cos_o)
    sin_i = um.safe_sqrt(1.0 - cos_i * cos_i)
    cos_phi = jnp.where(
        (sin_o > 1e-6) & (sin_i > 1e-6),
        (wo[..., 0] * wi[..., 0] + wo[..., 1] * wi[..., 1])
        / jnp.maximum(sin_o * sin_i, 1e-12), 0.0)
    sin_alpha = jnp.maximum(sin_o, sin_i)
    tan_beta = jnp.minimum(sin_o, sin_i) / jnp.maximum(
        jnp.minimum(cos_o, cos_i), 1e-6)
    return a + b * jnp.maximum(cos_phi, 0.0) * sin_alpha * tan_beta


def _toon_cones(size, smooth):
    """(cos_max, cos_end) of the toon response: full intensity inside
    size*pi/2, linear-in-cos falloff to zero at (size+smooth)*pi/2
    (ref: kernel/closure/bsdf_toon.h angle semantics)."""
    max_angle = jnp.clip(size, 0.0, 1.0) * (um.M_PI * 0.5)
    end_angle = jnp.minimum(max_angle + jnp.clip(smooth, 0.0, 1.0)
                            * (um.M_PI * 0.5), um.M_PI * 0.5)
    return jnp.cos(max_angle), jnp.cos(end_angle)


def _toon_intensity(cos_t, cm, ce):
    """Piecewise response in cos-space: 1 above cm, linear to 0 at ce."""
    band = jnp.where(cm - ce > 1e-6, (cos_t - ce)
                     / jnp.maximum(cm - ce, 1e-6), 0.0)
    return jnp.clip(jnp.where(cos_t >= cm, 1.0, band), 0.0, 1.0)


def _toon_norm(cm, ce):
    """K = 2 pi int_ce^1 i(c) c dc — hemispherical response so
    weight/K makes the lobe's albedo equal its weight."""
    hard = um.M_PI * (1.0 - cm * cm)
    d = jnp.maximum(cm - ce, 1e-6)
    band = um.M_2PI / d * ((cm ** 3 - ce ** 3) / 3.0
                           - ce * (cm * cm - ce * ce) / 2.0)
    return jnp.maximum(hard + jnp.where(cm - ce > 1e-6, band, 0.0), 1e-6)


def _toon_eval(weight, cos_t, cos_i, cm, ce):
    """f*cos of one toon lobe at angle cos_t from its axis."""
    i = _toon_intensity(cos_t, cm, ce)
    return weight * (i / _toon_norm(cm, ce) * jnp.maximum(cos_i, 0.0)
                     )[..., None]


def _toon_cone_pdf(cos_t, ce):
    """Uniform-solid-angle cone pdf for the sampled support."""
    inside = cos_t >= ce - 1e-7
    return jnp.where(inside, 1.0 / jnp.maximum(
        um.M_2PI * (1.0 - ce), 1e-7), 0.0)


def _sample_uniform_cone(axis, ce, u1, u2):
    """Uniform direction within the cone cos >= ce around `axis`
    (any-space unit vectors)."""
    cos_t = 1.0 - u1 * (1.0 - ce)
    sin_t = um.safe_sqrt(1.0 - cos_t * cos_t)
    phi = um.M_2PI * u2
    t, b = um.make_orthonormals(axis)
    return (t * (sin_t * jnp.cos(phi))[..., None]
            + b * (sin_t * jnp.sin(phi))[..., None]
            + axis * cos_t[..., None])


def _velvet_eval(wo, wi, sigma):
    """Ashikhmin velvet f*cos (ref: kernel/closure/
    bsdf_ashikhmin_velvet.h — the classic inverted-Gaussian cotangent
    microfiber distribution, independently implemented from the
    published model)."""
    cos_o = jnp.maximum(wo[..., 2], 1e-4)
    cos_i = jnp.maximum(wi[..., 2], 0.0)
    h = um.normalize(wo + wi)
    cos_nh = jnp.clip(h[..., 2], -1.0, 1.0)
    cos_ho = jnp.maximum(jnp.abs(um.dot(wo, h)), 1e-5)
    inv_s2 = 1.0 / jnp.maximum(sigma * sigma, 1e-4)
    sin_nh2 = jnp.maximum(1.0 - cos_nh * cos_nh, 1e-6)
    cot2 = (cos_nh * cos_nh) / sin_nh2
    D = jnp.exp(-cot2 * inv_s2) * inv_s2 * um.M_1_PI \
        / (sin_nh2 * sin_nh2)
    G = jnp.minimum(1.0, jnp.minimum(
        2.0 * cos_nh * cos_o / cos_ho,
        2.0 * cos_nh * cos_i / cos_ho))
    f = 0.25 * D * jnp.maximum(G, 0.0) / cos_o
    return jnp.where((cos_i > 0.0) & (cos_nh > 0.0), f * cos_i, 0.0)


def _lobe_probs(c, include_sss=True):
    """Lobe pick probabilities from mean closure weights
    (ref: shader_bsdf_pick sample_weight). include_sss=False when the
    random-walk integrator handles the subsurface lobe separately."""
    wd = jnp.mean(jnp.abs(c["diffuse"])
                  + (jnp.abs(c["subsurface"]) if include_sss else 0.0)
                  + jnp.abs(c["sheen"]), -1)
    wg = jnp.mean(jnp.abs(c["glossy"]), -1)
    wr = jnp.mean(jnp.abs(c["refraction"]), -1)
    wt = jnp.mean(jnp.abs(c["transparent"]), -1)
    wh = jnp.mean(jnp.abs(c["hair"]), -1)
    wtd = jnp.mean(jnp.abs(c["toon_diffuse"]), -1)
    wtg = jnp.mean(jnp.abs(c["toon_glossy"]), -1)
    whr = jnp.mean(jnp.abs(c["chair_refl"]), -1)
    wht = jnp.mean(jnp.abs(c["chair_trans"]), -1)
    tot = wd + wg + wr + wt + wh + wtd + wtg + whr + wht
    safe = jnp.maximum(tot, 1e-12)
    return (wd / safe, wg / safe, wr / safe, wt / safe, wh / safe,
            wtd / safe, wtg / safe, whr / safe, wht / safe, tot)


def _hair_on_curves_only(c, sd):
    """Hair closures on MESH prims (no packed curve tangent) fall back
    to a diffuse lobe instead of black: the hair lobes are only
    evaluable on curve lanes (is_curve = nonzero tangent), so leaving
    their mixture weight live on mesh lanes allocates pick probability
    to a lobe whose sample is then invalid — energy loss. The reference
    evals hair via dPdu on any prim (bsdf_hair_principled.h); a diffuse
    fallback is the graceful wavefront analog. Applies to both the
    principled lobe and the classic R/TT lobes (bsdf_hair.h)."""
    is_curve = um.dot(sd.dPdu, sd.dPdu) > 0.25
    c = dict(c)
    onc = is_curve[..., None]
    fallback = jnp.where(onc, 0.0,
                         c["hair"] + c["chair_refl"] + c["chair_trans"])
    c["diffuse"] = c["diffuse"] + fallback
    c["hair"] = jnp.where(onc, c["hair"], 0.0)
    c["chair_refl"] = jnp.where(onc, c["chair_refl"], 0.0)
    c["chair_trans"] = jnp.where(onc, c["chair_trans"], 0.0)
    return c


def bsdf_eval(c, N, I, omega_in, features=None, want_components=False,
              sd=None):
    """Evaluate the full closure stack at direction omega_in.

    Returns (f_cos (N,3), pdf (N,)) — f includes |cos|; delta lobes
    contribute nothing (ref: _shader_bsdf_multi_eval).

    `features` (dict of static bools from scene analysis) prunes unused
    lobes at trace time — the analog of the reference's
    feature-specialized kernel builds (device.h:228 get_build_options)."""
    ft = features or {}
    has_glossy = ft.get("has_glossy", True)
    has_refraction = ft.get("has_refraction", True)
    has_diffuse_rough = ft.get("has_diffuse_roughness", True)

    has_sss_walk = ft.get("has_subsurface", False)
    has_hair = ft.get("has_hair", False) and sd is not None
    has_chair = ft.get("has_classic_hair", False) and sd is not None
    has_aniso = ft.get("has_aniso", False)
    if has_hair or has_chair:
        c = _hair_on_curves_only(c, sd)
    if has_aniso:
        t, b = _aniso_frame(c, N)
    else:
        t, b = um.make_orthonormals(N)
    wo = um.to_local(I, t, b, N)
    wi = um.to_local(omega_in, t, b, N)

    pd, pg, pr, pt, ph, ptd, ptg, phr, pht, tot = _lobe_probs(
        c, include_sss=not has_sss_walk)

    reflect_side = wi[..., 2] > 0.0

    # diffuse (subsurface folds in as diffuse ONLY when the random walk
    # is not active, ref: the fallback diffuse approximation)
    cos_i = jnp.maximum(wi[..., 2], 0.0)
    if has_diffuse_rough:
        on = jnp.where(c["diffuse_roughness"] > 1e-4,
                       _oren_nayar_factor(wo, wi, c["diffuse_roughness"]), 1.0)
    else:
        on = 1.0
    sss_part = 0.0 if has_sss_walk else c["subsurface"]
    f_diff = (c["diffuse"] + sss_part) * (cos_i * um.M_1_PI * on)[..., None]
    pdf_diff = cos_i * um.M_1_PI

    f_diff_m = f_diff * jnp.where(reflect_side, 1.0, 0.0)[..., None]
    f = f_diff_m
    pdf = pd * jnp.where(reflect_side, pdf_diff, 0.0)
    comp = {"diffuse": f_diff_m} if want_components else None

    if has_glossy:
        alpha_g = jnp.maximum(c["glossy_roughness"] ** 2, 1e-7)
        glossy_delta = c["glossy_roughness"] < SHARP_ROUGHNESS
        if has_aniso:
            ax_g, ay_g = _aniso_glossy_alphas(c)
            fg, pdfg = _ggx_reflect_eval_aniso(wo, wi, ax_g, ay_g)
        else:
            fg, pdfg = _ggx_reflect_eval(wo, wi, alpha_g)
        f_gloss = jnp.where((~glossy_delta & reflect_side)[..., None],
                            c["glossy"] * fg[..., None], 0.0)
        pdf_gloss = jnp.where(~glossy_delta & reflect_side, pdfg, 0.0)
        if ft.get("has_multiscatter", False):
            ms_on = (c["glossy_multiscatter"] > 0.0) & ~glossy_delta
            f_ms = ms_compensation_lobe(c, wo[..., 2], wi[..., 2])
            f_gloss = f_gloss + jnp.where(
                (ms_on & reflect_side)[..., None],
                c["glossy"] * f_ms[..., None], 0.0)
        f = f + f_gloss
        pdf = pdf + pg * pdf_gloss
        if want_components:
            comp["glossy"] = f_gloss

    if has_refraction:
        alpha_r = jnp.maximum(c["refraction_roughness"] ** 2, 1e-7)
        refr_delta = c["refraction_roughness"] < SHARP_ROUGHNESS
        eta = jnp.maximum(c["ior"], 1e-5)
        # wo always +z by construction (N flipped to face I); refraction
        # goes to -z side. eta = 1/ior entering, caller flips for exit.
        fr, pdfr = _ggx_refract_eval(wo, wi, alpha_r, 1.0 / eta)
        f_refr = jnp.where((~refr_delta & ~reflect_side)[..., None],
                           c["refraction"] * fr[..., None], 0.0)
        pdf_refr = jnp.where(~refr_delta & ~reflect_side, pdfr, 0.0)
        f = f + f_refr
        pdf = pdf + pr * pdf_refr
        if want_components:
            comp["transmission"] = f_refr

    if ft.get("has_sheen", False):
        # Ashikhmin velvet rides the diffuse (cosine) sampling branch:
        # its weight is folded into pd, so pdf accounting is unchanged
        f_sheen = c["sheen"] * _velvet_eval(wo, wi, c["sheen_sigma"]
                                            )[..., None]
        f_sheen = jnp.where(reflect_side[..., None], f_sheen, 0.0)
        f = f + f_sheen
        if want_components:
            comp["diffuse"] = comp["diffuse"] + f_sheen

    if ft.get("has_toon", False):
        # toon lobes (ref: bsdf_toon.h): constant response inside the
        # size cone, linear falloff across smooth, uniform-cone sampled
        cos_i_s = wi[..., 2]
        cmd, ced = _toon_cones(c["toon_diffuse_size"],
                               c["toon_diffuse_smooth"])
        f_td = _toon_eval(c["toon_diffuse"], cos_i_s, cos_i_s, cmd, ced)
        f_td = jnp.where(reflect_side[..., None], f_td, 0.0)
        r_l = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
        cmg, ceg = _toon_cones(c["toon_glossy_size"],
                               c["toon_glossy_smooth"])
        cos_r = um.dot(wi, r_l)
        f_tg = _toon_eval(c["toon_glossy"], cos_r, cos_i_s, cmg, ceg)
        f_tg = jnp.where(reflect_side[..., None], f_tg, 0.0)
        f = f + f_td + f_tg
        pdf = pdf + ptd * jnp.where(reflect_side,
                                    _toon_cone_pdf(cos_i_s, ced), 0.0) \
            + ptg * jnp.where(reflect_side,
                              _toon_cone_pdf(cos_r, ceg), 0.0)
        if want_components:
            comp["diffuse"] = comp["diffuse"] + f_td
            comp["glossy"] = comp.get("glossy", 0.0) + f_tg

    if has_hair:
        # principled hair lobe (ops/hair.py; only live on curve prims,
        # flagged by a nonzero packed tangent)
        from raytracingproject_tpu.ops import hair as hair_ops
        is_curve = um.dot(sd.dPdu, sd.dPdu) > 0.25
        h_off = jnp.clip(sd.uv[..., 0] * 2.0 - 1.0, -1.0, 1.0)
        f_h, pdf_h = hair_ops.hair_eval(
            sd.dPdu, sd.Ng, h_off, I, omega_in, c["hair_sigma"],
            jnp.maximum(c["hair_v"], 1e-7),
            jnp.maximum(c["hair_s"], 1e-7),
            c["hair_alpha"], jnp.maximum(c["hair_ior"], 1.01))
        f_hair = jnp.where(is_curve[..., None], c["hair"] * f_h, 0.0)
        f = f + f_hair
        pdf = pdf + ph * jnp.where(is_curve, pdf_h, 0.0)
        if want_components:
            comp["glossy"] = comp.get("glossy", 0.0) + f_hair

    if has_chair:
        # classic hair R / TT lobes (ref: bsdf_hair.h): grayscale eval
        # equals the pdf (perfect importance sampling), colored by the
        # closure weight; live on curve lanes only (nonzero tangent)
        is_curve_c = um.dot(sd.dPdu, sd.dPdu) > 0.25
        r1r = jnp.clip(c["chair_refl_r1"], 1e-3, 1.0)
        r2r = jnp.clip(c["chair_refl_r2"], 1e-3, 1.0)
        pdf_hr = _chair_refl_eval(sd.dPdu, I, omega_in, r1r, r2r,
                                  c["chair_refl_off"])
        pdf_hr = jnp.where(is_curve_c, pdf_hr, 0.0)
        r1t = jnp.clip(c["chair_trans_r1"], 1e-3, 1.0)
        r2t = jnp.clip(c["chair_trans_r2"], 1e-3, 1.0)
        pdf_ht = _chair_trans_eval(sd.dPdu, I, omega_in, r1t, r2t,
                                   c["chair_trans_off"])
        pdf_ht = jnp.where(is_curve_c, pdf_ht, 0.0)
        f_chair = c["chair_refl"] * pdf_hr[..., None] \
            + c["chair_trans"] * pdf_ht[..., None]
        f = f + f_chair
        pdf = pdf + phr * pdf_hr + pht * pdf_ht
        if want_components:
            comp["glossy"] = comp.get("glossy", 0.0) + f_chair

    if want_components:
        return f, pdf, comp
    return f, pdf


def bsdf_sample(c, N, Ng, I, u1, u2, u_lobe, features=None, sd=None):
    """Sample an outgoing direction from the closure stack.

    Returns dict(omega (N,3), f_cos (N,3), pdf (N,), label (N,) int32,
    eta (N,) relative ior crossed for refraction lanes, valid mask).
    `features` statically prunes unused lobes (see bsdf_eval).
    """
    ft = features or {}
    has_glossy = ft.get("has_glossy", True)
    has_refraction = ft.get("has_refraction", True)
    has_transparent = ft.get("has_transparent", True)
    has_hair = ft.get("has_hair", False) and sd is not None
    has_chair = ft.get("has_classic_hair", False) and sd is not None
    has_aniso = ft.get("has_aniso", False)
    if has_hair or has_chair:
        c = _hair_on_curves_only(c, sd)

    if has_aniso:
        t, b = _aniso_frame(c, N)
    else:
        t, b = um.make_orthonormals(N)
    wo = um.to_local(I, t, b, N)

    has_toon = ft.get("has_toon", False)
    pd, pg, pr, pt, phh, ptd, ptg, phr, pht, tot = _lobe_probs(
        c, include_sss=not ft.get("has_subsurface", False))
    # statically-unrolled pick chain over the enabled lobes: each lobe
    # claims [cdf, cdf + p) of u_lobe; disabled lobes carry zero weight
    # (no node can produce them) so their intervals are empty anyway,
    # and the final enabled lobe absorbs the tail for fp robustness
    zeros_b = jnp.zeros_like(u_lobe < 0)
    chain = [("d", pd, True),
             ("g", pg, has_glossy),
             ("r", pr, has_refraction),
             ("t", pt, has_transparent),
             ("h", phh, has_hair),
             ("td", ptd, has_toon),
             ("tg", ptg, has_toon),
             ("hr", phr, has_chair),
             ("ht", pht, has_chair)]
    enabled = [nm for nm, _p, en in chain if en]
    picks = {}
    cdf = None
    taken = zeros_b
    for nm, p, en in chain:
        if not en:
            picks[nm] = zeros_b
            continue
        cdf = p if cdf is None else cdf + p
        if nm == enabled[-1]:
            picks[nm] = ~taken  # absorb the fp tail
        else:
            picks[nm] = ~taken & (u_lobe < cdf)
        taken = taken | picks[nm]
    pick_d, pick_g, pick_r, pick_t = (picks["d"], picks["g"], picks["r"],
                                      picks["t"])
    pick_h, pick_td, pick_tg = picks["h"], picks["td"], picks["tg"]
    pick_hr, pick_ht = picks["hr"], picks["ht"]

    # --- diffuse: cosine hemisphere ---
    r = jnp.sqrt(u1)
    phi = um.M_2PI * u2
    wi_diff = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi),
                         um.safe_sqrt(1.0 - u1)], -1)
    wi = wi_diff
    label = jnp.full(pick_d.shape, LABEL_DIFFUSE, jnp.int32)

    glossy_delta = c["glossy_roughness"] < SHARP_ROUGHNESS
    refr_delta = c["refraction_roughness"] < SHARP_ROUGHNESS
    eta_f = jnp.maximum(c["ior"], 1e-5)  # ior of medium being entered
    inv_eta = 1.0 / eta_f
    tir = jnp.zeros_like(pick_d)

    if has_glossy:
        # --- glossy: VNDF half-vector, reflect ---
        alpha_g = jnp.maximum(c["glossy_roughness"] ** 2, 1e-7)
        if has_aniso:
            ax_g, ay_g = _aniso_glossy_alphas(c)
            h_g = _sample_ggx_vndf_aniso(wo, ax_g, ay_g, u1, u2)
        else:
            h_g = _sample_ggx_vndf(wo, alpha_g, u1, u2)
        wi_gloss = 2.0 * um.dot3(wo, h_g) * h_g - wo
        wi_gloss_delta = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
        wi_gloss = jnp.where(glossy_delta[..., None], wi_gloss_delta, wi_gloss)
        wi = jnp.where(pick_g[..., None], wi_gloss, wi)
        label = jnp.where(pick_g, jnp.where(glossy_delta,
                                            LABEL_GLOSSY | LABEL_SINGULAR,
                                            LABEL_GLOSSY), label)

    if has_refraction:
        # --- refraction: VNDF half-vector, refract ---
        alpha_r = jnp.maximum(c["refraction_roughness"] ** 2, 1e-7)
        h_r = _sample_ggx_vndf(wo, alpha_r, u1, u2)
        h_r_eff = jnp.where(refr_delta[..., None],
                            jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0],
                                                         prec.FT),
                                             h_r.shape),
                            h_r)
        cos_oh = jnp.sum(wo * h_r_eff, -1)
        k = 1.0 - inv_eta * inv_eta * (1.0 - cos_oh * cos_oh)
        tir = k < 0.0
        wi_refr = um.normalize(
            (inv_eta[..., None] * (cos_oh[..., None] * h_r_eff - wo))
            - um.safe_sqrt(k)[..., None] * h_r_eff)
        # TIR: reflect off the half vector instead
        wi_tir = um.normalize(2.0 * cos_oh[..., None] * h_r_eff - wo)
        wi_refr = jnp.where(tir[..., None], wi_tir, wi_refr)
        wi = jnp.where(pick_r[..., None], wi_refr, wi)
        label = jnp.where(pick_r, jnp.where(refr_delta,
                                            LABEL_TRANSMIT | LABEL_SINGULAR,
                                            LABEL_TRANSMIT), label)

    if has_transparent:
        wi = jnp.where(pick_t[..., None], -wo, wi)
        label = jnp.where(pick_t, LABEL_TRANSPARENT | LABEL_SINGULAR, label)

    if has_toon:
        # uniform-cone samples around N (diffuse toon) / the mirror
        # direction (glossy toon); pdf accounted in bsdf_eval
        z_ax = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], prec.FT),
                                wi.shape)
        _, ced = _toon_cones(c["toon_diffuse_size"],
                             c["toon_diffuse_smooth"])
        wi_td = _sample_uniform_cone(z_ax, ced, u1, u2)
        wi = jnp.where(pick_td[..., None], wi_td, wi)
        r_l = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
        _, ceg = _toon_cones(c["toon_glossy_size"],
                             c["toon_glossy_smooth"])
        wi_tg = _sample_uniform_cone(um.normalize(r_l), ceg, u1, u2)
        wi = jnp.where(pick_tg[..., None], wi_tg, wi)
        label = jnp.where(pick_tg, LABEL_GLOSSY, label)

    omega = um.from_local(wi, t, b, N)

    if has_hair:
        # hair samples come back in world space already (its own frame)
        from raytracingproject_tpu.ops import hair as hair_ops
        h_off = jnp.clip(sd.uv[..., 0] * 2.0 - 1.0, -1.0, 1.0)
        omega_h, _fh, _pdfh, valid_h = hair_ops.hair_sample(
            sd.dPdu, sd.Ng, h_off, I, u1, u2, c["hair_sigma"],
            jnp.maximum(c["hair_v"], 1e-7),
            jnp.maximum(c["hair_s"], 1e-7),
            c["hair_alpha"], jnp.maximum(c["hair_ior"], 1.01))
        omega = jnp.where(pick_h[..., None], omega_h, omega)
        label = jnp.where(pick_h, LABEL_GLOSSY, label)

    if has_chair:
        # classic hair R / TT lobes sample in world space around the
        # curve tangent (ref: bsdf_hair.h *_sample)
        omega_hr, _pdf_hr = _chair_sample(
            sd.dPdu, I, jnp.clip(c["chair_refl_r1"], 1e-3, 1.0),
            jnp.clip(c["chair_refl_r2"], 1e-3, 1.0),
            c["chair_refl_off"], u1, u2, transmit=False)
        omega_ht, _pdf_ht = _chair_sample(
            sd.dPdu, I, jnp.clip(c["chair_trans_r1"], 1e-3, 1.0),
            jnp.clip(c["chair_trans_r2"], 1e-3, 1.0),
            c["chair_trans_off"], u1, u2, transmit=True)
        omega = jnp.where(pick_hr[..., None], omega_hr, omega)
        omega = jnp.where(pick_ht[..., None], omega_ht, omega)
        label = jnp.where(pick_hr, LABEL_GLOSSY, label)
        label = jnp.where(pick_ht, LABEL_TRANSMIT | LABEL_GLOSSY, label)

    # --- combine: delta lanes bypass the mixture eval ---
    sampled_delta = ((pick_g & glossy_delta) | (pick_r & refr_delta) | pick_t)

    f_eval, pdf_eval = bsdf_eval(c, N, I, omega, features, sd=sd)
    # delta contributions (weight/pick_prob with pdf treated as 1)
    f_delta = jnp.where(pick_g[..., None], c["glossy"],
                        jnp.where(pick_r[..., None], c["refraction"],
                                  c["transparent"]))
    p_delta = jnp.where(pick_g, pg, jnp.where(pick_r, pr, pt))

    f = jnp.where(sampled_delta[..., None], f_delta, f_eval)
    pdf = jnp.where(sampled_delta, p_delta, pdf_eval)

    valid = (tot > 1e-12) & (pdf > 1e-12)
    if has_hair:
        valid = valid & (~pick_h | valid_h)
    # refraction lanes record relative eta for russian-roulette radiance
    # scaling (ref: kernel_path_surface.h bounce eta_scale)
    eta_cross = jnp.where(pick_r & ~tir, inv_eta, 1.0)
    return {"omega": omega, "f_cos": f, "pdf": pdf, "label": label,
            "valid": valid, "eta": eta_cross}


# ---------------------------------------------------------------------------
# Multiscatter GGX energy compensation
# (ref: kernel/closure/bsdf_microfacet_multi.h — the reference evaluates
# multiple scattering with a stochastic random walk on the microsurface,
# which is wavefront-hostile; redesigned as the Kulla-Conty
# energy-compensation lobe: f_ms = (1-E(o))(1-E(i)) / (pi (1-E_avg)),
# driven by a precomputed directional-albedo table E(mu, roughness).)
# ---------------------------------------------------------------------------

MS_TABLE_MU = 16
MS_TABLE_R = 16
_ms_cache = {}


def _ms_tables_np():
    """E(mu_o, roughness) single-scatter directional albedo of the
    white-Fresnel GGX (same D/G family as _ggx_reflect_eval) plus its
    cosine average E_avg(roughness). Built once per process.

    Uses the VNDF identity: with h ~ visible-normal distribution the
    albedo estimator collapses to E = mean(G2/G1_o over samples with
    wi above the horizon) — exact in expectation and smooth for ALL
    roughness (a fixed wi grid misses the sharp-lobe spike)."""
    if "E" in _ms_cache:
        return _ms_cache["E"], _ms_cache["Eavg"]
    mu = (np.arange(MS_TABLE_MU) + 0.5) / MS_TABLE_MU         # (M,)
    rough = (np.arange(MS_TABLE_R) + 0.5) / MS_TABLE_R        # (R,)
    alpha = rough ** 2
    k = 64                                                     # u grid
    u1 = ((np.arange(k) + 0.5) / k)[:, None]
    u2 = ((np.arange(k) + 0.5) / k)[None, :]
    u1 = np.broadcast_to(u1, (k, k)).reshape(-1)
    u2 = np.broadcast_to(u2, (k, k)).reshape(-1)               # (S,)
    so = np.sqrt(np.maximum(1.0 - mu ** 2, 0.0))
    # shapes (M, R, S)
    a = alpha[None, :, None]
    vx = so[:, None, None] * a
    vz = mu[:, None, None] * np.ones_like(a)
    vn = np.sqrt(vx * vx + vz * vz)
    vhx, vhz = vx / vn, vz / vn                                # (M,R,1)
    # Heitz 2018 VNDF sampling with v in the xz-plane (vy=0):
    lensq = vhx * vhx
    inv = np.where(lensq > 1e-12, 1.0 / np.sqrt(np.maximum(lensq, 1e-12)),
                   0.0)
    # t1 = normalize(-vhy, vhx, 0) = (0, sign-ish, 0) -> (0,1,0) when
    # lensq ~ 0; general: t1 = (-vhy, vhx, 0)/len = (0, vhx, 0)/len
    t1y = np.where(lensq > 1e-12, vhx * inv, 1.0)
    # t2 = vh x t1
    t2x = -vhz * t1y
    t2z = vhx * t1y
    r = np.sqrt(u1)[None, None, :]
    phi = 2.0 * np.pi * u2[None, None, :]
    p1 = r * np.cos(phi)
    p2 = r * np.sin(phi)
    sfac = 0.5 * (1.0 + vhz)
    p2 = (1.0 - sfac) * np.sqrt(np.maximum(1.0 - p1 * p1, 0.0)) \
        + sfac * p2
    p3 = np.sqrt(np.maximum(1.0 - p1 * p1 - p2 * p2, 0.0))
    # h_local = p1*t1 + p2*t2 + p3*vh  (t1=(0,t1y,0), t2=(t2x,0,t2z))
    hx = p2 * t2x + p3 * vhx
    hy = p1 * t1y
    hz = p2 * t2z + p3 * vhz
    # unstretch
    hx, hy, hz_ = hx * a, hy * a, np.maximum(hz, 1e-9)
    hn = np.sqrt(hx * hx + hy * hy + hz_ * hz_)
    hx, hy, hz = hx / hn, hy / hn, hz_ / hn
    # wi = reflect(wo, h); wo = (so, 0, mu)
    woh = so[:, None, None] * hx + mu[:, None, None] * hz
    wix = 2.0 * woh * hx - so[:, None, None]
    wiz = 2.0 * woh * hz - mu[:, None, None]
    a2 = a * a

    def lam(c):
        c2 = np.clip(c * c, 1e-12, 1.0)
        t2_ = np.maximum(1.0 - c2, 0.0) / c2
        return 0.5 * (np.sqrt(1.0 + a2 * t2_) - 1.0)

    lam_o = lam(vz)
    g1_o = 1.0 / (1.0 + lam_o)
    g2 = 1.0 / (1.0 + lam_o + lam(np.clip(wiz, 1e-9, 1.0)))
    est = np.where(wiz > 1e-6, g2 / g1_o, 0.0)
    E = np.clip(est.mean(-1), 0.0, 1.0)                        # (M, R)
    Eavg = np.clip(2.0 * np.mean(E * mu[:, None], axis=0), 1e-4, 1.0)
    _ms_cache["E"] = E.astype(np.float32)
    _ms_cache["Eavg"] = Eavg.astype(np.float32)
    return _ms_cache["E"], _ms_cache["Eavg"]


def _ms_energy_lookup(mu, rough):
    """Bilinear E(mu, rough) via one-hot reductions (no dynamic
    gathers). mu, rough: (N,)."""
    E, _ = _ms_tables_np()
    tab = jnp.asarray(E.reshape(-1))                          # (M*R,)
    fm = jnp.clip(mu * MS_TABLE_MU - 0.5, 0.0, MS_TABLE_MU - 1.0)
    fr = jnp.clip(rough * MS_TABLE_R - 0.5, 0.0, MS_TABLE_R - 1.0)
    m0 = jnp.floor(fm).astype(jnp.int32)
    r0 = jnp.floor(fr).astype(jnp.int32)
    m1 = jnp.minimum(m0 + 1, MS_TABLE_MU - 1)
    r1 = jnp.minimum(r0 + 1, MS_TABLE_R - 1)
    wm = fm - m0.astype(prec.FT)
    wr = fr - r0.astype(prec.FT)
    cols = jnp.arange(MS_TABLE_MU * MS_TABLE_R, dtype=jnp.int32)

    def fetch(mi, ri):
        idx = mi * MS_TABLE_R + ri
        return jnp.sum(jnp.where(cols[None, :] == idx[:, None],
                                 tab[None, :], 0.0), -1)

    return ((1 - wm) * ((1 - wr) * fetch(m0, r0) + wr * fetch(m0, r1))
            + wm * ((1 - wr) * fetch(m1, r0) + wr * fetch(m1, r1)))


def _ms_eavg_lookup(rough):
    _, Eavg = _ms_tables_np()
    tab = jnp.asarray(Eavg)
    fr = jnp.clip(rough * MS_TABLE_R - 0.5, 0.0, MS_TABLE_R - 1.0)
    r0 = jnp.floor(fr).astype(jnp.int32)
    r1 = jnp.minimum(r0 + 1, MS_TABLE_R - 1)
    wr = fr - r0.astype(prec.FT)
    cols = jnp.arange(MS_TABLE_R, dtype=jnp.int32)

    def fetch(ri):
        return jnp.sum(jnp.where(cols[None, :] == ri[:, None],
                                 tab[None, :], 0.0), -1)

    return (1 - wr) * fetch(r0) + wr * fetch(r1)


def ms_compensation_lobe(c, cos_o, cos_i):
    """Kulla-Conty multiple-scattering lobe value (x cos_i), white
    albedo scaled by the glossy color (x color per extra bounce is
    approximated by one color factor — matches the reference's
    single-color multi_ggx closure usage)."""
    rough = jnp.clip(c["glossy_roughness"], 0.0, 1.0)
    E_o = _ms_energy_lookup(jnp.clip(cos_o, 1e-4, 1.0), rough)
    E_i = _ms_energy_lookup(jnp.clip(cos_i, 1e-4, 1.0), rough)
    E_avg = _ms_eavg_lookup(rough)
    denom = jnp.maximum(um.M_PI * (1.0 - E_avg), 1e-4)
    return (1.0 - E_o) * (1.0 - E_i) / denom * jnp.maximum(cos_i, 0.0)
