"""Fixed-slot closure union (ref: kernel/closure/bsdf.h dispatch +
ShaderClosure array in kernel/kernel_types.h SD storage).

The reference stores a variable-length ShaderClosure array per shading
point and dispatches on closure type at runtime. Over a wavefront,
variable-length per-lane unions defeat vectorization, so a shader
evaluates to a
*fixed set of weighted closure slots* (SoA over the wavefront):

  emission       — light emission (3)
  diffuse        — Lambert / Oren-Nayar (weight 3, roughness 1)
  glossy         — GGX microfacet reflection (weight 3, roughness 1,
                   fresnel f0 handled by weight)
  refraction     — GGX microfacet transmission (weight 3, roughness 1, ior 1)
  transparent    — pass-through (weight 3)
  subsurface     — diffusion approx placeholder until random-walk SSS
                   (weight 3, radius 3)

A Mix/Add closure graph op is a weighted blend of slot weights — exactly
the semantics of the reference's closure mixing (svm_node_mix_closure),
but shape-static. Unused slots carry zero weight and cost only masked
VPU math.
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import jax.numpy as jnp

CLOSURE_VEC_KEYS = ("emission", "diffuse", "glossy", "refraction",
                    "transparent", "subsurface", "subsurface_radius",
                    "holdout", "hair", "hair_sigma",
                    "toon_diffuse", "toon_glossy", "sheen",
                    "glossy_tangent", "chair_refl", "chair_trans",
                    "custom_N")
CLOSURE_SCALAR_KEYS = ("glossy_roughness", "refraction_roughness", "ior",
                       "diffuse_roughness", "glossy_multiscatter",
                       "subsurface_burley", "hair_v", "hair_s",
                       "hair_alpha", "hair_ior",
                       "toon_diffuse_size", "toon_diffuse_smooth",
                       "toon_glossy_size", "toon_glossy_smooth",
                       "sheen_sigma", "glossy_aniso",
                       "chair_refl_r1", "chair_refl_r2", "chair_refl_off",
                       "chair_trans_r1", "chair_trans_r2", "chair_trans_off")

# vec keys that are PARAMETERS of their slot, not weights: they do not
# scale with mix factors, they blend by the slot's weight
_PARAM_VEC = {"subsurface_radius": "subsurface", "hair_sigma": "hair",
              "glossy_tangent": "glossy"}

# custom_N: per-material shading-normal override (BumpNode/NormalMapNode
# linked into BSDF normal inputs). It scales like a weight so closure
# mixes average it, but by the SCALAR mean of a color factor — a
# componentwise color scale would skew the direction. Consumers
# renormalize; all-zero means "use sd.N". This is one shared normal per
# closure stack, not the reference's per-ShaderClosure N — the
# approximation covers the dominant one-bump-per-material pattern.

# which slot's weight governs a scalar parameter's blend in add/mix
_SCALAR_SLOT = {
    "glossy_roughness": "glossy",
    "refraction_roughness": "refraction",
    "ior": "refraction",
    "diffuse_roughness": "diffuse",
    "glossy_multiscatter": "glossy",
    "subsurface_burley": "subsurface",
    "hair_v": "hair",
    "hair_s": "hair",
    "hair_alpha": "hair",
    "hair_ior": "hair",
    "toon_diffuse_size": "toon_diffuse",
    "toon_diffuse_smooth": "toon_diffuse",
    "toon_glossy_size": "toon_glossy",
    "toon_glossy_smooth": "toon_glossy",
    "sheen_sigma": "sheen",
    "glossy_aniso": "glossy",
    "chair_refl_r1": "chair_refl",
    "chair_refl_r2": "chair_refl",
    "chair_refl_off": "chair_refl",
    "chair_trans_r1": "chair_trans",
    "chair_trans_r2": "chair_trans",
    "chair_trans_off": "chair_trans",
}


def empty_closures(batch_shape):
    c = {k: jnp.zeros(batch_shape + (3,), prec.FT) for k in CLOSURE_VEC_KEYS}
    for k in CLOSURE_SCALAR_KEYS:
        c[k] = jnp.zeros(batch_shape, prec.FT)
    c["ior"] = jnp.full(batch_shape, 1.45, prec.FT)
    c["hair_ior"] = jnp.full(batch_shape, 1.55, prec.FT)
    return c


def is_closure(v):
    return isinstance(v, dict) and "diffuse" in v and "glossy" in v


# --- volume closure union (ref: kernel/closure/volume.h) ---
# sigma_t: extinction, sigma_s: scattering, emission, g: HG anisotropy.

def empty_volume_closures(batch_shape):
    return {
        "volume": True,
        "sigma_t": jnp.zeros(batch_shape + (3,), prec.FT),
        "sigma_s": jnp.zeros(batch_shape + (3,), prec.FT),
        "v_emission": jnp.zeros(batch_shape + (3,), prec.FT),
        "anisotropy": jnp.zeros(batch_shape, prec.FT),
    }


def is_volume_closure(v):
    return isinstance(v, dict) and v.get("volume") is True


def add_volume_closures(a, b):
    out = empty_volume_closures(a["sigma_t"].shape[:-1])
    for k in ("sigma_t", "sigma_s", "v_emission"):
        out[k] = a[k] + b[k]
    wa = jnp.sum(a["sigma_s"], -1)
    wb = jnp.sum(b["sigma_s"], -1)
    tot = wa + wb
    out["anisotropy"] = jnp.where(
        tot > 0.0, (a["anisotropy"] * wa + b["anisotropy"] * wb)
        / jnp.where(tot > 0.0, tot, 1.0), 0.0)
    return out


def mix_volume_closures(a, b, fac):
    fac = jnp.clip(jnp.asarray(fac), 0.0, 1.0)
    sa = {k: (a[k] * (1.0 - (fac[..., None] if a[k].ndim > fac.ndim else fac))
              if k != "volume" else True) for k in a}
    sb = {k: (b[k] * (fac[..., None] if b[k].ndim > fac.ndim else fac)
              if k != "volume" else True) for k in b}
    return add_volume_closures(sa, sb)


def scale_closures(c, fac):
    """Scale all slot weights by fac (scalar or (...,1)/(...,3))."""
    fac3 = fac if (hasattr(fac, "ndim") and fac.ndim > 0 and fac.shape[-1] == 3) \
        else jnp.asarray(fac)[..., None]
    out = dict(c)
    for k in CLOSURE_VEC_KEYS:
        if k in _PARAM_VEC:
            continue  # radius/sigma are parameters, not weights
        if k == "custom_N":
            out[k] = c[k] * jnp.mean(fac3, axis=-1, keepdims=True)
            continue
        out[k] = c[k] * fac3
    return out


def add_closures(a, b):
    """Closure add (ref: svm_node_add_closure). Scalar params blend by
    the slot weights so e.g. mixing two roughnesses is weight-correct."""
    out = {}
    for k in CLOSURE_VEC_KEYS:
        if k in _PARAM_VEC:
            continue
        out[k] = a[k] + b[k]
    for k in CLOSURE_SCALAR_KEYS:
        slot = _SCALAR_SLOT[k]
        wa = jnp.sum(a[slot], axis=-1)
        wb = jnp.sum(b[slot], axis=-1)
        tot = wa + wb
        out[k] = jnp.where(tot > 0.0,
                           (a[k] * wa + b[k] * wb) / jnp.where(tot > 0.0, tot, 1.0),
                           a[k])
    # parameter vectors blend by their slot's weight
    for k, slot in _PARAM_VEC.items():
        wa = jnp.sum(a[slot], axis=-1, keepdims=True)
        wb = jnp.sum(b[slot], axis=-1, keepdims=True)
        tot = wa + wb
        out[k] = jnp.where(
            tot > 0.0,
            (a[k] * wa + b[k] * wb) / jnp.where(tot > 0.0, tot, 1.0),
            a[k])
    return out


def mix_closures(a, b, fac):
    """Linear closure mix (ref: svm_node_mix_closure)."""
    fac = jnp.clip(jnp.asarray(fac), 0.0, 1.0)
    return add_closures(scale_closures(a, 1.0 - fac), scale_closures(b, fac))
