"""Learned kernel-predicting denoiser (KPCN-style).

The reference ships learned denoisers as closed backends — the OptiX
AI denoiser (device/device_optix.cpp:669 launch_denoise ->
optixDenoiserInvoke) and OpenImageDenoise
(device/device_cpu.cpp:952 denoise_openimagedenoise_buffer). The
analog here is a small kernel-predicting CNN in JAX (Bako et al.
2017's KPCN idea at toy scale): a conv net over [color, albedo,
normal] predicts a per-pixel softmax filter kernel applied to the
noisy radiance. Predicting WEIGHTS (not colors) keeps the output a
convex combination of observed radiance — no color shift, energy
bounded by construction, and the convs are plain XLA convolutions.

Weights are trained offline on this renderer's own output
(tools/kpcn_train.py: low-spp renders + aux features vs high-spp
references of the example scenes) and shipped as a tiny .npz.
Architecture: 4x conv3x3 (9 -> W -> W -> W -> K*K), ReLU, softmax over
the K*K kernel axis. ~30k params at W=32, K=7.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

K = 7          # predicted filter kernel size (KxK neighborhood)
WIDTH = 32     # hidden conv width
CIN = 9        # color(3) + albedo(3) + normal(3)

WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "artifacts", "kpcn_weights.npz")


def init_params(seed=0, width=WIDTH, k=K, cin=CIN):
    """He-initialized conv stack [(3,3,cin,w), (3,3,w,w), (3,3,w,w),
    (3,3,w,k*k)] + biases."""
    rng = np.random.default_rng(seed)
    shapes = [(3, 3, cin, width), (3, 3, width, width),
              (3, 3, width, width), (3, 3, width, k * k)]
    params = []
    for s in shapes:
        fan_in = s[0] * s[1] * s[2]
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in), s).astype(np.float32)
        params.append((jnp.asarray(w),
                       jnp.zeros((s[3],), jnp.float32)))
    return params


def _conv(x, w, b):
    # HIGHEST: a default-precision float32 conv may run in TF32 on the
    # GPU, which would move the filter weights off the trained ones
    y = jax.lax.conv_general_dilated(
        x[None], w, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)[0]
    return y + b


def _features(color, albedo, normal):
    # log1p compresses radiance range (fireflies would otherwise
    # dominate the conv activations); features pass through
    c = jnp.log1p(jnp.maximum(jnp.asarray(color, jnp.float32), 0.0))
    f = [c]
    f.append(jnp.zeros_like(c) if albedo is None
             else jnp.asarray(albedo, jnp.float32))
    f.append(jnp.zeros_like(c) if normal is None
             else jnp.asarray(normal, jnp.float32))
    return jnp.concatenate(f, axis=-1)


def predict_kernels(params, color, albedo=None, normal=None):
    """(H, W, K*K) softmax filter weights from the feature stack."""
    x = _features(color, albedo, normal)
    for (w, b) in params[:-1]:
        x = jax.nn.relu(_conv(x, w, b))
    logits = _conv(x, *params[-1])
    return jax.nn.softmax(logits, axis=-1)


def apply_kernels(weights, color):
    """Apply per-pixel (H, W, K*K) weights to the KxK neighborhood of
    color (edge-padded) — a convex combination of observed radiance."""
    color = jnp.asarray(color, jnp.float32)
    r = K // 2
    cp = jnp.pad(color, ((r, r), (r, r), (0, 0)), mode="edge")
    h, w = color.shape[:2]
    out = jnp.zeros_like(color)
    idx = 0
    for dy in range(K):
        for dx in range(K):
            out = out + weights[..., idx:idx + 1] \
                * jax.lax.dynamic_slice(cp, (dy, dx, 0), (h, w, 3))
            idx += 1
    return out


def kpcn_denoise(color, albedo=None, normal=None, params=None):
    """Denoise (H, W, 3) linear radiance with the learned kernel
    predictor. Loads the shipped weights when params is None; raises
    FileNotFoundError if none are packaged."""
    if params is None:
        params = load_params()
    wts = predict_kernels(params, color, albedo, normal)
    return apply_kernels(wts, color)


_CACHED = None


def load_params(path=None):
    global _CACHED
    if _CACHED is not None and path is None:
        return _CACHED
    p = path or WEIGHTS_PATH
    z = np.load(p)
    n = int(z["n_layers"])
    params = [(jnp.asarray(z[f"w{i}"]), jnp.asarray(z[f"b{i}"]))
              for i in range(n)]
    if path is None:
        _CACHED = params
    return params


def save_params(params, path=None):
    p = path or WEIGHTS_PATH
    out = {"n_layers": np.int32(len(params))}
    for i, (w, b) in enumerate(params):
        out[f"w{i}"] = np.asarray(w)
        out[f"b{i}"] = np.asarray(b)
    np.savez_compressed(p, **out)
    return p


def has_weights():
    return os.path.exists(WEIGHTS_PATH)
