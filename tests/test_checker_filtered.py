"""Analytic box-filtered checker (models/shader_nodes.py
CheckerTextureNode): the filtered value must (1) match the point
sample away from cell edges, (2) be Lipschitz-continuous across an
edge — an eps position perturbation moves it O(eps/width), never O(1)
(the decision-flip noise the r03 RMSE run measured on
textured_instanced), and (3) integrate to the exact cell average.
Ref: svm_checker.h point sampler; the filtering is an addition of
this renderer (documented divergence)."""

import numpy as np
import jax.numpy as jnp

from raytracingproject_tpu.models import shader_nodes as sn
from raytracingproject_tpu.ops.shade import ShaderData
from raytracingproject_tpu.utils import precision as prec


class _Tex:
    pixel_angle = 2.7e-3


def _ctx(P, ray_length=None, with_jac=True):
    n = P.shape[0]
    gen_tfm = None
    if with_jac:
        gen_tfm = jnp.broadcast_to(
            jnp.asarray(np.eye(3, 4, dtype=np.float32)), (n, 3, 4))
    return ShaderData(
        generated=jnp.asarray(P, prec.FT),
        ray_length=None if ray_length is None
        else jnp.full((n,), ray_length, prec.FT),
        gen_tfm=gen_tfm, textures=_Tex(), batch_shape=(n,))


def _fac(ctx, scale=1.0):
    node = sn.CheckerTextureNode("c", scale=scale)
    inp = {"vector": None, "color1": (1.0, 1.0, 1.0),
           "color2": (0.0, 0.0, 0.0), "scale": scale}
    return np.asarray(node.eval(ctx, inp)["fac"])


class TestFilteredChecker:
    def test_matches_point_sample_mid_cell(self):
        P = np.array([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5],
                      [1.5, 1.5, 0.5], [2.5, -0.5, 0.5]], np.float32)
        expect = [(int(np.floor(p[0] + 1e-5)) + int(np.floor(p[1] + 1e-5))
                   + int(np.floor(p[2] + 1e-5))) % 2 == 0 for p in P]
        filt = _fac(_ctx(P, ray_length=10.0))
        point = _fac(_ctx(P, ray_length=None))
        np.testing.assert_allclose(filt, np.float32(expect), atol=1e-3)
        np.testing.assert_allclose(point, np.float32(expect), atol=0)

    def test_continuous_across_edge(self):
        # straddle x=1.0 (past the +1e-5 seam offset): the point
        # sampler flips 0 <-> 1; the filtered value moves eps/width
        eps = 5e-5
        P = np.array([[1.0 - eps, 0.5, 0.5], [1.0 + eps, 0.5, 0.5]],
                     np.float32)
        ctx = _ctx(P, ray_length=10.0)  # width = 10 * 2.7e-3 = 0.027
        f = _fac(ctx)
        assert abs(f[0] - f[1]) < 2 * eps / 0.027 + 1e-4, f
        point = _fac(_ctx(P, ray_length=None))
        assert abs(point[0] - point[1]) == 1.0  # the flip being fixed

    def test_wide_footprint_averages_to_half(self):
        P = np.array([[0.3, 0.7, 0.2]], np.float32)
        ctx = _ctx(P, ray_length=10000.0)  # width >> cell
        f = _fac(ctx)
        np.testing.assert_allclose(f, 0.5, atol=5e-2)

    def test_exact_average_one_axis(self):
        # exactly one full period on x -> per-axis mean 0 -> fac 0.5
        P = np.array([[1.0, 0.25, 0.25]], np.float32)
        node = sn.CheckerTextureNode("c", scale=1.0)
        ctx = _ctx(P, ray_length=10.0)
        inp = {"vector": None, "color1": (1.0, 1.0, 1.0),
               "color2": (0.0, 0.0, 0.0), "scale": 1.0}
        out = node.eval(ctx, inp)
        # Monte-Carlo cross-check of the analytic box integral
        w = 10.0 * 2.7e-3
        rng = np.random.default_rng(0)
        q = P[0][None] + 1e-5 + (rng.uniform(-0.5, 0.5, (200000, 3))
                                 * w).astype(np.float64)
        idx = np.floor(q).astype(int)
        mc = ((idx.sum(1) & 1) == 0).mean()
        np.testing.assert_allclose(np.asarray(out["fac"])[0], mc, atol=5e-3)
