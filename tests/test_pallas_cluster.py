"""Triton cluster walk vs the XLA shortlist (ops/cluster_walk_gpu.py vs
ops/cluster_intersect.py — same watertight math and the same visiting
order, so hits must agree; ref kernel/bvh/bvh_traversal.h:34-229).

Runs the kernel in interpret mode on the CPU: semantics only. The
compiled kernel is checked on the card by chip_smoke.py (phase 4) and by
the `gpu`-marked test in tests/test_cluster_walk_gpu.py."""

import numpy as np
import jax.numpy as jnp

from raytracingproject_tpu.app import examples
from raytracingproject_tpu.ops import cluster_intersect as ci
from raytracingproject_tpu.ops import cluster_walk_gpu as cwg
from raytracingproject_tpu.models import object as ob


def _cluster_scene(factory="cornell_box", **kw):
    scene = getattr(examples, factory)(64, 64, spp=2, **kw)
    scene.device_update()
    kg = scene.make_kernel_globals()
    ds = kg["dscene"]
    assert "cluster_bounds" in ds, "scene must use the cluster path"
    return kg, ds


def _rand_rays(n, seed, lo=(-300, -300, -300), hi=(900, 900, 900)):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _compare(kg, ds, o, d, shadow=False):
    n = o.shape[0]
    tmin = jnp.full((n,), 1e-4, jnp.float32)
    tmax = jnp.full((n,), 1e30, jnp.float32)
    vis = jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32)
    has_inst = bool(kg.get("has_instances", False))
    ref = ci.intersect_clusters(
        ds["cluster_bounds"], ds["cluster_table"],
        int(kg["cluster_tris"]), o, d, tmin, tmax,
        visibility=vis, shadow_any_hit=shadow, has_instances=has_inst)
    got = cwg.intersect_clusters_gpu(
        ds["cluster_bounds"], ds["cluster_table"],
        int(kg["cluster_tris"]), o, d, tmin, tmax, visibility=vis,
        shadow_any_hit=shadow, has_instances=has_inst, interpret=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: np.asarray(v) for k, v in got.items()}
    cwg.check_parity(ref, got, shadow)
    if shadow:
        # any-hit: only blocked-ness is contractual
        np.testing.assert_array_equal(ref["prim"] >= 0, got["prim"] >= 0)
        return ref, got
    np.testing.assert_array_equal(ref["prim"] >= 0, got["prim"] >= 0,
                                  err_msg="hit masks differ")
    np.testing.assert_array_equal(ref["prim"], got["prim"])
    np.testing.assert_array_equal(ref["object"], got["object"])
    # identical watertight math, but the two compilation contexts keep
    # FMA-contraction freedom — t/u/v may drift a few ulps
    np.testing.assert_allclose(ref["t"], got["t"], rtol=1e-5)
    np.testing.assert_allclose(ref["u"], got["u"], atol=1e-5)
    np.testing.assert_allclose(ref["v"], got["v"], atol=1e-5)
    return ref, got


class TestParity:
    def test_glossy_cornell_random_rays(self):
        kg, ds = _cluster_scene(spheres="glossy")
        o, d = _rand_rays(2048, 1)
        ref, _ = _compare(kg, ds, o, d)
        assert (ref["prim"] >= 0).mean() > 0.2  # scene actually hit

    def test_instanced_scene(self):
        kg, ds = _cluster_scene("instanced_scene")
        o, d = _rand_rays(1024, 2, lo=(-20, -20, -20), hi=(20, 20, 20))
        ref, _ = _compare(kg, ds, o, d)
        assert (ref["prim"] >= 0).any()

    def test_shadow_any_hit(self):
        kg, ds = _cluster_scene(spheres="glossy")
        o, d = _rand_rays(1024, 3)
        _compare(kg, ds, o, d, shadow=True)

    def test_nonaligned_lane_count(self):
        kg, ds = _cluster_scene(spheres="glossy")
        o, d = _rand_rays(1000, 4)     # forces padding
        _compare(kg, ds, o, d)

    def test_motion_clusters(self):
        kg, ds = _cluster_scene("dof_motion_scene")
        has_motion = bool(kg.get("cluster_motion", False))
        o, d = _rand_rays(512, 5)
        n = o.shape[0]
        tmin = jnp.full((n,), 1e-4, jnp.float32)
        tmax = jnp.full((n,), 1e30, jnp.float32)
        vis = jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32)
        time = jnp.asarray(
            np.random.default_rng(9).uniform(0, 1, n), jnp.float32)
        ref = ci.intersect_clusters(
            ds["cluster_bounds"], ds["cluster_table"],
            int(kg["cluster_tris"]), o, d, tmin, tmax, visibility=vis,
            has_instances=bool(kg.get("has_instances", False)),
            time=time, has_motion=has_motion)
        got = cwg.intersect_clusters_gpu(
            ds["cluster_bounds"], ds["cluster_table"],
            int(kg["cluster_tris"]), o, d, tmin, tmax, visibility=vis,
            has_instances=bool(kg.get("has_instances", False)),
            time=time, has_motion=has_motion, interpret=True)
        np.testing.assert_array_equal(np.asarray(ref["t"]),
                                      np.asarray(got["t"]))
        np.testing.assert_array_equal(np.asarray(ref["prim"]),
                                      np.asarray(got["prim"]))
