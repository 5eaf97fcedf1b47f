"""Per-entry light-row snapshot tables (models/scene.py _pack_lights).

The NEE pick's prim/object/lamp row fetches collapse to D-row tables
indexed by the entry index. The snapshot rows are verbatim copies, so
sample_light must return BIT-EXACT results with and without them
(ref parity style: kernel_light.h light_sample is one code path; here
the fast path must be indistinguishable).
"""
import numpy as np
import jax.numpy as jnp

from raytracingproject_tpu.app import examples
from raytracingproject_tpu.ops import light as light_ops


def _sample_both(scene, n=4096, seed=3):
    scene.device_update()
    kg = scene.make_kernel_globals()
    ds = kg["dscene"]
    assert "le_prim_rows" in ds, "snapshot tables missing"
    rng = np.random.default_rng(seed)
    P = jnp.asarray(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    u_sel = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
    u1 = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
    u2 = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
    fast = light_ops.sample_light(ds, P, u_sel, u1, u2)
    ds_slow = {k: v for k, v in ds.items()
               if not k.startswith("le_")}
    slow = light_ops.sample_light(ds_slow, P, u_sel, u1, u2)
    return fast, slow


def _assert_bitexact(fast, slow):
    for k in slow:
        if k == "rows":
            for rk in slow[k]:
                np.testing.assert_array_equal(
                    np.asarray(fast[k][rk]), np.asarray(slow[k][rk]),
                    err_msg=f"rows[{rk}]")
            continue
        np.testing.assert_array_equal(
            np.asarray(fast[k]), np.asarray(slow[k]), err_msg=k)


def test_snapshot_bitexact_tri_lights():
    fast, slow = _sample_both(examples.cornell_box(64, 64, spp=1))
    _assert_bitexact(fast, slow)


def test_snapshot_bitexact_lamp_mix():
    # scene with point/area lamps + emissive geometry covers both
    # entry types through the same snapshot
    scene = examples.cornell_box(64, 64, spp=1)
    from raytracingproject_tpu.models.light import Light
    scene.add_light(Light("p0", light_type="point", co=(0.2, 0.3, 0.4),
                          strength=(5.0, 4.0, 3.0), size=0.1))
    scene.add_light(Light("a0", light_type="area", co=(0.0, 0.9, 0.0),
                          axisu=(1.0, 0.0, 0.0),
                          axisv=(0.0, 0.0, 1.0),
                          sizeu=0.4, sizev=0.3,
                          strength=(2.0, 2.0, 2.0)))
    fast, slow = _sample_both(scene)
    _assert_bitexact(fast, slow)


def test_render_parity_with_and_without_snapshot():
    # full integrator: one sample, bit-exact image parity
    import jax
    from raytracingproject_tpu.ops import integrator as integ
    scene = examples.cornell_box(32, 32, spp=1)
    scene.device_update()
    kg = scene.make_kernel_globals()
    yy, xx = np.mgrid[0:32, 0:32]
    px = jnp.asarray(xx.reshape(-1), jnp.int32)
    py = jnp.asarray(yy.reshape(-1), jnp.int32)
    L1, _ = jax.jit(lambda: integ.render_samples(
        kg, px, py, py * 32 + px, jnp.uint32(0), 1))()
    kg2 = dict(kg)
    kg2["dscene"] = {k: v for k, v in kg["dscene"].items()
                     if not k.startswith("le_")}
    L2, _ = jax.jit(lambda: integ.render_samples(
        kg2, px, py, py * 32 + px, jnp.uint32(0), 1))()
    # sample_light itself is bit-exact (tests above); the two jit
    # graphs fuse/FMA-contract differently around the (now-absent)
    # one-hot fetch, so exact zeros at clamped-cosine boundaries pick
    # up ~1e-5 of cross-graph noise. Tight tolerance, not equality.
    np.testing.assert_allclose(np.asarray(L1), np.asarray(L2),
                               atol=2e-5, rtol=0.0)
