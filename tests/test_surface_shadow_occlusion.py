"""Surface-NEE shadow rays through the cluster walk.

integrator._shadow_blocked on cluster scenes routes the pure any-hit
through the traversal dispatch; on the GPU that is the Triton cluster
walk (ops/cluster_walk_gpu.py, run here in interpret mode). The boolean
must match the dense brute-force sweep exactly (ref contract:
kernel/kernel_shadow.h shadow_blocked opaque fast path), and a render
through the walk must match the render through the XLA shortlist.
"""
import numpy as np
import jax.numpy as jnp

from raytracingproject_tpu.app import examples
from raytracingproject_tpu.ops import integrator as integ


def _glossy_kg():
    scene = examples.cornell_box(32, 32, spp=2, spheres="glossy")
    scene.device_update()
    kg = scene.make_kernel_globals()
    assert "cluster_bounds" in kg["dscene"]
    return kg


def _rand_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform((-50, -50, 0), (600, 600, 550), (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32))


def test_shadow_blocked_parity_surface_scene():
    kg = _glossy_kg()
    o, d = _rand_rays(2048, 7)
    n = o.shape[0]
    tmin = jnp.full((n,), 1e-5, jnp.float32)
    rng = np.random.default_rng(8)
    # realistic NEE mix: disabled lanes (tmax=tmin) + finite segments
    tmax = jnp.asarray(np.where(rng.uniform(size=n) < 0.3, 1e-5,
                                rng.uniform(10.0, 900.0, n)), jnp.float32)
    ref = integ._shadow_blocked({**kg, "use_brute": True}, o, d, tmin, tmax)
    got = integ._shadow_blocked(
        {**kg, "use_brute": False, "pallas_interpret": True},
        o, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))
    assert np.asarray(ref).any() and not np.asarray(ref).all()


def test_glossy_render_end_to_end_parity():
    import jax
    scene = examples.cornell_box(16, 16, spp=4, spheres="glossy")
    scene.device_update()
    kg = {**scene.make_kernel_globals(), "use_brute": False}
    yy, xx = np.mgrid[0:16, 0:16]
    px = jnp.asarray(xx.reshape(-1), jnp.int32)
    py = jnp.asarray(yy.reshape(-1), jnp.int32)
    pidx = py * 16 + px

    def render(kg2):
        L, _ = jax.jit(lambda a, b, c: integ.render_samples(
            kg2, a, b, c, 0, 4))(px, py, pidx)
        return np.asarray(L).reshape(16, 16, 3) / 4

    xla = render({**kg, "pallas_clusters": False})
    walk = render({**kg, "pallas_interpret": True})
    assert np.isfinite(walk).all()
    # same hits; only cross-graph FMA noise can differ
    np.testing.assert_allclose(walk, xla, atol=1e-4, rtol=1e-4)
