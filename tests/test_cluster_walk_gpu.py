"""The GPU cluster walk (ops/cluster_walk_gpu.py): interpret-mode parity
with the XLA shortlist over scenes, hit modes and lane counts, the
wrapper's padding and per-lane windows, the integrator's choice of
kernel, and (on a card only) the compiled kernel."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracingproject_tpu.app import examples
from raytracingproject_tpu.bvh import build as bvh_build
from raytracingproject_tpu.bvh import clusters as cl_mod
from raytracingproject_tpu.models import object as ob
from raytracingproject_tpu.ops import cluster_intersect as ci
from raytracingproject_tpu.ops import cluster_walk_gpu as cwg
from raytracingproject_tpu.ops import integrator as integ


@functools.lru_cache(maxsize=None)
def _scene_tables(name):
    """(cbounds, ctable, cluster_tris, has_instances, has_motion, box)
    for one test scene; box is the (lo, hi) the random rays start in."""
    if name == "motion":
        # deforming triangles: rows carry per-tri shutter deltas
        rng = np.random.default_rng(5)
        p = 1500
        centers = rng.uniform(-5, 5, (p, 3)).astype(np.float32)
        tv0 = (centers[:, None, :]
               + rng.normal(0, 0.4, (p, 3, 3))).astype(np.float32)
        tv1 = (tv0 + rng.normal(0, 0.6, (p, 1, 3))).astype(np.float32)
        b = bvh_build.build_bvh(np.minimum(tv0.min(1), tv1.min(1)),
                                np.maximum(tv0.max(1), tv1.max(1)))
        v0o, v1o = tv0[b.prim_order], tv1[b.prim_order]
        cds = []
        for (s, c) in cl_mod.cut_clusters(b.children, 16):
            allv = np.concatenate([v0o[s:s + c],
                                   v1o[s:s + c]]).reshape(-1, 3)
            cds.append({"verts": v0o[s:s + c], "verts_t1": v1o[s:s + c],
                        "prim": np.arange(s, s + c),
                        "obj": np.zeros(c, np.int32),
                        "vis": np.full(c, 0xFFFFFFFF, np.uint32),
                        "w2o": None, "lo": allv.min(0), "hi": allv.max(0)})
        cb, ctab, ct, motion = ci.pack_cluster_table(cds)
        assert motion
        return (jnp.asarray(cb), jnp.asarray(ctab), ct, False, True,
                ((-8, -8, -8), (8, 8, 8)))
    factory, kw, box = {
        "glossy": ("cornell_box", {"spheres": "glossy"},
                   ((-300,) * 3, (900,) * 3)),
        # grid 6 keeps real instances: rows carry world->object transforms
        "instanced": ("instanced_scene", {"grid": 6},
                      ((-20,) * 3, (20,) * 3)),
        "dof": ("dof_motion_scene", {}, ((-300,) * 3, (900,) * 3)),
    }[name]
    scene = getattr(examples, factory)(16, 16, spp=1, **kw)
    scene.device_update()
    kg = scene.make_kernel_globals()
    ds = kg["dscene"]
    assert "cluster_bounds" in ds
    return (ds["cluster_bounds"], ds["cluster_table"],
            int(kg["cluster_tris"]), bool(kg.get("has_instances", False)),
            bool(kg.get("cluster_motion", False)), box)


def _rays(n, seed, box):
    rng = np.random.default_rng(seed)
    o = rng.uniform(box[0], box[1], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _both(name, o, d, tmin, tmax, vis=None, shadow=False, time=None):
    cb, ctab, ct, inst, motion, _ = _scene_tables(name)
    if motion and time is None:
        time = jnp.asarray(np.random.default_rng(9).uniform(
            0, 1, o.shape[0]), jnp.float32)
    kw = dict(visibility=vis, shadow_any_hit=shadow, has_instances=inst,
              time=time, has_motion=motion)
    ref = ci.intersect_clusters(cb, ctab, ct, o, d, tmin, tmax, **kw)
    got = cwg.intersect_clusters_gpu(cb, ctab, ct, o, d, tmin, tmax,
                                     interpret=True, **kw)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: np.asarray(v) for k, v in got.items()})


@pytest.mark.parametrize("n", [1000, 2048])
@pytest.mark.parametrize("shadow", [False, True],
                         ids=["closest", "anyhit"])
@pytest.mark.parametrize("name", ["glossy", "instanced", "motion", "dof"])
def test_walk_matches_shortlist(name, shadow, n):
    box = _scene_tables(name)[5]
    o, d = _rays(n, 11, box)
    tmin = jnp.full((n,), 1e-4, jnp.float32)
    tmax = jnp.full((n,), 1e30, jnp.float32)
    vis = jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32)
    ref, got = _both(name, o, d, tmin, tmax, vis, shadow)
    summary = cwg.check_parity(ref, got, shadow)
    assert summary["hit_frac"] > 0.05       # the rays really hit
    np.testing.assert_array_equal(ref["prim"] >= 0, got["prim"] >= 0)
    if not shadow:
        np.testing.assert_array_equal(ref["prim"], got["prim"])
        np.testing.assert_array_equal(ref["object"], got["object"])


def test_instanced_tables_carry_transforms():
    # the "instanced" cases above exercise the per-lane w2o path
    assert _scene_tables("instanced")[3]


def test_visibility_masks():
    """Per-lane ray visibility against per-triangle object visibility:
    lanes whose mask shares no bit with the row see nothing."""
    n = 1024
    box = _scene_tables("glossy")[5]
    o, d = _rays(n, 12, box)
    rng = np.random.default_rng(13)
    vis = jnp.asarray(rng.choice(
        [0, ob.PATH_RAY_CAMERA, ob.PATH_RAY_SHADOW, ob.PATH_RAY_DIFFUSE,
         ob.PATH_RAY_GLOSSY], n).astype(np.uint32))
    tmin = jnp.full((n,), 1e-4, jnp.float32)
    tmax = jnp.full((n,), 1e30, jnp.float32)
    ref, got = _both("glossy", o, d, tmin, tmax, vis)
    cwg.check_parity(ref, got)
    assert not (got["prim"][np.asarray(vis) == 0] >= 0).any()
    assert (got["prim"] >= 0).any()


def test_per_lane_windows_and_disabled_lanes():
    """Per-lane [tmin, tmax] windows, and lanes with an empty window
    (tmax < tmin), as the NEE call sites build them."""
    n = 1024
    box = _scene_tables("glossy")[5]
    o, d = _rays(n, 14, box)
    rng = np.random.default_rng(15)
    tmin = jnp.asarray(rng.uniform(0.0, 200.0, n), jnp.float32)
    tmax = jnp.asarray(np.where(rng.uniform(size=n) < 0.3, -1.0,
                                rng.uniform(50.0, 900.0, n)), jnp.float32)
    for shadow in (False, True):
        ref, got = _both("glossy", o, d, tmin, tmax, shadow=shadow)
        cwg.check_parity(ref, got, shadow)
        off = np.asarray(tmax) < np.asarray(tmin)
        assert not (got["prim"][off] >= 0).any()
        hit = got["prim"] >= 0
        assert np.all(got["t"][hit] > np.asarray(tmin)[hit])
        assert np.all(got["t"][hit] < np.asarray(tmax)[hit])


@pytest.mark.parametrize("n", [1, 5, 127, 129])
def test_wrapper_pads_to_blocks(n):
    """Lane counts that are not a multiple of the block come back at
    their own length, with the same hits as the shortlist."""
    box = _scene_tables("glossy")[5]
    o, d = _rays(n, 16, box)
    tmin = jnp.full((n,), 1e-4, jnp.float32)
    tmax = jnp.full((n,), 1e30, jnp.float32)
    ref, got = _both("glossy", o, d, tmin, tmax)
    assert all(v.shape == (n,) for v in got.values())
    cwg.check_parity(ref, got)
    # misses report the ray's own far bound, like the shortlist
    miss = got["prim"] < 0
    np.testing.assert_array_equal(got["t"][miss], ref["t"][miss])


def test_check_parity_flags_a_wrong_winner():
    ref = {"t": np.array([1.0, 2.0]), "prim": np.array([3, -1]),
           "u": np.zeros(2), "v": np.zeros(2), "object": np.array([0, -1])}
    bad = dict(ref, prim=np.array([4, -1]))
    with pytest.raises(AssertionError):
        cwg.check_parity(ref, bad)
    # in any-hit mode only blocked-ness counts
    cwg.check_parity(ref, bad, shadow_any_hit=True)


def _glossy_kg():
    scene = examples.cornell_box(16, 16, spp=1, spheres="glossy")
    scene.device_update()
    return scene.make_kernel_globals()


def test_kernel_choice():
    """The walk runs on the GPU, or in interpret mode when a test asks;
    the CPU and `pallas_clusters=False` keep the shortlist."""
    kg = _glossy_kg()
    on_gpu = jax.default_backend() == "gpu"
    assert integ._use_cluster_walk_gpu(kg) == on_gpu
    assert integ._use_cluster_walk_gpu({**kg, "pallas_interpret": True})
    assert not integ._use_cluster_walk_gpu({**kg, "pallas_clusters": False})


def test_integrator_dispatches_to_walk(monkeypatch):
    kg = {**_glossy_kg(), "use_brute": False}
    calls = {"walk": 0, "xla": 0}
    real_walk, real_xla = cwg.intersect_clusters_gpu, ci.intersect_clusters

    def walk(*a, **k):
        calls["walk"] += 1
        return real_walk(*a, **k)

    def xla(*a, **k):
        calls["xla"] += 1
        return real_xla(*a, **k)

    monkeypatch.setattr(cwg, "intersect_clusters_gpu", walk)
    monkeypatch.setattr(ci, "intersect_clusters", xla)
    n = 256
    o, d = _rays(n, 17, _scene_tables("glossy")[5])
    tmin = jnp.full((n,), 1e-4, jnp.float32)
    tmax = jnp.full((n,), 1e30, jnp.float32)
    vis = jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32)
    h_walk = integ._scene_intersect_tris({**kg, "pallas_interpret": True},
                                         o, d, tmin, tmax, vis)
    h_xla = integ._scene_intersect_tris(kg, o, d, tmin, tmax, vis)
    assert calls == {"walk": 1, "xla": 1}
    np.testing.assert_array_equal(np.asarray(h_walk["prim"]),
                                  np.asarray(h_xla["prim"]))


@pytest.mark.gpu
def test_compiled_walk_matches_shortlist(gpu_device):
    """The Triton-compiled walk on the card (skips without one)."""
    n = 65536
    cb, ctab, ct, inst, motion, box = _scene_tables("glossy")
    o, d = _rays(n, 18, box)
    tmin = jnp.full((n,), 1e-4, jnp.float32)
    tmax = jnp.full((n,), 1e30, jnp.float32)
    vis = jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32)
    with jax.default_device(gpu_device):
        for shadow in (False, True):
            kw = dict(visibility=vis, shadow_any_hit=shadow,
                      has_instances=inst)
            ref = ci.intersect_clusters(cb, ctab, ct, o, d, tmin, tmax, **kw)
            got = cwg.intersect_clusters_gpu(cb, ctab, ct, o, d, tmin,
                                             tmax, **kw)
            cwg.check_parity(ref, got, shadow)
