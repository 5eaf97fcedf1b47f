"""Measure dense vs packed-walk vs cluster traversal on the attached
chip (run from repo root). Drives the intersect kernels directly on a
262144-lane wavefront of camera + incoherent rays over scenes of
increasing prim count."""

import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time
import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from raytracingproject_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    from raytracingproject_tpu.app import examples
    from raytracingproject_tpu.ops import intersect as isect
    from raytracingproject_tpu.ops import cluster_intersect as ci
    from raytracingproject_tpu.models import object as ob

    N = 262144
    rng = np.random.default_rng(1)

    def make_rays(kg, w=512, h=512):
        # half coherent camera-style, half incoherent bounce-style
        lo = np.array([50, 50, 50], np.float32)
        hi = np.array([500, 500, 500], np.float32)
        o = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
        d = rng.normal(size=(N, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return (jnp.asarray(o), jnp.asarray(d),
                jnp.full((N,), 1e-4, jnp.float32),
                jnp.full((N,), 1e30, jnp.float32),
                jnp.full((N,), ob.PATH_RAY_CAMERA, jnp.uint32))

    def timeit(fn, *args):
        r = fn(*args)
        jax.tree_util.tree_map(
            lambda x: x.block_until_ready(), r)
        t0 = time.time()
        for _ in range(5):
            r = fn(*args)
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), r)
        return (time.time() - t0) / 5

    for nlat, label in ((16, "glossy-cornell ~2k"), (32, "~8k"),
                        (48, "~18k")):
        scene = examples.cornell_box(64, 64, spp=1, spheres="glossy")
        # swap sphere tessellation for size sweeps
        from raytracingproject_tpu.models.mesh import make_sphere_mesh
        from raytracingproject_tpu.models import Object
        s3 = make_sphere_mesh((278, 279, 350), 80, 0, nlat=nlat,
                              nlon=nlat * 2, name="extra")
        s3.used_shaders = [scene.shaders[0]]
        scene.add_object(Object("extra", s3))
        scene.device_update()
        kg = scene.make_kernel_globals()
        ds = kg["dscene"]
        P = ds["tri_verts"].shape[0]
        o, d, tmin, tmax, vis = make_rays(kg)

        res = {}
        dense = jax.jit(lambda o, d, a, b, v: isect.intersect_brute(
            ds["tri_verts_world"], ds["prim_object_packed"], o, d, a, b,
            visibility=v, object_visibility=ds["object_visibility"]))
        res["dense"] = timeit(dense, o, d, tmin, tmax, vis)

        packed = jax.jit(lambda o, d, a, b, v: isect.intersect_bvh_packed(
            ds["bvh_nodes_packed"], ds["bvh_leaf_blocks"], o, d, a, b,
            has_instances=False, o_world=o, d_world=d,
            prim_object=ds["prim_object_packed"], visibility=v,
            object_visibility=ds["object_visibility"]))
        res["packed"] = timeit(packed, o, d, tmin, tmax, vis)

        if "cluster_bounds" in ds:
            clus = jax.jit(lambda o, d, a, b, v: ci.intersect_clusters(
                ds["cluster_bounds"], ds["cluster_table"],
                int(kg["cluster_tris"]), o, d, a, b, visibility=v))
            res["cluster"] = timeit(clus, o, d, tmin, tmax, vis)
            # parity spot check
            hc = clus(o, d, tmin, tmax, vis)
            hd = dense(o, d, tmin, tmax, vis)
            match = float(np.mean(np.asarray(hc["prim"])
                                  == np.asarray(hd["prim"])))
        else:
            match = -1
        print(f"P={P} ({label}) C="
              f"{ds.get('cluster_bounds', np.zeros((0,))).shape[0]} "
              + " ".join(f"{k}={v*1e3:.2f}ms" for k, v in res.items())
              + f" parity={match:.4f}", flush=True)


if __name__ == "__main__":
    main()
