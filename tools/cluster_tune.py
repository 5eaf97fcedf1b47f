"""Sweep cluster-traversal tuning knobs (chunk size, cluster size) on
the attached chip. Run from repo root."""

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
    from raytracingproject_tpu.bvh import build as bvh_build
    from raytracingproject_tpu.bvh import clusters as cl_mod
    from raytracingproject_tpu.ops import cluster_intersect as ci

    N = 262144
    rng = np.random.default_rng(1)
    P = 5900
    c = rng.uniform(-5, 5, (P, 3)).astype(np.float32)
    tri = (c[:, None] + rng.uniform(-0.25, 0.25, (P, 3, 3))).astype(
        np.float32)
    bvh = bvh_build.build_bvh(tri.min(1), tri.max(1))
    tv = tri[bvh.prim_order]

    def tables(ct_size):
        cuts = cl_mod.cut_clusters(bvh.children, ct_size)
        cd = []
        for (s, cc) in cuts:
            verts = tv[s:s + cc]
            cd.append({"verts": verts, "prim": np.arange(s, s + cc),
                       "obj": np.zeros(cc, np.int32),
                       "vis": np.full(cc, 0x1FF, np.float32),
                       "lo": verts.reshape(-1, 3).min(0),
                       "hi": verts.reshape(-1, 3).max(0), "w2o": None})
        return ci.pack_cluster_table(cd)[:3]

    # incoherent rays (bounce-like) and coherent rays (camera-like)
    o_i = rng.uniform(-6, 6, (N, 3)).astype(np.float32)
    d_i = rng.normal(size=(N, 3)).astype(np.float32)
    d_i /= np.linalg.norm(d_i, axis=1, keepdims=True)
    o_c = np.tile(np.array([0, -20, 0], np.float32), (N, 1))
    px = (np.arange(N) % 512) / 512.0 - 0.5
    py = (np.arange(N) // 512) / 512.0 - 0.5
    d_c = np.stack([px, np.ones(N), py], 1).astype(np.float32)
    d_c /= np.linalg.norm(d_c, axis=1, keepdims=True)

    tmin = jnp.full((N,), 1e-4, jnp.float32)
    tmax = jnp.full((N,), 1e30, jnp.float32)
    vis = jnp.full((N,), 1, jnp.uint32)

    def timeit(fn, *args):
        r = fn(*args)
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), r)
        t0 = time.time()
        for _ in range(5):
            r = fn(*args)
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), r)
        return (time.time() - t0) / 5

    for ct_size in (16, 32, 64):
        cb, ctab, ct = tables(ct_size)
        for chunk in (8192, 16384, 32768, 65536):
            fn = jax.jit(lambda o, d, cb=jnp.asarray(cb),
                         tb=jnp.asarray(ctab), ct=ct, ch=chunk:
                         ci.intersect_clusters(cb, tb, ct, o, d, tmin,
                                               tmax, visibility=vis,
                                               chunk=ch))
            ti = timeit(fn, jnp.asarray(o_i), jnp.asarray(d_i))
            tc = timeit(fn, jnp.asarray(o_c), jnp.asarray(d_c))
            print(f"ct={ct_size:3d} C={len(cb):4d} chunk={chunk:6d} "
                  f"incoherent={ti*1e3:7.2f}ms coherent={tc*1e3:7.2f}ms",
                  flush=True)


if __name__ == "__main__":
    main()
