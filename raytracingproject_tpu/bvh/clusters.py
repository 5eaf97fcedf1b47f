"""Host-side BVH tree cut into triangle clusters.

Cluster traversal (ops/cluster_intersect.py, ops/cluster_walk_gpu.py)
replaces per-lane pointer chasing with a flat cluster list: the BVH is
cut into maximal subtrees of <= cluster_tris primitives; each cluster
becomes one wide row, fetched with a single row gather. The builder's
depth-first prim_order guarantees every subtree covers a contiguous
prim range, so a cluster is just (start, count) + a tight AABB.

Replaces the role of the reference's packed BVH layout for the
1k-40k-prim regime (ref: bvh/bvh2.cpp pack_nodes, consumed by
kernel/bvh/bvh_traversal.h:34-229 — redesigned: the traversal loop's
"which node next" becomes a data-parallel min-reduction over all
cluster entry distances, giving front-to-back order with ~3-10
iterations instead of ~150 stack steps).
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu.bvh.build import decode_leaf


def cut_clusters(children, cluster_tris):
    """Cut tree at maximal subtrees with <= cluster_tris prims.

    children: (M, 2) i32 BVH2 child array (root = node 0).
    Returns list of (start, count) prim ranges (contiguous, in
    prim_order space), covering every prim exactly once.
    """
    m = len(children)
    if m == 0:
        return []

    # subtree prim range per node, computed iteratively (deep BVHs
    # overflow Python recursion)
    ranges = {}

    def node_range(i):
        # iterative post-order
        stack = [(i, False)]
        while stack:
            n, done = stack.pop()
            if n in ranges:
                continue
            c0, c1 = int(children[n][0]), int(children[n][1])
            kids = [c for c in (c0, c1) if c >= 0]
            if not done and kids:
                stack.append((n, True))
                stack.extend((c, False) for c in kids if c not in ranges)
                continue
            lo, hi = None, None

            def acc(lo, hi, s, c):
                if c == 0:
                    return lo, hi
                lo = s if lo is None else min(lo, s)
                hi = s + c if hi is None else max(hi, s + c)
                return lo, hi

            for c in (c0, c1):
                if c >= 0:
                    s2, c2 = ranges[c]
                    lo, hi = acc(lo, hi, s2, c2)
                else:
                    s2, c2 = decode_leaf(c)
                    lo, hi = acc(lo, hi, s2, c2)
            ranges[n] = (0, 0) if lo is None else (lo, hi - lo)
        return ranges[i]

    node_range(0)

    # top-down cut: take maximal subtrees small enough
    out = []
    stack = [0]
    while stack:
        n = stack.pop()
        s, c = ranges[n]
        if c == 0:
            continue
        if c <= cluster_tris:
            out.append((s, c))
            continue
        for ch in (int(children[n][0]), int(children[n][1])):
            if ch >= 0:
                stack.append(ch)
            else:
                s2, c2 = decode_leaf(ch)
                if c2 > 0:
                    # an oversize leaf cannot happen (builder leaf size
                    # << cluster_tris) but split defensively
                    for k in range(0, c2, cluster_tris):
                        out.append((s2 + k, min(cluster_tris, c2 - k)))
    out.sort()
    # verify full disjoint coverage
    total = sum(c for _, c in out)
    end = 0
    for s, c in out:
        assert s == end, f"cluster ranges not contiguous: {s} != {end}"
        end = s + c
    return out


def cluster_bounds(tri_verts, clusters):
    """Tight world/object-space AABBs per cluster.

    tri_verts: (P, 3, 3) in prim_order; clusters: [(start, count)].
    Returns (C, 3) lo, (C, 3) hi.
    """
    lo = np.zeros((len(clusters), 3), np.float32)
    hi = np.zeros((len(clusters), 3), np.float32)
    for i, (s, c) in enumerate(clusters):
        v = tri_verts[s:s + c].reshape(-1, 3)
        lo[i] = v.min(0)
        hi[i] = v.max(0)
    return lo, hi
