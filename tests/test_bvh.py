"""BVH build + traversal golden tests (ref test model: the reference has
no kernel unit tests and relies on image tests — we add traversal goldens
because the wavefront traversal is novel code)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracingproject_tpu.bvh import build as bb
from raytracingproject_tpu.ops import intersect as isect


def random_tris(n, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n, 1, 3))
    tris = base + rng.uniform(-1.0, 1.0, (n, 3, 3))
    return tris.astype(np.float32)


class TestBuild:
    def test_leaf_coverage(self):
        tris = random_tris(100)
        bvh = bb.build_bvh(tris.min(1), tris.max(1))
        # every primitive appears exactly once in prim_order
        assert sorted(bvh.prim_order.tolist()) == list(range(100))

    def test_leaf_encoding_roundtrip(self):
        enc = bb.encode_leaf(1234, 7)
        assert enc < 0
        assert bb.decode_leaf(enc) == (1234, 7)

    def test_node_bounds_contain_prims(self):
        tris = random_tris(64, seed=1)
        bvh = bb.build_bvh(tris.min(1), tris.max(1))
        ordered = tris[bvh.prim_order]
        # walk tree, check leaves are inside their recorded child bounds
        stack = [(0, None)]
        while stack:
            node, bound = stack.pop()
            if node < 0:
                start, count = bb.decode_leaf(node)
                if count and bound is not None:
                    lo, hi = bound
                    seg = ordered[start:start + count]
                    assert (seg.min((0, 1)) >= lo - 1e-4).all()
                    assert (seg.max((0, 1)) <= hi + 1e-4).all()
                continue
            b = bvh.bounds[node]
            c = bvh.children[node]
            stack.append((int(c[0]), (b[0:3], b[3:6])))
            stack.append((int(c[1]), (b[6:9], b[9:12])))


class TestTraversal:
    def _setup(self, ntri=200, nray=128, seed=3):
        tris = random_tris(ntri, seed=seed)
        bvh = bb.build_bvh(tris.min(1), tris.max(1))
        ordered = tris[bvh.prim_order]
        rng = np.random.default_rng(seed + 1)
        o = rng.uniform(-15, 15, (nray, 3)).astype(np.float32)
        d = rng.normal(size=(nray, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return bvh, ordered, o, d

    def test_bvh_matches_numpy_golden(self):
        bvh, ordered, o, d = self._setup()
        n = len(o)
        prim_obj = np.zeros(len(ordered), np.int32)
        hit = jax.jit(lambda o, d: isect.intersect_bvh(
            jnp.asarray(bvh.bounds), jnp.asarray(bvh.children),
            jnp.asarray(ordered), jnp.asarray(prim_obj),
            o, d, jnp.zeros(n), jnp.full(n, 1e30)))(
                jnp.asarray(o), jnp.asarray(d))
        t_jax = np.asarray(hit["t"])
        prim_jax = np.asarray(hit["prim"])
        miss = 0
        for i in range(n):
            t, prim, u, v = bb.intersect_ray_np(bvh, ordered, o[i], d[i])
            if prim < 0:
                assert prim_jax[i] == -1, f"ray {i}: jax hit, numpy miss"
                miss += 1
            else:
                assert prim_jax[i] == prim, f"ray {i}: prim mismatch"
                np.testing.assert_allclose(t_jax[i], t, rtol=1e-4)
        assert 0 < miss < n  # test covers both outcomes

    def test_bvh_matches_brute(self):
        bvh, ordered, o, d = self._setup(ntri=150, nray=256, seed=9)
        n = len(o)
        prim_obj = np.zeros(len(ordered), np.int32)
        args = (jnp.asarray(o), jnp.asarray(d), jnp.zeros(n),
                jnp.full(n, 1e30))
        h_bvh = jax.jit(lambda *a: isect.intersect_bvh(
            jnp.asarray(bvh.bounds), jnp.asarray(bvh.children),
            jnp.asarray(ordered), jnp.asarray(prim_obj), *a))(*args)
        h_brt = jax.jit(lambda *a: isect.intersect_brute(
            jnp.asarray(ordered), jnp.asarray(prim_obj), *a))(*args)
        np.testing.assert_array_equal(np.asarray(h_bvh["prim"]),
                                      np.asarray(h_brt["prim"]))
        np.testing.assert_allclose(np.asarray(h_bvh["t"]),
                                   np.asarray(h_brt["t"]), rtol=1e-5)

    def test_shadow_any_hit(self):
        bvh, ordered, o, d = self._setup(ntri=80, nray=64, seed=5)
        n = len(o)
        prim_obj = np.zeros(len(ordered), np.int32)
        full = isect.intersect_bvh(
            jnp.asarray(bvh.bounds), jnp.asarray(bvh.children),
            jnp.asarray(ordered), jnp.asarray(prim_obj),
            jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.full(n, 1e30))
        shadow = isect.intersect_bvh(
            jnp.asarray(bvh.bounds), jnp.asarray(bvh.children),
            jnp.asarray(ordered), jnp.asarray(prim_obj),
            jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.full(n, 1e30),
            shadow_any_hit=True)
        np.testing.assert_array_equal(np.asarray(full["prim"]) >= 0,
                                      np.asarray(shadow["prim"]) >= 0)

    def test_instancing(self):
        """Two instances of one geometry vs the equivalent flattened
        scene must produce identical hits."""
        from raytracingproject_tpu.utils import transform as tfm
        tris = random_tris(40, seed=11, spread=2.0)
        t1 = tfm.translate(6.0, 0, 0)
        t2 = tfm.compose(tfm.translate(-6.0, 0, 0), tfm.rotate(0.7, (0, 0, 1)))
        # flattened reference
        w1 = tfm.transform_point(t1, tris.reshape(-1, 3)).reshape(-1, 3, 3)
        w2 = tfm.transform_point(t2, tris.reshape(-1, 3)).reshape(-1, 3, 3)
        flat = np.concatenate([w1, w2]).astype(np.float32)
        fb = bb.build_bvh(flat.min(1), flat.max(1))
        fordered = flat[fb.prim_order]
        # instanced version: BLAS + TLAS
        blas = bb.build_bvh(tris.min(1), tris.max(1))
        bordered = tris[blas.prim_order]
        lo, hi = tris.min((0, 1)), tris.max((0, 1))
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                           np.float32)
        ilo, ihi = [], []
        for t in (t1, t2):
            wc = tfm.transform_point(t, corners)
            ilo.append(wc.min(0)); ihi.append(wc.max(0))
        tlas = bb.build_bvh(np.array(ilo), np.array(ihi), max_leaf_size=1)
        tn = len(tlas.bounds)
        bounds = np.concatenate([tlas.bounds, blas.bounds])
        children = np.concatenate([tlas.children, blas.children])
        # rebase BLAS children
        blk = children[tn:]
        inner = blk >= 0
        blk[inner] += tn
        # TLAS leaves -> instance encoding
        tl = children[:tn]
        leaves = tl < 0
        v = -tl[leaves] - 1
        start, count = v >> 4, v & 15
        inst = np.where(count > 0, tlas.prim_order[np.minimum(start, 1)], 0)
        tl[leaves] = np.where(count > 0,
                              -(1 + (inst.astype(np.int64) << 4) + 1 + (1 << 30)),
                              bb.encode_leaf(0, 0)).astype(np.int32)
        inst_w2o = np.stack([tfm.inverse(t1), tfm.inverse(t2)])
        rng = np.random.default_rng(2)
        nray = 128
        o = rng.uniform(-12, 12, (nray, 3)).astype(np.float32)
        d = rng.normal(size=(nray, 3)).astype(np.float32)
        d /= np.linalg.norm(d, -1, keepdims=True)
        prim_obj = np.full(len(bordered), -1, np.int32)
        h_inst = isect.intersect_bvh(
            jnp.asarray(bounds), jnp.asarray(children),
            jnp.asarray(bordered), jnp.asarray(prim_obj),
            jnp.asarray(o), jnp.asarray(d), jnp.zeros(nray),
            jnp.full(nray, 1e30),
            instance_w2o=jnp.asarray(inst_w2o),
            instance_blas_root=jnp.asarray([tn, tn], np.int32),
            instance_object=jnp.asarray([0, 1], np.int32))
        h_flat = isect.intersect_bvh(
            jnp.asarray(fb.bounds), jnp.asarray(fb.children),
            jnp.asarray(fordered), jnp.asarray(np.zeros(len(fordered), np.int32)),
            jnp.asarray(o), jnp.asarray(d), jnp.zeros(nray),
            jnp.full(nray, 1e30))
        np.testing.assert_allclose(np.asarray(h_inst["t"]),
                                   np.asarray(h_flat["t"]), rtol=2e-4)
        np.testing.assert_array_equal(np.asarray(h_inst["prim"]) >= 0,
                                      np.asarray(h_flat["prim"]) >= 0)
        # instanced hits carry the instance object id
        hits = np.asarray(h_inst["prim"]) >= 0
        assert set(np.asarray(h_inst["object"])[hits]) <= {0, 1}


class TestPackedTraversal:
    def test_packed_matches_baseline(self):
        """Single-fetch packed traversal == baseline lockstep walk."""
        tris = random_tris(300, seed=21)
        bvh = bb.build_bvh(tris.min(1), tris.max(1))
        ordered = tris[bvh.prim_order]
        nodes, leaves = isect.pack_traversal_tables(
            bvh.bounds, bvh.children, ordered)
        rng = np.random.default_rng(5)
        n = 256
        o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, -1, keepdims=True)
        prim_obj = np.zeros(len(ordered), np.int32)
        base = isect.intersect_bvh(
            jnp.asarray(bvh.bounds), jnp.asarray(bvh.children),
            jnp.asarray(ordered), jnp.asarray(prim_obj),
            jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.full(n, 1e30))
        packed = isect.intersect_bvh_packed(
            jnp.asarray(nodes), jnp.asarray(leaves),
            jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.full(n, 1e30),
            prim_object=jnp.asarray(prim_obj))
        np.testing.assert_array_equal(np.asarray(base["prim"]),
                                      np.asarray(packed["prim"]))
        np.testing.assert_allclose(np.asarray(base["t"]),
                                   np.asarray(packed["t"]), rtol=1e-5)

    def test_packed_instancing_scene(self):
        """End-to-end: an instanced scene forced onto the packed BVH path
        matches the flattened render."""
        import jax as _jax
        from raytracingproject_tpu.app import examples
        from raytracingproject_tpu.ops import integrator as integ
        from raytracingproject_tpu.models import scene as scene_mod
        w = h = 16
        # force instancing by lowering the flatten threshold
        old = scene_mod.AUTO_FLATTEN_MAX_PRIMS
        old_b = scene_mod.BRUTE_FORCE_MAX_PRIMS
        try:
            scene_mod.AUTO_FLATTEN_MAX_PRIMS = 0
            scene_mod.BRUTE_FORCE_MAX_PRIMS = 0
            s_inst = examples.instanced_scene(w, h, 2, grid=2)
            s_inst.device_update()
            kg_i = s_inst.make_kernel_globals()
            assert kg_i["has_instances"] and not kg_i["use_brute"]
            # strip cluster tables so the packed gather-walk (and not
            # the preferred cluster path) is what renders
            kg_i["dscene"] = {k: v for k, v in kg_i["dscene"].items()
                              if not k.startswith("cluster")}
            kg_i["cluster_tris"] = 0
        finally:
            scene_mod.AUTO_FLATTEN_MAX_PRIMS = old
            scene_mod.BRUTE_FORCE_MAX_PRIMS = old_b
        s_flat = examples.instanced_scene(w, h, 2, grid=2)
        s_flat.device_update()
        kg_f = s_flat.make_kernel_globals()
        # flattened 2.3k-prim scenes now ride the cluster path (brute
        # below BRUTE_VS_CLUSTER_PRIMS only)
        kg_f["dscene"] = {k: v for k, v in kg_f["dscene"].items()
                          if not k.startswith("cluster")}
        kg_f["cluster_tris"] = 0
        kg_f["use_brute"] = True
        yy, xx = np.mgrid[0:h, 0:w]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        Li = np.asarray(_jax.jit(lambda a, b, c: integ.render_samples(
            kg_i, a, b, c, 0, 2))(px, py, py * w + px)[0])
        Lf = np.asarray(_jax.jit(lambda a, b, c: integ.render_samples(
            kg_f, a, b, c, 0, 2))(px, py, py * w + px)[0])
        # object-space vs world-baked geometry round differently at
        # silhouette pixels; images must agree except a few edge lanes
        close = np.isclose(Li, Lf, atol=5e-2, rtol=0.2).all(-1)
        assert close.mean() > 0.98, close.mean()
        assert abs(Li.mean() - Lf.mean()) < 0.02


class TestRefit:
    def _golden_hits(self, bvh, tris, o, d):
        ts, prims = [], []
        for i in range(len(o)):
            t, p, _u, _v = bb.intersect_ray_np(
                bvh, tris[bvh.prim_order], o[i], d[i])
            ts.append(t)
            prims.append(p)
        return np.array(ts), np.array(prims)

    def _check_deformed(self, n, seed, use_native):
        tris = random_tris(n, seed=seed)
        bvh = bb.build_bvh(tris.min(1), tris.max(1), use_native=use_native)
        rng = np.random.default_rng(seed + 7)
        # deform: non-uniform per-vertex jitter + global stretch
        tris2 = (tris * np.array([1.3, 0.8, 1.1], np.float32)
                 + rng.uniform(-0.5, 0.5, tris.shape).astype(np.float32))
        bb.refit_bvh(bvh, tris2.min(1), tris2.max(1))
        # refit tree must find the same closest hits as a fresh build
        fresh = bb.build_bvh(tris2.min(1), tris2.max(1))
        o = rng.uniform(-16, 16, (64, 3)).astype(np.float32)
        d = rng.normal(size=(64, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t_r, p_r = self._golden_hits(bvh, tris2, o, d)
        t_f, p_f = self._golden_hits(fresh, tris2, o, d)
        np.testing.assert_allclose(t_r, t_f, rtol=1e-5, atol=1e-5)
        # ordered indices differ between trees; compare original prim ids
        orig_r = np.where(p_r >= 0, bvh.prim_order[p_r], -1)
        orig_f = np.where(p_f >= 0, fresh.prim_order[p_f], -1)
        np.testing.assert_array_equal(orig_r, orig_f)

    def test_refit_matches_rebuild_numpy(self):
        self._check_deformed(300, seed=11, use_native=False)

    def test_refit_matches_rebuild_native(self):
        self._check_deformed(3000, seed=12, use_native=True)

    def test_refit_bounds_contain_prims(self):
        tris = random_tris(128, seed=13)
        bvh = bb.build_bvh(tris.min(1), tris.max(1))
        tris2 = tris + 3.0
        bb.refit_bvh(bvh, tris2.min(1), tris2.max(1))
        ordered = tris2[bvh.prim_order]
        stack = [(0, None)]
        while stack:
            node, bound = stack.pop()
            if node < 0:
                start, count = bb.decode_leaf(node)
                if count and bound is not None:
                    lo, hi = bound
                    seg = ordered[start:start + count]
                    assert (seg.min((0, 1)) >= lo - 1e-4).all()
                    assert (seg.max((0, 1)) <= hi + 1e-4).all()
                continue
            b = bvh.bounds[node]
            c = bvh.children[node]
            stack.append((int(c[0]), (b[0:3], b[3:6])))
            stack.append((int(c[1]), (b[6:9], b[9:12])))


class TestStackDepth:
    """Traversal stack sizing (a fixed 48-entry stack would silently
    drop entries on deep trees; the
    scene packer computes the requirement with bb.tree_depth and the
    traversal allocates exactly that)."""

    def test_tree_depth_chain(self):
        # hand-built left-spine chain: node i -> (i+1, leaf)
        M = 20
        children = np.zeros((M, 2), np.int32)
        for i in range(M - 1):
            children[i] = (i + 1, bb.encode_leaf(i, 1))
        children[M - 1] = (bb.encode_leaf(M - 1, 1),
                          bb.encode_leaf(M - 1, 1))
        assert bb.tree_depth(children) == M

    def test_tree_depth_balanced(self):
        tris = random_tris(512, seed=2)
        bvh = bb.build_bvh(tris.min(1), tris.max(1))
        depth = bb.tree_depth(bvh.children)
        assert 9 <= depth <= 40  # balanced-ish SAH over 512 prims

    def test_exact_stack_traversal_matches_brute(self):
        tris = random_tris(300, seed=11)
        bvh = bb.build_bvh(tris.min(1), tris.max(1))
        ordered = tris[bvh.prim_order]
        depth = bb.tree_depth(bvh.children)
        rng = np.random.default_rng(5)
        n = 256
        o = rng.uniform(-15, 15, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        prim_obj = np.zeros(len(ordered), np.int32)
        args = (jnp.asarray(o), jnp.asarray(d), jnp.zeros(n),
                jnp.full(n, 1e30))
        h_exact = jax.jit(lambda *a: isect.intersect_bvh(
            jnp.asarray(bvh.bounds), jnp.asarray(bvh.children),
            jnp.asarray(ordered), jnp.asarray(prim_obj), *a,
            stack_depth=depth + 2))(*args)
        h_brt = jax.jit(lambda *a: isect.intersect_brute(
            jnp.asarray(ordered), jnp.asarray(prim_obj), *a))(*args)
        np.testing.assert_array_equal(np.asarray(h_exact["prim"]),
                                      np.asarray(h_brt["prim"]))

    def test_scene_records_stack_depth(self):
        from raytracingproject_tpu.app import examples
        scene = examples.cornell_box(16, 16)
        scene.device_update()
        kg = scene.make_kernel_globals()
        assert kg["bvh_stack_depth"] >= 3
