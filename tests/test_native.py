"""The native BVH builder: a library named by a hash of its sources and
flags, built into the ignored build directory, and a tree whose
subtrees cover contiguous prim ranges even when threads build it."""

import os

import numpy as np

from raytracingproject_tpu import native
from raytracingproject_tpu.bvh import build as bvh_build
from raytracingproject_tpu.bvh import clusters as cl_mod


def test_build_key_tracks_sources_and_flags(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    k0 = native.build_key([str(src)])
    assert k0 == native.build_key([str(src)])
    assert k0 != native.build_key([str(src)], native.CXXFLAGS + ("-g",))
    src.write_text("int f() { return 2; }\n")
    assert k0 != native.build_key([str(src)])


def test_library_is_portable_and_built_out_of_tree():
    assert not any("march" in f for f in native.CXXFLAGS)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native.BUILD_DIR == os.path.join(repo, "build", "native")
    lib = native.get_lib()
    assert lib is not None
    key = native.build_key(native._sources())
    assert os.path.exists(os.path.join(native.BUILD_DIR,
                                       f"librtp_native-{key}.so"))


def test_threaded_build_keeps_subtrees_contiguous():
    """Above 2x4096 prims the top levels build on threads; leaves must
    still tile the prim order so every subtree is one range (the cluster
    cut asserts it), and two builds must give the same order."""
    rng = np.random.default_rng(0)
    c = rng.uniform(-10, 10, (20000, 3)).astype(np.float32)
    lo, hi = c - 0.05, c + 0.05
    a = bvh_build.build_bvh(lo, hi, use_native=True)
    b = bvh_build.build_bvh(lo, hi, use_native=True)
    assert sorted(a.prim_order.tolist()) == list(range(20000))
    np.testing.assert_array_equal(a.prim_order, b.prim_order)
    cuts = cl_mod.cut_clusters(a.children, 64)
    assert sum(n for _, n in cuts) == 20000
