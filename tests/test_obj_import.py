"""OBJ/MTL importer (app/obj.py — standard scene ingestion without a
DCC bridge)."""

import numpy as np

from raytracingproject_tpu.app.obj import load_obj, read_mtl

_OBJ = """# test cube-ish
mtllib test.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl red
s 1
f 1/1 2/2 3/3 4/4
usemtl glow
s off
f -5/-4 -3/-2 -1/-1
"""

_MTL = """newmtl red
Kd 0.8 0.1 0.1
newmtl glow
Kd 0.1 0.1 0.1
Ke 4.0 3.0 2.0
"""


def _write(tmp_path):
    (tmp_path / "test.obj").write_text(_OBJ)
    (tmp_path / "test.mtl").write_text(_MTL)
    return str(tmp_path / "test.obj")


class TestObjImport:
    def test_parse_geometry_materials_uvs(self, tmp_path):
        mesh, shaders = load_obj(_write(tmp_path))
        # quad fans into 2 tris + 1 tri = 3
        assert mesh.num_triangles == 3
        assert len(shaders) == 2
        assert [s.name for s in shaders] == ["red", "glow"]
        tri_mat = np.asarray(mesh.shader)
        assert tri_mat.tolist() == [0, 0, 1]
        smooth = np.asarray(mesh.smooth)
        assert smooth.tolist() == [True, True, False]
        uv = mesh.attribute_get("std_uv").data.reshape(3, 3, 2)
        np.testing.assert_allclose(uv[0], [[0, 0], [1, 0], [1, 1]])
        # negative indices resolved relative to current counts
        tris = mesh.triangles_array
        assert tris[2].tolist() == [0, 2, 4]

    def test_mtl_emission(self, tmp_path):
        _write(tmp_path)
        mats = read_mtl(str(tmp_path / "test.mtl"))
        assert mats["glow"]["Ke"] == (4.0, 3.0, 2.0)

    def test_renders_in_scene(self, tmp_path):
        import jax.numpy as jnp
        from raytracingproject_tpu.app import examples
        from raytracingproject_tpu.ops import integrator as integ

        W = H = 12
        scene = examples.cornell_box(W, H, spp=2)
        mesh, shaders, obj = load_obj(_write(tmp_path), scene=scene,
                                      name="imported")
        # place it inside the box so it is visible
        obj.set("transform", np.asarray(
            [[150, 0, 0, 200], [0, 150, 0, 200], [0, 0, 150, 100]],
            np.float32))
        scene.device_update()
        kg = scene.make_kernel_globals()
        yy, xx = np.mgrid[0:H, 0:W]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        L, A = integ.render_samples_regen(kg, px, py, py * W + px,
                                          jnp.uint32(0), 2)
        img = np.asarray(L).reshape(H, W, 3) / 2
        assert np.isfinite(img).all()
        assert img.mean() > 0.0
