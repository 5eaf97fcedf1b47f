"""Custom shader-node authoring API (docs/CUSTOM_NODES.md — the
answer to the reference's OSL user-shader capability,
render/osl.cpp): subclassing ShaderNode with a NODE_NAME must register
the node for BOTH the Python graph API and the XML reader with no
further wiring, and the node must trace into the production integrator
like any built-in."""

import numpy as np
import jax.numpy as jnp

from raytracingproject_tpu.models.node import NodeType
from raytracingproject_tpu.models.shader import Shader, ShaderGraph
from raytracingproject_tpu.models import shader_nodes as sn


class RingsTextureNode(sn.ShaderNode):
    NODE_NAME = "rings_texture"
    INPUTS = [("vector", "vector", (0.0, 0.0, 0.0)),
              ("scale", "float", 5.0)]
    OUTPUTS = [("fac", "float")]

    def eval(self, ctx, inp):
        p = ctx.generated if inp["vector"] is None else inp["vector"]
        r = jnp.sqrt(jnp.sum(p * p, axis=-1))
        return {"fac": 0.5 + 0.5 * jnp.sin(r * inp["scale"])}


def _rings_shader():
    g = ShaderGraph()
    t = g.add(RingsTextureNode("rings", scale=8.0))
    d = g.add(sn.DiffuseBsdfNode("bsdf"))
    g.connect(t, "fac", d, "color")
    g.connect(d, "bsdf", g.output_node, "surface")
    return Shader("rings_mat", g)


class TestCustomNode:
    def test_auto_registered(self):
        nt = NodeType.find("rings_texture")
        assert nt is not None and nt.cls is RingsTextureNode
        # the XML reader resolves tags through the same registry, LIVE
        # (custom nodes registered after the xml module import count)
        from raytracingproject_tpu.app import xml as xml_mod
        assert xml_mod._shader_node_class("rings_texture") \
            is RingsTextureNode

    def test_renders_through_production_integrator(self):
        from raytracingproject_tpu.app import examples
        from raytracingproject_tpu.ops import integrator as integ

        W = H = 16
        scene = examples.cornell_box(W, H, spp=4)
        mat = _rings_shader()
        scene.add_shader(mat)
        from raytracingproject_tpu.models.object import Object
        sphere = examples.make_sphere_mesh((300, 250, 150), 120, 0,
                                           nlat=8, nlon=16,
                                           name="rings_sphere")
        sphere.used_shaders = [mat]
        scene.add_object(Object("rings_sphere", sphere))
        scene.device_update()
        kg = scene.make_kernel_globals()
        yy, xx = np.mgrid[0:H, 0:W]
        px = jnp.asarray(xx.reshape(-1), jnp.int32)
        py = jnp.asarray(yy.reshape(-1), jnp.int32)
        L, A = integ.render_samples_regen(kg, px, py, py * W + px,
                                          jnp.uint32(0), 4)
        img = np.asarray(L).reshape(H, W, 3) / 4
        assert np.isfinite(img).all()
        assert img.mean() > 0.01  # lit scene, node contributing

    def test_xml_round_trip(self, tmp_path):
        xml = """<cycles>
  <camera width="8" height="8"/>
  <shader name="mat">
    <rings_texture name="rings" scale="8.0"/>
    <diffuse_bsdf name="bsdf"/>
    <connect from="rings fac" to="bsdf color"/>
    <connect from="bsdf bsdf" to="output surface"/>
  </shader>
</cycles>"""
        p = tmp_path / "custom.xml"
        p.write_text(xml)
        from raytracingproject_tpu.app.xml import read_scene
        scene = read_scene(str(p))
        names = {s.name for s in scene.shaders}
        assert "mat" in names
        mat = next(s for s in scene.shaders if s.name == "mat")
        kinds = {type(n).__name__ for n in mat.graph.nodes}
        assert "RingsTextureNode" in kinds
