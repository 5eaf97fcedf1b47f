"""Shader graphs (ref: render/graph.h ShaderGraph, render/shader.h Shader).

Compilation model: where the reference compiles a graph to SVM
`int4` bytecode interpreted divergently per ray (render/svm.cpp:828,
kernel/svm/svm.h), we *trace* the graph: topological evaluation of jnp
ops over the whole wavefront, producing a fixed-slot closure union
(ops/closures.py). XLA then fuses the entire shader into the
surrounding kernel — no interpreter, no divergence, and per-shader
specialization falls out of jit caching (the analog of the reference's
feature-pruned kernel recompiles, device/device.h:228).

Per-material dispatch over a wavefront happens in ops/shade.py by
masked evaluation of each distinct shader (shader counts in real scenes
are small; material sorting keeps lanes coherent).
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu.models.node import Node, SocketType as S
from raytracingproject_tpu.ops import closures as cl


class ShaderNode(Node):
    """Base shader-graph node.

    Subclasses declare:
      INPUTS  = [(name, type, default), ...]   dynamic, linkable
      OUTPUTS = [(name, type), ...]
      PARAMS  = [SocketType(...), ...]         static parameters (enums...)
    and implement eval(ctx, inp) -> {output_name: value}.

    Input/param values are exposed through Node reflection so XML IO and
    incremental diffing work generically (ref: graph/node.h).
    """

    INPUTS = []
    OUTPUTS = []
    PARAMS = []

    def __init_subclass__(cls, **kw):
        sockets = list(cls.PARAMS)
        for (iname, itype, default) in cls.INPUTS:
            st = {"float": S.FLOAT, "int": S.INT, "color": S.COLOR,
                  "vector": S.VECTOR, "point": S.POINT, "normal": S.NORMAL,
                  "string": S.STRING, "closure": S.STRING}[itype]
            if itype == "closure":
                continue  # closures have no constant default
            sockets.append(S(iname, st, default))
        cls.SOCKETS = sockets
        super().__init_subclass__(**kw)

    def input_default(self, ctx, iname, itype):
        if itype == "closure":
            return None
        v = getattr(self, iname)
        if itype in ("color", "vector", "point", "normal"):
            return np.asarray(v, np.float32)
        return v

    def eval(self, ctx, inp):
        raise NotImplementedError


class OutputNode(ShaderNode):
    NODE_NAME = "output"
    INPUTS = [("surface", "closure", None), ("volume", "closure", None),
              ("displacement", "vector", (0.0, 0.0, 0.0))]
    OUTPUTS = []

    def eval(self, ctx, inp):
        return {}


class ShaderGraph:
    """DAG of shader nodes with named links (ref: render/graph.h)."""

    def __init__(self):
        self.nodes = []
        self.links = {}  # (to_node_id, to_socket) -> (from_node, from_socket)
        self.output_node = OutputNode("output")
        self.add(self.output_node)

    def add(self, node):
        if node not in self.nodes:
            self.nodes.append(node)
        return node

    def connect(self, from_node, from_socket, to_node, to_socket):
        outs = [o[0] for o in from_node.OUTPUTS]
        ins = [i[0] for i in to_node.INPUTS]
        if from_socket not in outs:
            raise ValueError(f"{from_node} has no output '{from_socket}' ({outs})")
        if to_socket not in ins:
            raise ValueError(f"{to_node} has no input '{to_socket}' ({ins})")
        self.links[(id(to_node), to_socket)] = (from_node, from_socket)

    def topo_order(self):
        order, seen, onstack = [], set(), set()

        def visit(n):
            if id(n) in seen:
                return
            if id(n) in onstack:
                raise ValueError("shader graph contains a cycle")
            onstack.add(id(n))
            for (iname, itype, _d) in n.INPUTS:
                link = self.links.get((id(n), iname))
                if link is not None:
                    visit(link[0])
            onstack.discard(id(n))
            seen.add(id(n))
            order.append(n)

        visit(self.output_node)
        # AOV outputs are sinks that don't feed the output node
        # (ref: render/graph.cpp keeps OutputAOVNode alive in clean())
        for n in self.nodes:
            if getattr(n, "IS_AOV_SINK", False):
                visit(n)
        return order

    def _stamp_custom_normal(self, ctx, node, inp, out):
        """A BSDF node with a LINKED normal input records it on its
        closure output as custom_N — the integrator substitutes it for
        sd.N in BSDF math (ref: per-ShaderClosure N; see
        ops/closures.py for the shared-normal approximation)."""
        if self.links.get((id(node), "normal")) is None:
            return
        nv = inp.get("normal")
        if nv is None:
            return
        import jax.numpy as jnp
        from raytracingproject_tpu.utils import precision as prec
        for (oname, _t) in node.OUTPUTS:
            v = out.get(oname)
            if cl.is_closure(v):
                v["custom_N"] = jnp.broadcast_to(
                    jnp.asarray(nv, prec.FT), ctx.batch_shape + (3,))

    def _eval_subgraph(self, ctx, node, values):
        """Evaluate `node` and its upstream dependencies under `ctx`,
        memoizing into `values`. Used to re-trace the height subgraph of
        a BumpNode at offset contexts (the traced analog of the
        reference's bump graph duplication, render/graph.cpp
        bump_from_displacement). Nested bump nodes inside a height
        subgraph pass through (no differentials at that level)."""
        if (id(node), "__done__") in values:
            return values
        values[(id(node), "__done__")] = True
        inp = {}
        for (iname, itype, _d) in node.INPUTS:
            link = self.links.get((id(node), iname))
            if link is not None:
                from_node, from_socket = link
                self._eval_subgraph(ctx, from_node, values)
                inp[iname] = values[(id(from_node), from_socket)]
            else:
                inp[iname] = node.input_default(ctx, iname, itype)
        if getattr(node, "IS_BUMP", False):
            inp["__bump__"] = None
        out = node.eval(ctx, inp)
        self._stamp_custom_normal(ctx, node, inp, out)
        for (oname, _t) in node.OUTPUTS:
            values[(id(node), oname)] = out[oname]
        return values

    def _bump_aux(self, ctx, order):
        """Per-BumpNode (h_c, h_x, h_y, dPdx, dPdy) tuples: the height
        subgraph re-traced at two barycentric-offset contexts. XLA DCE
        keeps only the height-feeding ops of the offset traces, so each
        bump costs its height subgraph twice more — same cost model as
        the reference's duplicated bump graph."""
        bump_nodes = [n for n in order
                      if getattr(n, "IS_BUMP", False)
                      and (id(n), "height") in self.links]
        if not bump_nodes:
            return {}
        from raytracingproject_tpu.ops import shade as _shade
        off = _shade.bump_offset_contexts(ctx)
        if off is None:
            return {}
        ctx_c, ctx_x, ctx_y, dPdx, dPdy = off
        vals_c, vals_x, vals_y = {}, {}, {}
        aux = {}
        for bn in bump_nodes:
            src, sock = self.links[(id(bn), "height")]
            h_c = self._eval_subgraph(ctx_c, src, vals_c)[(id(src), sock)]
            h_x = self._eval_subgraph(ctx_x, src, vals_x)[(id(src), sock)]
            h_y = self._eval_subgraph(ctx_y, src, vals_y)[(id(src), sock)]
            aux[id(bn)] = (h_c, h_x, h_y, dPdx, dPdy)
        return aux

    def evaluate(self, ctx):
        """Trace the graph for shading context `ctx` (ops/shade.ShaderData
        view). Returns dict with 'surface' closures, 'volume' closures,
        'displacement' vector."""
        values = {}
        aovs = {}
        result = None
        order = self.topo_order()
        bump_aux = self._bump_aux(ctx, order)
        for node in order:
            inp = {}
            for (iname, itype, _d) in node.INPUTS:
                link = self.links.get((id(node), iname))
                if link is not None:
                    from_node, from_socket = link
                    v = values[(id(from_node), from_socket)]
                else:
                    v = node.input_default(ctx, iname, itype)
                inp[iname] = v
            if getattr(node, "IS_BUMP", False):
                inp["__bump__"] = bump_aux.get(id(node))
            out = node.eval(ctx, inp)
            self._stamp_custom_normal(ctx, node, inp, out)
            for (oname, _t) in node.OUTPUTS:
                values[(id(node), oname)] = out[oname]
            if node is self.output_node:
                surf = inp.get("surface")
                result = {
                    "surface": surf if surf is not None
                    else cl.empty_closures(ctx.batch_shape),
                    "volume": inp.get("volume"),
                    "displacement": inp.get("displacement"),
                    "aov": aovs,
                }
            if getattr(node, "IS_AOV_SINK", False):
                aovs[node.aov_name] = out["__aov__"]
        if result is None:
            result = {"surface": cl.empty_closures(ctx.batch_shape),
                      "volume": None, "displacement": None, "aov": aovs}
        return result

    def finalize(self):
        """Graph cleanup pass (ref: ShaderGraph::finalize — constant
        folding/dedup are left to XLA CSE; here we only validate)."""
        self.topo_order()
        return self


class Shader(Node):
    """A material: graph + settings (ref: render/shader.h:54)."""

    NODE_NAME = "shader"
    SOCKETS = [
        S("use_mis", S.BOOLEAN, True),
        S("use_transparent_shadow", S.BOOLEAN, True),
        S("heterogeneous_volume", S.BOOLEAN, True),
        S("volume_sampling_method", S.ENUM, "multiple_importance",
          {"distance": 0, "equiangular": 1, "multiple_importance": 2}),
        S("volume_interpolation_method", S.ENUM, "linear",
          {"linear": 0, "cubic": 1}),
        S("volume_step_rate", S.FLOAT, 1.0),
        S("displacement_method", S.ENUM, "bump",
          {"bump": 0, "true": 1, "both": 2}),
        S("pass_id", S.INT, 0),
    ]

    def __init__(self, name="shader", graph=None, **kwargs):
        super().__init__(name, **kwargs)
        self.graph = graph or ShaderGraph()
        self.slot = -1           # assigned at scene flatten
        self.has_surface_emission = False
        self.has_volume = False
        self.has_transparent = False

    def evaluate_surface(self, ctx):
        return self.graph.evaluate(ctx)["surface"]

    def has_displacement(self):
        """True when the graph output's displacement socket is linked and
        the method requests true displacement (ref: Shader::has_displacement
        + displacement_method)."""
        linked = (id(self.graph.output_node),
                  "displacement") in self.graph.links
        return linked and self.get_enum_int("displacement_method") in (1, 2)

    def has_bump(self):
        """True when the displacement output should perturb the shading
        normal at render time (displacement_method 'bump' or 'both';
        ref: svm_displace.h svm_node_set_bump)."""
        linked = (id(self.graph.output_node),
                  "displacement") in self.graph.links
        return linked and self.get_enum_int("displacement_method") in (0, 2)

    def aov_names(self):
        return [n.aov_name for n in self.graph.nodes
                if getattr(n, "IS_AOV_SINK", False)]

    def evaluate_volume(self, ctx):
        return self.graph.evaluate(ctx)["volume"]

    def analyze(self):
        """Static feature detection (ref: Shader::device_update detecting
        has_surface_emission etc.; feature flags feed kernel pruning like
        DeviceRequestedFeatures, device/device.h:120)."""
        from raytracingproject_tpu.models import shader_nodes as sn
        self.has_surface_emission = False
        self.has_volume = False
        self.has_transparent = False
        self.has_glossy = False
        self.has_multiscatter = False
        self.has_refraction = False
        self.has_diffuse_roughness = False
        self.has_subsurface = False
        self.has_heterogeneous_volume = False
        self.has_hair = False
        self.has_toon = False
        self.has_sheen = False
        self.has_aniso = False
        self.has_classic_hair = False
        self.has_vertex_color = False
        self.has_ao_node = False
        self.has_bevel_node = False
        self.ao_distance = 0.0
        self.ao_samples = 0
        self.ao_inside = False
        self.bevel_radius = 0.0
        self.bevel_samples = 0
        self.has_custom_normal = False

        def linked(node, sock):
            return self.graph.links.get((id(node), sock)) is not None

        for node in self.graph.nodes:
            if linked(node, "normal") and any(
                    t == "closure" for (_n, t) in node.OUTPUTS):
                # a BSDF consumes a custom normal (bump / normal map)
                self.has_custom_normal = True
            if isinstance(node, (sn.EmissionNode, sn.BackgroundNode)):
                self.has_surface_emission = True
            if isinstance(node, sn.TransparentBsdfNode):
                self.has_transparent = True
            if isinstance(node, (sn.GlossyBsdfNode, sn.GlassBsdfNode)):
                self.has_glossy = True
                if node.get_enum_int("distribution") == 3:  # multi_ggx
                    self.has_multiscatter = True
            if isinstance(node, (sn.GlassBsdfNode, sn.RefractionBsdfNode,
                                 sn.TranslucentBsdfNode)):
                self.has_refraction = True
            if isinstance(node, sn.DiffuseBsdfNode):
                if linked(node, "roughness") or float(node.roughness) > 0.0:
                    self.has_diffuse_roughness = True
            if isinstance(node, sn.SubsurfaceScatteringNode):
                self.has_subsurface = True
            if isinstance(node, sn.PrincipledHairBsdfNode):
                self.has_hair = True
            if isinstance(node, sn.ToonBsdfNode):
                self.has_toon = True
            if isinstance(node, sn.AnisotropicBsdfNode):
                self.has_glossy = True
                self.has_aniso = True
            if isinstance(node, sn.HairBsdfNode):
                self.has_classic_hair = True
            if isinstance(node, sn.VertexColorNode):
                self.has_vertex_color = True
            if isinstance(node, sn.AmbientOcclusionNode):
                self.has_ao_node = True
                self.ao_distance = max(self.ao_distance,
                                       float(node.distance))
                self.ao_samples = max(self.ao_samples, int(node.samples))
                self.ao_inside = self.ao_inside or bool(node.inside)
            if isinstance(node, sn.BevelNode):
                self.has_bevel_node = True
                self.bevel_radius = max(self.bevel_radius,
                                        float(node.radius))
                self.bevel_samples = max(self.bevel_samples,
                                         int(node.samples))
            if isinstance(node, sn.VelvetBsdfNode):
                self.has_sheen = True
            if isinstance(node, sn.PrincipledBsdfNode):
                self.has_glossy = True
                if linked(node, "subsurface") or float(node.subsurface) > 0:
                    self.has_subsurface = True
                if linked(node, "transmission") or float(node.transmission) > 0:
                    self.has_refraction = True
                if linked(node, "alpha") or float(node.alpha) < 1.0:
                    self.has_transparent = True
                if (linked(node, "emission_color")
                        or np.any(np.asarray(node.emission_color) > 0)):
                    self.has_surface_emission = True
            if isinstance(node, (sn.ScatterVolumeNode, sn.AbsorptionVolumeNode,
                                 sn.PrincipledVolumeNode)):
                self.has_volume = True
                if (linked(node, "density") or linked(node, "color")):
                    self.has_heterogeneous_volume = True
        if self.graph.links.get((id(self.graph.output_node), "volume")):
            self.has_volume = True
        return self
