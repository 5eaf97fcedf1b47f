"""Wavefront OBJ/MTL import — standard-scene ingestion without a DCC
bridge (the reference gets real meshes through
BlenderSync, blender/blender_mesh.cpp:1026 — out of scope here, so one
ubiquitous interchange format closes the capability).

Host-side only: parses v/vt/vn/f (+ negative indices, polygon fan
triangulation, usemtl material binding, s smoothing groups) and the MTL
subset that maps onto the shader graph (Kd diffuse color, map_Kd image
texture, Ke emission). Unknown statements are skipped with a warning —
an importer must degrade, never refuse.
"""

from __future__ import annotations

import os

import numpy as np

from raytracingproject_tpu.models.mesh import (
    Mesh, ATTR_STD_UV, ATTR_ELEMENT_CORNER)
from raytracingproject_tpu.models.object import Object
from raytracingproject_tpu.models.shader import Shader, ShaderGraph
from raytracingproject_tpu.models import shader_nodes as sn
from raytracingproject_tpu.utils import log


def _mtl_shader(name, props, base_path):
    """Build a shader graph for one MTL material: map_Kd/Kd -> diffuse
    color; Ke adds emission (mixed additively via AddShader)."""
    g = ShaderGraph()
    d = g.add(sn.DiffuseBsdfNode(name + "_bsdf"))
    if props.get("map_Kd"):
        t = g.add(sn.ImageTextureNode(
            name + "_tex",
            filename=os.path.join(base_path, props["map_Kd"])))
        g.connect(t, "color", d, "color")
    else:
        d.set("color", props.get("Kd", (0.8, 0.8, 0.8)))
    ke = np.asarray(props.get("Ke", (0.0, 0.0, 0.0)), np.float32)
    if ke.max() > 0.0:
        e = g.add(sn.EmissionNode(name + "_emit",
                                  color=tuple(float(x) for x in ke),
                                  strength=1.0))
        add = g.add(sn.AddClosureNode(name + "_add"))
        g.connect(d, "bsdf", add, "closure1")
        g.connect(e, "emission", add, "closure2")
        g.connect(add, "closure", g.output_node, "surface")
    else:
        g.connect(d, "bsdf", g.output_node, "surface")
    return Shader(name, g)


def read_mtl(path):
    """-> {material_name: {Kd: (3,), Ke: (3,), map_Kd: str}}"""
    mats = {}
    cur = None
    try:
        f = open(path, "r", errors="replace")
    except OSError as e:
        log.log_warning("obj: cannot read mtllib %s (%s)", path, e)
        return mats
    with f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "newmtl":
                cur = mats.setdefault(" ".join(tok[1:]) or "default", {})
            elif cur is None:
                continue
            elif tok[0] in ("Kd", "Ke") and len(tok) >= 4:
                cur[tok[0]] = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "map_Kd" and len(tok) >= 2:
                cur["map_Kd"] = tok[-1]
    return mats


def _resolve(idx, n):
    """OBJ 1-based / negative-relative index -> 0-based."""
    i = int(idx)
    return i - 1 if i > 0 else n + i


def load_obj(path, scene=None, name=None, default_shader=None):
    """Parse an OBJ file into one Mesh (+ its material shaders).

    Returns (mesh, shaders). When `scene` is given, the shaders and an
    Object wrapping the mesh are added to it and the Object returned as
    third element. Faces with >3 corners fan-triangulate; per-corner
    UVs pack into the std_uv attribute; materials map per-triangle
    through used_shaders order."""
    base = os.path.dirname(os.path.abspath(path))
    name = name or os.path.splitext(os.path.basename(path))[0]
    verts, uvs = [], []
    tris, tri_uv, tri_mat, tri_smooth = [], [], [], []
    mtl_props = {}
    mat_order = []          # material name per slot, in first-use order
    cur_mat = None
    smooth_on = False

    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            cmd = tok[0]
            if cmd == "v" and len(tok) >= 4:
                verts.append([float(tok[1]), float(tok[2]),
                              float(tok[3])])
            elif cmd == "vt" and len(tok) >= 3:
                uvs.append([float(tok[1]), float(tok[2])])
            elif cmd == "vn":
                pass  # smooth normals are recomputed area-weighted
            elif cmd == "mtllib" and len(tok) >= 2:
                mtl_props.update(read_mtl(os.path.join(base, tok[-1])))
            elif cmd == "usemtl":
                cur_mat = " ".join(tok[1:]) or "default"
                if cur_mat not in mat_order:
                    mat_order.append(cur_mat)
            elif cmd == "s":
                smooth_on = tok[1] not in ("off", "0") \
                    if len(tok) > 1 else True
            elif cmd == "f" and len(tok) >= 4:
                corners = []
                for c in tok[1:]:
                    parts = c.split("/")
                    vi = _resolve(parts[0], len(verts))
                    ti = _resolve(parts[1], len(uvs)) \
                        if len(parts) > 1 and parts[1] else -1
                    corners.append((vi, ti))
                slot = mat_order.index(cur_mat) if cur_mat else 0
                for k in range(1, len(corners) - 1):
                    fan = (corners[0], corners[k], corners[k + 1])
                    tris.append([c[0] for c in fan])
                    tri_uv.append([uvs[c[1]] if c[1] >= 0 else [0.0, 0.0]
                                   for c in fan])
                    tri_mat.append(slot)
                    tri_smooth.append(smooth_on)
            # o/g/l/p/vn and exotica: ignored (degrade, don't refuse)

    if not tris:
        raise ValueError(f"obj: no faces in {path}")

    shaders = []
    if mat_order:
        for mname in mat_order:
            shaders.append(_mtl_shader(mname, mtl_props.get(mname, {}),
                                       base))
    else:
        shaders.append(default_shader
                       or _mtl_shader(name + "_default", {}, base))
        tri_mat = [0] * len(tris)

    mesh = Mesh(name)
    mesh.set_mesh(np.asarray(verts, np.float32),
                  np.asarray(tris, np.int32),
                  shader=np.asarray(tri_mat, np.int32),
                  smooth=np.asarray(tri_smooth, bool))
    mesh.attribute_set(ATTR_STD_UV, ATTR_ELEMENT_CORNER,
                       np.asarray(tri_uv, np.float32).reshape(-1, 2))
    mesh.used_shaders = shaders

    if scene is not None:
        for s in shaders:
            scene.add_shader(s)
        obj = scene.add_object(Object(name, mesh))
        return mesh, shaders, obj
    return mesh, shaders
