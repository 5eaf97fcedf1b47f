"""Geometry nodes (ref: render/geometry.h:49, render/mesh.h:54, render/hair.h).

`Mesh` stores triangle geometry + named attributes; `Hair` stores curve
keys/radii. Both are host-side numpy until the GeometryManager flattens
them into the device scene (models/scene.py) and builds per-geometry
BVHs (BLAS).
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu.models.node import Node, SocketType as S

# Attribute standards (ref: kernel/kernel_types.h AttributeStandard)
ATTR_STD_UV = "std_uv"
ATTR_STD_VERTEX_NORMAL = "std_vertex_normal"
ATTR_STD_FACE_NORMAL = "std_face_normal"
ATTR_STD_GENERATED = "std_generated"
ATTR_STD_MOTION_VERTEX_POSITION = "std_motion_vertex_position"

# Attribute element domains (ref: AttributeElement)
ATTR_STD_CURVE_TANGENT = "std_curve_tangent"

ATTR_ELEMENT_VERTEX = "vertex"
ATTR_ELEMENT_FACE = "face"
ATTR_ELEMENT_CORNER = "corner"
ATTR_ELEMENT_CURVE = "curve"
ATTR_ELEMENT_CURVE_KEY = "curve_key"
ATTR_ELEMENT_OBJECT = "object"


class Attribute:
    """Named geometry attribute (ref: render/attribute.cpp)."""

    def __init__(self, name, element, data):
        self.name = name
        self.element = element
        self.data = np.asarray(data, np.float32)


class Geometry(Node):
    """Base geometry (ref: render/geometry.h:49)."""

    SOCKETS = [
        S("use_motion_blur", S.BOOLEAN, False),
        S("motion_steps", S.UINT, 3),
    ]

    def __init__(self, name="", **kwargs):
        super().__init__(name, **kwargs)
        self.used_shaders = []       # Shader nodes used by this geometry
        self.attributes = {}         # name -> Attribute
        self.bvh = None              # packed BLAS (set by GeometryManager)

    def attribute_set(self, name, element, data):
        self.attributes[name] = Attribute(name, element, data)
        self.tag_modified("attributes")

    def attribute_get(self, name):
        return self.attributes.get(name)

    def compute_bounds(self):
        raise NotImplementedError


class Mesh(Geometry):
    NODE_NAME = "mesh"
    SOCKETS = Geometry.SOCKETS + [
        S("verts", S.POINT_ARRAY, np.zeros((0, 3), np.float32)),
        S("triangles", S.INT_ARRAY, np.zeros((0,), np.int32)),
        S("shader", S.INT_ARRAY, np.zeros((0,), np.int32)),  # per-tri shader slot
        S("smooth", S.BOOLEAN_ARRAY, np.zeros((0,), bool)),
        # adaptive subdivision (ref: SubdParams/Mesh::subdivision_type,
        # render/mesh.h; diced at sync by models/subd.py)
        S("subdivision_type", S.ENUM, "none",
          {"none": 0, "linear": 1, "catmull_clark": 2}),
        S("max_subdivisions", S.INT, 3),
        S("dicing_rate", S.FLOAT, 1.0),
        # quad/ngon control cage (ref: Mesh::SubdFace, render/mesh.h;
        # diced by models/subd.py subdivide_quad_mesh with the genuine
        # Catmull-Clark limit surface when subdivision_type is
        # catmull_clark). Empty -> triangle subdivision path.
        S("subd_face_verts", S.INT_ARRAY, np.zeros((0,), np.int32)),
        S("subd_face_len", S.INT_ARRAY, np.zeros((0,), np.int32)),
        S("subd_shader", S.INT_ARRAY, np.zeros((0,), np.int32)),
        S("subd_smooth", S.BOOLEAN_ARRAY, np.zeros((0,), bool)),
    ]

    def __init__(self, name="", **kwargs):
        super().__init__(name, **kwargs)

    # --- construction helpers (ref: Mesh::add_triangle / reserve) ---
    def set_mesh(self, verts, triangles, shader=None, smooth=None):
        verts = np.asarray(verts, np.float32).reshape(-1, 3)
        triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
        ntris = len(triangles)
        self.set("verts", verts)
        self.set("triangles", triangles.reshape(-1))
        self.set("shader", np.zeros(ntris, np.int32) if shader is None
                 else np.broadcast_to(np.asarray(shader, np.int32), (ntris,)).copy())
        self.set("smooth", np.zeros(ntris, bool) if smooth is None
                 else np.broadcast_to(np.asarray(smooth, bool), (ntris,)).copy())

    @property
    def num_triangles(self):
        return len(self.triangles) // 3

    @property
    def verts_array(self):
        return np.asarray(self.verts, np.float32).reshape(-1, 3)

    @property
    def triangles_array(self):
        return np.asarray(self.triangles, np.int32).reshape(-1, 3)

    def compute_bounds(self):
        v = self.verts_array
        if len(v) == 0:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        return v.min(0), v.max(0)

    def compute_vertex_normals(self):
        """Area-weighted vertex normals (ref: Mesh::add_vertex_normals)."""
        v = self.verts_array
        t = self.triangles_array
        n = np.zeros_like(v)
        fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
        for i in range(3):
            np.add.at(n, t[:, i], fn)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.where(ln > 1e-12, n / np.maximum(ln, 1e-12), [0.0, 0.0, 1.0])
        self.attribute_set(ATTR_STD_VERTEX_NORMAL, ATTR_ELEMENT_VERTEX, n)
        return n

    def set_subd_mesh(self, verts, faces, shader=None, smooth=None,
                      corner_uv=None):
        """Define a polygon control cage for subdivision surfaces (ref:
        Mesh::add_subd_face, render/mesh.cpp). `faces` is an (F, 4)
        quad array or a list of per-face index lists (ngons allowed;
        the first Catmull-Clark round quadrangulates them). Also stores
        a fan triangulation into the plain triangle sockets so the mesh
        renders as its linear cage when subdivision is off.

        corner_uv: optional per-CAGE-corner UVs (sum(face_len), 2) —
        stored as the dedicated "subd_uv" attribute (cage convention);
        the matching triangle-corner "std_uv" for the linear fallback
        is derived through the fan mapping, so the two conventions
        never conflict on one attribute."""
        verts = np.asarray(verts, np.float32).reshape(-1, 3)
        if isinstance(faces, np.ndarray) and faces.ndim == 2:
            flen = np.full(len(faces), faces.shape[1], np.int32)
            fv = np.asarray(faces, np.int32).reshape(-1)
        else:
            flen = np.array([len(f) for f in faces], np.int32)
            fv = np.concatenate([np.asarray(f, np.int32)
                                 for f in faces]) if len(faces) else \
                np.zeros((0,), np.int32)
        F = len(flen)
        shader = (np.zeros(F, np.int32) if shader is None
                  else np.broadcast_to(np.asarray(shader, np.int32),
                                       (F,)).copy())
        smooth = (np.ones(F, bool) if smooth is None
                  else np.broadcast_to(np.asarray(smooth, bool),
                                       (F,)).copy())
        self.set("subd_face_verts", fv)
        self.set("subd_face_len", flen)
        self.set("subd_shader", shader)
        self.set("subd_smooth", smooth)
        if corner_uv is not None:
            corner_uv = np.asarray(corner_uv, np.float32).reshape(-1, 2)
            assert len(corner_uv) == len(fv), (
                "corner_uv must be per cage corner")
            self.attribute_set("subd_uv", "corner", corner_uv)
        # linear cage fallback triangulation (+ matching triangle-corner
        # uvs derived through the same fan mapping)
        tris, tri_face, tri_uv = [], [], []
        off = np.concatenate([[0], np.cumsum(flen)[:-1]]).astype(np.int64)
        for m in np.unique(flen):
            sel = flen == m
            base = off[sel]
            for k in range(int(m) - 2):
                tris.append(np.stack([fv[base], fv[base + k + 1],
                                      fv[base + k + 2]], 1))
                tri_face.append(np.nonzero(sel)[0])
                if corner_uv is not None:
                    tri_uv.append(np.stack([corner_uv[base],
                                            corner_uv[base + k + 1],
                                            corner_uv[base + k + 2]], 1))
        if tris:
            tris = np.concatenate(tris)
            tri_face = np.concatenate(tri_face)
            self.set_mesh(verts, tris, shader=shader[tri_face],
                          smooth=smooth[tri_face])
            if corner_uv is not None:
                self.attribute_set("std_uv", "corner",
                                   np.concatenate(tri_uv).reshape(-1, 2))
        else:
            self.set_mesh(verts, np.zeros((0, 3), np.int32))

    @property
    def has_subd_cage(self):
        return len(np.asarray(self.subd_face_len)) > 0

    def tessellate_quads(self, quads):
        """Helper: quads (N,4) -> triangles (2N,3)."""
        quads = np.asarray(quads, np.int32).reshape(-1, 4)
        tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], 0)
        return tris


class Hair(Geometry):
    """Curve geometry (ref: render/hair.h:24). Round-1 scaffold: stores
    keys/radii; device intersection lands with the hair feature pass."""

    NODE_NAME = "hair"
    SOCKETS = Geometry.SOCKETS + [
        # native ray-facing ribbon segments (ref default curve shape,
        # geom_curve_intersect.h) vs twisted-triangle tessellation;
        # instanced/deforming hair always tessellates (scene.py)
        S("curve_shape", S.ENUM, "ribbon", {"ribbon": 0, "mesh": 1}),
        S("curve_keys", S.POINT_ARRAY, np.zeros((0, 3), np.float32)),
        S("curve_radius", S.FLOAT_ARRAY, np.zeros((0,), np.float32)),
        S("curve_first_key", S.INT_ARRAY, np.zeros((0,), np.int32)),
        S("curve_num_keys", S.INT_ARRAY, np.zeros((0,), np.int32)),
        S("curve_shader", S.INT_ARRAY, np.zeros((0,), np.int32)),
    ]

    def add_curve(self, keys, radius, shader=0):
        keys = np.asarray(keys, np.float32).reshape(-1, 3)
        radius = np.broadcast_to(np.asarray(radius, np.float32), (len(keys),))
        first = len(self.curve_keys)
        self.set("curve_keys", np.concatenate([self.curve_keys.reshape(-1, 3), keys]))
        self.set("curve_radius", np.concatenate([self.curve_radius, radius]))
        self.set("curve_first_key", np.concatenate([self.curve_first_key, [first]]).astype(np.int32))
        self.set("curve_num_keys", np.concatenate([self.curve_num_keys, [len(keys)]]).astype(np.int32))
        self.set("curve_shader", np.concatenate([self.curve_shader, [shader]]).astype(np.int32))

    @property
    def num_curves(self):
        return len(self.curve_first_key)

    def compute_bounds(self):
        v = self.curve_keys.reshape(-1, 3)
        if len(v) == 0:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        r = self.curve_radius[:, None]
        return (v - r).min(0), (v + r).max(0)

    def tessellate_ribbons(self):
        """Curves -> twisted triangle ribbons (host-side; the analog of
        the reference's curve-to-mesh export paths — keeps hair on the
        dense/BVH triangle pipeline; true curve
        intersection ref kernel/geom/geom_curve_intersect.h is a later
        refinement). Returns a Mesh with per-curve ribbons, uv.v along
        the strand, and the curve shader per triangle."""
        verts, tris, uvs, shaders = [], [], [], []
        face_tangents = []  # per-triangle strand direction
        keys = np.asarray(self.curve_keys, np.float32).reshape(-1, 3)
        radius = np.asarray(self.curve_radius, np.float32)
        base = 0
        for ci in range(self.num_curves):
            first = int(self.curve_first_key[ci])
            nk = int(self.curve_num_keys[ci])
            if nk < 2:
                continue
            pts = keys[first:first + nk]
            rad = radius[first:first + nk]
            tangents = np.gradient(pts, axis=0)
            tangents /= np.maximum(
                np.linalg.norm(tangents, axis=-1, keepdims=True), 1e-12)
            # rotation-minimizing-ish side vectors
            up = np.array([0.0, 0.0, 1.0])
            if abs(tangents[0] @ up) > 0.9:
                up = np.array([1.0, 0.0, 0.0])
            side = np.cross(tangents[0], up)
            sides = []
            for k in range(nk):
                side = side - tangents[k] * (side @ tangents[k])
                nrm = np.linalg.norm(side)
                if nrm < 1e-9:
                    side = np.cross(tangents[k], up)
                    nrm = max(np.linalg.norm(side), 1e-9)
                side = side / nrm
                sides.append(side.copy())
            sides = np.asarray(sides)
            left = pts - sides * rad[:, None]
            right = pts + sides * rad[:, None]
            v0 = base
            for k in range(nk):
                verts.append(left[k])
                verts.append(right[k])
            vparam = np.linspace(0.0, 1.0, nk)
            for k in range(nk - 1):
                a = v0 + 2 * k
                tris.append([a, a + 1, a + 3])
                tris.append([a, a + 3, a + 2])
                uvs.append([[0, vparam[k]], [1, vparam[k]],
                            [1, vparam[k + 1]]])
                uvs.append([[0, vparam[k]], [1, vparam[k + 1]],
                            [0, vparam[k + 1]]])
                shaders.extend([int(self.curve_shader[ci])] * 2)
                seg = pts[k + 1] - pts[k]
                seg = seg / max(np.linalg.norm(seg), 1e-12)
                face_tangents.extend([seg, seg])
            base += 2 * nk
        m = Mesh(self.name + "_ribbons")
        if not tris:
            return m
        m.set_mesh(np.asarray(verts, np.float32),
                   np.asarray(tris, np.int32),
                   shader=np.asarray(shaders, np.int32),
                   smooth=np.ones(len(tris), bool))
        m.attribute_set(ATTR_STD_UV, ATTR_ELEMENT_CORNER,
                        np.asarray(uvs, np.float32))
        m.attribute_set(ATTR_STD_CURVE_TANGENT, ATTR_ELEMENT_FACE,
                        np.asarray(face_tangents, np.float32))
        m.used_shaders = self.used_shaders
        return m


def make_plane_mesh(p0, e0, e1, shader=0, name="plane"):
    """Convenience: quad from corner + two edge vectors."""
    p0, e0, e1 = (np.asarray(x, np.float32) for x in (p0, e0, e1))
    verts = np.stack([p0, p0 + e0, p0 + e0 + e1, p0 + e1])
    m = Mesh(name)
    m.set_mesh(verts, [[0, 1, 2], [0, 2, 3]], shader=shader)
    return m


def make_box_mesh(lo, hi, shader=0, name="box", inside=False):
    """Axis-aligned box; `inside=True` flips windings (Cornell walls)."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    verts = np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]], np.float32)
    quads = np.array([
        [3, 2, 1, 0],  # z0 bottom, outward normal -z
        [4, 5, 6, 7],  # z1 top, +z
        [0, 1, 5, 4],  # y0, -y
        [2, 3, 7, 6],  # y1, +y
        [4, 7, 3, 0],  # x0, -x
        [1, 2, 6, 5],  # x1, +x
    ], np.int32)
    if inside:
        quads = quads[:, ::-1]
    m = Mesh(name)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], 0)
    m.set_mesh(verts, tris, shader=shader)
    return m


def make_sphere_mesh(center, radius, shader=0, nlat=16, nlon=32, name="sphere"):
    """UV-sphere triangulation."""
    center = np.asarray(center, np.float32)
    lat = np.linspace(0, np.pi, nlat + 1)
    lon = np.linspace(0, 2 * np.pi, nlon, endpoint=False)
    verts = []
    for th in lat:
        for ph in lon:
            verts.append(center + radius * np.array(
                [np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)]))
    verts = np.asarray(verts, np.float32)
    tris = []
    for i in range(nlat):
        for j in range(nlon):
            a = i * nlon + j
            b = i * nlon + (j + 1) % nlon
            c = (i + 1) * nlon + j
            d = (i + 1) * nlon + (j + 1) % nlon
            if i > 0:
                tris.append([a, c, b])
            if i < nlat - 1:
                tris.append([b, c, d])
    m = Mesh(name)
    m.set_mesh(verts, np.asarray(tris, np.int32), shader=shader)
    # spherical uvs (vertex domain)
    rel = (verts - center) / max(radius, 1e-9)
    u = 0.5 + np.arctan2(rel[:, 1], rel[:, 0]) / (2 * np.pi)
    vv = 0.5 + np.arcsin(np.clip(rel[:, 2], -1, 1)) / np.pi
    m.attribute_set(ATTR_STD_UV, ATTR_ELEMENT_VERTEX,
                    np.stack([u, vv], -1))
    return m
