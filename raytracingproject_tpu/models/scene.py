"""Scene container + flattening (ref: render/scene.h Scene/DeviceScene,
render/scene.cpp:193-321 Scene::device_update ordering;
geometry packing ref: render/geometry.cpp GeometryManager::device_update;
object packing ref: render/object.cpp ObjectManager::device_update;
light CDF ref: render/light.cpp LightManager::device_update_distribution).

`device_update()` runs the manager pipeline in the reference's order
(shaders -> geometry/BVH -> objects -> lights -> camera/film/integrator
-> images) and produces a flat dict of numpy arrays — the DeviceScene —
plus kernel-globals for ops/integrator.py.

Geometry policy (layout decisions for the wavefront kernels):
- single-user static geometry is baked to world space and merged into
  one 'static BLAS' (ref: object.cpp apply_static_transforms);
- multi-user geometry keeps object space: per-geometry BLAS + a TLAS
  whose leaves enter instances in-traversal (ops/intersect.py);
- tiny all-static scenes skip the BVH entirely (brute-force kernel).
Per-corner attributes (normals, UVs) are denormalized into prim-order
arrays so shading is pure row gathers.
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu.models.node import Node, SocketType as S
from raytracingproject_tpu.models.camera import Camera
from raytracingproject_tpu.models.film import Film
from raytracingproject_tpu.models.integrator import Integrator
from raytracingproject_tpu.models.background import Background
from raytracingproject_tpu.models.light import Light  # noqa: F401
from raytracingproject_tpu.models.object import PATH_RAY_ALL_VISIBILITY
from raytracingproject_tpu.models.image import ImageManager, TextureStore
from raytracingproject_tpu.models.shader import Shader, ShaderGraph
from raytracingproject_tpu.models import shader_nodes as sn
from raytracingproject_tpu.bvh import build as bvh_build
from raytracingproject_tpu.utils import transform as tfm
from raytracingproject_tpu.utils import log

# Dispatch thresholds between the dense triangle sweep, the cluster
# walk and the packed BVH walk. Set on the earlier accelerator; not
# measured on the H100 yet.
# Below this many prims, static scenes run the tri-major dense sweep.
BRUTE_FORCE_MAX_PRIMS = 16384
# build cluster tables from this size up (below it the dense kernel has
# no competition); the brute-vs-cluster dispatch crossover is separate
CLUSTER_MIN_PRIMS = 384
# dense wins below this many prims on incoherent wavefronts
BRUTE_VS_CLUSTER_PRIMS = 1024
# single-level cluster-table row cap: every cluster walk tests each
# lane against all C cluster boxes, so past it the scene takes the
# packed BVH walk
CLUSTER_MAX_SINGLE_LEVEL = 640
# curve segments from this count up ride the oriented-cluster walk
# (ops/curve_clusters.py); below it the dense segment sweep wins the
# same way dense triangles do
CURVE_CLUSTER_MIN_SEGS = 512
# Instanced geometry whose flattened copy stays under the dense
# threshold is baked to world space (the reference applies static
# transforms similarly, object.cpp apply_static_transforms).
AUTO_FLATTEN_MAX_PRIMS = 16384

def _resample_motion_steps(v0, extra_steps, n_extra):
    """Resample a mesh's piecewise-linear vertex path onto n_extra
    uniform shutter steps after t=0. extra_steps: (S_m-1, V, 3)
    positions at times k/(S_m-1); returns (n_extra, V, 3) at times
    j/n_extra. Exact at shared grid points (nested grids resample
    bit-identically at endpoints)."""
    if n_extra == 0:
        return np.zeros((0,) + v0.shape, np.float32)
    path = np.concatenate([v0[None], extra_steps], axis=0)  # (S_m, V, 3)
    sm1 = path.shape[0] - 1
    out = np.empty((n_extra,) + v0.shape, np.float32)
    for j in range(1, n_extra + 1):
        tt = j / n_extra * sm1
        k = min(int(np.floor(tt)), sm1 - 1)
        f = tt - k
        out[j - 1] = path[k] if f == 0.0 \
            else (1.0 - f) * path[k] + f * path[k + 1]
    return out


class SceneParams(Node):
    """ref: render/scene.h:137 SceneParams."""
    NODE_NAME = "scene_params"
    SOCKETS = [
        S("bvh_use_spatial_split", S.BOOLEAN, False),
        S("use_bvh_steps", S.BOOLEAN, False),
        S("persistent_data", S.BOOLEAN, False),
        S("texture_limit", S.INT, 0),
        S("background", S.BOOLEAN, True),
    ]


def default_surface_shader():
    g = ShaderGraph()
    d = g.add(sn.DiffuseBsdfNode("default_diffuse", color=(0.8, 0.8, 0.8)))
    g.connect(d, "bsdf", g.output_node, "surface")
    return Shader("default_surface", g)


def default_background_shader():
    g = ShaderGraph()
    b = g.add(sn.BackgroundNode("default_background", color=(0.0, 0.0, 0.0),
                                strength=0.0))
    g.connect(b, "background", g.output_node, "surface")
    return Shader("default_background", g)


class Scene:
    def __init__(self, params=None):
        self.params = params or SceneParams()
        self.camera = Camera()
        self.film = Film()
        self.integrator = Integrator()
        self.background = Background()
        self.image_manager = ImageManager()
        self.objects = []
        self.lights = []
        self.shaders = []
        self.default_surface = default_surface_shader()
        self.default_background = default_background_shader()
        self.add_shader(self.default_surface)
        self.dscene = None
        self.need_update = True

    # --- construction API ---
    def add_shader(self, shader):
        if shader not in self.shaders:
            self.shaders.append(shader)
        return shader

    def add_object(self, obj):
        self.objects.append(obj)
        self.need_update = True
        return obj

    def add_light(self, light):
        self.lights.append(light)
        self.need_update = True
        return light

    # ------------------------------------------------------------------
    def device_update(self, progress=None):
        """Flatten everything (ref ordering: scene.cpp:193-321)."""
        # 1. shaders: slots + feature analysis + images
        if self.background.shader is not None:
            self.add_shader(self.background.shader)
        for li in self.lights:
            if li.shader is not None:
                self.add_shader(li.shader)
        for slot, sh in enumerate(self.shaders):
            sh.slot = slot
            sh.analyze()
            if sh.has_volume and \
                    sh.get_enum_int("volume_interpolation_method") == 1:
                raise NotImplementedError(
                    f"shader '{sh.name}': volume_interpolation_method="
                    "'cubic' is not implemented (grids sample "
                    "trilinearly); use 'linear'.")
            for node in sh.graph.nodes:
                if isinstance(node, (sn.ImageTextureNode,
                                     sn.EnvironmentTextureNode)):
                    if node.slot < 0:
                        src = node.image if node.image is not None \
                            else node.filename
                        if src is None or (isinstance(src, str) and not src):
                            node.slot = -1
                        else:
                            node.slot = self.image_manager.add_image(src)
                    if getattr(node, "use_auto_mip", False) \
                            and node.slot >= 0:
                        self.image_manager.want_mips.add(node.slot)
                elif isinstance(node, sn.SkyTextureNode) \
                        and node.get_enum_int("sky_type") == 1:
                    # nishita: bake the atmosphere to an equirect map
                    # (ref: render/nodes.cpp:708-745 sky precompute);
                    # re-bake (new slot) only when parameters changed
                    prev_key = node._bake_key
                    img = node.bake_nishita()
                    if node.slot < 0:
                        node.slot = self.image_manager.add_image(
                            img, name="__nishita_sky__")
                    elif node._bake_key != prev_key:
                        # parameter edit: rebake IN PLACE (a fresh slot
                        # per edit would grow the packed texture array
                        # without bound on interactive re-syncs)
                        node.slot = self.image_manager.replace_image(
                            node.slot, img, name="__nishita_sky__")

        # 2. geometry + objects -> packed prims + BVH
        packed = self._pack_geometry()
        # vertex colors ride a separate per-prim table gathered in
        # shader_setup ONLY when some shader reads them (an extra
        # 12-wide gather per shading batch otherwise wasted)
        if not any(getattr(s, "has_vertex_color", False)
                   for s in self.shaders):
            packed.pop("prim_vcol", None)
        else:
            vc = packed["prim_vcol"].reshape(-1, 12)
            # pad to the prim_table row count (curve rows read white)
            extra = len(packed["prim_table"]) - len(vc)
            if extra > 0:
                vc = np.concatenate(
                    [vc, np.ones((extra, 12), np.float32)])
            packed["prim_vcol"] = np.ascontiguousarray(vc)

        # 3. lights -> distribution CDF
        lightd = self._pack_lights(packed)

        # 4. camera / film / integrator
        cam = self.camera.update()
        kint = self.integrator.kernel_record()
        filter_table = self.film.build_filter_table()

        # 5. images
        tex_data, tex_sizes = self.image_manager.device_update()

        bg_slot = (self.background.shader.slot
                   if self.background.shader is not None
                   else self.default_background.slot
                   if self.default_background in self.shaders else -1)

        dscene = {}
        dscene.update(packed)
        dscene.update(lightd)
        self.dscene = {
            "arrays": dscene,
            "cam": cam,
            "kint": kint,
            "filter_table": filter_table,
            "tex_data": tex_data,
            "tex_sizes": tex_sizes,
            "background_shader": bg_slot,
            "use_brute": packed.pop("__use_brute__"),
            "has_instances": packed.pop("__has_instances__"),
            "has_deform_motion": packed.pop("__has_deform_motion__", False),
            "deform_steps": packed.pop("__deform_steps__", 1),
            "obj_motion_steps": packed.pop("__obj_motion_steps__", 2),
            "cluster_tris": packed.pop("__cluster_tris__", 0),
            "cluster_motion": packed.pop("__cluster_motion__", False),
            "bvh_stack_depth": packed.pop("__bvh_stack_depth__", 0),
            "curve_prim_base": packed.pop("__curve_prim_base__", 0),
            "curve_cluster_segs": packed.pop("__curve_cluster_segs__", 0),
            "film_transparent": bool(self.background.transparent),
            "light_tree": dscene.pop("__light_tree__", None),
            "light_kinds": dscene.pop("__light_kinds__", None),
        }
        dscene.pop("__prim_source__", None)
        dscene.pop("__use_brute__", None)
        dscene.pop("__has_instances__", None)
        dscene.pop("__has_deform_motion__", None)
        dscene.pop("__deform_steps__", None)
        dscene.pop("__obj_motion_steps__", None)
        dscene.pop("__cluster_tris__", None)
        dscene.pop("__cluster_motion__", None)
        dscene.pop("__bvh_stack_depth__", None)
        dscene.pop("__curve_prim_base__", None)
        dscene.pop("__curve_cluster_segs__", None)
        self.need_update = False
        return self.dscene

    # ------------------------------------------------------------------
    def _displace_mesh(self, mesh, v, vn, t, uv_attr):
        """True displacement at sync time (ref: render/geometry.cpp
        displacement step + kernel/geom displacement eval; redesigned as
        a host-side traced graph eval over all vertices at once).

        Evaluates the material's displacement output at every vertex in
        OBJECT space and offsets the mesh, then recomputes smooth
        normals. Procedural textures only (image slots are uploaded
        after geometry packing)."""
        dshader = next((sh for sh in mesh.used_shaders
                        if sh.has_displacement()), None)
        if dshader is None or len(v) == 0:
            return v, vn
        import jax.numpy as jnp
        from raytracingproject_tpu.ops.shade import ShaderData
        nv = len(v)
        # per-vertex uv (corner uvs: last-writer-wins scatter)
        uv = np.zeros((nv, 2), np.float32)
        if uv_attr is not None:
            if uv_attr.element == "corner":
                uv[t.reshape(-1)] = uv_attr.data.reshape(-1, 2)[
                    : t.size]
            else:
                uv[:] = uv_attr.data[:nv]
        lo, hi = v.min(0), v.max(0)
        gen = (v - lo) / np.maximum(hi - lo, 1e-12)
        vj = jnp.asarray(v, jnp.float32)
        nj = jnp.asarray(vn, jnp.float32)
        zeros = jnp.zeros((nv, 3), jnp.float32)
        ctx = ShaderData(
            P=vj, N=nj, Ng=nj, Ns=nj, I=nj,
            uv=jnp.asarray(uv), generated=jnp.asarray(gen, jnp.float32),
            P_object=vj,
            time=jnp.zeros(nv, jnp.float32),
            ray_length=jnp.zeros(nv, jnp.float32),
            ray_depth=jnp.zeros(nv, jnp.int32),
            path_flag=jnp.zeros(nv, jnp.uint32),
            prim=jnp.zeros(nv, jnp.int32),
            shader=jnp.full(nv, max(dshader.slot, 0), jnp.int32),
            object_index=jnp.zeros(nv, jnp.int32),
            object_color=zeros, object_location=zeros,
            object_random=jnp.zeros(nv, jnp.float32),
            backfacing=jnp.zeros(nv, bool),
            textures=None, batch_shape=(nv,))
        disp = dshader.graph.evaluate(ctx)["displacement"]
        if disp is None:
            return v, vn
        v2 = v + np.asarray(disp, np.float32)
        # recompute area-weighted smooth vertex normals
        fn = np.cross(v2[t[:, 1]] - v2[t[:, 0]], v2[t[:, 2]] - v2[t[:, 0]])
        vn2 = np.zeros_like(v2)
        for k in range(3):
            np.add.at(vn2, t[:, k], fn)
        ln = np.linalg.norm(vn2, axis=-1, keepdims=True)
        vn2 = np.where(ln > 1e-12, vn2 / np.maximum(ln, 1e-12), vn)
        return v2.astype(np.float32), vn2.astype(np.float32)

    # ------------------------------------------------------------------
    def _subdivided_mesh(self, mesh, world_tfm):
        """Adaptive dicing of a subdivision mesh into a plain Mesh
        (ref: render/mesh_subdivision.cpp + subd/subd_split.h DiagSplit;
        models/subd.py). Cached per (params, camera) so repeated syncs
        don't re-dice."""
        from raytracingproject_tpu.models import subd
        from raytracingproject_tpu.models.mesh import Mesh as MeshCls
        cam = self.camera
        cam_mat = np.asarray(cam.matrix, np.float32)
        cam_pos = cam_mat[:3, 3]
        pixel_angle = float(cam.fov) / max(int(cam.width), 1)
        v_arr = np.asarray(mesh.verts_array, np.float32)
        key = (mesh.get_enum_int("subdivision_type"),
               int(mesh.max_subdivisions), float(mesh.dicing_rate),
               tuple(np.round(cam_pos, 4).tolist()),
               round(pixel_angle, 9),
               # cheap geometry fingerprint: edits to the base mesh's
               # verts/topology between syncs must invalidate the cache
               len(v_arr), int(mesh.num_triangles),
               len(np.asarray(mesh.subd_face_verts)),
               float(v_arr.sum()) if len(v_arr) else 0.0,
               None if world_tfm is None
               else tuple(np.asarray(world_tfm).reshape(-1).tolist()))
        cached = getattr(mesh, "_subd_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]

        if mesh.has_subd_cage:
            refined = self._subdivided_cage(mesh, world_tfm, cam_pos,
                                            pixel_angle)
            mesh._subd_cache = (key, refined)
            return refined

        v = mesh.verts_array
        t = mesh.triangles_array
        uv_attr = mesh.attribute_get("std_uv")
        if uv_attr is not None:
            if uv_attr.element == "corner":
                corner_uv = np.asarray(uv_attr.data,
                                       np.float32).reshape(-1, 3, 2)[:len(t)]
            else:
                corner_uv = np.asarray(uv_attr.data, np.float32)[t]
        else:
            corner_uv = None
        mv_attr = mesh.attribute_get("std_motion_vertex_position")
        if mv_attr is not None:
            mv = np.asarray(mv_attr.data, np.float32)
            mv = mv[None] if mv.ndim == 2 else mv   # (S-1, V, 3)
            extra = tuple(mv[k] for k in range(mv.shape[0]))
        else:
            extra = ()
        subd_type = ("catmull_clark"
                     if mesh.get_enum_int("subdivision_type") == 2
                     else "linear")
        v2, t2, uv2, sh2, sm2, extra2, levels = subd.subdivide_mesh(
            v, t, corner_uv, np.asarray(mesh.shader, np.int32),
            np.asarray(mesh.smooth, bool), subd_type,
            int(mesh.max_subdivisions), float(mesh.dicing_rate),
            cam_pos, pixel_angle,
            to_world=(None if world_tfm is None
                      else tfm.to_4x4(world_tfm)),
            extra_verts=extra)
        refined = MeshCls(mesh.name + "_subd")
        refined.set_mesh(v2, t2, shader=sh2, smooth=sm2)
        refined.used_shaders = mesh.used_shaders
        if uv2 is not None:
            refined.attribute_set("std_uv", "corner", uv2.reshape(-1, 2))
        if extra2:
            refined.attribute_set(
                "std_motion_vertex_position", "vertex",
                extra2[0] if len(extra2) == 1 else np.stack(extra2))
        log.vlog(1, "subdivided %s: %d -> %d tris (%d levels)",
                 mesh.name, len(t), len(t2), levels)
        mesh._subd_cache = (key, refined)
        return refined

    # ------------------------------------------------------------------
    def _subdivided_cage(self, mesh, world_tfm, cam_pos, pixel_angle):
        """Dice a quad/ngon control cage with the true Catmull-Clark
        limit surface (ref: render/mesh_subdivision.cpp OpenSubdiv path;
        models/subd.py subdivide_quad_mesh)."""
        from raytracingproject_tpu.models import subd
        from raytracingproject_tpu.models.mesh import Mesh as MeshCls
        fv = np.asarray(mesh.subd_face_verts, np.int64)
        flen = np.asarray(mesh.subd_face_len, np.int64)
        # cage UVs live in the dedicated "subd_uv" attribute (per cage
        # corner); a std_uv that happens to match the cage-corner count
        # is accepted, but the triangle-corner convention (3*T rows,
        # the linear-fallback layout) is NOT reinterpreted
        uv_attr = mesh.attribute_get("subd_uv")
        if uv_attr is None:
            cand = mesh.attribute_get("std_uv")
            if cand is not None and cand.element == "corner" \
                    and len(np.asarray(cand.data).reshape(-1, 2)) \
                    == len(fv):
                uv_attr = cand
        corner_uv = (np.asarray(uv_attr.data, np.float32).reshape(-1, 2)
                     if uv_attr is not None else None)
        mv_attr = mesh.attribute_get("std_motion_vertex_position")
        if mv_attr is not None:
            mv = np.asarray(mv_attr.data, np.float32)
            mv = mv[None] if mv.ndim == 2 else mv   # (S-1, V, 3)
            extra = tuple(mv[k] for k in range(mv.shape[0]))
        else:
            extra = ()
        subd_type = ("catmull_clark"
                     if mesh.get_enum_int("subdivision_type") == 2
                     else "linear")
        v2, t2, uv2, sh2, sm2, extra2, levels = subd.subdivide_quad_mesh(
            mesh.verts_array, fv, flen, corner_uv,
            np.asarray(mesh.subd_shader, np.int32),
            np.asarray(mesh.subd_smooth, bool), subd_type,
            int(mesh.max_subdivisions), float(mesh.dicing_rate),
            cam_pos, pixel_angle,
            to_world=(None if world_tfm is None
                      else tfm.to_4x4(world_tfm)),
            extra_verts=extra)
        refined = MeshCls(mesh.name + "_subd")
        refined.set_mesh(v2, t2, shader=sh2, smooth=sm2)
        refined.used_shaders = mesh.used_shaders
        if uv2 is not None:
            refined.attribute_set("std_uv", "corner", uv2.reshape(-1, 2))
        if extra2:
            refined.attribute_set(
                "std_motion_vertex_position", "vertex",
                extra2[0] if len(extra2) == 1 else np.stack(extra2))
        log.vlog(1, "subdivided cage %s: %d faces -> %d tris (%d levels)",
                 mesh.name, len(flen), len(t2), levels)
        return refined

    # ------------------------------------------------------------------
    def _pack_geometry(self):
        objects = self.objects
        nobj = max(len(objects), 1)

        # classify: single-user static -> merge; else instanced
        geom_users = {}
        for oi, obj in enumerate(objects):
            geom_users.setdefault(id(obj.geometry), []).append(oi)

        # total flattened size decides whether shared geometry is baked
        # to world space (dense kernel) or instanced (TLAS/BLAS)
        total_flat = sum(getattr(o.geometry, "num_triangles", 0)
                        for o in objects)
        flatten_all = total_flat <= AUTO_FLATTEN_MAX_PRIMS

        static_objs = []
        instanced_geoms = {}  # id(geom) -> (geom, [obj indices])
        for oi, obj in enumerate(objects):
            users = geom_users[id(obj.geometry)]
            if (len(users) == 1 or flatten_all) and not obj.use_motion:
                static_objs.append(oi)
            else:
                instanced_geoms.setdefault(
                    id(obj.geometry), (obj.geometry, []))[1].append(oi)

        # scene-wide motion step count (ref: Geometry::motion_steps,
        # bvh_build.cpp:89-130 motion-step references): every deforming
        # mesh's piecewise-linear vertex path is resampled onto the
        # common (S-1) uniform shutter steps so one packed array serves
        # the whole wavefront; S = max steps over meshes (2-step attrs
        # stay bit-identical: resampling a 1-segment path is exact).
        def _geom_extra_steps(g):
            a = g.attributes.get("std_motion_vertex_position") \
                if hasattr(g, "attributes") else None
            if a is None:
                return 0
            d = np.asarray(a.data)
            return d.shape[0] if d.ndim == 3 else 1
        deform_extra = max(
            [_geom_extra_steps(o.geometry) for o in objects
             if o.geometry is not None
             and hasattr(o.geometry, "triangles_array")] + [0])

        tri_verts, tri_vnormal, tri_uv = [], [], []
        tri_verts_t1 = []  # per-mesh (deform_extra, T, 3, 3) step verts
        tri_tangent = []  # per-prim curve tangent (zeros for meshes)
        tri_vcol = []     # per-corner RGBA vertex colors
        vcol_seen = []    # packed only when some mesh carries the attr
        prim_shader, prim_smooth, prim_object = [], [], []
        deform_seen = []
        # native curve segments (world space; ops/intersect.py
        # intersect_curves_ribbon sweeps them after the triangle pass)
        curve_cols = {k: [] for k in ("p0", "e", "r0", "r1", "vp0",
                                      "vp1", "shader", "object")}

        def append_hair_native(hair, obj_idx, world_tfm):
            keys = np.asarray(hair.curve_keys, np.float32).reshape(-1, 3)
            rad = np.asarray(hair.curve_radius, np.float32)
            fk = np.asarray(hair.curve_first_key, np.int64)
            nk = np.asarray(hair.curve_num_keys, np.int64)
            csh = np.asarray(hair.curve_shader, np.int32)
            nseg = np.maximum(nk - 1, 0)
            total = int(nseg.sum())
            if total == 0:
                return
            off = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(nseg) - nseg, nseg)
            i0 = np.repeat(fk, nseg) + off
            p0, p1 = keys[i0], keys[i0 + 1]
            r0, r1 = rad[i0], rad[i0 + 1]
            if world_tfm is not None:
                m = np.asarray(world_tfm, np.float32)
                p0 = tfm.transform_point(m, p0)
                p1 = tfm.transform_point(m, p1)
                # uniform-scale approximation for radii under the
                # object transform (hair widths are tiny vs the scene)
                s = abs(float(np.linalg.det(m[:3, :3]))) ** (1.0 / 3.0)
                r0, r1 = r0 * s, r1 * s
            nsegc = np.repeat(np.maximum(nseg, 1), nseg).astype(np.float32)
            slots = np.array([self._shader_slot(hair, int(s))
                              for s in csh], np.int32)
            curve_cols["p0"].append(p0)
            curve_cols["e"].append(p1 - p0)
            curve_cols["r0"].append(r0)
            curve_cols["r1"].append(r1)
            curve_cols["vp0"].append(off / nsegc)
            curve_cols["vp1"].append((off + 1) / nsegc)
            curve_cols["shader"].append(np.repeat(slots, nseg))
            curve_cols["object"].append(
                np.full(total, obj_idx, np.int32))

        def append_mesh(mesh, obj_idx, world_tfm=None):
            from raytracingproject_tpu.models.mesh import Hair
            if isinstance(mesh, Hair):
                if (obj_idx >= 0
                        and mesh.get_enum_int("curve_shape") == 0
                        and mesh.num_curves):
                    # native ribbon segments, swept densely after the
                    # triangle pass (ref: geom_curve_intersect.h)
                    append_hair_native(mesh, obj_idx, world_tfm)
                    return 0
                # instanced/deforming hair (or curve_shape="mesh"):
                # curves ride the triangle pipeline as twisted ribbons
                mesh = mesh.tessellate_ribbons()
            elif mesh.get_enum_int("subdivision_type") != 0:
                # adaptive dicing at sync (ref: subd/subd_split.h
                # DiagSplit; models/subd.py) — before displacement so
                # the graph evaluates on the diced vertices
                mesh = self._subdivided_mesh(mesh, world_tfm)
            v = mesh.verts_array
            t = mesh.triangles_array
            if len(t) == 0:
                return 0
            vn_attr = mesh.attribute_get("std_vertex_normal")
            if vn_attr is None:
                vn = mesh.compute_vertex_normals()
            else:
                vn = vn_attr.data
            uv_attr = mesh.attribute_get("std_uv")
            v, vn = self._displace_mesh(mesh, v, vn, t, uv_attr)
            # deforming motion blur: per-step vertex positions (ref:
            # ATTR_STD_MOTION_VERTEX_POSITION + motion-step references,
            # bvh_build.cpp:89-130). The attr carries (V, 3) — classic
            # shutter-close — or (S_m-1, V, 3) uniform steps; each
            # mesh's piecewise-linear path is resampled onto the
            # scene-wide step grid (exact when grids nest).
            mv_attr = mesh.attribute_get("std_motion_vertex_position")
            if mv_attr is not None:
                mv = np.asarray(mv_attr.data, np.float32)
                if mv.ndim == 2:
                    mv = mv[None]
                steps = _resample_motion_steps(v, mv, deform_extra)
                deform_seen.append(True)
            else:
                steps = None  # static: steps mirror v (set after tfm)
            if world_tfm is not None:
                v = tfm.transform_point(world_tfm, v)
                if steps is not None and len(steps):
                    steps = np.stack([tfm.transform_point(world_tfm, s)
                                      for s in steps])
                itt = np.linalg.inv(tfm.to_4x4(world_tfm))[:3, :3].T
                vn = vn @ itt.T
                ln = np.linalg.norm(vn, axis=-1, keepdims=True)
                vn = vn / np.maximum(ln, 1e-12)
            if steps is None:
                steps = (np.broadcast_to(v, (deform_extra,) + v.shape)
                         if deform_extra > 0 else
                         np.zeros((0,) + v.shape, np.float32))
            tri_verts_t1.append(steps[:, t])  # (S-1, T, 3, 3)
            tri_verts.append(v[t])            # (T, 3, 3)
            tri_vnormal.append(vn[t])
            # hair ribbons carry the strand direction per triangle
            # (ref: ATTR_STD_CURVE_TANGENT; consumed by the hair BSDF)
            tan_attr = mesh.attribute_get("std_curve_tangent")
            if tan_attr is not None:
                tt = np.asarray(tan_attr.data, np.float32).reshape(-1, 3)
                tt = tt[: len(t)]
                if world_tfm is not None:
                    tt = tt @ np.asarray(world_tfm,
                                         np.float32)[:3, :3].T
                    tt = tt / np.maximum(
                        np.linalg.norm(tt, axis=-1, keepdims=True), 1e-12)
            else:
                tt = np.zeros((len(t), 3), np.float32)
            tri_tangent.append(tt)
            if uv_attr is not None:
                if uv_attr.element == "corner":
                    tri_uv.append(uv_attr.data.reshape(-1, 3, 2)[: len(t)])
                else:  # vertex uvs
                    tri_uv.append(uv_attr.data[t])
            else:
                # default: barycentric-ish placeholder uvs
                tri_uv.append(np.tile(
                    np.array([[0, 0], [1, 0], [1, 1]], np.float32),
                    (len(t), 1, 1)))
            # per-corner vertex colors (ref: ATTR_STD_VERTEX_COLOR,
            # consumed by VertexColorNode); white where absent
            vc_attr = mesh.attribute_get("std_vertex_color")
            if vc_attr is not None:
                vc = np.asarray(vc_attr.data, np.float32)
                if vc.shape[-1] == 3:  # RGB -> RGBA
                    vc = np.concatenate(
                        [vc, np.ones(vc.shape[:-1] + (1,), np.float32)],
                        -1)
                if vc_attr.element == "corner":
                    vc = vc.reshape(-1, 3, 4)[: len(t)]
                else:  # per-vertex
                    vc = vc[t]
                tri_vcol.append(vc)
                vcol_seen.append(True)
            else:
                tri_vcol.append(np.ones((len(t), 3, 4), np.float32))
            shader_slots = np.array(
                [self._shader_slot(mesh, s) for s in
                 np.asarray(mesh.shader, np.int32)], np.int32)
            prim_shader.append(shader_slots)
            prim_smooth.append(np.asarray(mesh.smooth, bool))
            prim_object.append(np.full(len(t), obj_idx, np.int32))
            return len(t)

        # ---- static merged geometry ----
        for oi in static_objs:
            obj = objects[oi]
            append_mesh(obj.geometry, oi,
                        np.asarray(obj.transform, np.float32))

        def cat(lst, shape_tail, dtype=np.float32):
            if lst:
                return np.concatenate(lst).astype(dtype)
            return np.zeros((0,) + shape_tail, dtype)

        static_verts = cat(tri_verts, (3, 3))
        static_steps = (np.concatenate(tri_verts_t1, axis=1)
                        .astype(np.float32) if tri_verts_t1 else
                        np.zeros((deform_extra, 0, 3, 3), np.float32))
        static_vnormal = cat(tri_vnormal, (3, 3))
        static_uv = cat(tri_uv, (3, 2))
        static_tangent = cat(tri_tangent, (3,))
        static_shader = cat(prim_shader, (), np.int32)
        static_smooth = cat(prim_smooth, (), bool)
        static_object = cat(prim_object, (), np.int32)

        has_instances = len(instanced_geoms) > 0

        # build static BLAS
        blocks = []  # (bounds, children, prim arrays...) with local ids
        # spatial splits clip refs against the shutter-OPEN triangles,
        # which would under-bound deforming geometry — keep object
        # splits when any mesh carries deform motion
        use_spatial = bool(self.params.get("bvh_use_spatial_split")) \
            and not deform_seen

        def build(lo, hi, verts):
            # spatial splits duplicate straddling refs into both
            # children (ref: bvh_split.cpp, gate bvh_build.cpp:390);
            # prim tables below are gathered BY prim_order, so
            # duplicated refs simply repeat their prim's row
            if use_spatial:
                return bvh_build.build_bvh_spatial(lo, hi,
                                                   tri_verts=verts)
            return bvh_build.build_bvh(lo, hi)

        if len(static_verts):
            lo, hi = static_verts.min(1), static_verts.max(1)
            sb = build(lo, hi, static_verts)
            order = sb.prim_order
            blocks.append({
                "source": order,   # original prim id (copies share it)
                "bounds": sb.bounds, "children": sb.children,
                "verts": static_verts[order],
                "verts_steps": static_steps[:, order],
                "verts_t1": (static_steps[-1, order]
                             if len(static_steps) else
                             static_verts[order]),
                "vnormal": static_vnormal[order],
                "uv": static_uv[order], "shader": static_shader[order],
                "smooth": static_smooth[order], "object": static_object[order],
                "tangent": static_tangent[order],
                "vcol": cat(tri_vcol, (3, 4))[order],
                "root_lo": sb.root_bound_lo, "root_hi": sb.root_bound_hi,
            })

        # build per-geometry BLAS (object space)
        geom_blas = {}  # id(geom) -> block index
        for gid, (geom, users) in instanced_geoms.items():
            tri_verts.clear(); tri_vnormal.clear(); tri_uv.clear()
            tri_verts_t1.clear(); tri_tangent.clear(); tri_vcol.clear()
            prim_shader.clear(); prim_smooth.clear(); prim_object.clear()
            append_mesh(geom, -1, None)
            gv = cat(tri_verts, (3, 3))
            lo, hi = gv.min(1), gv.max(1)
            gb = build(lo, hi, gv)
            order = gb.prim_order
            geom_blas[gid] = len(blocks)
            blocks.append({
                "source": order,
                "bounds": gb.bounds, "children": gb.children,
                "verts": gv[order],
                "vnormal": cat(tri_vnormal, (3, 3))[order],
                "uv": cat(tri_uv, (3, 2))[order],
                "tangent": cat(tri_tangent, (3,))[order],
                "vcol": cat(tri_vcol, (3, 4))[order],
                "shader": cat(prim_shader, (), np.int32)[order],
                "smooth": cat(prim_smooth, (), bool)[order],
                "object": cat(prim_object, (), np.int32)[order],
                "root_lo": gb.root_bound_lo, "root_hi": gb.root_bound_hi,
            })

        # ---- concatenate blocks with offsets ----
        # node order: [TLAS (if any)] [block0] [block1] ...
        # first compute prim bases and node bases (TLAS size known later)
        instance_rows = []  # (w2o 3x4, blas_block, object_idx, motion)
        obj_steps = 2       # object-motion steps (>=2 when multi-step)
        if has_instances:
            if blocks and "object" in blocks[0] and len(static_verts):
                instance_rows.append((tfm.identity(), 0, -1, None))
            # scene-wide object motion step count: every moving
            # instance's path is slerp-resampled onto the common grid
            # so the packed leaf rows share one static layout (ref:
            # motion-step references, bvh_build.cpp:89-130)
            obj_steps = max(
                [len(objects[oi].motion_transforms())
                 for _, users in instanced_geoms.values()
                 for oi in users if objects[oi].use_motion] + [obj_steps])
            for gid, (geom, users) in instanced_geoms.items():
                for oi in users:
                    obj = objects[oi]
                    motion = None
                    if obj.use_motion:
                        # decomposed object->world steps for in-
                        # traversal shutter interpolation
                        motion = tuple(tfm.resample_motion_decomps(
                            obj.motion_transforms(), obj_steps))
                    instance_rows.append(
                        (tfm.inverse(np.asarray(obj.transform, np.float32)),
                         geom_blas[gid], oi, motion))

        # TLAS over instance world bounds
        tlas = None
        if has_instances:
            ilo, ihi = [], []
            for w2o, bi, oi, motion in instance_rows:
                blo, bhi = blocks[bi]["root_lo"], blocks[bi]["root_hi"]
                corners = np.array([[x, y, z]
                                    for x in (blo[0], bhi[0])
                                    for y in (blo[1], bhi[1])
                                    for z in (blo[2], bhi[2])], np.float32)
                tfms = []
                if oi >= 0:
                    obj = objects[oi]
                    tfms.append(np.asarray(obj.transform, np.float32))
                    if obj.use_motion:
                        # shutter-union bounds over every motion step
                        tfms.extend(obj.motion_transforms())
                else:
                    tfms.append(tfm.identity())
                wcs = np.concatenate(
                    [tfm.transform_point(t, corners) for t in tfms])
                ilo.append(wcs.min(0))
                ihi.append(wcs.max(0))
            tlas = bvh_build.build_bvh(np.array(ilo), np.array(ihi),
                                       max_leaf_size=1)

        tlas_nodes = len(tlas.bounds) if tlas is not None else 0
        node_bases, prim_bases = [], []
        nb, pb = tlas_nodes, 0
        for blk in blocks:
            node_bases.append(nb)
            prim_bases.append(pb)
            nb += len(blk["bounds"])
            pb += len(blk["verts"])

        total_nodes = max(nb, 1)
        bvh_bounds = np.zeros((total_nodes, 12), np.float32)
        bvh_children = np.full((total_nodes, 2),
                               bvh_build.encode_leaf(0, 0), np.int32)
        all_verts, all_vnormal, all_uv = [], [], []
        all_shader, all_smooth, all_object = [], [], []
        all_tangent = []
        all_vcol = []

        def rebase_children(children, node_base, prim_base):
            out = children.copy()
            inner = out >= 0
            out[inner] += node_base
            leaves = ~inner
            v = -out[leaves] - 1
            start = (v >> 4) + prim_base
            count = v & 15
            out[leaves] = -(1 + (start << 4) + count)
            return out

        all_source = []
        src_base = 0
        for bi, blk in enumerate(blocks):
            b0 = node_bases[bi]
            bvh_bounds[b0:b0 + len(blk["bounds"])] = blk["bounds"]
            bvh_children[b0:b0 + len(blk["children"])] = rebase_children(
                blk["children"], b0, prim_bases[bi])
            # globally-unique ORIGINAL prim id per packed row — spatial
            # splits duplicate rows, and per-prim semantics (emissive
            # light entries) must see one physical prim, not its copies
            src = np.asarray(blk["source"], np.int64)
            all_source.append(src + src_base)
            src_base += int(src.max()) + 1 if len(src) else 0
            all_verts.append(blk["verts"])
            all_vnormal.append(blk["vnormal"])
            all_uv.append(blk["uv"])
            all_tangent.append(blk["tangent"])
            all_vcol.append(blk["vcol"])
            all_shader.append(blk["shader"])
            all_smooth.append(blk["smooth"])
            all_object.append(blk["object"])

        if tlas is not None:
            bvh_bounds[:tlas_nodes] = tlas.bounds
            tc = tlas.children.copy()
            inner = tc >= 0
            # TLAS inner children stay TLAS-local (base 0). Leaves encode
            # instance ids with flag bit 30.
            leaves = ~inner
            v = -tc[leaves] - 1
            start, count = v >> 4, v & 15
            inst_ids = np.where(count > 0, tlas.prim_order[
                np.minimum(start, max(len(tlas.prim_order) - 1, 0))], 0)
            tc[leaves] = np.where(
                count > 0,
                -(1 + (inst_ids.astype(np.int64) << 4) + 1 + (1 << 30)),
                bvh_build.encode_leaf(0, 0)).astype(np.int32)
            bvh_children[:tlas_nodes] = tc

        # traversal stack requirement, computed from the actual trees so
        # device-side overflow is impossible by construction (an entry
        # per far-child push, +1 instance-restore entry, +2 margin)
        blas_depths = [bvh_build.tree_depth(blk["children"])
                       for blk in blocks if len(blk["children"])]
        stack_need = max(blas_depths, default=1)
        if tlas is not None:
            stack_need += bvh_build.tree_depth(tlas.children) + 1
        packed_stack_depth = int(stack_need + 2)

        P = sum(len(v) for v in all_verts)
        packed = {
            "bvh_bounds": bvh_bounds,
            "bvh_children": bvh_children,
            "tri_verts": (np.concatenate(all_verts) if P else
                          np.zeros((0, 3, 3), np.float32)),
            "tri_vnormal": (np.concatenate(all_vnormal) if P else
                            np.zeros((0, 3, 3), np.float32)),
            "tri_uv": (np.concatenate(all_uv) if P else
                       np.zeros((0, 3, 2), np.float32)),
            "prim_tangent": (np.concatenate(all_tangent) if P else
                             np.zeros((0, 3), np.float32)),
            "prim_vcol": (np.concatenate(all_vcol) if P else
                          np.zeros((0, 3, 4), np.float32)),
            "prim_shader": (np.concatenate(all_shader) if P else
                            np.zeros(0, np.int32)),
            "prim_smooth": (np.concatenate(all_smooth) if P else
                            np.zeros(0, bool)),
            "prim_object_packed": (np.concatenate(all_object) if P else
                                   np.zeros(0, np.int32)),
            "__prim_source__": (np.concatenate(all_source) if P else
                                np.zeros(0, np.int64)),
        }

        # ---- object tables ----
        obj_tfm = np.tile(tfm.identity(), (nobj, 1, 1))
        obj_itfm = np.tile(tfm.identity(), (nobj, 1, 1))
        obj_itfm_gen = np.tile(tfm.identity(), (nobj, 1, 1))
        obj_color = np.zeros((nobj, 3), np.float32)
        obj_random = np.zeros(nobj, np.float32)
        obj_visibility = np.full(nobj, PATH_RAY_ALL_VISIBILITY, np.uint32)
        obj_flags = np.zeros(nobj, np.uint32)
        obj_blo = np.zeros((nobj, 3), np.float32)
        obj_bhi = np.ones((nobj, 3), np.float32)
        from raytracingproject_tpu.models.object import PATH_RAY_SHADOW
        for oi, obj in enumerate(objects):
            t = np.asarray(obj.transform, np.float32)
            inv = tfm.inverse(t)
            merged = oi in static_objs
            # packed-space transforms: identity for merged (world verts)
            if not merged and obj.use_motion:
                # shading transforms use the shutter-center transform
                # (hit-time-exact normals land with full motion
                # shading); the center is evaluated on the PIECEWISE
                # path so multi-step objects shade where they render
                import jax.numpy as _jnpm
                path = obj.motion_transforms()
                dec = [tfm.decompose(x) for x in path]
                s1 = len(dec) - 1
                tt = 0.5 * s1
                k = min(int(np.floor(tt)), s1 - 1)
                t = np.asarray(tfm.motion_interpolate(
                    _jnpm.asarray(dec[k]), _jnpm.asarray(dec[k + 1]),
                    tt - k))
                inv = tfm.inverse(t)
            obj_tfm[oi] = tfm.identity() if merged else t
            obj_itfm[oi] = tfm.identity() if merged else inv
            obj_itfm_gen[oi] = inv
            obj_color[oi] = np.asarray(obj.color, np.float32)
            obj_random[oi] = (obj.random_id & 0xFFFF) / 65535.0
            vis = np.uint32(obj.visibility)
            # volume-only boundaries never block shadow rays (ref: the
            # transparent-shadow fast path, kernel_shadow.h; full
            # transparent-shadow accumulation lands with the ladder)
            shaders = obj.geometry.used_shaders or [self.default_surface]
            if all(s.has_volume and s.graph.links.get(
                    (id(s.graph.output_node), "surface")) is None
                   for s in shaders):
                vis &= ~np.uint32(PATH_RAY_SHADOW)
            obj_visibility[oi] = vis
            obj_flags[oi] = np.uint32(obj.flags())
            lo, hi = obj.geometry.compute_bounds()
            obj_blo[oi], obj_bhi[oi] = lo, hi
        packed.update({
            "object_tfm": obj_tfm, "object_itfm": obj_itfm,
            "object_itfm_gen": obj_itfm_gen,
            "object_color": obj_color, "object_random": obj_random,
            "object_visibility": obj_visibility, "object_flags": obj_flags,
            "object_bounds_lo": obj_blo, "object_bounds_hi": obj_bhi,
        })

        # ---- instance tables ----
        if has_instances:
            packed["instance_w2o"] = np.stack(
                [r[0] for r in instance_rows]).astype(np.float32)
            packed["instance_blas_root"] = np.array(
                [node_bases[r[1]] for r in instance_rows], np.int32)
            packed["instance_object"] = np.array(
                [r[2] for r in instance_rows], np.int32)
            packed["__instance_motion__"] = [r[3] for r in instance_rows]
        else:
            packed["instance_w2o"] = np.zeros((1, 3, 4), np.float32)
            packed["instance_blas_root"] = np.zeros(1, np.int32)
            packed["instance_object"] = np.full(1, -1, np.int32)

        has_deform = bool(deform_seen) and not has_instances
        # deforming motion rides the dense path this round: the per-ray
        # time lerp is a (B, N) VPU op there (ops/intersect.py
        # _motion_components); gather-BVH bounds would also need motion
        # dilation, so force brute while deform motion is present
        use_brute = ((not has_instances) and P <= BRUTE_FORCE_MAX_PRIMS) \
            or has_deform
        packed["__use_brute__"] = use_brute
        packed["__has_instances__"] = has_instances
        packed["__has_deform_motion__"] = has_deform
        packed["__bvh_stack_depth__"] = packed_stack_depth
        packed["tri_verts_world"] = packed["tri_verts"]  # valid when static
        if has_deform and blocks:
            packed["tri_verts_world_t1"] = blocks[0]["verts_t1"]
            # full multi-step path (S-1, T, 3, 3) for the dense sweeps'
            # hat-weighted piecewise evaluation (_motion_components)
            packed["tri_verts_world_steps"] = blocks[0]["verts_steps"]
        else:
            packed["tri_verts_world_t1"] = packed["tri_verts_world"]
        packed["__deform_steps__"] = (deform_extra + 1 if has_deform
                                      else 1)
        packed["__obj_motion_steps__"] = obj_steps

        # single-fetch traversal tables (ops/intersect.py packed layout)
        from raytracingproject_tpu.ops import intersect as isect_mod
        nodes_packed, leaf_blocks = isect_mod.pack_traversal_tables(
            bvh_bounds, bvh_children, packed["tri_verts"],
            instance_w2o=packed["instance_w2o"],
            instance_blas_root=packed["instance_blas_root"],
            instance_object=packed["instance_object"],
            instance_motion=packed.pop("__instance_motion__", None))
        packed["bvh_nodes_packed"] = nodes_packed
        packed["bvh_leaf_blocks"] = leaf_blocks

        # ---- cluster traversal tables (the fast path for 1k-40k
        # prims; ops/cluster_walk_gpu.py, ops/cluster_intersect.py) ----
        has_motion_instances = any(r[3] is not None for r in instance_rows)
        # cluster rows carry ONE delta block per tri (2-step lerp);
        # multi-step deform paths are piecewise, so those scenes ride
        # the dense sweeps where _motion_components evaluates the hats
        multi_step_deform = has_deform and deform_extra > 1
        if (not has_motion_instances) and (not multi_step_deform) \
                and (has_instances or P >= CLUSTER_MIN_PRIMS):
            from raytracingproject_tpu.ops import cluster_intersect as ci
            from raytracingproject_tpu.bvh import clusters as cl_mod
            # small clusters cull finest; row width grows with cluster
            # size, so cap at 64 tris -> max ~40k prims on the cluster
            # path; bigger scenes take the packed BVH walk
            for ct_size in (16, 32, 64):
                block_cuts = [cl_mod.cut_clusters(blk["children"], ct_size)
                              for blk in blocks]
                if has_instances:
                    total_c = sum(len(block_cuts[r[1]])
                                  for r in instance_rows)
                else:
                    total_c = len(block_cuts[0]) if block_cuts else 0
                if total_c <= CLUSTER_MAX_SINGLE_LEVEL:
                    break
            else:
                block_cuts = None
            if block_cuts is not None and total_c > 0:
                def _cut_cluster_dicts(cuts):
                    cds = []
                    if has_instances:
                        for (w2o, bi, oi, _motion) in instance_rows:
                            blk = blocks[bi]
                            pb = prim_bases[bi]
                            o2w = (np.asarray(objects[oi].transform,
                                              np.float32)
                                   if oi >= 0 else tfm.identity())
                            for (s, c) in cuts[bi]:
                                verts = blk["verts"][s:s + c]
                                prim = pb + np.arange(s, s + c)
                                if oi >= 0:
                                    objv = np.full(c, oi, np.int32)
                                else:
                                    objv = blk["object"][s:s + c]
                                vis = obj_visibility[np.maximum(objv, 0)]
                                vlo = verts.reshape(-1, 3).min(0)
                                vhi = verts.reshape(-1, 3).max(0)
                                corners = np.array(
                                    [[x, y, z] for x in (vlo[0], vhi[0])
                                     for y in (vlo[1], vhi[1])
                                     for z in (vlo[2], vhi[2])],
                                    np.float32)
                                wc = tfm.transform_point(o2w, corners)
                                cds.append({
                                    "verts": verts, "prim": prim,
                                    "obj": objv,
                                    "vis": vis, "w2o": w2o,
                                    "lo": wc.min(0), "hi": wc.max(0)})
                    else:
                        tv = packed["tri_verts"]
                        tv1 = packed["tri_verts_world_t1"] if has_deform \
                            else None
                        po = packed["prim_object_packed"]
                        for (s, c) in cuts[0]:
                            verts = tv[s:s + c]
                            objv = po[s:s + c]
                            # deform motion: bounds cover both shutter
                            # steps; rows carry per-tri deltas lerped by
                            # ray time in the intersector
                            allv = verts.reshape(-1, 3) if tv1 is None \
                                else np.concatenate(
                                    [verts, tv1[s:s + c]]).reshape(-1, 3)
                            cds.append({
                                "verts": verts,
                                "verts_t1": (None if tv1 is None
                                             else tv1[s:s + c]),
                                "prim": np.arange(s, s + c),
                                "obj": objv,
                                "vis": obj_visibility[
                                    np.maximum(objv, 0)],
                                "w2o": None,
                                "lo": allv.min(0),
                                "hi": allv.max(0)})
                    return cds

                cb, ctab, ct_used, cmotion = \
                    ci.pack_cluster_table(_cut_cluster_dicts(block_cuts))
                packed["cluster_bounds"] = cb
                packed["cluster_table"] = ctab
                packed["__cluster_tris__"] = ct_used
                packed["__cluster_motion__"] = cmotion
                log.vlog(1, "cluster tables: %d clusters x %d tris "
                         "(row %d cols)", len(cb), ct_used, ctab.shape[1])
        # finalize kernel dispatch now that we know which fast paths
        # exist (crossovers set on the earlier accelerator, not measured
        # on the H100: cluster over dense from ~1k prims, dense over the
        # packed gather-walk at every size it can hold):
        if has_deform:
            # deform motion rides the cluster path when tables exist
            # (rows carry per-tri shutter deltas); dense lerp otherwise
            use_brute = ("cluster_bounds" not in packed
                         or P <= BRUTE_VS_CLUSTER_PRIMS)
        elif has_instances:
            use_brute = False          # world-baked tris don't exist
        elif "cluster_bounds" in packed:
            use_brute = P <= BRUTE_VS_CLUSTER_PRIMS
        else:
            use_brute = True
        packed["__use_brute__"] = use_brute

        # ---- wide lookup tables (ops/lookup.py layout contract) ----
        from raytracingproject_tpu.ops import lookup as lk
        pt = np.zeros((max(P, 1), lk.PT_COLS), np.float32)
        if P:
            pt[:, lk.PT_V0:lk.PT_V0 + 9] = packed["tri_verts"].reshape(P, 9)
            pt[:, lk.PT_VN:lk.PT_VN + 9] = packed["tri_vnormal"].reshape(P, 9)
            pt[:, lk.PT_UV:lk.PT_UV + 6] = packed["tri_uv"].reshape(P, 6)
            pt[:, lk.PT_SHADER] = packed["prim_shader"]
            pt[:, lk.PT_SMOOTH] = packed["prim_smooth"]
            pt[:, lk.PT_OBJECT] = packed["prim_object_packed"]
            pt[:, lk.PT_TANGENT:lk.PT_TANGENT + 3] = packed["prim_tangent"]
        # native curve segments: appended as prim rows (PT_CURVE layout,
        # ops/lookup.py) so shader_setup stays one gather; the dense
        # segment sweep reports prim ids curve_prim_base + i
        S_curves = sum(len(a) for a in curve_cols["p0"])
        if S_curves:
            cp0 = np.concatenate(curve_cols["p0"]).astype(np.float32)
            ce = np.concatenate(curve_cols["e"]).astype(np.float32)
            cr0 = np.concatenate(curve_cols["r0"]).astype(np.float32)
            cr1 = np.concatenate(curve_cols["r1"]).astype(np.float32)
            cvp0 = np.concatenate(curve_cols["vp0"]).astype(np.float32)
            cvp1 = np.concatenate(curve_cols["vp1"]).astype(np.float32)
            csh = np.concatenate(curve_cols["shader"]).astype(np.int32)
            cob = np.concatenate(curve_cols["object"]).astype(np.int32)
            ct = np.zeros((S_curves, lk.PT_COLS), np.float32)
            ct[:, lk.PT_V0:lk.PT_V0 + 3] = cp0
            ct[:, lk.PT_V0 + 3:lk.PT_V0 + 6] = ce
            ct[:, lk.PT_V0 + 6] = cr0
            ct[:, lk.PT_V0 + 7] = cr1
            ct[:, lk.PT_UV] = cvp0
            ct[:, lk.PT_UV + 1] = cvp1
            ct[:, lk.PT_SHADER] = csh
            ct[:, lk.PT_OBJECT] = cob
            tl = ce / np.maximum(
                np.linalg.norm(ce, axis=-1, keepdims=True), 1e-12)
            ct[:, lk.PT_TANGENT:lk.PT_TANGENT + 3] = tl
            ct[:, lk.PT_CURVE] = 1.0
            packed["__curve_prim_base__"] = pt.shape[0]
            pt = np.concatenate([pt, ct])
            packed["curve_p0"] = cp0
            packed["curve_e"] = ce
            packed["curve_r0"] = cr0
            packed["curve_r1"] = cr1
            packed["curve_object"] = cob
            log.vlog(1, "native hair: %d curve segments", S_curves)
            # oriented (unaligned) curve clusters replace the dense
            # all-segments sweep above the threshold (ref:
            # bvh/bvh_unaligned.cpp; ops/curve_clusters.py). The walk's
            # (C, N) entry table grows with the cluster count, so C is
            # capped at 512 (set on the earlier accelerator, not
            # measured on the H100)
            if S_curves >= CURVE_CLUSTER_MIN_SEGS:
                from raytracingproject_tpu.ops import (
                    curve_clusters as ccl)
                for kseg in (16, 32, 64):
                    if (S_curves + kseg - 1) // kseg <= 512:
                        break
                else:
                    kseg = None
                    log.vlog(1, "curve clusters SKIPPED: %d segments "
                             "exceed the 512x64 cluster cap; dense "
                             "sweep in effect", S_curves)
                if kseg is not None:
                    cvis = obj_visibility[np.maximum(cob, 0)]
                    packed["curve_cluster_table"] = \
                        ccl.build_curve_cluster_table(
                            cp0, ce, cr0, cr1, cob, cvis,
                            cluster_segs=kseg)
                    packed["__curve_cluster_segs__"] = kseg
                    log.vlog(1, "curve clusters: %d x %d segs",
                             len(packed["curve_cluster_table"]), kseg)
        packed["prim_table"] = pt

        ot = np.zeros((nobj, lk.OT_COLS), np.float32)
        ot[:, lk.OT_TFM:lk.OT_TFM + 12] = obj_tfm.reshape(nobj, 12)
        ot[:, lk.OT_ITFM:lk.OT_ITFM + 12] = obj_itfm.reshape(nobj, 12)
        ot[:, lk.OT_ITFM_GEN:lk.OT_ITFM_GEN + 12] = \
            obj_itfm_gen.reshape(nobj, 12)
        ot[:, lk.OT_COLOR:lk.OT_COLOR + 3] = obj_color
        ot[:, lk.OT_RANDOM] = obj_random
        ot[:, lk.OT_BOUNDS_LO:lk.OT_BOUNDS_LO + 3] = obj_blo
        ot[:, lk.OT_BOUNDS_HI:lk.OT_BOUNDS_HI + 3] = obj_bhi
        ot[:, lk.OT_VISIBILITY] = obj_visibility.astype(np.float32)
        ot[:, lk.OT_FLAGS] = obj_flags.astype(np.float32)
        # particle binding (ref: render/particles.cpp device_update +
        # KernelParticle rows; models/particles.py packs inline)
        for oi, obj in enumerate(objects):
            ps = getattr(obj, "particle_system", None)
            if ps is not None:
                ot[oi, lk.OT_PARTICLE:lk.OT_PARTICLE + 14] = \
                    ps.particle_row(getattr(obj, "particle_index", 0))
        packed["object_table"] = ot
        log.vlog(1, "packed scene: %d prims, %d nodes, %d objects, "
                 "%d instances, brute=%s", P, total_nodes, nobj,
                 len(instance_rows), use_brute)
        return packed

    def _shader_slot(self, mesh, local_idx):
        """Map a mesh-local shader index -> scene shader slot."""
        if mesh.used_shaders and 0 <= local_idx < len(mesh.used_shaders):
            sh = mesh.used_shaders[local_idx]
            if sh not in self.shaders:
                self.add_shader(sh)
                sh.slot = self.shaders.index(sh)
            return self.shaders.index(sh)
        return self.default_surface.slot if self.default_surface in self.shaders else 0

    # ------------------------------------------------------------------
    def _pack_lights(self, packed):
        """Flat emission distribution (ref: light.cpp:277)."""
        entries = []  # (type 0=lamp/1=tri, id, power)

        # emissive triangles (static prims only this round)
        prim_shader = packed["prim_shader"]
        prim_obj = packed["prim_object_packed"]
        tri_verts = packed["tri_verts"]
        P = len(prim_shader)
        prim_emission = np.zeros((P, 3), np.float32)
        emis_by_slot = {}
        for sh in self.shaders:
            est = estimate_constant_emission(sh)
            if est is not None and np.any(est > 0):
                emis_by_slot[sh.slot] = est
        # spatial splits duplicate packed rows per physical prim; one
        # light entry per SOURCE prim (canonical = first copy), so the
        # emission distribution counts each physical triangle once
        source = packed.get("__prim_source__")
        if source is None or len(source) != P:
            source = np.arange(P, dtype=np.int64)
        src_copies = {}
        for slot, est in emis_by_slot.items():
            mask = (prim_shader == slot) & (prim_obj >= 0)
            idxs = np.nonzero(mask)[0]
            prim_emission[idxs] = est
            seen = {}
            for pi in idxs:
                s = int(source[pi])
                if s in seen:
                    src_copies.setdefault(seen[s], []).append(int(pi))
                    continue
                seen[s] = int(pi)
                v = tri_verts[pi]
                area = 0.5 * np.linalg.norm(
                    np.cross(v[1] - v[0], v[2] - v[0]))
                lum = float(0.2126 * est[0] + 0.7152 * est[1]
                            + 0.0722 * est[2])
                entries.append((1, int(pi), max(lum * area * np.pi, 1e-12)))

        # lamps
        num_l = len(self.lights)
        lamp_arrays = {
            "lamp_type": np.zeros(max(num_l, 1), np.int32),
            "lamp_co": np.zeros((max(num_l, 1), 3), np.float32),
            "lamp_dir": np.zeros((max(num_l, 1), 3), np.float32),
            "lamp_size": np.zeros(max(num_l, 1), np.float32),
            "lamp_axisu": np.zeros((max(num_l, 1), 3), np.float32),
            "lamp_axisv": np.zeros((max(num_l, 1), 3), np.float32),
            "lamp_sizeu": np.ones(max(num_l, 1), np.float32),
            "lamp_sizev": np.ones(max(num_l, 1), np.float32),
            "lamp_strength": np.zeros((max(num_l, 1), 3), np.float32),
            "lamp_angle": np.zeros(max(num_l, 1), np.float32),
            "lamp_spot_angle": np.zeros(max(num_l, 1), np.float32),
            "lamp_spot_smooth": np.zeros(max(num_l, 1), np.float32),
            "lamp_pmf": np.zeros(max(num_l, 1), np.float32),
        }
        bg_entry = -1
        portal_rows = []
        for li, light in enumerate(self.lights):
            if bool(light.is_portal):
                # portals guide bg sampling, never emit
                # (ref: light.cpp skipping portals in the distribution)
                au = np.asarray(light.axisu, np.float32)
                av = np.asarray(light.axisv, np.float32)
                nrm = np.cross(au, av)
                area = float(np.linalg.norm(nrm))                     * float(light.sizeu) * float(light.sizev)
                nrm = nrm / max(np.linalg.norm(nrm), 1e-12)
                row = np.zeros(16, np.float32)
                row[0:3] = np.asarray(light.co, np.float32)
                row[3:6] = au
                row[6:9] = av
                row[9:12] = nrm
                row[12] = light.sizeu
                row[13] = light.sizev
                row[14] = max(area, 1e-12)
                portal_rows.append(row)
                continue
            lamp_arrays["lamp_type"][li] = light.get_enum_int("light_type")
            lamp_arrays["lamp_co"][li] = np.asarray(light.co, np.float32)
            d = np.asarray(light.dir, np.float32)
            lamp_arrays["lamp_dir"][li] = d / max(np.linalg.norm(d), 1e-12)
            lamp_arrays["lamp_size"][li] = light.size
            lamp_arrays["lamp_axisu"][li] = np.asarray(light.axisu, np.float32)
            lamp_arrays["lamp_axisv"][li] = np.asarray(light.axisv, np.float32)
            lamp_arrays["lamp_sizeu"][li] = light.sizeu
            lamp_arrays["lamp_sizev"][li] = light.sizev
            strength = np.asarray(light.strength, np.float32)
            if light.shader is not None:
                est = estimate_constant_emission(light.shader)
                if est is not None:
                    strength = est
            lamp_arrays["lamp_strength"][li] = strength
            lamp_arrays["lamp_angle"][li] = light.angle
            lamp_arrays["lamp_spot_angle"][li] = light.spot_angle
            lamp_arrays["lamp_spot_smooth"][li] = light.spot_smooth
            if light.get_enum_int("light_type") == 2:  # background
                bg_entry = len(entries)
            entries.append((0, li, light.total_power()))

        D = len(entries)
        if D:
            powers = np.array([e[2] for e in entries], np.float64)
            cdf = np.concatenate([[0.0], np.cumsum(powers / powers.sum())])
            cdf[-1] = 1.0
            pmfs = (powers / powers.sum()).astype(np.float32)
        else:
            cdf = np.array([0.0, 1.0])
            pmfs = np.zeros(0, np.float32)

        prim_light_pmf = np.zeros(max(P, 1), np.float32)
        bg_pmf = 0.0
        for ei, (etype, eid, _p) in enumerate(entries):
            if etype == 1:
                prim_light_pmf[eid] = pmfs[ei]
                # duplicated copies carry the canonical pmf so a
                # forward hit on ANY copy yields the same MIS pdf
                for cp in src_copies.get(eid, ()):
                    prim_light_pmf[cp] = pmfs[ei]
            elif ei == bg_entry:
                bg_pmf = float(pmfs[ei])
            else:
                lamp_arrays["lamp_pmf"][eid] = pmfs[ei]

        # background importance map (ref: light.cpp:530-700
        # device_update_background: equirect luminance -> marginal +
        # conditional CDFs). Built whenever a background light entry
        # exists and the bg shader is non-trivial.
        bg_map = None
        if bg_entry >= 0 and self.background.shader is not None:
            bg_map = self._build_background_map()
        if bg_map is None:
            out_bg = {
                "bg_marginal_cdf": np.array([0.0, 1.0], np.float32),
                "bg_conditional_cdf": np.zeros((1, 2), np.float32),
                "bg_pdf_map": np.zeros((1, 1), np.float32),
                "__bg_map_res__": (0, 0),
            }
        else:
            out_bg = bg_map

        # ---- hierarchical light tree (ops/light_tree.py) ----
        # Opt-in via integrator.use_light_tree; the flat CDF machinery
        # above stays (fallback + within-infinite-group pick). Finite
        # emitters (triangles, point/spot/area lamps) become tree
        # leaves; distant + background form the infinite group.
        lt_meta = None
        lt_out = {}
        if bool(getattr(self.integrator, "use_light_tree", False)) and D >= 2:
            lt_meta, lt_out = self._build_light_tree(
                packed, entries, lamp_arrays, tri_verts, prim_obj,
                src_copies, num_l)

        out = {
            "portal_data": (np.stack(portal_rows).astype(np.float32)
                            if portal_rows else
                            np.zeros((0, 16), np.float32)),
            "light_dist_cdf": cdf.astype(np.float32),
            "light_dist_type": np.array([e[0] for e in entries], np.int32),
            "light_dist_id": np.array([e[1] for e in entries], np.int32),
            "prim_light_pmf": prim_light_pmf,
            "prim_emission": (prim_emission if P else
                              np.zeros((1, 3), np.float32)),
            "bg_pmf": np.float32(bg_pmf),
        }
        out.update(lamp_arrays)
        out.update(out_bg)
        out.update(lt_out)
        out["__light_tree__"] = lt_meta

        # fill light columns of the packed prim table + build lamp table
        from raytracingproject_tpu.ops import lookup as lk
        if P:
            # curve-segment rows (appended past P) never emit
            packed["prim_table"][:P, lk.PT_EMISSION:lk.PT_EMISSION + 3] = \
                prim_emission[:P]
            packed["prim_table"][:P, lk.PT_LIGHT_PMF] = prim_light_pmf[:P]
        nl = len(lamp_arrays["lamp_type"])
        lt = np.zeros((nl, lk.LT_COLS), np.float32)
        lt[:, lk.LT_TYPE] = lamp_arrays["lamp_type"]
        lt[:, lk.LT_CO:lk.LT_CO + 3] = lamp_arrays["lamp_co"]
        lt[:, lk.LT_DIR:lk.LT_DIR + 3] = lamp_arrays["lamp_dir"]
        lt[:, lk.LT_SIZE] = lamp_arrays["lamp_size"]
        lt[:, lk.LT_AXISU:lk.LT_AXISU + 3] = lamp_arrays["lamp_axisu"]
        lt[:, lk.LT_AXISV:lk.LT_AXISV + 3] = lamp_arrays["lamp_axisv"]
        lt[:, lk.LT_SIZEU] = lamp_arrays["lamp_sizeu"]
        lt[:, lk.LT_SIZEV] = lamp_arrays["lamp_sizev"]
        lt[:, lk.LT_STRENGTH:lk.LT_STRENGTH + 3] = lamp_arrays["lamp_strength"]
        lt[:, lk.LT_ANGLE] = lamp_arrays["lamp_angle"]
        lt[:, lk.LT_SPOT_ANGLE] = lamp_arrays["lamp_spot_angle"]
        lt[:, lk.LT_SPOT_SMOOTH] = lamp_arrays["lamp_spot_smooth"]
        lt[:, lk.LT_PMF] = lamp_arrays["lamp_pmf"]
        # IES profiles: per-lamp resampled grid rows (ref: light.cpp
        # device_update_ies; util_ies.cpp), flag column = row index + 1
        from raytracingproject_tpu.utils import ies as ies_util
        ies_rows = []
        for li, light in enumerate(self.lights):
            txt = str(getattr(light, "ies", "") or "")
            if txt.strip():
                grid = ies_util.load_ies_grid(txt)
                lt[li, lk.LT_IES] = float(len(ies_rows) + 1)
                ies_rows.append(grid.reshape(-1))
        out["lamp_ies"] = (np.stack(ies_rows).astype(np.float32)
                           if ies_rows else
                           np.zeros((0, ies_util.IES_RES_H *
                                     ies_util.IES_RES_V), np.float32))
        out["lamp_table"] = lt
        # flat (D, 4) entry table: [type, id, pmf, pad]
        if D:
            out["light_entries"] = np.stack(
                [out["light_dist_type"].astype(np.float32),
                 out["light_dist_id"].astype(np.float32),
                 pmfs.astype(np.float32),
                 np.zeros(D, np.float32)], -1)
        else:
            out["light_entries"] = np.zeros((1, 4), np.float32)
        # HOST-side static per-entry kinds ("tri" or the lamp type int)
        # — lets sample_light prune unreachable light-type branches at
        # trace time (the all-triangle mesh-light scene skips the whole
        # lamp machinery; ~26% of cornell's chunk is NEE math,
        # artifacts/STAGE_r05.json)
        out["__light_kinds__"] = tuple(
            "tri" if int(e[0]) == 1
            else int(lamp_arrays["lamp_type"][int(e[1])])
            for e in entries)

        # per-ENTRY row snapshots: the NEE pick's three row fetches
        # (prim/object/lamp tables, indexed through erow) collapse to
        # D-row tables indexed by the entry index itself. D is tiny on
        # most scenes (1-2 emitters -> broadcast/select-chain fetches)
        # while prim_table can be >512 rows (a dynamic gather per NEE
        # per iteration — ops/lookup.py).
        # Rows are verbatim copies, so the fast path is bit-exact vs
        # the wide fetch (tests/test_light_entry_rows.py). Flat-CDF
        # pick only: the light-tree pick has no entry index.
        pt_full = packed.get("prim_table")
        ot_full = packed.get("object_table")
        # skipped when the light tree picks (no entry index at runtime
        # -> the fast path can never fire; shipping the rows would only
        # waste device memory) and when any row payload is non-finite
        # (the fetch is a one-hot dot: 0*inf = nan — ops/lookup.py).
        use_tree = bool(getattr(self.integrator, "use_light_tree",
                                False)) and D >= 2
        if D and D <= lk.ONEHOT_MAX_ROWS and not use_tree \
                and pt_full is not None and len(pt_full) \
                and ot_full is not None and len(ot_full):
            types = out["light_dist_type"]
            ids = out["light_dist_id"]
            p0 = np.maximum(np.where(types == 1, ids, 0), 0)
            le_prim = pt_full[np.minimum(p0, len(pt_full) - 1)]
            ob = np.maximum(
                le_prim[:, lk.PT_OBJECT].astype(np.int64), 0)
            le_obj = ot_full[np.minimum(ob, len(ot_full) - 1)]
            l0 = np.maximum(np.where(types == 1, 0, ids), 0)
            le_lamp = (lt[np.minimum(l0, len(lt) - 1)] if len(lt)
                       else np.zeros((D, lk.LT_COLS), np.float32))
            le_prim = le_prim.astype(np.float32)
            le_obj = le_obj.astype(np.float32)
            le_lamp = le_lamp.astype(np.float32)
            if np.isfinite(le_prim).all() and np.isfinite(le_obj).all() \
                    and np.isfinite(le_lamp).all():
                out["le_prim_rows"] = le_prim
                out["le_obj_rows"] = le_obj
                out["le_lamp_rows"] = le_lamp
        return out

    # ------------------------------------------------------------------
    def _build_light_tree(self, packed, entries, lamp_arrays, tri_verts,
                          prim_obj, src_copies, num_l):
        """Host-side light-tree build (ops/light_tree.py): leaf bounding
        cones per finite emitter, balanced Morton heap, infinite-group
        CDF. Writes the per-prim leaf slot into prim_table[PT_LT_LEAF]
        so BSDF-hit MIS can re-derive the P-aware pick pmf with zero
        extra gathers. Returns (meta, device-array dict)."""
        from raytracingproject_tpu.ops import light_tree as ltree
        from raytracingproject_tpu.ops import lookup as lk
        ot = packed.get("object_table")
        pt = packed.get("prim_table")
        if pt is not None:
            pt[:, lk.PT_LT_LEAF] = -1.0
        fin_rows, fin_entries, fin_src = [], [], []
        inf_entries, inf_powers, inf_is_bg = [], [], []
        for etype, eid, power in entries:
            if etype == 1:
                # emissive triangle: world-space bounds; double-sided
                # planar emitter => theta_o = theta_e = pi/2 (the pdf in
                # sample_light uses |cos|, so both hemispheres emit)
                v = tri_verts[eid].astype(np.float64)
                oi = int(prim_obj[eid])
                if ot is not None and 0 <= oi < len(ot):
                    m = ot[oi, lk.OT_TFM:lk.OT_TFM + 12].reshape(3, 4)
                    v = v @ m[:, :3].T + m[None, :, 3]
                nrm = np.cross(v[1] - v[0], v[2] - v[0])
                if np.linalg.norm(nrm) < 1e-20:
                    nrm = np.array([0.0, 0.0, 1.0])
                fin_rows.append(ltree.leaf_cluster(
                    v.min(0), v.max(0), nrm, np.pi / 2, np.pi / 2, power))
                fin_entries.append((1.0, float(eid), 0.0, 0.0))
                fin_src.append((1, int(eid)))
                continue
            li = int(eid)
            lt_type = int(lamp_arrays["lamp_type"][li])
            if lt_type in (1, 2):       # distant / background: no
                inf_entries.append((0.0, float(li), 0.0, 0.0))
                inf_powers.append(max(float(power), 1e-12))
                inf_is_bg.append(lt_type == 2)
                continue
            co = lamp_arrays["lamp_co"][li].astype(np.float64)
            size = float(lamp_arrays["lamp_size"][li])
            if lt_type == 3:            # area: rect bounds, one-sided
                au = (lamp_arrays["lamp_axisu"][li].astype(np.float64)
                      * 0.5 * float(lamp_arrays["lamp_sizeu"][li]))
                av = (lamp_arrays["lamp_axisv"][li].astype(np.float64)
                      * 0.5 * float(lamp_arrays["lamp_sizev"][li]))
                corners = np.stack([co + au + av, co + au - av,
                                    co - au + av, co - au - av])
                lo, hi = corners.min(0), corners.max(0)
                axis = np.cross(lamp_arrays["lamp_axisu"][li],
                                lamp_arrays["lamp_axisv"][li])
                if np.linalg.norm(axis) < 1e-20:
                    axis = np.array([0.0, 0.0, 1.0])
                th_o, th_e = 0.0, np.pi / 2
            elif lt_type == 4:          # spot: emission cone = spot cone
                lo, hi = co - size, co + size
                axis = lamp_arrays["lamp_dir"][li]
                th_o = 0.0
                th_e = min(max(
                    float(lamp_arrays["lamp_spot_angle"][li]) * 0.5,
                    1e-3), np.pi)
            else:                       # point: isotropic
                lo, hi = co - size, co + size
                axis, th_o, th_e = (0.0, 0.0, 1.0), np.pi, np.pi / 2
            fin_rows.append(ltree.leaf_cluster(lo, hi, axis, th_o, th_e,
                                               power))
            fin_entries.append((0.0, float(li), 0.0, 0.0))
            fin_src.append((0, li))
        if not fin_rows:
            return None, {}
        tree_arrays, depth, leaf_of = ltree.build_light_tree(
            np.stack(fin_rows), np.asarray(fin_entries, np.float32))
        inf_energy = float(np.sum(inf_powers)) if inf_powers else 0.0
        bg_inf_pmf = 0.0
        if inf_powers:
            ip = np.asarray(inf_powers, np.float64)
            ipmf = ip / ip.sum()
            icdf = np.concatenate([[0.0], np.cumsum(ipmf)])
            icdf[-1] = 1.0
            ient = np.asarray(inf_entries, np.float32)
            ient[:, 2] = ipmf.astype(np.float32)
            for k, isbg in enumerate(inf_is_bg):
                if isbg:
                    bg_inf_pmf = float(ipmf[k])
            tree_arrays["lt_inf_cdf"] = icdf.astype(np.float32)
            tree_arrays["lt_inf_entries"] = ient
        else:
            tree_arrays["lt_inf_cdf"] = np.array([0.0, 1.0], np.float32)
            tree_arrays["lt_inf_entries"] = np.zeros((1, 4), np.float32)
        lamp_leaf = [-1] * max(num_l, 1)
        for fi, (kind, idx) in enumerate(fin_src):
            slot = int(leaf_of[fi])
            if kind == 1:
                if pt is not None:
                    pt[idx, lk.PT_LT_LEAF] = float(slot)
                    # spatial-split copies carry the canonical leaf so a
                    # hit on ANY copy re-derives the same pick pmf
                    for cp in src_copies.get(idx, ()):
                        pt[cp, lk.PT_LT_LEAF] = float(slot)
            else:
                lamp_leaf[idx] = slot
        meta = {"depth": int(depth), "inf_energy": inf_energy,
                "bg_inf_pmf": bg_inf_pmf, "lamp_leaf": lamp_leaf}
        return meta, tree_arrays

    # ------------------------------------------------------------------
    def _estimate_volume_majorants(self):
        """Per-shader extinction majorants for delta tracking
        (ref: the heterogeneous volume step-size heuristics). Sampled on
        a coarse world grid over the shader's user objects x2 safety."""
        import numpy as _np
        out = _np.zeros(max(len(self.shaders), 1), _np.float32)
        het = [getattr(s, "has_heterogeneous_volume", False)
               for s in self.shaders]
        if not any(het):
            return out
        import jax.numpy as jnp
        from raytracingproject_tpu.ops.shade import ShaderData
        from raytracingproject_tpu.models.image import TextureStore
        tex_data, tex_sizes = self.image_manager.device_update()
        store = TextureStore(jnp.asarray(tex_data), tex_sizes)
        for slot, s in enumerate(self.shaders):
            if not het[slot]:
                if getattr(s, "has_volume", False):
                    out[slot] = 0.0
                continue
            los, his = [], []
            for obj in self.objects:
                if s in (obj.geometry.used_shaders or []):
                    lo, hi = obj.compute_bounds()
                    los.append(lo); his.append(hi)
            if not los:
                out[slot] = 1.0
                continue
            lo = _np.min(los, axis=0); hi = _np.max(his, axis=0)
            g = _np.linspace(0, 1, 6)
            gx, gy, gz = _np.meshgrid(g, g, g)
            P = lo + _np.stack([gx, gy, gz], -1).reshape(-1, 3) * (hi - lo)
            n = len(P)
            Pj = jnp.asarray(P.astype(_np.float32))
            ctx = ShaderData(
                P=Pj, N=Pj, Ng=Pj, Ns=Pj, I=Pj,
                uv=jnp.zeros((n, 2)), generated=Pj, P_object=Pj,
                time=jnp.zeros(n), ray_length=jnp.ones(n),
                ray_depth=jnp.zeros(n, jnp.int32),
                path_flag=jnp.zeros(n, jnp.uint32),
                prim=jnp.zeros(n, jnp.int32),
                shader=jnp.full(n, slot, jnp.int32),
                object_index=jnp.zeros(n, jnp.int32),
                object_color=jnp.zeros((n, 3)),
                object_location=jnp.zeros((n, 3)),
                object_random=jnp.zeros(n),
                backfacing=jnp.zeros(n, bool),
                textures=store, batch_shape=(n,))
            v = s.evaluate_volume(ctx)
            if v is None:
                continue
            out[slot] = float(_np.max(_np.asarray(v["sigma_t"]))) * 2.0                 + 1e-3
        return out

    def _build_background_map(self, width=256, height=128):
        """Evaluate the background shader on an equirect grid and build
        sampling CDFs (ref: light.cpp background importance map)."""
        import jax
        import jax.numpy as jnp
        from raytracingproject_tpu.ops import shade as shade_ops
        from raytracingproject_tpu.models.image import TextureStore
        tex_data, tex_sizes = self.image_manager.device_update()
        store = TextureStore(jnp.asarray(tex_data), tex_sizes)
        u = (np.arange(width) + 0.5) / width
        v = (np.arange(height) + 0.5) / height
        uu, vv = np.meshgrid(u, v)
        from raytracingproject_tpu.utils import math as um_np
        phi = np.pi * (1.0 - 2.0 * uu)
        theta = np.pi * (vv - 0.5)
        d = np.stack([np.cos(theta) * np.cos(phi),
                      np.cos(theta) * np.sin(phi),
                      np.sin(theta)], -1).reshape(-1, 3).astype(np.float32)
        slot = self.background.shader.slot
        rgb = np.asarray(jax.jit(lambda dd: shade_ops.eval_background(
            self.shaders, slot, dd, textures=store))(jnp.asarray(d)))
        lum = (0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1]
               + 0.0722 * rgb[:, 2]).reshape(height, width)
        if lum.max() <= 0 or lum.max() == lum.min():
            return None  # constant background: uniform sampling is exact
        sin_theta = np.maximum(np.cos(np.pi * (v - 0.5)), 1e-4)  # weight
        weighted = lum * sin_theta[:, None] + 1e-8
        cond = np.cumsum(weighted, axis=1)
        row_int = cond[:, -1].copy()
        cond = np.concatenate(
            [np.zeros((height, 1)), cond / row_int[:, None]], axis=1)
        marg = np.cumsum(row_int)
        total = marg[-1]
        marg = np.concatenate([[0.0], marg / total])
        # solid-angle pdf map: p(dir) = lum*H*W / (total * 2 pi^2 sin)
        pdf_map = (weighted * height * width
                   / (total * 2.0 * np.pi * np.pi * sin_theta[:, None]))
        return {"bg_marginal_cdf": marg.astype(np.float32),
                "bg_conditional_cdf": cond.astype(np.float32),
                "bg_pdf_map": pdf_map.astype(np.float32),
                "__bg_map_res__": (height, width)}

    def make_kernel_globals(self, device_put=True):
        """Assemble the kg dict for ops/integrator.py; uploads arrays."""
        import jax
        import jax.numpy as jnp
        assert self.dscene is not None, "call device_update() first"
        ds = self.dscene
        arrays = ds["arrays"]
        if device_put:
            arrays = {k: (jax.device_put(v) if isinstance(v, np.ndarray)
                          else v) for k, v in arrays.items()}
        lamp_types = [int(li.get_enum_int("light_type"))
                      for li in self.lights]
        num_area_lamps = lamp_types.count(3)
        tex = TextureStore(jnp.asarray(ds["tex_data"]), ds["tex_sizes"])
        # static camera matrix for VectorTransformNode's camera space
        # (ref: svm_vector_transform.h reads kernel_data.cam)
        tex.cam_to_world = np.asarray(ds["cam"]["cam_to_world"],
                                      np.float32)
        # mip pyramids (slot -> per-level slot ids) + the camera pixel
        # angle the auto-mip footprint estimate uses
        tex.mips = dict(getattr(self.image_manager, "mip_slots", {}))
        tex.pixel_angle = float(self.camera.fov) / max(
            int(self.camera.width), 1)
        # per-prim volume-boundary mask (prim order) for the cheap
        # two-min occlusion sweep (ops/intersect.py
        # intersect_brute_occlusion): boundary prims belong to shaders
        # with a volume closure
        from raytracingproject_tpu.ops import lookup as lk
        shv = np.array([bool(s.has_volume) for s in self.shaders]
                       or [False])
        pt_np = np.asarray(ds["arrays"]["prim_table"])
        pshader = np.clip(pt_np[:, lk.PT_SHADER].astype(np.int64), 0,
                          len(shv) - 1)
        prim_bnd = shv[pshader]
        arrays["prim_is_boundary"] = jnp.asarray(prim_bnd)
        return {
            "dscene": arrays,
            "cam": ds["cam"],
            "kint": ds["kint"],
            "filter_table": jnp.asarray(ds["filter_table"]),
            "shaders": self.shaders,
            "textures": tex,
            "background_shader": ds["background_shader"],
            "use_brute": ds["use_brute"],
            "cluster_tris": ds.get("cluster_tris", 0),
            "cluster_motion": ds.get("cluster_motion", False),
            "bvh_stack_depth": ds.get("bvh_stack_depth", 0),
            "volume_stack_depth": int(self.integrator.volume_stack_depth),
            "curve_prim_base": ds.get("curve_prim_base", 0),
            "curve_cluster_segs": ds.get("curve_cluster_segs", 0),
            # material-sorted shading (shade.eval_shaders_sorted):
            # profitable when many/large shader graphs would otherwise
            # each run a full masked wavefront pass
            # crossover set on the earlier accelerator (not measured on
            # the H100; tools/matsort_bench.py): sorted wins only above
            # ~15 shaders
            "sorted_shading": (
                self.integrator.get_enum_int("material_sort") == 1
                or (self.integrator.get_enum_int("material_sort") == 0
                    and len(self.shaders) >= 16
                    and sum(len(s.graph.nodes) for s in self.shaders)
                    >= 64)),
            "has_instances": ds.get("has_instances", False),
            "has_deform_motion": ds.get("has_deform_motion", False),
            "deform_steps": ds.get("deform_steps", 1),
            "obj_motion_steps": ds.get("obj_motion_steps", 2),
            "has_motion": any(o.use_motion for o in self.objects)
            or ds.get("has_deform_motion", False),
            "has_shadow_catcher": any(o.is_shadow_catcher
                                      for o in self.objects),
            "film_transparent": ds["film_transparent"],
            "num_area_lamps": num_area_lamps,
            "lamp_types": lamp_types,
            # hierarchical light-pick meta (static depths/energies;
            # device arrays live in dscene as lt_*) — None = flat CDF
            "light_tree": ds.get("light_tree"),
            # host-static per-entry light kinds for trace-time branch
            # pruning in sample_light (ops/light.py)
            "light_kinds": ds.get("light_kinds"),
            "bg_map_res": tuple(self.dscene["arrays"].pop(
                "__bg_map_res__", (0, 0))),
            "shader_has_volume": [bool(s.has_volume) for s in self.shaders],
            # shaders whose surfaces pass shadow rays with accumulated
            # transparency (ref: shader_bsdf_transparency +
            # SD_HAS_TRANSPARENT_SHADOW, kernel_shadow.h:142-454);
            # volume-only boundaries are excluded here because they are
            # already culled from shadow visibility at pack time
            "shader_shadow_transparent": [
                bool(s.has_transparent and s.use_transparent_shadow
                     and not (s.has_volume and s.graph.links.get(
                         (id(s.graph.output_node), "surface")) is None))
                for s in self.shaders],
            "shader_het_volume": [
                bool(getattr(s, "has_heterogeeous_volume", False)
                     or getattr(s, "has_heterogeneous_volume", False))
                for s in self.shaders],
            "shader_sigma_max": self._estimate_volume_majorants(),
            # per-shader volume NEE technique (0 distance, 1 equiangular,
            # 2 multiple-importance; ref: SHD_VOLUME_SAMPLING_* in
            # kernel_types.h, sampled at kernel_volume.h:297-319)
            "shader_vol_sampling": [
                s.get_enum_int("volume_sampling_method")
                if s.has_volume else 0
                for s in self.shaders],
            # bump mapping (displacement_method bump/both): shade-time
            # normal perturbation from the displacement graph
            "shader_bump": [bool(s.has_bump()) for s in self.shaders],
            # volume-only shaders: surface acts as a transparent boundary
            "shader_volume_only": [
                bool(s.has_volume
                     and s.graph.links.get((id(s.graph.output_node),
                                            "surface")) is None)
                for s in self.shaders],
            # scene-wide feature set -> static kernel pruning
            # (ref: DeviceRequestedFeatures, device/device.h:120)
            "features": {
                "has_glossy": any(s.has_glossy for s in self.shaders),
                "has_multiscatter": any(
                    getattr(s, "has_multiscatter", False)
                    for s in self.shaders),
                "has_refraction": any(s.has_refraction
                                      for s in self.shaders),
                # volume-only boundaries pass through as transparent
                "has_transparent": any(
                    s.has_transparent or (s.has_volume and s.graph.links.get(
                        (id(s.graph.output_node), "surface")) is None)
                    for s in self.shaders),
                "has_diffuse_roughness": any(s.has_diffuse_roughness
                                             for s in self.shaders),
                "has_volume": any(s.has_volume for s in self.shaders),
                "has_subsurface": any(getattr(s, "has_subsurface", False)
                                      for s in self.shaders),
                "has_heterogeneous": any(
                    getattr(s, "has_heterogeneous_volume", False)
                    for s in self.shaders),
                # equiangular/MIS volume NEE is compiled in only when a
                # volume shader asks for it (static pruning)
                "has_equiangular": any(
                    s.has_volume
                    and s.get_enum_int("volume_sampling_method") != 0
                    for s in self.shaders),
                "has_emission": any(s.has_surface_emission
                                    for s in self.shaders),
                "has_hair": any(getattr(s, "has_hair", False)
                                for s in self.shaders),
                "has_toon": any(getattr(s, "has_toon", False)
                                for s in self.shaders),
                "has_aniso": any(getattr(s, "has_aniso", False)
                                 for s in self.shaders),
                "has_classic_hair": any(
                    getattr(s, "has_classic_hair", False)
                    for s in self.shaders),
                "has_sheen": any(getattr(s, "has_sheen", False)
                                 for s in self.shaders),
                "has_ao_node": any(getattr(s, "has_ao_node", False)
                                   for s in self.shaders),
                "has_bevel_node": any(
                    getattr(s, "has_bevel_node", False)
                    for s in self.shaders),
                # static probe budgets (max over nodes; capped — each
                # AO sample is a shadow sweep, each bevel sample a full
                # closest-hit sweep per shading batch)
                "ao_node_distance": max(
                    [getattr(s, "ao_distance", 0.0)
                     for s in self.shaders] + [0.0]) or 1.0,
                "ao_node_samples": min(max(
                    [getattr(s, "ao_samples", 0)
                     for s in self.shaders] + [0]), 8) or 4,
                "ao_node_inside": any(getattr(s, "ao_inside", False)
                                      for s in self.shaders),
                "bevel_node_radius": max(
                    [getattr(s, "bevel_radius", 0.0)
                     for s in self.shaders] + [0.0]) or 0.05,
                "bevel_node_samples": min(max(
                    [getattr(s, "bevel_samples", 0)
                     for s in self.shaders] + [0]), 8) or 4,
                "has_bump": any(s.has_bump() for s in self.shaders),
                # BumpNode / NormalMapNode linked into BSDF normal
                # inputs: compile the custom_N substitution in
                "has_custom_normal": any(
                    getattr(s, "has_custom_normal", False)
                    for s in self.shaders),
            },
        }


def estimate_constant_emission(shader):
    """Constant-fold the emission reaching the output (round-1 light
    estimate; ref: Shader::estimate_emission semantics)."""
    g = shader.graph
    link = g.links.get((id(g.output_node), "surface"))
    if link is None:
        return None

    def walk(node, scale):
        if isinstance(node, (sn.EmissionNode, sn.BackgroundNode)):
            if (g.links.get((id(node), "color")) is None
                    and g.links.get((id(node), "strength")) is None):
                return (np.asarray(node.color, np.float32)
                        * float(node.strength) * scale)
            return np.ones(3, np.float32) * scale
        if isinstance(node, sn.PrincipledBsdfNode):
            if g.links.get((id(node), "emission_color")) is None:
                return (np.asarray(node.emission_color, np.float32)
                        * float(node.emission_strength) * scale)
            return None
        if isinstance(node, (sn.MixClosureNode, sn.AddClosureNode)):
            out = np.zeros(3, np.float32)
            fac = 0.5
            if isinstance(node, sn.MixClosureNode) \
                    and g.links.get((id(node), "fac")) is None:
                fac = float(np.clip(node.fac, 0.0, 1.0))
            for iname, sub_scale in (("closure1",
                                      (1.0 - fac) if isinstance(node, sn.MixClosureNode) else 1.0),
                                     ("closure2",
                                      fac if isinstance(node, sn.MixClosureNode) else 1.0)):
                l = g.links.get((id(node), iname))
                if l is not None:
                    sub = walk(l[0], scale * sub_scale)
                    if sub is not None:
                        out = out + sub
            return out
        return None

    return walk(link[0], 1.0)
