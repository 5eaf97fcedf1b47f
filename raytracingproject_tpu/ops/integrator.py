"""Wavefront path integrator (ref: kernel/kernel_path.h:509-695
kernel_path_integrate / kernel_path_trace; wavefront structure ref:
device/device_split_kernel.cpp + kernel/split/*).

One `path_trace_sample` call advances EVERY pixel's path for one sample:
camera ray generation -> [intersect -> lamp/background MIS emission ->
shade -> NEE + MIS -> bounce] x max_bounce -> film accumulate, all as
batched SoA ops under `lax.fori_loop`. Dead lanes are masked, not
compacted (compaction/sorting is an optimization layered on top in
parallel/; masked elementwise math is cheap for Cornell-class depth).

Static configuration (bounce limits, sampler pattern, brute-vs-BVH) is
Python-level so XLA specializes the kernel per scene feature set — the
analog of the reference's feature-pruned kernel compiles
(DeviceRequestedFeatures::get_build_options, device/device.h:228).
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import jax
import jax.numpy as jnp
import numpy as np

from raytracingproject_tpu.utils import math as um
from raytracingproject_tpu.utils import rng as rngu
from raytracingproject_tpu.ops import bsdf as bsdf_ops
from raytracingproject_tpu.ops import camera as cam_ops
from raytracingproject_tpu.ops import film as film_ops
from raytracingproject_tpu.ops import intersect as isect
from raytracingproject_tpu.ops import light as light_ops
from raytracingproject_tpu.ops import shade as shade_ops
from raytracingproject_tpu.models import object as ob

RAY_EPS = 1e-4


def _offset_eps(P, t):
    """Scale-aware ray-origin offset (ref: kernel ray_offset's
    magnitude-relative epsilon). An absolute 1e-4 is ~2 f32 ulps at
    coordinates ~500 (hit-point reconstruction error ~ t*eps_f32), so
    large scenes self-occluded their own shadow rays — measured -17%
    local NEE loss on Cornell's tall box before this fix."""
    scale = jnp.maximum(1.0, jnp.maximum(
        jnp.max(jnp.abs(P), axis=-1), jnp.minimum(t, 1e6)))
    return RAY_EPS * scale


def _merge_curve_hit(kg, hit, o, d, tmin, visibility):
    """Sweep native hair segments and merge into `hit` by min-t.

    Curves live OUTSIDE the BVH in their own dense SoA table (ref
    capability: kernel/geom/geom_curve_intersect.h; redesign:
    ops/intersect.py intersect_curves_ribbon docstring)."""
    ds = kg["dscene"]
    if "curve_p0" not in ds:
        return hit
    if _use_curve_clusters(kg):
        from raytracingproject_tpu.ops import curve_clusters as ccl
        return ccl.intersect_curve_clusters(
            ds["curve_cluster_table"], int(kg["curve_cluster_segs"]),
            int(kg["curve_prim_base"]), o, d, tmin, hit["t"],
            visibility, hit0=hit)
    return isect.intersect_curves_ribbon(
        ds["curve_p0"], ds["curve_e"], ds["curve_r0"], ds["curve_r1"],
        ds["curve_object"], int(kg["curve_prim_base"]), o, d, tmin,
        hit["t"], hit0=hit, visibility=visibility,
        object_visibility=ds["object_visibility"])


def _use_curve_clusters(kg):
    """Oriented curve-cluster walk (the unaligned-BVH analog,
    ops/curve_clusters.py) when the scene packed a table; the dense
    segment sweep is the small-scene/parity twin
    (kg["curve_clusters"]: True/False forces)."""
    ds = kg["dscene"]
    if "curve_cluster_table" not in ds \
            or int(kg.get("curve_cluster_segs", 0)) <= 0:
        return False
    mode = kg.get("curve_clusters", "auto")
    return True if mode == "auto" else bool(mode)


def _curve_any_hit(kg, o, d, tmin, tmax, vis):
    ds = kg["dscene"]
    if _use_curve_clusters(kg):
        from raytracingproject_tpu.ops import curve_clusters as ccl
        h = ccl.intersect_curve_clusters(
            ds["curve_cluster_table"], int(kg["curve_cluster_segs"]),
            int(kg["curve_prim_base"]), o, d, tmin, tmax, vis,
            shadow_any_hit=True)
        return h["prim"] >= 0
    return isect.curves_any_hit(
        ds["curve_p0"], ds["curve_e"], ds["curve_r0"],
        ds["curve_r1"], ds["curve_object"], o, d, tmin, tmax,
        visibility=vis, object_visibility=ds["object_visibility"])


def _scene_intersect(kg, o, d, tmin, tmax, visibility, shadow=False,
                     time=None):
    hit = _scene_intersect_tris(kg, o, d, tmin, tmax, visibility,
                                shadow=shadow, time=time)
    return _merge_curve_hit(kg, hit, o, d, tmin, visibility)


def _use_cluster_walk_gpu(kg):
    """The cluster walk kernel (ops/cluster_walk_gpu.py) on the GPU; the
    XLA shortlist (ops/cluster_intersect.py) elsewhere, and as the twin
    the kernel is tested against. kg["pallas_clusters"] = False keeps
    the shortlist on the GPU too (A/B runs); kg["pallas_interpret"]
    runs the kernel in interpret mode (CPU tests)."""
    if kg.get("pallas_interpret", False):
        return True
    if not kg.get("pallas_clusters", True):
        return False
    return jax.default_backend() == "gpu"


def _scene_intersect_tris(kg, o, d, tmin, tmax, visibility, shadow=False,
                          time=None):
    ds = kg["dscene"]
    if kg["use_brute"]:
        deform = kg.get("has_deform_motion") and time is not None
        return isect.intersect_brute(
            ds["tri_verts_world"], ds["prim_object_packed"], o, d, tmin, tmax,
            visibility=visibility, object_visibility=ds["object_visibility"],
            tri_verts_t1=ds.get("tri_verts_world_steps",
                                ds["tri_verts_world_t1"])
            if deform else None,
            time=time if deform else None)
    if "cluster_bounds" in ds and int(kg.get("cluster_tris", 0)) > 0:
        if _use_cluster_walk_gpu(kg):
            from raytracingproject_tpu.ops import cluster_walk_gpu as cwg
            return cwg.intersect_clusters_gpu(
                ds["cluster_bounds"], ds["cluster_table"],
                int(kg["cluster_tris"]), o, d, tmin, tmax,
                visibility=visibility, shadow_any_hit=shadow,
                has_instances=bool(kg.get("has_instances", False)),
                time=time, has_motion=bool(kg.get("cluster_motion", False)),
                interpret=bool(kg.get("pallas_interpret", False)))
        # cluster-shortlist traversal in plain XLA
        # (ops/cluster_intersect.py)
        from raytracingproject_tpu.ops import cluster_intersect as ci
        return ci.intersect_clusters(
            ds["cluster_bounds"], ds["cluster_table"],
            int(kg["cluster_tris"]), o, d, tmin, tmax,
            visibility=visibility, shadow_any_hit=shadow,
            has_instances=bool(kg.get("has_instances", False)),
            time=time, has_motion=bool(kg.get("cluster_motion", False)))
    if "bvh_nodes_packed" in ds:
        # single-fetch packed traversal (2 row fetches/iteration)
        return isect.intersect_bvh_packed(
            ds["bvh_nodes_packed"], ds["bvh_leaf_blocks"], o, d, tmin, tmax,
            has_instances=bool(kg.get("has_instances", False)),
            o_world=o, d_world=d,
            prim_object=ds["prim_object_packed"],
            visibility=visibility,
            object_visibility=ds["object_visibility"],
            shadow_any_hit=shadow, time=time,
            has_motion=bool(kg.get("has_motion", False)),
            stack_depth=int(kg.get("bvh_stack_depth", 0)),
            motion_steps=int(kg.get("obj_motion_steps", 2)))
    return isect.intersect_bvh(
        ds["bvh_bounds"], ds["bvh_children"], ds["tri_verts"],
        ds["prim_object_packed"], o, d, tmin, tmax,
        instance_w2o=ds.get("instance_w2o"),
        instance_blas_root=ds.get("instance_blas_root"),
        instance_object=ds.get("instance_object"),
        visibility=visibility, object_visibility=ds["object_visibility"],
        shadow_any_hit=shadow,
        stack_depth=int(kg.get("bvh_stack_depth", 0)))


def _shadow_blocked(kg, o, d, tmin, tmax, time=None):
    vis = jnp.full(o.shape[:1], ob.PATH_RAY_SHADOW, jnp.uint32)
    ds = kg["dscene"]
    if kg["use_brute"]:
        deform = kg.get("has_deform_motion") and time is not None
        blocked = isect.shadow_blocked_brute(
            ds["tri_verts_world"], ds["prim_object_packed"], o, d, tmin,
            tmax, visibility=vis,
            object_visibility=ds["object_visibility"],
            tri_verts_t1=ds.get("tri_verts_world_steps",
                                ds["tri_verts_world_t1"])
            if deform else None,
            time=time if deform else None)
        if "curve_p0" in ds:
            blocked = blocked | _curve_any_hit(kg, o, d, tmin, tmax, vis)
        return blocked
    hit = _scene_intersect(kg, o, d, tmin, tmax, vis, shadow=True,
                           time=time)
    return hit["prim"] >= 0


def _shadow_transmittance(kg, o, d, tmin, tmax, time=None):
    """(N, 3) light transmittance along shadow segments.

    Scenes without shadow-transparent shaders keep the cheap boolean
    any-hit. Otherwise: a bounded record-and-step loop — closest-hit,
    accumulate the hit shader's transparent-closure color, advance tmin
    past the hit — the wavefront analog of
    shadow_blocked_transparent_stepped (ref: kernel/kernel_shadow.h:
    142-454, dispatch :386); honors per-shader use_transparent_shadow.
    """
    from raytracingproject_tpu.ops import shade as shade_ops

    n = o.shape[0]
    if not any(kg.get("shader_shadow_transparent", ())):
        blocked = _shadow_blocked(kg, o, d, tmin, tmax, time=time)
        return jnp.where(blocked[:, None], 0.0, 1.0)

    ds = kg["dscene"]
    vis = jnp.full((n,), ob.PATH_RAY_SHADOW, jnp.uint32)
    is_st = jnp.asarray(np.array(kg["shader_shadow_transparent"], bool))
    max_hits = max(int(kg["kint"]["transparent_max_bounce"]), 1)

    trans = jnp.ones((n, 3), prec.FT)
    active = tmax > tmin
    t_lo = tmin
    for _ in range(max_hits):
        hit = _scene_intersect(kg, o, d, t_lo,
                               jnp.where(active, tmax, t_lo), vis,
                               shadow=False, time=time)
        found = active & (hit["prim"] >= 0)
        sd = shade_ops.shader_setup(ds, hit, o, d, time=time,
                                    path_flag=jnp.full(
                                        n, ob.PATH_RAY_SHADOW, jnp.uint32),
                                    textures=kg["textures"])
        shader = jnp.clip(sd.shader, 0, len(kg["shaders"]) - 1)
        st_hit = found & is_st[shader]
        opaque = found & ~st_hit
        trans = jnp.where(opaque[:, None], 0.0, trans)
        tp = shade_ops.eval_transparency(
            kg["shaders"], sd, shader, kg["shader_shadow_transparent"])
        trans = jnp.where(st_hit[:, None], trans * tp, trans)
        active = st_hit & jnp.any(trans > 1e-7, axis=-1)
        t_lo = jnp.where(active, hit["t"] * (1.0 + 1e-4) + RAY_EPS, t_lo)
    # hit budget exhausted: any remaining blocker makes the lane opaque
    # (the reference bails out to "blocked" the same way)
    still = _shadow_blocked(kg, o, d, t_lo,
                            jnp.where(active, tmax, t_lo), time=time)
    return jnp.where((active & still)[:, None], 0.0, trans)


def _clamp_contrib(contrib, clamp):
    """Per-sample firefly clamp (ref: kernel_accumulate.h
    path_radiance_clamp). `clamp` may be a python float (<= 0 disables)
    or a traced scalar."""
    if isinstance(clamp, float) and clamp <= 0.0:
        return contrib
    m = jnp.max(contrib, axis=-1)
    scale = jnp.where((jnp.asarray(clamp) > 0.0) & (m > clamp),
                      clamp / jnp.maximum(m, 1e-12), 1.0)
    return contrib * scale[..., None]


def make_path_kernel(kg, px, py, pixel_index):
    """Build the wavefront path kernel for a pixel set.

    Returns (start_paths, step): `start_paths(samples_u32)` creates a
    fresh per-lane path state (camera rays for each lane's sample);
    `step(state)` advances every lane one bounce. Both fixed-grid
    (path_trace_sample) and path-regeneration (render_samples_regen)
    drivers are built on these.
    """
    kint = kg["kint"]
    pattern = int(kint["sampling_pattern"])
    seed = jnp.uint32(kint["seed"])
    max_bounce = int(kint["max_bounce"])
    min_bounce = int(kint["min_bounce"])
    clamp_direct = float(kint["sample_clamp_direct"])
    clamp_indirect = float(kint["sample_clamp_indirect"])

    n = px.shape[0]
    rng_hash = rngu.pixel_rng_hash(pixel_index.astype(jnp.uint32), seed)

    def rng2_batch(dim_pairs, samples=None):
        """All of a stage's dimension pairs in ONE vectorized sampler
        call — (K, N) broadcast keeps the uint32 pipeline a single fused
        kernel instead of K dispatch-sized chunks. dim_pairs may be (K,)
        shared or (K, N) per-lane (path regeneration)."""
        dims = jnp.asarray(dim_pairs, jnp.uint32)
        if dims.ndim == 1:
            dims = dims[:, None]
        return rngu.path_rng_2d(rng_hash[None, :], samples[None, :],
                                dims, pattern,
                                num_samples=int(kint["aa_samples"]))

    ds = kg["dscene"]
    has_lights = int(ds["light_dist_type"].shape[0]) > 0
    bg_pmf = float(ds["bg_pmf"])
    # hierarchical many-light pick (ops/light_tree.py). The pick pmf
    # becomes a function of the receiving point, so the path state
    # threads P_mis — the exact point this bounce's NEE sampled from —
    # and every BSDF-hit MIS site re-derives the pmf there (twin walks
    # are bit-exact at equal P, keeping the weights summing to one).
    light_tree = kg.get("light_tree")
    if "light_tree" in kg.get("debug_ablate", ()):
        light_tree = None
    # DebugFlags analog (ref: util/util_debug.h): statically disable
    # pipeline stages for profiling/debugging via kg["debug_ablate"].
    ablate = kg.get("debug_ablate", ())
    if "nee" in ablate:
        has_lights = False
    features = kg.get("features") or {}
    has_catcher = bool(kg.get("has_shadow_catcher", False))
    has_volume = bool(features.get("has_volume", False)) \
        and "volume" not in ablate
    has_sss = bool(features.get("has_subsurface", False)) \
        and "sss" not in ablate
    has_het = has_volume and bool(features.get("has_heterogeneous", False))
    has_medium = has_volume or has_sss
    # equiangular / multiple-importance volume NEE (ref:
    # kernel_volume.h:297-319 equiangular sample, :978-1050 MIS combine)
    has_equiangular = has_volume \
        and bool(features.get("has_equiangular", False)) \
        and "equiangular" not in ablate
    # volume NEE: the shadow any-hit and the medium boundary
    # closest-hit interrogate the SAME segment — one dual-reduction
    # sweep (intersect_brute_occlusion) answers both on dense scenes.
    # Cluster and BVH scenes, and transparent shadows, take the
    # stepped loop.
    use_dual_shadow = has_volume \
        and not any(kg.get("shader_shadow_transparent", ())) \
        and bool(kg["use_brute"])

    aux_names = tuple(kg.get("aux_passes", ()))
    aov_names = tuple(n[4:] for n in aux_names if n.startswith("aov:"))
    light_passes = bool(kg.get("light_passes", False))
    LP_CATS = ("diffuse", "glossy", "transmission", "volume")

    def _vis_of_flag(flag):
        return jnp.where(
            flag & ob.PATH_RAY_CAMERA > 0,
            jnp.uint32(ob.PATH_RAY_CAMERA),
            jnp.where(flag & ob.PATH_RAY_DIFFUSE > 0,
                      jnp.uint32(ob.PATH_RAY_DIFFUSE),
                      jnp.where(flag & ob.PATH_RAY_TRANSMIT > 0,
                                jnp.uint32(ob.PATH_RAY_TRANSMIT),
                                jnp.uint32(ob.PATH_RAY_GLOSSY))))

    def start_paths(samples_u32, samples_cam=None):
        # samples_cam: branched-path mode pins the camera dims to the
        # AA sample while the path dims advance per branch
        # (ref: kernel_path_branched.h splitting structure)
        if samples_cam is None:
            samples_cam = samples_u32
        if kg.get("ray_override") is not None:
            # baking / custom primary rays (ref: kernel_bake.h — bake
            # shoots probe rays at the surface instead of camera rays)
            ro = kg["ray_override"]
            ray = {"o": ro["o"], "d": ro["d"],
                   "tmin": jnp.zeros((n,), prec.FT),
                   "tmax": ro.get("tmax", jnp.full((n,), 1e30, prec.FT)),
                   "time": jnp.zeros((n,), prec.FT)}
        else:
            # --- camera sample (ref: kernel_path.h:643-660) ---
            cu, cv = rng2_batch(
                [rngu.PRNG_FILTER, rngu.PRNG_LENS, rngu.PRNG_TIME],
                samples=samples_cam)
            (fu, lens_u, time_u), (fv, lens_v, _) = cu, cv
            ft = kg["filter_table"]
            raster_x = px.astype(prec.FT) + 0.5 \
                + film_ops.filter_table_lookup(ft, fu)
            raster_y = py.astype(prec.FT) + 0.5 \
                + film_ops.filter_table_lookup(ft, fv)
            ray = cam_ops.camera_sample_ray(kg["cam"], raster_x, raster_y,
                                            lens_u, lens_v, time_u)
        state = {
            "o": ray["o"], "d": ray["d"],
            "tmin": ray["tmin"], "tmax": ray["tmax"],
            "time": ray["time"],
            "throughput": jnp.ones((n, 3), prec.FT),
            "L": jnp.zeros((n, 3), prec.FT),
            "alpha": (jnp.zeros((n,), prec.FT) if kg["film_transparent"]
                      else jnp.ones((n,), prec.FT)),
            "alive": jnp.ones((n,), bool),
            "pdf_prev": jnp.zeros((n,), prec.FT),
            "singular_prev": jnp.ones((n,), bool),  # camera: weight 1
            "path_flag": jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32),
            "diffuse_depth": jnp.zeros((n,), jnp.int32),
            "glossy_depth": jnp.zeros((n,), jnp.int32),
            "transmission_depth": jnp.zeros((n,), jnp.int32),
            "transparent_depth": jnp.zeros((n,), jnp.int32),
            "bounce": jnp.zeros((n,), jnp.int32),
            "sample": samples_u32,
        }
        if light_tree is not None:
            # the previous bounce's NEE point (pdf_prev's twin); camera
            # rays never weight by it (singular_prev), zeros are fine
            state["P_mis"] = jnp.zeros((n, 3), prec.FT)
        if has_volume:
            # K-level volume stack (ref: kernel_types.h:1035
            # VolumeStack): vol_shader = current medium (top),
            # vol_rest = the K-1 enclosing media below it, so e.g.
            # liquid-in-glass-in-smoke resolves correctly
            vk = max(2, int(kg.get("volume_stack_depth", 4)))
            state["vol_shader"] = jnp.full((n,), -1, jnp.int32)
            state["vol_rest"] = jnp.full((n, vk - 1), -1, jnp.int32)
        if has_sss:
            # random-walk SSS medium (ref: kernel_subsurface.h random
            # walk; the walk reuses the volume scattering machinery)
            state["in_sss"] = jnp.zeros((n,), bool)
            state["sss_sigma_t"] = jnp.zeros((n, 3), prec.FT)
            state["sss_albedo"] = jnp.ones((n, 3), prec.FT)
        # aux pass collection (ref: kernel_passes.h; first-hit data)
        if aux_names:
            state["aux_normal"] = jnp.zeros((n, 3), prec.FT)
            state["aux_albedo"] = jnp.zeros((n, 3), prec.FT)
            state["aux_depth"] = jnp.zeros((n,), prec.FT)
            state["aux_object_id"] = jnp.full((n,), -1.0, prec.FT)
            state["aux_material_id"] = jnp.full((n,), -1.0, prec.FT)
            state["aux_emission"] = jnp.zeros((n, 3), prec.FT)
            state["aux_background"] = jnp.zeros((n, 3), prec.FT)
            if "ao" in aux_names:
                state["aux_ao"] = jnp.zeros((n, 3), prec.FT)
            for nm in aov_names:
                state["aux_aov:" + nm] = jnp.zeros((n, 3), prec.FT)
            if "mist" in aux_names:
                state["aux_mist"] = jnp.zeros((n,), prec.FT)
        if light_passes:
            # per-category radiance split (ref: kernel_accumulate.h
            # PathRadiance direct/indirect/color decomposition); the
            # category is fixed by the FIRST bounce's lobe.
            for cat in LP_CATS:
                state[f"aux_{cat}_direct"] = jnp.zeros((n, 3), prec.FT)
                state[f"aux_{cat}_indirect"] = jnp.zeros((n, 3), prec.FT)
            state["aux_diffuse_color"] = jnp.zeros((n, 3), prec.FT)
            state["aux_glossy_color"] = jnp.zeros((n, 3), prec.FT)
            state["aux_transmission_color"] = jnp.zeros((n, 3), prec.FT)
            state["first_cat"] = jnp.full((n,), -1, jnp.int32)
        return state

    def bounce_body(_i, st):
        alive = st["alive"]
        bounce = st["bounce"]          # (N,) per-lane path depth
        is_direct = bounce <= 1  # for clamping semantics
        clamp_val = jnp.where(is_direct, clamp_direct, clamp_indirect)

        # ---- per-bounce rng: all four dimension pairs in one call ----
        base = jnp.uint32(rngu.PRNG_BASE_NUM) \
            + bounce.astype(jnp.uint32) * jnp.uint32(rngu.PRNG_BOUNCE_NUM)
        bdims = base[None, :] + jnp.asarray(
            [rngu.PRNG_BSDF, rngu.PRNG_LIGHT, rngu.PRNG_TERMINATE,
             rngu.PRNG_PHASE], jnp.uint32)[:, None]
        bu4, bv4 = rng2_batch(bdims, samples=st["sample"])
        (bu, lu, rr_u, sel_u) = bu4
        (bv, lv, lobe_u, phase_v) = bv4
        if "lobe_strat" in st:
            # branched per-lobe/per-light forced split (ref:
            # kernel_path_branched.h per-closure + all-light sampling —
            # redesigned lockstep: the FIRST bounce's lobe-pick and
            # light-pick randoms are stratified over the branch index,
            # so every lobe/light whose CDF span exceeds 1/branch is
            # deterministically covered across the branch set; unbiased
            # because (k + u)/n remains uniform on [0,1)).
            k_strat, n_strat, k_place = st["lobe_strat"]
            first = bounce == 0
            lobe_u = jnp.where(first, (k_strat + lobe_u) / n_strat, lobe_u)
            # sel_u is the light-SELECTION random (sample_light CDF
            # inversion); lu/lv only place the sample on the chosen
            # light's surface
            sel_u = jnp.where(first, (k_strat + sel_u) / n_strat, sel_u)
            # lu carries the background portal-vs-map decision and the
            # on-light placement u: stratify it too, but on a per-AA-
            # sample Latin ROTATION of the branch index (k_place) — the
            # raw index would lock each light's placement bin to the
            # branch that picks it (sel_u and lu bins would pair
            # diagonally forever: a bin-0 light would never see
            # lu >= 1/n, so portals could never trigger for it).
            lu = jnp.where(first, (k_place + lu) / n_strat, lu)

        vis_ray = _vis_of_flag(st["path_flag"])
        hit = _scene_intersect(kg, st["o"], st["d"], st["tmin"],
                               st["tmax"], vis_ray, time=st["time"])
        found = hit["prim"] >= 0

        L = st["L"]
        throughput = st["throughput"]

        # ---- volume segment (ref: kernel_path.h do_volume; homogeneous
        # closed-form, kernel_volume.h; SSS walk rides the same machinery,
        # ref: kernel_subsurface.h random walk) ----
        scattered = jnp.zeros((n,), bool)
        if has_medium:
            from raytracingproject_tpu.ops import volume as vol_ops
            from raytracingproject_tpu.ops.shade import ShaderData
            in_vol = alive & (st["vol_shader"] >= 0) if has_volume \
                else jnp.zeros((n,), bool)
            vctx = None if not has_volume else ShaderData(
                P=st["o"], N=-st["d"], Ng=-st["d"], Ns=-st["d"], I=-st["d"],
                uv=jnp.zeros((n, 2)), generated=st["o"], P_object=st["o"],
                time=st["time"], ray_length=hit["t"],
                ray_depth=bounce,
                path_flag=st["path_flag"],
                prim=hit["prim"], shader=st.get("vol_shader"),
                object_index=hit["object"],
                object_color=jnp.zeros((n, 3)),
                object_location=jnp.zeros((n, 3)),
                object_random=jnp.zeros((n,)),
                backfacing=jnp.zeros((n,), bool),
                textures=kg["textures"], batch_shape=(n,))
            if has_volume:
                vc = vol_ops.eval_volume_closures(
                    kg["shaders"], kg["shader_has_volume"],
                    st["vol_shader"], n, vctx)
            else:
                from raytracingproject_tpu.ops import closures as _clv
                vc = _clv.empty_volume_closures((n,))
            if has_sss:
                # pure-scattering walk medium: sigma_s = sigma_t (the
                # entry already applied the subsurface color; albedo-1
                # walk conserves energy)
                in_sss = alive & st["in_sss"]
                vc = dict(vc)
                vc["sigma_t"] = jnp.where(in_sss[:, None],
                                          st["sss_sigma_t"], vc["sigma_t"])
                vc["sigma_s"] = jnp.where(in_sss[:, None],
                                          st["sss_sigma_t"]
                                          * st["sss_albedo"],
                                          vc["sigma_s"])
                vc["anisotropy"] = jnp.where(in_sss, 0.0, vc["anisotropy"])
                in_vol = in_vol | in_sss
            # rng: PHASE pair's v for distance; TERMINATE pair's v for
            # channel (volume lanes never do a surface lobe pick)
            ds_res = vol_ops.sample_distance_homogeneous(
                vc["sigma_t"], throughput, hit["t"], phase_v, lobe_u)
            # NOTE: no sigma_s gate — a "scatter" event in a purely
            # absorbing medium carries weight*sigma_s = 0 and terminates
            # the lane, which IS the absorption estimator
            scattered = in_vol & ds_res["scatter"]
            if has_het:
                # heterogeneous lanes: spectral delta tracking
                # (ref: kernel_volume.h heterogeneous; ops/volume.py)
                het_by_shader = jnp.asarray(
                    np.array(kg["shader_het_volume"], bool))
                smax_by_shader = jnp.asarray(
                    np.array(kg["shader_sigma_max"], np.float32))
                safe_vs = jnp.clip(st.get("vol_shader"), 0,
                                   len(kg["shaders"]) - 1)
                het_lane = in_vol & het_by_shader[safe_vs]
                smax = smax_by_shader[safe_vs]

                def _eval_sigma(Pw):
                    from raytracingproject_tpu.ops.shade import \
                        ShaderData as _SD
                    c2 = _SD(
                        P=Pw, N=-st["d"], Ng=-st["d"], Ns=-st["d"],
                        I=-st["d"], uv=jnp.zeros((n, 2)), generated=Pw,
                        P_object=Pw, time=st["time"], ray_length=hit["t"],
                        ray_depth=bounce, path_flag=st["path_flag"],
                        prim=hit["prim"], shader=st.get("vol_shader"),
                        object_index=hit["object"],
                        object_color=jnp.zeros((n, 3)),
                        object_location=jnp.zeros((n, 3)),
                        object_random=jnp.zeros((n,)),
                        backfacing=jnp.zeros((n,), bool),
                        textures=kg["textures"], batch_shape=(n,))
                    vcp = vol_ops.eval_volume_closures(
                        kg["shaders"], kg["shader_has_volume"],
                        st.get("vol_shader"), n, c2)
                    return vcp["sigma_t"], vcp["sigma_s"]

                lane_seed = rngu.hash_pcg3d(
                    pixel_index.astype(jnp.uint32), st["sample"],
                    bounce.astype(jnp.uint32))
                # step budget honors the integrator's step-rate knob
                # (delta tracking has no step SIZE; the rate scales the
                # per-dispatch collision budget instead)
                steps = min(max(int(int(kint["volume_max_steps"])
                                    * float(kint["volume_step_rate"])), 4),
                            32)
                wres = vol_ops.woodcock_sample(
                    _eval_sigma, st["o"], st["d"], hit["t"],
                    jnp.where(het_lane, smax, 1e-12), lane_seed,
                    steps=steps)
                scattered = jnp.where(het_lane, wres["scatter"] & in_vol,
                                      scattered)
                ds_res = dict(ds_res)
                ds_res["t_scatter"] = jnp.where(het_lane, wres["t"],
                                                ds_res["t_scatter"])

            seg_t = jnp.where(scattered, ds_res["t_scatter"], hit["t"])
            # volume emission along the traversed segment
            L = jnp.where(in_vol[:, None],
                          L + throughput * vol_ops.emission_integral(
                              vc["v_emission"], vc["sigma_t"], seg_t), L)
            w_seg = jnp.where(
                scattered[:, None],
                ds_res["weight_scatter"] * vc["sigma_s"],
                ds_res["weight_pass"])
            if has_het:
                # delta-tracking weight already folds albedo + nulls
                w_seg = jnp.where(het_lane[:, None], wres["weight"], w_seg)
            throughput = jnp.where(in_vol[:, None], throughput * w_seg,
                                   throughput)
            P_scatter = st["o"] + st["d"] * ds_res["t_scatter"][:, None]
            vol_g = vc["anisotropy"]

        # ---- virtual lamp (area light) emission with MIS ----
        if kg["num_area_lamps"] > 0:
            def lamp_accum(li, emission, pdf_lamp, t_lamp, mask):
                nonlocal L
                m = mask & alive & (t_lamp < hit["t"])
                w = jnp.where(st["singular_prev"], 1.0,
                              um.power_heuristic(st["pdf_prev"], pdf_lamp))
                contrib = throughput * emission * w[:, None]
                contrib = _clamp_contrib(contrib, clamp_indirect)
                L = jnp.where(m[:, None], L + contrib, L)
            light_ops.lamp_hits(ds, kg["lamp_types"], st["o"], st["d"],
                                st["tmax"], lamp_accum, tree=light_tree,
                                P_mis=st.get("P_mis"))

        # ---- background (ref: indirect_background) ----
        miss = alive & ~found & ~scattered
        bg = shade_ops.eval_background(
            kg["shaders"], kg["background_shader"], st["d"],
            textures=kg["textures"], path_flag=st["path_flag"])
        if bg_pmf > 0.0:
            # NEE's background strategy pdf at the escaped direction:
            # importance map, mixed 50/50 with portal-rect sampling when
            # portals exist (must match sample_light's mixture exactly
            # for the MIS weights to sum to 1)
            if light_tree is not None:
                from raytracingproject_tpu.ops import light_tree as ltree
                pick_bg = ltree.bg_pick_pmf(ds, light_tree, st["P_mis"])
            else:
                pick_bg = bg_pmf
            if int(ds["portal_data"].shape[0]):
                pdf_bg = pick_bg * (
                    0.5 * light_ops.bg_map_pdf(ds, st["d"])
                    + 0.5 * light_ops.portal_pdf(ds, st["o"], st["d"]))
            else:
                pdf_bg = pick_bg * light_ops.bg_map_pdf(ds, st["d"])
            w_bg = jnp.where(st["singular_prev"], 1.0,
                             um.power_heuristic(st["pdf_prev"], pdf_bg))
        else:
            w_bg = jnp.ones((n,), prec.FT)
        contrib = _clamp_contrib(throughput * bg * w_bg[:, None], clamp_val)
        L = jnp.where(miss[:, None], L + contrib, L)
        # transparent film: any surface hit makes the pixel opaque;
        # opaque film: alpha is 1 everywhere (set at init).
        alpha = jnp.maximum(st["alpha"],
                            (alive & (found | scattered)).astype(prec.FT)) \
            if kg["film_transparent"] else st["alpha"]
        alive = alive & (found | scattered)
        on_surface = alive & ~scattered

        # ---- shading setup + closures ----
        sd = shade_ops.shader_setup(
            ds, hit, st["o"], st["d"], time=st["time"],
            ray_depth=bounce,
            path_flag=st["path_flag"], textures=kg["textures"])

        # ---- shade-time probe rays for AmbientOcclusionNode /
        # BevelNode (ref: nodes.h AmbientOcclusionNode + BevelNode,
        # kernel svm_ao/svm_bevel). Computed ONCE per shading batch and
        # handed to the nodes through sd — the wavefront analog of the
        # reference's in-shader probe loops. All K probes ride one
        # flattened (K*N)-lane sweep instead of K dispatches. ----
        if bool(features.get("has_ao_node", False)) \
                and "shade" not in ablate:
            K = int(features.get("ao_node_samples", 4))
            ao_dist = float(features.get("ao_node_distance", 1.0))
            n_ao = -sd.N if features.get("ao_node_inside") else sd.N
            us, vs = rng2_batch(
                [jnp.uint32(100_000 + bounce * 64 + k)
                 for k in range(K)], samples=st["sample"])
            d_k, _ = um.sample_cos_hemisphere(
                jnp.broadcast_to(n_ao[None], (K, n, 3)), us, vs)
            eps = _offset_eps(sd.P, sd.ray_length)
            off = jnp.where(um.dot(d_k, sd.Ng[None])[..., None] > 0,
                            sd.Ng[None], -sd.Ng[None]) \
                * eps[None, :, None]
            blocked = _shadow_blocked(
                kg, (sd.P[None] + off).reshape(-1, 3),
                d_k.reshape(-1, 3),
                jnp.full((K * n,), 1e-5, prec.FT),
                jnp.full((K * n,), min(ao_dist, 1e30), prec.FT),
                time=jnp.broadcast_to(st["time"][None],
                                      (K, n)).reshape(-1)
                if st["time"] is not None else None)
            sd.ao = 1.0 - jnp.mean(
                blocked.reshape(K, n).astype(prec.FT), axis=0)
        if bool(features.get("has_bevel_node", False)) \
                and "shade" not in ablate:
            # ref: svm/svm_bevel.h svm_bevel — BSSRDF-style disk
            # probes with a RANDOM axis pick among {Ng, T, B}
            # (0.5/0.25/0.25) and 3-axis MIS. The tangent-axis probes
            # are what see the adjacent face of a CONVEX edge (a probe
            # along -N is parallel to it and can never hit). Closest
            # hit stands in for the reference's LOCAL_MAX_HITS
            # multi-hit list; all-object instead of same-object.
            K = int(features.get("bevel_node_samples", 4))
            r_bev = float(features.get("bevel_node_radius", 0.05))
            us, vs = rng2_batch(
                [jnp.uint32(200_000 + bounce * 64 + k)
                 for k in range(K)], samples=st["sample"])
            ng = sd.Ng
            t1, b1 = um.make_orthonormals(ng)
            # per-lane axis pick from the u random (ref lines 67-92)
            pick_n = us < 0.5
            pick_t = (us >= 0.5) & (us < 0.75)
            disk_u = jnp.where(pick_n, us * 2.0,
                               jnp.where(pick_t, (us - 0.5) * 4.0,
                                         (us - 0.75) * 4.0))

            def _sel(v_n, v_t, v_b):
                return jnp.where(pick_n[..., None], v_n,
                                 jnp.where(pick_t[..., None], v_t, v_b))
            axes = (jnp.broadcast_to(ng[None], (K, n, 3)),
                    jnp.broadcast_to(t1[None], (K, n, 3)),
                    jnp.broadcast_to(b1[None], (K, n, 3)))
            disk_N = _sel(axes[0], axes[1], axes[2])
            disk_T = _sel(axes[1], axes[0], axes[1])
            disk_B = _sel(axes[2], axes[2], axes[0])
            pp_n = jnp.where(pick_n, 0.5, 0.25)
            pp_t = jnp.where(pick_t, 0.5, 0.25)
            pp_b = jnp.where(pick_n | pick_t, 0.25, 0.5)
            # cubic-falloff radius sample (ref bssrdf_cubic_sample):
            # invert the quintic CDF 10x^2-20x^3+15x^4-4x^5 by Newton
            x = jnp.full_like(vs, 0.25)
            for _ in range(8):
                x2, nx = x * x, 1.0 - x
                f = 10.0 * x2 - 20.0 * x2 * x + 15.0 * x2 * x2 \
                    - 4.0 * x2 * x2 * x - vs
                fp = 20.0 * x * nx * nx * nx
                x = jnp.clip(x - f / jnp.maximum(fp, 1e-6), 0.0, 1.0)
            disk_r = r_bev * x                               # (K, n)
            disk_h = jnp.sqrt(jnp.maximum(
                r_bev * r_bev - disk_r * disk_r, 0.0))
            phi = um.M_2PI * disk_u
            o_b = (sd.P[None] + disk_N * disk_h[..., None]
                   + disk_T * (disk_r * jnp.cos(phi))[..., None]
                   + disk_B * (disk_r * jnp.sin(phi))[..., None]) \
                .reshape(-1, 3)
            d_b = (-disk_N).reshape(-1, 3)
            t_b = jnp.broadcast_to(st["time"][None],
                                   (K, n)).reshape(-1) \
                if st["time"] is not None else None
            hit_b = _scene_intersect(
                kg, o_b, d_b, jnp.zeros((K * n,), prec.FT),
                (2.0 * disk_h).reshape(-1),
                jnp.full((K * n,), ob.PATH_RAY_DIFFUSE, jnp.uint32),
                time=t_b)
            sd_b = shade_ops.shader_setup(
                ds, hit_b, o_b, d_b, time=t_b,
                path_flag=jnp.full((K * n,), ob.PATH_RAY_DIFFUSE,
                                   jnp.uint32),
                textures=kg["textures"])
            hit_ng = sd_b.Ng.reshape(K, n, 3)
            # 3-axis MIS (power heuristic, ref lines 169-180)
            pdf_n = pp_n * jnp.abs(um.dot(disk_N, hit_ng))
            pdf_t = pp_t * jnp.abs(um.dot(disk_T, hit_ng))
            pdf_b = pp_b * jnp.abs(um.dot(disk_B, hit_ng))
            w = pdf_n / jnp.maximum(
                pdf_n * pdf_n + pdf_t * pdf_t + pdf_b * pdf_b, 1e-20)
            # reweight sampled disk radius -> real distance to hit
            # (ref bssrdf_cubic_pdf: 10 (R-r)^3 / (pi R^5))
            P_hit = (o_b + d_b * hit_b["t"][:, None]).reshape(K, n, 3)
            r_real = um.length(P_hit - sd.P[None])

            def _cubic(r):
                f = jnp.maximum(r_bev - r, 0.0)
                return 10.0 * f * f * f / (um.M_PI * r_bev ** 5)
            w = w * _cubic(r_real) / jnp.maximum(_cubic(disk_r), 1e-20)
            valid = (hit_b["prim"].reshape(K, n) >= 0)
            w = jnp.where(valid, w, 0.0)
            sum_N = jnp.sum(w[..., None] * sd_b.N.reshape(K, n, 3),
                            axis=0)
            bev = um.safe_normalize(sum_N)
            sd.bevel_N = jnp.where(
                um.dot(bev, bev)[..., None] < 0.5, sd.N, bev)

        if bool(features.get("has_bump", False)) and "bump" not in ablate:
            # bump mapping perturbs N BEFORE closure eval so fresnel/
            # layer-weight nodes see the bumped frame (ref: ShaderGraph
            # bump duplication + svm_node_set_bump)
            sd.N = shade_ops.eval_bump_normals(
                kg["shaders"], sd, sd.shader, kg["shader_bump"])
        if "shade" in ablate:
            from raytracingproject_tpu.ops import closures as _cl
            closures = _cl.empty_closures((n,))
            closures["diffuse"] = jnp.full((n, 3), 0.8)
            aovs = {}
        else:
            if aov_names:
                closures, aovs = shade_ops.eval_shaders(
                    kg["shaders"], sd, sd.shader, aov_names=aov_names)
            elif kg.get("sorted_shading"):
                # material-sorted dispatch (ref: kernel_shader_sort.h)
                closures = shade_ops.eval_shaders_sorted(
                    kg["shaders"], sd, sd.shader)
                aovs = {}
            else:
                closures = shade_ops.eval_shaders(
                    kg["shaders"], sd, sd.shader)
                aovs = {}
        if has_volume:
            # volume-only materials: boundary surfaces pass straight
            # through (ref: volume boundaries are transparent hits)
            vol_only = jnp.asarray(
                np.array(kg["shader_volume_only"], np.float32))[
                    jnp.clip(sd.shader, 0, len(kg["shaders"]) - 1)]
            closures["transparent"] = closures["transparent"] \
                + vol_only[:, None]
        if has_sss:
            # SSS walk EXIT: any surface hit while inside ends the walk
            # as a unit diffuse transmission on the outside of the
            # boundary (ref: random-walk exit, kernel_subsurface.h)
            sss_exit = on_surface & st["in_sss"]
            from raytracingproject_tpu.ops import closures as _cls
            for k in _cls.CLOSURE_VEC_KEYS:
                if k == "subsurface_radius":
                    continue
                base_v = jnp.ones((n, 3), prec.FT) if k == "diffuse" \
                    else jnp.zeros((n, 3), prec.FT)
                closures[k] = jnp.where(sss_exit[:, None], base_v,
                                        closures[k])
            closures["diffuse_roughness"] = jnp.where(
                sss_exit, 0.0, closures["diffuse_roughness"])
            # the outside of the boundary is the -N side (ray arrives
            # from within): flip the shading frame for exit lanes
            sd.N = jnp.where(sss_exit[:, None], -sd.N, sd.N)
            sd.Ng = jnp.where(sss_exit[:, None], -sd.Ng, sd.Ng)

        # ---- custom shading normal (BumpNode / NormalMapNode linked
        # into a BSDF normal input, recorded as closures["custom_N"]):
        # substitutes for sd.N in BSDF eval/sample ONLY — ray offsets
        # and MIS geometry stay on the true frame (ref: per-closure N
        # in ShaderClosure; compiled in only when a scene shader links
        # one, like every other feature flag) ----
        N_bsdf = sd.N
        if kg.get("features", {}).get("has_custom_normal"):
            cN = closures["custom_N"]
            use_cn = um.dot(cN, cN) > 1e-12
            cNn = um.safe_normalize(cN)
            d_ng = um.dot(cNn, sd.Ng)
            cNn = jnp.where(
                (d_ng < 0.0)[:, None],
                um.safe_normalize(cNn + sd.Ng * (1e-3 - 2.0 * d_ng)[:, None]),
                cNn)
            N_bsdf = jnp.where(use_cn[:, None], cNn, sd.N)

        # ---- AO pass (ref: kernel_path.h kernel_path_ao): one cosine
        # hemisphere occlusion probe at the camera hit ----
        if aux_names and "ao" in aux_names:
            ao_u, ao_v = rng2_batch(
                [jnp.uint32(rngu.PRNG_BASE_NUM - 1)],
                samples=st["sample"])
            ao_dir, _pdf_ao = um.sample_cos_hemisphere(
                sd.N, ao_u[0], ao_v[0])
            ao_dist = float(kint["ao_distance"])
            ao_off = jnp.where(um.dot(ao_dir, sd.Ng)[:, None] > 0,
                               sd.Ng, -sd.Ng) \
                * _offset_eps(sd.P, sd.ray_length)[:, None]
            ao_blocked = _shadow_blocked(
                kg, sd.P + ao_off, ao_dir,
                jnp.full((n,), 1e-5, prec.FT),
                jnp.full((n,), min(ao_dist, 1e30), prec.FT),
                time=st["time"])
            ao_first = on_surface & (bounce == 0)
            st = dict(st)
            st["aux_ao"] = jnp.where(
                ao_first[:, None],
                jnp.where(ao_blocked, 0.0,
                          float(kint["ao_factor"]))[:, None]
                * jnp.ones(3),
                st["aux_ao"])

        # ---- aux passes: first camera-hit data ----
        if aux_names:
            first = (bounce == 0)
            fh = on_surface & first
            st = dict(st)
            st["aux_normal"] = jnp.where(fh[:, None], sd.N, st["aux_normal"])
            st["aux_albedo"] = jnp.where(
                fh[:, None], closures["diffuse"] + closures["glossy"]
                + closures["subsurface"], st["aux_albedo"])
            st["aux_depth"] = jnp.where(fh, hit["t"], st["aux_depth"])
            st["aux_object_id"] = jnp.where(
                fh, hit["object"].astype(prec.FT), st["aux_object_id"])
            st["aux_material_id"] = jnp.where(
                fh, sd.shader.astype(prec.FT), st["aux_material_id"])
            st["aux_background"] = jnp.where(
                (miss & first)[:, None], bg, st["aux_background"])
            for nm in aov_names:
                st["aux_aov:" + nm] = jnp.where(
                    fh[:, None], aovs.get(
                        nm, jnp.zeros((n, 3), prec.FT)),
                    st["aux_aov:" + nm])
            if "mist" in aux_names:
                # ref: kernel_passes.h kernel_write_data_passes mist:
                # pow(clamp((t - start) * inv_depth), falloff); misses
                # saturate to 1 (fully in the mist)
                mp = kg["mist"]
                mist_f = jnp.power(
                    jnp.clip((hit["t"] - mp[0]) * mp[1], 0.0, 1.0), mp[2])
                st["aux_mist"] = jnp.where(fh, mist_f, st["aux_mist"])
                st["aux_mist"] = jnp.where(miss & first, 1.0,
                                           st["aux_mist"])
        if light_passes:
            st = dict(st)
            fh0 = on_surface & (bounce == 0)
            st["aux_diffuse_color"] = jnp.where(
                fh0[:, None], closures["diffuse"] + closures["subsurface"],
                st["aux_diffuse_color"])
            st["aux_glossy_color"] = jnp.where(
                fh0[:, None], closures["glossy"], st["aux_glossy_color"])
            st["aux_transmission_color"] = jnp.where(
                fh0[:, None], closures["refraction"],
                st["aux_transmission_color"])

        # ---- holdout (ref: kernel_path.h holdout: camera-ray hits on
        # holdout materials punch a hole — alpha 0 with transparent
        # film, black otherwise; lane terminates) ----
        hold_w = jnp.clip(jnp.mean(closures["holdout"], -1), 0.0, 1.0)
        is_camera_hit = (st["path_flag"] & ob.PATH_RAY_CAMERA) > 0
        holdout_m = on_surface & is_camera_hit & (hold_w > 0.0)
        if kg["film_transparent"]:
            alpha = jnp.where(holdout_m, alpha * (1.0 - hold_w), alpha)
        alive = alive & ~(holdout_m & (hold_w >= 1.0 - 1e-6))
        on_surface = on_surface & alive

        # ---- surface emission with MIS (ref: indirect_primitive_emission)
        emis = closures["emission"]
        has_emis = jnp.any(emis > 0.0, axis=-1)
        cos_hit = um.dot(sd.Ng, sd.I)
        pdf_light = light_ops.triangle_light_pdf(
            ds, (sd.prim_row, sd.object_tfm), hit["t"], cos_hit,
            tree=light_tree, P_mis=st.get("P_mis")) \
            if has_lights else 0.0
        w_emis = jnp.where(st["singular_prev"], 1.0,
                           um.power_heuristic(st["pdf_prev"], pdf_light))
        contrib = _clamp_contrib(throughput * emis * w_emis[:, None], clamp_val)
        L = jnp.where((on_surface & has_emis)[:, None], L + contrib, L)
        if light_passes:
            # emission seen via a bounce-1 bsdf ray is DIRECT light of
            # the first bounce category; deeper is INDIRECT
            m_e = on_surface & has_emis
            for ci, cat in enumerate(LP_CATS):
                mc = m_e & (st["first_cat"] == ci)
                st[f"aux_{cat}_direct"] = jnp.where(
                    (mc & (bounce == 1))[:, None],
                    st[f"aux_{cat}_direct"] + contrib,
                    st[f"aux_{cat}_direct"])
                st[f"aux_{cat}_indirect"] = jnp.where(
                    (mc & (bounce > 1))[:, None],
                    st[f"aux_{cat}_indirect"] + contrib,
                    st[f"aux_{cat}_indirect"])
        if aux_names:
            st["aux_emission"] = jnp.where(
                (on_surface & has_emis & (bounce == 0))[:, None], emis,
                st["aux_emission"])

        # ---- NEE (ref: kernel_path_surface.h direct lighting;
        # volume NEE ref: kernel_path_volume.h) ----
        if has_lights:
            P_nee = jnp.where(scattered[:, None], P_scatter, sd.P) \
                if has_medium else sd.P
            ls = light_ops.sample_light(ds, P_nee, sel_u, lu, lv,
                                        tree=light_tree,
                                        static_kinds=kg.get(
                                            "light_kinds"))
            l_eval = ls["eval"]  # tri emission already folded in
            if bg_pmf > 0.0:
                # background-light NEE evaluates the bg shader along the
                # sampled direction (ref: background light eval)
                bg_l = shade_ops.eval_background(
                    kg["shaders"], kg["background_shader"], ls["D"],
                    textures=kg["textures"], path_flag=st["path_flag"])
                l_eval = jnp.where(ls["is_bg"][:, None], bg_l, l_eval)
            if light_passes:
                f_l, pdf_fwd, f_comp = bsdf_ops.bsdf_eval(
                    closures, N_bsdf, sd.I, ls["D"], kg.get("features"),
                    want_components=True, sd=sd)
            else:
                f_l, pdf_fwd = bsdf_ops.bsdf_eval(
                    closures, N_bsdf, sd.I, ls["D"], kg.get("features"),
                    sd=sd)
            if has_medium:
                from raytracingproject_tpu.ops import volume as vol_ops2
                cos_ph = um.dot(st["d"], ls["D"])
                ph = vol_ops2.hg_phase_eval(cos_ph, vol_g)
                f_l = jnp.where(scattered[:, None], ph[:, None], f_l)
                pdf_fwd = jnp.where(scattered, ph, pdf_fwd)
            w_l = jnp.where(ls["delta"], 1.0,
                            um.power_heuristic(ls["pdf"], pdf_fwd))
            contrib = throughput * f_l * l_eval \
                * um.safe_divide(w_l, ls["pdf"], 0.0)[:, None]
            contrib = _clamp_contrib(contrib, clamp_val)
            can_light = alive & ls["valid"] \
                & jnp.any(contrib != 0.0, axis=-1)
            # shadow ray (no normal offset for volume scatter points).
            # The visibility SEGMENT is recomputed from the offset
            # origin toward the sampled light point — offsetting the
            # origin while keeping the original direction/length lands
            # the endpoint past the light point, crossing the emitter
            # plane in contact regions (measured: the ceiling sliver
            # 0.1 above Cornell's light went dark; the reference
            # recomputes the segment the same way).
            off = jnp.where(um.dot(ls["D"], sd.Ng)[:, None] > 0,
                            sd.Ng, -sd.Ng) \
                * _offset_eps(sd.P, sd.ray_length)[:, None]
            if has_medium:
                off = jnp.where(scattered[:, None], 0.0, off)
            base_o = P_nee if has_medium else sd.P
            sh_o = base_o + off
            distant = ls["dist"] >= um.RAY_TMAX * 0.5
            P_light = base_o + ls["D"] * ls["dist"][:, None]
            to_l = P_light - sh_o
            dist2 = jnp.maximum(um.length(to_l), 1e-12)
            sh_d = jnp.where(distant[:, None], ls["D"],
                             to_l / dist2[:, None])
            sh_tmax = jnp.where(distant, prec.FT(um.RAY_TMAX),
                                dist2 * (1.0 - 1e-3) - RAY_EPS)
            in_vol_sh = st["vol_shader"] >= 0 if has_volume else None

            def _dual_sweep(o_s, d_s, on_any, on_closest, tmax_s):
                """One dense pass -> ((t_boundary, t_other), blocked):
                the winner-free occlusion sweep (see
                intersect_brute_occlusion for why this beats a
                closest-hit + any-hit pair)."""
                dsd = kg["dscene"]
                deform = kg.get("has_deform_motion")
                t_b, t_o, blk = isect.intersect_brute_occlusion(
                    dsd["tri_verts_world"],
                    dsd["prim_object_packed"],
                    dsd["prim_is_boundary"],
                    o_s, d_s, jnp.full((n,), 1e-5, prec.FT),
                    tmax_closest=jnp.where(
                        on_closest,
                        jnp.minimum(tmax_s, um.RAY_TMAX), 1e-5),
                    tmax_any=jnp.where(on_any, tmax_s, 1e-5),
                    visibility_closest=jnp.full(
                        (n,), ob.PATH_RAY_CAMERA, jnp.uint32),
                    visibility_any=jnp.full(
                        (n,), ob.PATH_RAY_SHADOW, jnp.uint32),
                    object_visibility=dsd["object_visibility"],
                    tri_verts_t1=(dsd.get(
                        "tri_verts_world_steps",
                        dsd["tri_verts_world_t1"])
                                  if deform else None),
                    time=st["time"] if deform else None)
                if "curve_p0" in dsd:
                    # hair is never a volume boundary: its closest hit
                    # feeds t_other and the shadow any-hit
                    chit = _merge_curve_hit(
                        kg,
                        {"t": jnp.where(
                            on_closest,
                            jnp.minimum(tmax_s, um.RAY_TMAX), 1e-5),
                         "prim": jnp.full((n,), -1, jnp.int32),
                         "u": jnp.zeros((n,), prec.FT),
                         "v": jnp.zeros((n,), prec.FT),
                         "object": jnp.full((n,), -1, jnp.int32)},
                        o_s, d_s, jnp.full((n,), 1e-5, prec.FT),
                        jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32))
                    t_o = jnp.minimum(t_o, jnp.where(
                        chit["prim"] >= 0, chit["t"], um.RAY_TMAX))
                    blk = blk | _curve_any_hit(
                        kg, o_s, d_s, jnp.full((n,), 1e-5, prec.FT),
                        jnp.where(on_any, tmax_s, 1e-5),
                        jnp.full((n,), ob.PATH_RAY_SHADOW, jnp.uint32))
                return (t_b, t_o), blk

            sh_trans = jnp.ones((n, 3), prec.FT)
            bhit_sh = None
            if "shadow" in ablate:
                blocked = jnp.zeros((n,), bool)
            elif use_dual_shadow:
                bhit_sh, blocked = _dual_sweep(
                    sh_o, sh_d, can_light, can_light & in_vol_sh, sh_tmax)
                sh_trans = jnp.where(blocked[:, None], 0.0, 1.0)
                contrib = contrib * sh_trans
            else:
                sh_trans = _shadow_transmittance(
                    kg, sh_o, sh_d,
                    jnp.full((n,), 1e-5, prec.FT),
                    jnp.where(can_light, sh_tmax, 1e-5),
                    time=st["time"])
                contrib = contrib * sh_trans
                blocked = ~jnp.any(sh_trans > 0.0, axis=-1)
            if has_volume:
                def _vol_nee_attenuation(P0, Dl, on_mask, dist_l,
                                         seed_salt, boundary_hit=None):
                    """Medium attenuation from an in-volume point to the
                    medium boundary along an NEE direction + boundary
                    blocking (ref: kernel_volume.h shadow transmittance).
                    Homogeneous lanes use the closed form; heterogeneous
                    lanes use unbiased ratio tracking through the actual
                    density field (ops/volume.py ratio_tracking)."""
                    if "volatten" in ablate:  # profiling: skip the
                        # boundary sweep + medium attenuation entirely
                        return (jnp.ones((n, 3), prec.FT),
                                jnp.zeros((n,), bool))
                    # camera visibility: the boundary must be FOUND here
                    # (volume-only objects are excluded from shadow rays)
                    if boundary_hit is not None:
                        # winner-free occlusion sweep output: minima of
                        # boundary-prim and other-prim hit distances
                        t_bb, t_oo = boundary_hit
                        t_first = jnp.minimum(t_bb, t_oo)
                        sh_found = t_first < um.RAY_TMAX * 0.5
                        is_boundary = t_bb <= t_oo
                    else:
                        sh_hit2 = _scene_intersect(
                            kg, P0, Dl, jnp.full((n,), 1e-5, prec.FT),
                            jnp.where(on_mask,
                                      jnp.minimum(dist_l, um.RAY_TMAX),
                                      1e-5),
                            jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32))
                        # boundary surfaces belong to volume shaders ->
                        # not blockers; everything else blocks
                        bshader = ds["prim_table"][
                            jnp.maximum(sh_hit2["prim"], 0), 24].astype(
                                jnp.int32)
                        is_boundary = jnp.asarray(
                            np.array(kg["shader_has_volume"], bool))[
                                jnp.clip(bshader, 0,
                                         len(kg["shaders"]) - 1)]
                        sh_found = sh_hit2["prim"] >= 0
                        t_first = sh_hit2["t"]
                    t_seg = jnp.where(sh_found, t_first,
                                      jnp.minimum(dist_l, 1e6))
                    trans = jnp.exp(-vc["sigma_t"] * t_seg[:, None])
                    if has_het:
                        seed2 = rngu.hash_pcg3d(
                            pixel_index.astype(jnp.uint32), st["sample"],
                            bounce.astype(jnp.uint32)
                            ^ jnp.uint32(seed_salt))
                        trans_het = vol_ops2.ratio_tracking(
                            _eval_sigma, P0, Dl, t_seg,
                            jnp.where(het_lane & on_mask, smax, 1e-12),
                            seed2, steps=steps)
                        trans = jnp.where(het_lane[:, None], trans_het,
                                          trans)
                    return trans, sh_found & ~is_boundary

                trans, vol_block = _vol_nee_attenuation(
                    sh_o, sh_d if bhit_sh is not None else ls["D"],
                    can_light & in_vol_sh, sh_tmax,
                    0x7F4A7C15, boundary_hit=bhit_sh)
                contrib = jnp.where(in_vol_sh[:, None], contrib * trans,
                                    contrib)
                blocked = jnp.where(in_vol_sh, vol_block, blocked)

            contrib_eq = None
            if has_equiangular:
                # ---- equiangular volume NEE, decoupled from the path
                # continuation (ref: kernel_volume.h:297-319 equiangular
                # sample; :978-1050 MIS combine). The scatter point for
                # DIRECT light is drawn toward the sampled light point
                # with pdf ~ 1/dist^2; the path continues from the
                # distance-sampled point. method=multiple_importance
                # runs both direct estimators, power-heuristic weighted
                # in the t-density (a partition of unity, so the combo
                # stays unbiased even for heterogeneous lanes whose
                # distance pdf is approximated at the segment start). --
                vs_modes = jnp.asarray(
                    np.array(kg["shader_vol_sampling"], np.int32))
                safe_vs2 = jnp.clip(st["vol_shader"], 0,
                                    len(kg["shaders"]) - 1)
                mode_lane = vs_modes[safe_vs2]
                # the equiangular estimator fires on EVERY traversed
                # volume segment (it is decoupled from whether distance
                # sampling produced a scatter event; conditioning it on
                # `scattered` would lose the pass-through fraction of
                # the in-scatter integral)
                eq_vol = st["alive"] & (st["vol_shader"] >= 0)
                if has_sss:
                    # SSS-walk lanes ride the volume machinery with their
                    # own medium; their closures don't match vol_shader
                    eq_vol = eq_vol & ~st["in_sss"]
                eq_lane = eq_vol & (mode_lane >= 1)
                mis_lane = eq_vol & (mode_lane == 2)
                t_seg_max = hit["t"]
                thr0 = st["throughput"]  # pre-segment throughput
                # position-based lights only (the sampled point on the
                # light is position-independent, so ls["P_l"] is valid
                # viewed from anywhere); distant/background lights have
                # no finite pivot -> fall back to the distance estimator
                pos_light = ls["valid"] & ~ls["is_bg"] \
                    & (ls["dist"] < um.RAY_TMAX * 0.5)
                eq_seed = rngu.hash_pcg3d(
                    pixel_index.astype(jnp.uint32), st["sample"],
                    bounce.astype(jnp.uint32) ^ jnp.uint32(0x51ED270B))
                u_eq = rngu.uint_to_float_01(eq_seed)
                t_eq, pdf_eq, eq_geom = vol_ops2.equiangular_sample(
                    st["o"], st["d"], t_seg_max, ls["P_l"], u_eq)
                eq_ok = eq_geom & eq_lane & pos_light & (pdf_eq > 1e-12)
                P_eq = st["o"] + st["d"] * t_eq[:, None]
                # light geometry re-evaluated from the equiangular point
                # (same rng -> same light entry + point, new observer;
                # the picked rows are reused so this costs zero lookups)
                ls_eq = light_ops.sample_light(
                    ds, P_eq, sel_u, lu, lv, rows=ls["rows"],
                    static_kinds=kg.get("light_kinds"))
                if has_het:
                    sig_eq_t, sig_eq_s = _eval_sigma(P_eq)
                    sig_eq_s = jnp.where(het_lane[:, None], sig_eq_s,
                                         vc["sigma_s"])
                    T_eq = jnp.exp(-vc["sigma_t"] * t_eq[:, None])
                    T_eq_het = vol_ops2.ratio_tracking(
                        _eval_sigma, st["o"], st["d"], t_eq,
                        jnp.where(het_lane & eq_ok, smax, 1e-12),
                        eq_seed ^ jnp.uint32(0x2C1B3C6D), steps=steps)
                    T_eq = jnp.where(het_lane[:, None], T_eq_het, T_eq)
                else:
                    sig_eq_s = vc["sigma_s"]
                    T_eq = jnp.exp(-vc["sigma_t"] * t_eq[:, None])
                cos_eq = um.dot(st["d"], ls_eq["D"])
                ph_eq = vol_ops2.hg_phase_eval(cos_eq, vol_g)
                w_l_eq = jnp.where(ls_eq["delta"], 1.0,
                                   um.power_heuristic(ls_eq["pdf"], ph_eq))
                pdf_d_at_eq = vol_ops2.distance_pdf(vc["sigma_t"], thr0,
                                                    t_eq)
                w_t_eq = jnp.where(
                    mis_lane, um.power_heuristic(pdf_eq, pdf_d_at_eq), 1.0)
                contrib_eq = thr0 * T_eq * sig_eq_s * ls_eq["eval"] \
                    * (ph_eq * w_l_eq * w_t_eq)[:, None] \
                    * um.safe_divide(1.0, pdf_eq * ls_eq["pdf"],
                                     0.0)[:, None]
                contrib_eq = _clamp_contrib(contrib_eq, clamp_val)
                sh_on_eq = eq_ok & jnp.any(contrib_eq != 0.0, axis=-1)
                sh_tmax_eq = jnp.maximum(
                    ls_eq["dist"] * (1.0 - 1e-3) - RAY_EPS, 1e-5)
                bhit_eq = None
                if "shadow" in ablate:
                    sh_trans_eq = jnp.ones((n, 3), prec.FT)
                elif use_dual_shadow:
                    bhit_eq, blk_eq = _dual_sweep(
                        P_eq, ls_eq["D"], sh_on_eq, sh_on_eq, sh_tmax_eq)
                    sh_trans_eq = jnp.where(blk_eq[:, None], 0.0, 1.0)
                else:
                    sh_trans_eq = _shadow_transmittance(
                        kg, P_eq, ls_eq["D"],
                        jnp.full((n,), 1e-5, prec.FT),
                        jnp.where(sh_on_eq, sh_tmax_eq, 1e-5),
                        time=st["time"])
                contrib_eq = contrib_eq * sh_trans_eq
                trans_eq, block_eq = _vol_nee_attenuation(
                    P_eq, ls_eq["D"], sh_on_eq, sh_tmax_eq, 0x3BD1E995,
                    boundary_hit=bhit_eq)
                contrib_eq = contrib_eq * trans_eq
                eq_lit = sh_on_eq & ~block_eq \
                    & jnp.any(sh_trans_eq > 0.0, axis=-1)
                L = jnp.where(eq_lit[:, None], L + contrib_eq, L)
                # distance-point estimator: MIS-weighted in MIS mode,
                # dropped where pure equiangular covered the light
                pdf_eq_at_td = jnp.where(
                    pos_light,
                    vol_ops2.equiangular_pdf(st["o"], st["d"], t_seg_max,
                                             ls["P_l"],
                                             ds_res["t_scatter"]), 0.0)
                pdf_d_at_td = vol_ops2.distance_pdf(
                    vc["sigma_t"], thr0, ds_res["t_scatter"])
                w_t_d = um.power_heuristic(pdf_d_at_td, pdf_eq_at_td)
                # the distance-point estimator only exists on scattered
                # lanes; non-scattered lanes run SURFACE NEE, which is a
                # different transport term and stays untouched
                contrib = jnp.where((scattered & mis_lane)[:, None],
                                    contrib * w_t_d[:, None], contrib)
                can_light = can_light \
                    & ~(scattered & eq_lane & ~mis_lane & eq_ok)
            if has_catcher:
                # shadow catcher (ref: OBJECT_FLAG_SHADOW_CATCHER,
                # simplified pre-Cycles-X semantics): camera hits on
                # catcher objects produce a shadow matte — alpha is the
                # blocked fraction of NEE light, color contributes
                # nothing, and the lane ends.
                from raytracingproject_tpu.ops import lookup as _lkc
                oflags = _lkc.lookup_rows(
                    ds["object_table"],
                    jnp.maximum(hit["object"], 0))[:, _lkc.OT_FLAGS]
                is_catch = on_surface & is_camera_hit \
                    & ((oflags.astype(jnp.int32)
                        & ob.OBJECT_FLAG_SHADOW_CATCHER) > 0)
                shadowed = is_catch & (blocked | ~ls["valid"])
                if kg["film_transparent"]:
                    alpha = jnp.where(is_catch,
                                      shadowed.astype(prec.FT), alpha)
                alive = alive & ~is_catch
                can_light = can_light & ~is_catch
            L = jnp.where((can_light & ~blocked)[:, None], L + contrib, L)
            if light_passes:
                lit = can_light & ~blocked
                scale = sh_trans * l_eval \
                    * um.safe_divide(w_l, ls["pdf"], 0.0)[:, None]
                first0 = bounce == 0
                for ci, cat in enumerate(LP_CATS[:3]):
                    fc = f_comp.get(cat)
                    if fc is None:
                        continue
                    # bounce-0 NEE splits per lobe (DIRECT light)
                    st[f"aux_{cat}_direct"] = jnp.where(
                        (lit & first0)[:, None],
                        st[f"aux_{cat}_direct"]
                        + _clamp_contrib(throughput * fc * scale, clamp_val),
                        st[f"aux_{cat}_direct"])
                # deeper NEE lands in the first category's INDIRECT
                for ci, cat in enumerate(LP_CATS):
                    mc = lit & ~first0 & (st["first_cat"] == ci)
                    st[f"aux_{cat}_indirect"] = jnp.where(
                        mc[:, None], st[f"aux_{cat}_indirect"] + contrib,
                        st[f"aux_{cat}_indirect"])
                # volume scatter NEE at bounce 0
                if has_volume:
                    mv = lit & first0 & scattered
                    st["aux_volume_direct"] = jnp.where(
                        mv[:, None], st["aux_volume_direct"] + contrib,
                        st["aux_volume_direct"])
                if contrib_eq is not None:
                    mv_eq = eq_lit & first0
                    st["aux_volume_direct"] = jnp.where(
                        mv_eq[:, None],
                        st["aux_volume_direct"] + contrib_eq,
                        st["aux_volume_direct"])

        # ---- BSDF bounce (ref: kernel_path_surface_bounce) ----
        bs = bsdf_ops.bsdf_sample(closures, N_bsdf, sd.Ng, sd.I, bu, bv,
                                  lobe_u, kg.get("features"), sd=sd)
        if has_medium:
            from raytracingproject_tpu.ops import volume as vol_ops3
            ph_dir, ph_pdf = vol_ops3.hg_phase_sample(st["d"], vol_g, bu, bv)
            bs = dict(bs)
            bs["omega"] = jnp.where(scattered[:, None], ph_dir, bs["omega"])
            # HG is perfectly importance sampled: f/pdf = 1
            # HG is perfectly importance sampled: f == pdf -> f/pdf = 1
            bs["f_cos"] = jnp.where(scattered[:, None],
                                    ph_pdf[:, None], bs["f_cos"])
            bs["pdf"] = jnp.where(scattered, ph_pdf, bs["pdf"])
            bs["valid"] = jnp.where(scattered, ph_pdf > 0.0, bs["valid"])
            bs["label"] = jnp.where(scattered,
                                    bsdf_ops.LABEL_VOLUME_SCATTER,
                                    bs["label"])

        if has_sss:
            # SSS walk ENTRY (ref: kernel_subsurface.h random walk entry):
            # pick the subsurface lobe vs the rest, dive in with a
            # cosine-weighted direction through the surface; the walk is
            # a pure-scattering medium with sigma_t = 1/radius (the
            # closure color is applied once, here).
            sss_w = jnp.mean(jnp.abs(closures["subsurface"]), -1)
            rest_w = bsdf_ops._lobe_probs(closures,
                                          include_sss=False)[-1]
            p_entry = um.safe_divide(sss_w, sss_w + rest_w, 0.0)
            entry = on_surface & ~st["in_sss"] & (phase_v < p_entry) \
                & (sss_w > 1e-12)
            d_in, pdf_in = um.sample_cos_hemisphere(-sd.N, bu, bv)
            bs = dict(bs)
            bs["omega"] = jnp.where(entry[:, None], d_in, bs["omega"])
            # Burley falloff: Christensen-Burley albedo inversion
            # (ref: kernel_subsurface.h subsurface_random_walk remap /
            # Christensen & Burley 2015 "Approximate Reflectance
            # Profiles"): the closure color becomes the DIFFUSION
            # albedo A; the walk runs with single-scatter albedo
            # alpha(A) and sigma_t = 1/(d*s(A)) so that the multiple-
            # scatter result converges to A, instead of applying the
            # color once at entry.
            is_burley = closures["subsurface_burley"] > 0.0
            A_c = jnp.clip(closures["subsurface"], 0.0, 0.999)
            alpha_w = 1.0 - jnp.exp(
                A_c * (-5.09406 + A_c * (2.61188 - 4.31805 * A_c)))
            s_scale = 1.9 - A_c + 3.5 * (A_c - 0.8) ** 2
            entry_color = jnp.where(is_burley[:, None],
                                    jnp.ones((n, 3), prec.FT),
                                    closures["subsurface"])
            bs["f_cos"] = jnp.where(entry[:, None],
                                    entry_color * pdf_in[:, None],
                                    bs["f_cos"])
            bs["pdf"] = jnp.where(entry, pdf_in * jnp.maximum(p_entry, 1e-12),
                                  bs["pdf"])
            bs["valid"] = jnp.where(entry, pdf_in > 0.0, bs["valid"])
            bs["label"] = jnp.where(entry, bsdf_ops.LABEL_TRANSMIT,
                                    bs["label"])
            # non-entry lanes keep their (1 - p_entry) discrete weight
            keep = on_surface & ~st["in_sss"] & ~entry & (sss_w > 1e-12)
            bs["pdf"] = jnp.where(keep,
                                  bs["pdf"] * jnp.maximum(1.0 - p_entry,
                                                          1e-12),
                                  bs["pdf"])

        new_throughput = throughput * bs["f_cos"] \
            * um.safe_divide(1.0, bs["pdf"], 0.0)[:, None]
        alive2 = alive & bs["valid"] \
            & jnp.any(jnp.abs(new_throughput) > 1e-7, axis=-1)

        # per-type depth limits (ref: kernel_path_state.h)
        is_diff = (bs["label"] & bsdf_ops.LABEL_DIFFUSE) > 0
        is_gloss = (bs["label"] & bsdf_ops.LABEL_GLOSSY) > 0
        is_trans = (bs["label"] & bsdf_ops.LABEL_TRANSMIT) > 0
        is_transp = (bs["label"] & bsdf_ops.LABEL_TRANSPARENT) > 0
        is_sing = (bs["label"] & bsdf_ops.LABEL_SINGULAR) > 0
        dd = st["diffuse_depth"] + is_diff.astype(jnp.int32)
        gd = st["glossy_depth"] + is_gloss.astype(jnp.int32)
        td = st["transmission_depth"] + is_trans.astype(jnp.int32)
        pd = st["transparent_depth"] + is_transp.astype(jnp.int32)
        alive2 &= dd <= int(kint["max_diffuse_bounce"])
        alive2 &= gd <= int(kint["max_glossy_bounce"])
        alive2 &= td <= int(kint["max_transmission_bounce"])
        alive2 &= pd <= int(kint["transparent_max_bounce"])

        # per-lane depth limit (replaces the fixed loop bound so path
        # regeneration can run lanes at different depths)
        alive2 &= bounce + 1 <= max_bounce

        # russian roulette (ref: kernel_path.h path_state_terminate_probability)
        rr_active = bounce >= min_bounce
        p_cont = jnp.clip(jnp.max(jnp.abs(new_throughput), -1), 0.0, 1.0)
        p_cont = jnp.where(rr_active, p_cont, 1.0)
        survive = rr_u < p_cont
        alive2 &= survive
        new_throughput = new_throughput \
            * um.safe_divide(1.0, p_cont, 0.0)[:, None]

        # next ray
        out_side = um.dot(bs["omega"], sd.Ng) > 0.0
        off = jnp.where(out_side[:, None], sd.Ng, -sd.Ng) \
            * _offset_eps(sd.P, sd.ray_length)[:, None]
        new_o = sd.P + off
        if has_medium:
            new_o = jnp.where(scattered[:, None], P_scatter, new_o)
        new_flag = jnp.where(
            is_transp, st["path_flag"],  # transparent keeps path type
            (st["path_flag"] & ~jnp.uint32(ob.PATH_RAY_CAMERA))
            | jnp.where(is_diff, jnp.uint32(ob.PATH_RAY_DIFFUSE), 0)
            | jnp.where(is_gloss, jnp.uint32(ob.PATH_RAY_GLOSSY | ob.PATH_RAY_REFLECT), 0)
            | jnp.where(is_trans, jnp.uint32(ob.PATH_RAY_TRANSMIT), 0)
            | jnp.where(is_sing, jnp.uint32(ob.PATH_RAY_SINGULAR), 0))
        if has_medium:
            new_flag = jnp.where(
                scattered, st["path_flag"]
                | jnp.uint32(ob.PATH_RAY_VOLUME_SCATTER), new_flag)
        if has_volume:
            # volume entry/exit at transmissive surface crossings
            # (ref: kernel_volume.h volume stack enter/exit)
            shader_vol = jnp.asarray(
                np.array(kg["shader_has_volume"], bool))[
                    jnp.clip(sd.shader, 0, len(kg["shaders"]) - 1)]
            crossing = (is_trans | is_transp) & on_surface & alive2
            entering = crossing & shader_vol & ~sd.backfacing
            exiting = crossing & sd.backfacing
            # K-level stack (ref: kernel_volume_stack_* semantics over
            # kernel_types.h:1035 VolumeStack): vol_shader is the top
            # (current medium), vol_rest the K-1 media below it.
            stack = jnp.concatenate(
                [st["vol_shader"][:, None], st["vol_rest"]], axis=1)
            # enter: push on top; the bottom entry drops on overflow
            pushed = jnp.concatenate(
                [sd.shader[:, None], stack[:, :-1]], axis=1)
            # exit: remove the FIRST entry matching the crossed shader
            # (it may be below the top when surfaces interleave),
            # shifting deeper entries up; no match leaves the stack
            # unchanged
            match = stack == sd.shader[:, None]
            first = match & (jnp.cumsum(match, axis=1) == 1)
            seen = jnp.cumsum(first.astype(jnp.int32), axis=1) > 0
            shifted = jnp.concatenate(
                [stack[:, 1:], jnp.full_like(stack[:, :1], -1)], axis=1)
            popped = jnp.where(seen, shifted, stack)
            new_stack = jnp.where(entering[:, None], pushed,
                                  jnp.where(exiting[:, None], popped,
                                            stack))
            new_vol = new_stack[:, 0]
            new_rest = new_stack[:, 1:]

        if light_passes:
            cat_now = jnp.where(
                (bs["label"] & bsdf_ops.LABEL_VOLUME_SCATTER) > 0, 3,
                jnp.where((bs["label"] & bsdf_ops.LABEL_DIFFUSE) > 0, 0,
                          jnp.where((bs["label"] & bsdf_ops.LABEL_GLOSSY) > 0,
                                    1, 2)))
            first_cat = jnp.where((bounce == 0) & alive,
                                  cat_now, st["first_cat"])

        out = {
            "o": jnp.where(alive2[:, None], new_o, st["o"]),
            "d": jnp.where(alive2[:, None], bs["omega"], st["d"]),
            "tmin": jnp.full((n,), 1e-5, prec.FT),
            "tmax": jnp.full((n,), um.RAY_TMAX, prec.FT),
            "time": st["time"],
            "throughput": jnp.where(alive2[:, None], new_throughput,
                                    throughput),
            "L": L,
            "alpha": alpha,
            "alive": alive2,
            "pdf_prev": jnp.where(is_sing, st["pdf_prev"], bs["pdf"]),
            "singular_prev": is_sing,
            "path_flag": new_flag,
            "diffuse_depth": dd, "glossy_depth": gd,
            "transmission_depth": td, "transparent_depth": pd,
            "bounce": bounce + 1,
            "sample": st["sample"],
        }
        if light_tree is not None:
            # pdf_prev's twin: the point NEE sampled from this bounce;
            # kept through singular/transparent bounces exactly like
            # pdf_prev so the MIS-side walk re-derives the pmf the
            # sample-side pick actually used
            p_nee_pt = (jnp.where(scattered[:, None], P_scatter, sd.P)
                        if has_medium else sd.P)
            out["P_mis"] = jnp.where(is_sing[:, None], st["P_mis"],
                                     p_nee_pt)
        if has_volume:
            out["vol_shader"] = new_vol
            out["vol_rest"] = new_rest
        if has_sss:
            radius = jnp.clip(closures["subsurface_radius"], 1e-5, 1e8)
            out["in_sss"] = ((st["in_sss"] & ~sss_exit) | entry) & alive2
            sigma_entry = jnp.where(
                is_burley[:, None],
                1.0 / jnp.clip(radius * s_scale, 1e-5, 1e8),
                1.0 / radius)
            out["sss_sigma_t"] = jnp.where(entry[:, None], sigma_entry,
                                           st["sss_sigma_t"])
            out["sss_albedo"] = jnp.where(
                entry[:, None],
                jnp.where(is_burley[:, None], alpha_w,
                          jnp.ones((n, 3), prec.FT)),
                st["sss_albedo"])
        if light_passes:
            out["first_cat"] = first_cat
        for k in st:
            if k.startswith("aux_"):
                out[k] = st[k]
        if "lobe_strat" in st:
            out["lobe_strat"] = st["lobe_strat"]
        return out

    return start_paths, bounce_body


def path_trace_sample(kg, px, py, pixel_index, sample):
    """Trace one sample for a wavefront of pixels (fixed-depth grid).

    Returns (radiance (N,3), alpha (N,), aux dict)."""
    start_paths, step = make_path_kernel(kg, px, py, pixel_index)
    n = px.shape[0]
    max_bounce = int(kg["kint"]["max_bounce"])
    state = start_paths(jnp.broadcast_to(jnp.uint32(sample), (n,)))
    final = jax.lax.fori_loop(0, max_bounce + 1,
                              lambda i, st: step(i, st), state)
    aux = {k[4:]: v for k, v in final.items() if k.startswith("aux_")}
    return final["L"], final["alpha"], aux


def render_samples(kg, px, py, pixel_index, sample_start, num_samples):
    """Accumulate `num_samples` consecutive samples (static count) for a
    pixel wavefront. Returns (radiance_sum (N,3), alpha_sum (N,)) — plus
    a dict of accumulated aux passes when kg["aux_passes"] or
    kg["light_passes"] is set."""
    want_aux = bool(kg.get("aux_passes")) or bool(kg.get("light_passes"))

    # first sample establishes the aux structure; remaining samples scan
    L0, A0, aux0 = path_trace_sample(kg, px, py, pixel_index,
                                     jnp.uint32(sample_start))

    def body(i, acc):
        L, A, aux_acc = acc
        rad, alpha, aux = path_trace_sample(
            kg, px, py, pixel_index,
            jnp.uint32(sample_start) + i.astype(jnp.uint32))
        aux_out = {k: aux_acc[k] + aux[k] for k in aux_acc}
        return (L + rad, A + alpha, aux_out)

    L, A, aux = jax.lax.fori_loop(1, num_samples, body, (L0, A0, aux0))
    if want_aux:
        return L, A, aux
    return L, A


def render_samples_regen(kg, px, py, pixel_index, sample_start, num_samples,
                         lanes_per_pixel=1):
    """Path-regeneration renderer: dead lanes immediately start their
    pixel's next sample, keeping the wavefront near 100% occupancy
    (ref: the split kernel's ray-regeneration queues,
    kernel_types.h:1592 QUEUE_..._TOREGEN_RAYS, redesigned as a
    `lax.while_loop` over a persistent lane state).

    Produces BIT-IDENTICAL results to render_samples (same per-lane
    sample/dimension RNG, same per-sample accumulation order) in fewer
    wavefront iterations: ~samples x E[path length] instead of
    samples x (max_bounce + 1). Aux/light passes accumulate at sample
    merge exactly like radiance, so pass-heavy renders keep the
    occupancy win; when any pass is enabled the return gains an aux
    dict (same contract as render_samples).

    lanes_per_pixel=K > 1 runs K samples of each pixel CONCURRENTLY
    (lane k covers samples {start+k, start+k+K, ...}): callers pass
    px/py/pixel_index tiled K times. Where the per-iteration cost is
    dominated by fixed latencies, a wider wavefront renders nearly K x
    the samples in the same wall time for small pixel counts — the
    split-kernel "more work per launch" lever
    (ref: device_split_kernel.cpp:210-232) applied to sample space.
    Accumulation per sample is unchanged; only the final K-way pixel
    reduction reorders float adds.
    """
    want_aux = bool(kg.get("aux_passes")) or bool(kg.get("light_passes"))
    K = int(lanes_per_pixel)
    assert num_samples % K == 0, "lanes_per_pixel must divide num_samples"
    per_lane = num_samples // K
    start_paths, step = make_path_kernel(kg, px, py, pixel_index)
    n = px.shape[0]
    assert n % K == 0
    npix = n // K

    if K == 1:
        s0 = jnp.broadcast_to(jnp.uint32(sample_start), (n,))
    else:
        # lane layout: [replica k][pixel i]; replica k starts at
        # sample_start + k and strides by K
        s0 = jnp.uint32(sample_start) + jnp.repeat(
            jnp.arange(K, dtype=jnp.uint32), npix)
    st0 = start_paths(s0)
    aux_keys = [k for k in st0 if k.startswith("aux_")]
    carry0 = {
        "st": st0,
        "L_acc": jnp.zeros((n, 3), prec.FT),
        "A_acc": jnp.zeros((n,), prec.FT),
        "done": jnp.zeros((n,), jnp.int32),   # samples completed per lane
        "fresh": jnp.ones((n,), bool),        # lane holds unmerged sample
    }
    carry0.update({"acc_" + k: jnp.zeros_like(st0[k]) for k in aux_keys})

    def cond(c):
        return jnp.any(c["st"]["alive"] | (c["fresh"])
                       | (c["done"] < per_lane))

    def body(c):
        st = c["st"]
        dead = ~st["alive"]
        merge = dead & c["fresh"]
        L_acc = c["L_acc"] + jnp.where(merge[:, None], st["L"], 0.0)
        A_acc = c["A_acc"] + jnp.where(merge, st["alpha"], 0.0)
        aux_acc = {"acc_" + k: c["acc_" + k] + _sel(merge, st[k],
                                                    jnp.zeros_like(st[k]))
                   for k in aux_keys}
        done = c["done"] + merge.astype(jnp.int32)
        fresh = c["fresh"] & ~merge

        regen = dead & ~fresh & (done < per_lane)
        next_sample = st["sample"] + jnp.uint32(K)
        new_st = start_paths(jnp.where(regen, next_sample, st["sample"]))
        st = {k: _sel(regen, new_st[k], st[k]) for k in st}
        fresh = fresh | regen

        st = step(0, st)
        out = {"st": st, "L_acc": L_acc, "A_acc": A_acc, "done": done,
               "fresh": fresh}
        out.update(aux_acc)
        return out

    out = jax.lax.while_loop(cond, body, carry0)

    # the loop exits only after every lane is dead AND merged
    def _pix(v):
        if K == 1:
            return v
        return jnp.sum(v.reshape((K, npix) + v.shape[1:]), axis=0)

    L, A = _pix(out["L_acc"]), _pix(out["A_acc"])
    if want_aux:
        aux = {k[4:]: _pix(out["acc_" + k]) for k in aux_keys}
        return L, A, aux
    return L, A


def _sel(mask, a, b):
    m = mask
    while m.ndim < a.ndim:
        m = m[..., None]
    return jnp.where(m, a, b)


def render_samples_adaptive_chunk(kg, px, py, pixel_index, sample_start,
                                  num_samples):
    """One fixed-shape adaptive-sampling chunk (ref: the error-driven
    active-pixel loop of kernel_adaptive_sampling.h +
    render/session.cpp, redesigned for XLA's static-shape model).

    The host compacts unconverged pixels and REPLICATES them to fill
    the full wavefront — converged pixels' lanes are reassigned as
    extra samples of still-active pixels, so occupancy stays 100% while
    the active set shrinks. All per-lane variation (which pixel, which
    sample index) is DATA, not shape: `sample_start` is a per-lane
    uint32 array and each lane renders `num_samples` CONSECUTIVE
    samples of its pixel. One compiled kernel therefore serves every
    chunk of the adaptive loop — no shape-driven recompiles.

    Returns (L_sum, A_sum, L_even_sum) per LANE; the caller
    scatter-adds lanes into the framebuffer by pixel id. L_even_sum
    accumulates only even-global-sample-index contributions, feeding
    the half-buffer error estimate (ref: kernel_adaptive_sampling.h).
    """
    assert not kg.get("aux_passes"), \
        "aux passes require the fixed-grid renderer"
    start_paths, step = make_path_kernel(kg, px, py, pixel_index)
    n = px.shape[0]
    s0 = jnp.asarray(sample_start, jnp.uint32)
    st0 = start_paths(s0)
    carry0 = {
        "st": st0,
        "L_acc": jnp.zeros((n, 3), prec.FT),
        "A_acc": jnp.zeros((n,), prec.FT),
        "E_acc": jnp.zeros((n, 3), prec.FT),
        "done": jnp.zeros((n,), jnp.int32),
        "fresh": jnp.ones((n,), bool),
    }

    def cond(c):
        return jnp.any(c["st"]["alive"] | c["fresh"]
                       | (c["done"] < num_samples))

    def body(c):
        st = c["st"]
        dead = ~st["alive"]
        merge = dead & c["fresh"]
        L_acc = c["L_acc"] + jnp.where(merge[:, None], st["L"], 0.0)
        A_acc = c["A_acc"] + jnp.where(merge, st["alpha"], 0.0)
        even = merge & (st["sample"] % 2 == 0)
        E_acc = c["E_acc"] + jnp.where(even[:, None], st["L"], 0.0)
        done = c["done"] + merge.astype(jnp.int32)
        fresh = c["fresh"] & ~merge

        regen = dead & ~fresh & (done < num_samples)
        new_st = start_paths(jnp.where(regen, st["sample"] + 1,
                                       st["sample"]))
        st = {k: _sel(regen, new_st[k], st[k]) for k in st}
        fresh = fresh | regen

        st = step(0, st)
        return {"st": st, "L_acc": L_acc, "A_acc": A_acc, "E_acc": E_acc,
                "done": done, "fresh": fresh}

    out = jax.lax.while_loop(cond, body, carry0)
    return out["L_acc"], out["A_acc"], out["E_acc"]


def render_samples_branched(kg, px, py, pixel_index, aa_start, num_aa,
                            branch, lobe_split=True):
    """Branched-path mode (ref: kernel_path_branched.h): each AA sample
    reuses its camera/filter/lens dims across `branch` shading branches
    whose per-bounce dims advance independently — few camera samples,
    many shading samples, the reference's variance trade.

    lobe_split additionally forces per-lobe/per-light coverage at the
    first bounce by stratifying the pick randoms over the branch index
    (the lockstep redesign of kernel_branched_path_surface_bounce's
    per-closure loops + sample_all_lights_direct).

    Returns (L_sum, A_sum) over num_aa x branch total samples.
    """
    start_paths, step = make_path_kernel(kg, px, py, pixel_index)
    n = px.shape[0]
    max_bounce = int(kg["kint"]["max_bounce"])

    def one(aa, k, acc):
        L, A = acc
        s_cam = jnp.broadcast_to(
            jnp.uint32(aa_start) + aa.astype(jnp.uint32), (n,))
        s_path = jnp.broadcast_to(
            (jnp.uint32(aa_start) + aa.astype(jnp.uint32))
            * jnp.uint32(branch) + k.astype(jnp.uint32), (n,))
        st = start_paths(s_path, samples_cam=s_cam)
        if lobe_split:
            # per-lobe/per-light forced split at the first bounce: the
            # branch index stratifies the pick randoms (see bounce_body).
            # The placement random gets a per-(lane, AA-sample) Latin
            # rotation of the branch index so placement bins decorrelate
            # from the light-pick bins (portal-aware branched NEE).
            rot_u = rngu.uint_to_float_01(rngu.hash_pcg3d(
                pixel_index.astype(jnp.uint32),
                jnp.uint32(aa_start) + aa.astype(jnp.uint32),
                jnp.uint32(0x9D0C7A5B)))
            k_place = jnp.mod(
                k.astype(prec.FT)
                + jnp.floor(rot_u * float(branch)), float(branch))
            st["lobe_strat"] = (
                jnp.broadcast_to(k.astype(prec.FT), (n,)),
                jnp.full((n,), float(branch), prec.FT),
                jnp.broadcast_to(k_place, (n,)))
        fin = jax.lax.fori_loop(0, max_bounce + 1,
                                lambda i, s: step(i, s), st)
        return (L + fin["L"], A + fin["alpha"])

    def aa_body(aa, acc):
        return jax.lax.fori_loop(
            0, branch, lambda k, a: one(aa, k, a), acc)

    init = (jnp.zeros((n, 3), prec.FT), jnp.zeros((n,), prec.FT))
    return jax.lax.fori_loop(0, num_aa, aa_body, init)
