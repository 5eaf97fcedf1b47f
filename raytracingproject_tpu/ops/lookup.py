"""Batched table lookups (replaces the reference's per-thread texture
fetches, kernel/kernel_textures.h KERNEL_TEX).

The scene packer concatenates all per-primitive (resp. per-object,
per-lamp) attributes into ONE wide float32 table and the kernels fetch
each with a single `lookup_rows` call:

  prim_table   (P, 36): verts(9) vnormal(9) uv(6) shader smooth
                        emission(3) light_pmf object tangent(3) curve
                        lt_leaf
  object_table (O, 48): tfm(12) itfm(12) itfm_gen(12) color(3) random
                        bounds(6) visibility flags
  lamp_table   (L, 24): type co(3) dir(3) size axisu(3) axisv(3)
                        sizeu sizev strength(3) angle spot_angle
                        spot_smooth pmf

Tiny tables take a select chain, small ones a one-hot contraction,
large ones a row gather. The row limits were set on the earlier
accelerator, where a gather was the expensive primitive; they are not
measured on the H100. The one-hot contraction runs at
Precision.HIGHEST: on the H100 a default-precision float32 product runs
in TF32 and would round vertex positions; at HIGHEST a 0/1 one-hot
reproduces each f32 row exactly.
"""

from __future__ import annotations
from raytracingproject_tpu.utils import precision as prec

import jax
import jax.numpy as jnp

ONEHOT_MAX_ROWS = 512

# prim_table column layout
PT_V0 = 0          # 0:9   v0, v1, v2
PT_VN = 9          # 9:18  per-corner normals
PT_UV = 18         # 18:24 per-corner uvs
PT_SHADER = 24
PT_SMOOTH = 25
PT_EMISSION = 26   # 26:29
PT_LIGHT_PMF = 29
PT_OBJECT = 30
PT_TANGENT = 31    # 31:34 curve tangent (zeros for non-curve prims);
#                    hair ribbons carry the strand direction here
#                    (ref: ATTR_STD_CURVE_TANGENT / geom_curve.h tangent)
PT_CURVE = 34      # 1.0 on native curve-segment rows. Those rows remap
#                    the triangle slots (ref: geom_curve_intersect.h
#                    primitives live in their own table; here they share
#                    the prim table so shader_setup stays one gather):
#                    V0:V0+3 = segment p0, V0+3:V0+6 = p1-p0,
#                    V0+6/V0+7 = r0/r1, UV/UV+1 = strand v at the ends
PT_LT_LEAF = 35    # light-tree leaf slot of an emissive prim, -1 when
#                    the prim is not a light (or the tree is disabled);
#                    BSDF-hit MIS re-derives the P-dependent pick pmf
#                    from it (ops/light_tree.py finite_pmf)
PT_COLS = 36

# object_table column layout
OT_TFM = 0         # 0:12
OT_ITFM = 12       # 12:24
OT_ITFM_GEN = 24   # 24:36
OT_COLOR = 36      # 36:39
OT_RANDOM = 39
OT_BOUNDS_LO = 40  # 40:43
OT_BOUNDS_HI = 43  # 43:46
OT_VISIBILITY = 46
OT_FLAGS = 47
OT_PARTICLE = 48   # 48:62 particle binding: [index, random, age,
#                    lifetime, size, location(3), velocity(3),
#                    angular_velocity(3)] (ref: KernelParticle,
#                    kernel_types.h:1551; read by ParticleInfo)
OT_COLS = 62

# lamp_table column layout
LT_TYPE = 0
LT_CO = 1          # 1:4
LT_DIR = 4         # 4:7
LT_SIZE = 7
LT_AXISU = 8       # 8:11
LT_AXISV = 11      # 11:14
LT_SIZEU = 14
LT_SIZEV = 15
LT_STRENGTH = 16   # 16:19
LT_ANGLE = 19
LT_SPOT_ANGLE = 20
LT_SPOT_SMOOTH = 21
LT_PMF = 22
LT_IES = 23        # >0: row index+1 into lamp_ies grid table
LT_COLS = 24


SELECT_MAX_ROWS = 8


def lookup_rows(table, idx, method="auto"):
    """Fetch rows `idx` (any shape) from `table` (P, C) -> (*idx, C)."""
    p = table.shape[0]
    if method == "auto":
        if p <= SELECT_MAX_ROWS:
            method = "select"
        elif p <= ONEHOT_MAX_ROWS:
            method = "onehot"
        else:
            method = "gather"
    if method == "select":
        # tiny tables: pure VPU select chain, fuses to ~nothing
        out = jnp.broadcast_to(table[0], idx.shape + (table.shape[1],))
        for i in range(1, p):
            out = jnp.where((idx == i)[..., None], table[i], out)
        return out
    if method == "onehot":
        oh = jax.nn.one_hot(idx, p, dtype=prec.FT)
        return jnp.dot(oh, table, precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=prec.FT)
    return table[idx]


def searchsorted_cdf(cdf, u):
    """Branchless CDF inversion: index of the interval containing u.

    cdf: (D+1,) ascending with cdf[0]=0, cdf[-1]=1. For small D a
    compare-sum beats binary-search gathers by a wide margin.
    """
    d = cdf.shape[0] - 1
    if d <= 1:
        return jnp.zeros(u.shape, jnp.int32)
    if d <= 4096:
        # count of interior boundaries <= u
        return jnp.sum(u[..., None] >= cdf[None, 1:-1],
                       axis=-1).astype(jnp.int32)
    return jnp.clip(jnp.searchsorted(cdf, u, side="right") - 1,
                    0, d - 1).astype(jnp.int32)


def mat34(flat):
    """(N, 12) -> (N, 3, 4)."""
    return flat.reshape(flat.shape[:-1] + (3, 4))
