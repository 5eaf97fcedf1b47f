"""Light tree: hierarchical many-light importance sampling.

Replaces the flat power-CDF light pick (ops/light.py
light_distribution_sample, ref: render/light.cpp:277) with a bounding
cone/box hierarchy whose per-cluster importance depends on the shading
point — the adaptive-splitting light BVH of Conty & Kulla, "Importance
Sampling of Many Lights with Adaptive Tree Splitting" (the design later
productionized as Cycles' light tree). The reference checkout predates
it; this is a deliberate capability extension for many-light scenes,
where the flat CDF's pick quality collapses (pick pmf independent of
receiver position).

Wavefront shape, NOT a per-ray recursive descent:

- The tree is a *balanced* implicit heap over Morton-ordered emitters,
  so every lane walks exactly `depth` levels in lockstep — no stacks,
  no divergence, static unroll inside jit.
- Each interior node row pair-packs BOTH child clusters (24 floats), so
  one `lookup_rows` fetch per level serves the whole wavefront: the
  walk costs depth gathers total (depth = ceil(log2(lights))), vs. the
  flat CDF's 1 — enable only when many lights make that worthwhile.
- Distant + background lights have no finite bounds; they form an
  "infinite group" chosen first with probability
  E_inf / (E_inf + importance(root cluster, P)), then a flat CDF inside
  the group. Both factors are recomputable at any P, which MIS needs.

MIS contract: the pick pmf now depends on the receiving point P, so
BSDF-hit MIS (indirect_primitive_emission / indirect_lamp_emission /
background MIS, kernel/kernel_emission.h:209-333) must re-derive the
pmf NEE *would have used* from the previous bounce's shading point.
`leaf_pmf` walks root->leaf along the known heap path (leaf index bits)
with the same importance math, so sample-side and pdf-side pmfs agree
bit-for-bit at equal P. The integrator threads `P_prev` through the
path state for this.

Cluster importance is conservative: it is zero only where the cone
geometry proves no emission can reach P (so the estimator stays
unbiased — wherever the true contribution is nonzero the pick pmf is
nonzero; a zero-importance sibling pair falls back to 0.5/0.5).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from raytracingproject_tpu.utils import math as um
from raytracingproject_tpu.utils import precision as prec

# cluster row layout (12 cols): lo(3) hi(3) axis(3) theta_o theta_e energy
CL_LO = 0
CL_HI = 3
CL_AXIS = 6
CL_THETA_O = 9
CL_THETA_E = 10
CL_ENERGY = 11
CL_COLS = 12

_ONE_MINUS = np.float32(1.0 - 2 ** -24)


# ---------------------------------------------------------------------------
# host-side build (NumPy)
# ---------------------------------------------------------------------------

def _morton3(q):
    """Interleave 10-bit x/y/z into 30-bit Morton codes. q: (N,3) ints."""
    def spread(v):
        v = v.astype(np.uint64) & np.uint64(0x3FF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x30000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x9249249)
        return v
    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def _merge_clusters(a, b):
    """Conservative parent cluster of two child clusters (12-col rows).
    Cone merge: new axis = energy-weighted average; theta_o grows to
    cover both children's normal cones seen from the new axis."""
    out = np.zeros(CL_COLS, np.float32)
    out[CL_LO:CL_LO + 3] = np.minimum(a[CL_LO:CL_LO + 3], b[CL_LO:CL_LO + 3])
    out[CL_HI:CL_HI + 3] = np.maximum(a[CL_HI:CL_HI + 3], b[CL_HI:CL_HI + 3])
    ea, eb = float(a[CL_ENERGY]), float(b[CL_ENERGY])
    out[CL_ENERGY] = ea + eb
    if ea <= 0.0:
        src = b
        out[CL_AXIS:CL_AXIS + 3] = src[CL_AXIS:CL_AXIS + 3]
        out[CL_THETA_O] = src[CL_THETA_O]
        out[CL_THETA_E] = src[CL_THETA_E]
        return out
    if eb <= 0.0:
        src = a
        out[CL_AXIS:CL_AXIS + 3] = src[CL_AXIS:CL_AXIS + 3]
        out[CL_THETA_O] = src[CL_THETA_O]
        out[CL_THETA_E] = src[CL_THETA_E]
        return out
    ax = ea * a[CL_AXIS:CL_AXIS + 3] + eb * b[CL_AXIS:CL_AXIS + 3]
    nl = float(np.linalg.norm(ax))
    if nl < 1e-9:
        out[CL_AXIS:CL_AXIS + 3] = a[CL_AXIS:CL_AXIS + 3]
        out[CL_THETA_O] = np.pi
    else:
        axis = ax / nl
        out[CL_AXIS:CL_AXIS + 3] = axis
        ang_a = float(np.arccos(np.clip(
            np.dot(axis, a[CL_AXIS:CL_AXIS + 3]), -1.0, 1.0)))
        ang_b = float(np.arccos(np.clip(
            np.dot(axis, b[CL_AXIS:CL_AXIS + 3]), -1.0, 1.0)))
        out[CL_THETA_O] = min(np.pi, max(ang_a + float(a[CL_THETA_O]),
                                         ang_b + float(b[CL_THETA_O])))
    out[CL_THETA_E] = max(float(a[CL_THETA_E]), float(b[CL_THETA_E]))
    return out


def leaf_cluster(lo, hi, axis, theta_o, theta_e, energy):
    row = np.zeros(CL_COLS, np.float32)
    row[CL_LO:CL_LO + 3] = lo
    row[CL_HI:CL_HI + 3] = hi
    n = np.linalg.norm(axis)
    row[CL_AXIS:CL_AXIS + 3] = (np.asarray(axis, np.float32) / n
                                if n > 1e-12 else (0.0, 0.0, 1.0))
    row[CL_THETA_O] = theta_o
    row[CL_THETA_E] = theta_e
    row[CL_ENERGY] = max(float(energy), 0.0)
    return row


def build_light_tree(leaf_rows, leaf_entries):
    """Build the balanced heap tree.

    leaf_rows: (L, 12) clusters; leaf_entries: (L, 4) [type, id, -, -]
    aligned with leaf_rows. Returns dict of device arrays + meta:
      lt_nodes (max(Lp-1,1), 24)  pair-packed child clusters per parent
      lt_root  (12,)              merged cluster of everything
      lt_leaf_entries (Lp, 4)     entry rows in leaf (Morton) order
      depth    int                levels to walk (log2 Lp)
      leaf_of  (L,) int           input leaf i -> tree leaf slot
    """
    leaf_rows = np.asarray(leaf_rows, np.float32)
    leaf_entries = np.asarray(leaf_entries, np.float32)
    L = len(leaf_rows)
    assert L >= 1 and leaf_rows.shape[1] == CL_COLS
    centers = 0.5 * (leaf_rows[:, CL_LO:CL_LO + 3]
                     + leaf_rows[:, CL_HI:CL_HI + 3])
    lo = centers.min(0)
    span = np.maximum(centers.max(0) - lo, 1e-12)
    q = np.clip(((centers - lo) / span) * 1023.0, 0, 1023).astype(np.uint64)
    order = np.argsort(_morton3(q), kind="stable")

    depth = int(np.ceil(np.log2(L))) if L > 1 else 0
    Lp = 1 << depth
    rows = np.zeros((Lp, CL_COLS), np.float32)
    entries = np.zeros((Lp, 4), np.float32)
    leaf_of = np.zeros(L, np.int64)
    for k, oi in enumerate(order):
        rows[k] = leaf_rows[oi]
        entries[k] = leaf_entries[oi]
        leaf_of[oi] = k
    # pads: clone the last real leaf's bounds with zero energy so they
    # never attract probability and never distort parent bounds. Their
    # entry id is -1: a pad CAN still be picked with pmf > 0 when an
    # entire sibling subtree has provably-zero importance (the 0.5/0.5
    # fallback), and an id-0 alias would double-count lamp 0 — the
    # sampler masks id < 0 invalid instead (zero true contribution, so
    # dropping the lane is exact).
    for k in range(L, Lp):
        rows[k] = rows[L - 1]
        rows[k, CL_ENERGY] = 0.0
        entries[k, 1] = -1.0

    clus = np.zeros((2 * Lp - 1, CL_COLS), np.float32)
    clus[Lp - 1:] = rows
    for p in range(Lp - 2, -1, -1):
        clus[p] = _merge_clusters(clus[2 * p + 1], clus[2 * p + 2])
    M = Lp - 1
    nodes = np.zeros((max(M, 1), 2 * CL_COLS), np.float32)
    for p in range(M):
        nodes[p, 0:CL_COLS] = clus[2 * p + 1]
        nodes[p, CL_COLS:] = clus[2 * p + 2]
    return {
        "lt_nodes": nodes,
        "lt_root": clus[0],
        "lt_leaf_entries": entries,
    }, depth, leaf_of


# ---------------------------------------------------------------------------
# device-side walk (JAX)
# ---------------------------------------------------------------------------

def cluster_importance(P, cl):
    """Importance of cluster rows cl (N, 12) seen from P (N, 3).
    Conty-Kulla measure: energy * cos(theta') / max(d, r)^2, zero when
    the emission cone provably misses P. Position-only (no receiver
    normal) so sample-side and every pdf-side agree without threading
    normals; angles are cheap elementwise math."""
    lo = cl[:, CL_LO:CL_LO + 3]
    hi = cl[:, CL_HI:CL_HI + 3]
    axis = cl[:, CL_AXIS:CL_AXIS + 3]
    th_o = cl[:, CL_THETA_O]
    th_e = cl[:, CL_THETA_E]
    energy = cl[:, CL_ENERGY]
    c = 0.5 * (lo + hi)
    r = 0.5 * um.length(hi - lo)
    dvec = c - P
    dist = jnp.maximum(um.length(dvec), 1e-12)
    to_p = -dvec / dist[:, None]                 # cluster -> P
    cos_t = jnp.clip(um.dot(axis, to_p), -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    theta_u = jnp.arcsin(jnp.clip(r / dist, 0.0, 1.0))
    th_p = jnp.maximum(theta - th_o - theta_u, 0.0)
    visible = th_p < th_e
    d2 = jnp.square(jnp.maximum(dist, jnp.maximum(r, 1e-6)))
    return jnp.where(visible, energy * jnp.cos(th_p), 0.0) / d2


def _pair_probs(dscene, p, P):
    """P(left child) at interior heap nodes p (N,) from points P."""
    from raytracingproject_tpu.ops import lookup as lk
    row = lk.lookup_rows(dscene["lt_nodes"], p)
    i_l = cluster_importance(P, row[:, 0:CL_COLS])
    i_r = cluster_importance(P, row[:, CL_COLS:])
    s = i_l + i_r
    return jnp.where(s > 0.0, i_l / jnp.maximum(s, 1e-30), prec.FT(0.5))


def pick(dscene, depth, P, u):
    """Walk the tree: returns (leaf (N,), pmf (N,)). One pair-row fetch
    per level; u is hierarchically remapped (standard CDF warping)."""
    n = P.shape[0]
    p = jnp.zeros((n,), jnp.int32)
    pmf = jnp.ones((n,), prec.FT)
    u = jnp.clip(u, 0.0, _ONE_MINUS)
    for _ in range(depth):
        p_l = _pair_probs(dscene, p, P)
        right = u >= p_l
        u = jnp.clip(jnp.where(right,
                               (u - p_l) / jnp.maximum(1.0 - p_l, 1e-12),
                               u / jnp.maximum(p_l, 1e-12)),
                     0.0, _ONE_MINUS)
        pmf = pmf * jnp.where(right, 1.0 - p_l, p_l)
        p = 2 * p + 1 + right.astype(jnp.int32)
    leaf = p - ((1 << depth) - 1)
    return leaf, pmf


def leaf_pmf(dscene, depth, P, leaf):
    """pmf with which `pick` from P would select `leaf` — the MIS-side
    twin of pick(): the heap path is the leaf index's bit string, so the
    walk needs no u, only the same importance math."""
    n = P.shape[0]
    p = jnp.zeros((n,), jnp.int32)
    pmf = jnp.ones((n,), prec.FT)
    lf = jnp.clip(leaf, 0, (1 << depth) - 1)
    for lvl in range(depth):
        p_l = _pair_probs(dscene, p, P)
        bit = (lf >> (depth - 1 - lvl)) & 1
        pmf = pmf * jnp.where(bit == 1, 1.0 - p_l, p_l)
        p = 2 * p + 1 + bit
    return pmf


def q_infinite(dscene, P, inf_energy):
    """Probability of picking the infinite group (distant + background)
    at P: E_inf / (E_inf + importance(root, P)). Row fetch is static
    (root row), so this costs no gather."""
    if inf_energy <= 0.0:
        return jnp.zeros(P.shape[:1], prec.FT)
    root = jnp.broadcast_to(dscene["lt_root"][None, :],
                            (P.shape[0], CL_COLS))
    i_root = cluster_importance(P, root)
    return prec.FT(inf_energy) / (prec.FT(inf_energy) + i_root)


def sample_entry(dscene, tree, P, u):
    """Full P-aware light pick: returns an entry row (N, 4)
    [type, id, pmf, 0] drop-in compatible with light_entries rows
    (ops/light.py sample_light), with col 2 = the walked pick pmf."""
    from raytracingproject_tpu.ops import lookup as lk
    depth = int(tree["depth"])
    e_inf = float(tree["inf_energy"])
    n = P.shape[0]
    if e_inf > 0.0:
        q = q_infinite(dscene, P, e_inf)
        use_inf = u < q
        u_fin = jnp.clip((u - q) / jnp.maximum(1.0 - q, 1e-12),
                         0.0, _ONE_MINUS)
        u_inf = jnp.clip(u / jnp.maximum(q, 1e-12), 0.0, _ONE_MINUS)
    else:
        q = jnp.zeros((n,), prec.FT)
        use_inf = None
        u_fin = u
    leaf, pmf_fin = pick(dscene, depth, P, u_fin)
    erow = lk.lookup_rows(dscene["lt_leaf_entries"], leaf)
    pmf = (1.0 - q) * pmf_fin
    if use_inf is not None:
        k = lk.searchsorted_cdf(dscene["lt_inf_cdf"], u_inf)
        irow = lk.lookup_rows(dscene["lt_inf_entries"], k)
        erow = jnp.where(use_inf[:, None], irow, erow)
        pmf = jnp.where(use_inf, q * irow[:, 2], pmf)
    erow = jnp.concatenate(
        [erow[:, 0:2], pmf[:, None], erow[:, 3:4]], axis=1)
    return erow


def bg_pick_pmf(dscene, tree, P):
    """Pick pmf NEE at P would assign to the background light:
    q_infinite(P) x its static within-infinite-group pmf. The MIS twin
    of the background branch of sample_entry (used by
    indirect_background, kernel_emission.h:309-333)."""
    return (q_infinite(dscene, P, float(tree["inf_energy"]))
            * prec.FT(tree["bg_inf_pmf"]))


def finite_pmf(dscene, tree, P, leaf):
    """Pick pmf NEE at P would assign to a finite-emitter tree leaf:
    (1 - q_inf) * leaf walk. Used by triangle/lamp BSDF-hit MIS."""
    depth = int(tree["depth"])
    e_inf = float(tree["inf_energy"])
    pmf = leaf_pmf(dscene, depth, P, leaf)
    if e_inf > 0.0:
        pmf = pmf * (1.0 - q_infinite(dscene, P, e_inf))
    return pmf
