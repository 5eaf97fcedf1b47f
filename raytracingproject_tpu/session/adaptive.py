"""Fixed-shape adaptive-sampling driver.

Error-driven sample allocation (ref: blender/intern/cycles/kernel/
kernel_adaptive_sampling.h + the session-side active-pixel handling in
render/session.cpp) redesigned for XLA's static-shape compilation
model: instead of shrinking the launch to the unconverged pixel list
(every new list size would be a fresh compile), the wavefront KEEPS
ITS FULL SHAPE and the host re-points converged pixels' lanes at
still-active pixels as additional samples. Which pixel a lane renders
and which sample index it starts at are device DATA (int arrays), so
one compiled kernel serves the whole adaptive loop, and occupancy is
100% in every chunk.

The error metric is the reference's half-buffer estimate: the kernel
returns an even-sample-only accumulator next to the full accumulator,
and a pixel is converged when |A - 2E| / (n * sqrt(mean)) drops below
the threshold (ref: kernel_adaptive_sampling.h kernel_do_adaptive_*).
"""
import numpy as np


def render_adaptive_device(kg, W, H, spp, *, threshold, min_samples=None,
                           chunk=4, lanes=None, max_rounds=None,
                           on_dispatch=None):
    """Device-resident adaptive loop (the reference's
    "near-zero-overhead contract", ref: kernel_adaptive_sampling.h
    :24-150 — the reference's estimator is a masked in-kernel early
    exit, not a host driver).

    The host version (render_adaptive) pays per-dispatch transfers of
    the full lane buffers (~9 MB at 262k lanes) plus numpy scatter-adds
    and allocation on the host. Here the
    ENTIRE round is one jitted device program: render a chunk, scatter
    lanes into the framebuffer, update the half-buffer error, and build
    the next lane->pixel allocation — only ONE scalar (the next active
    count) crosses to the host per round.

    Allocation is rank-based: active pixels get contiguous, near-even
    lane ranges (first `lanes % A` ranks get one extra), computed
    closed-form per lane so no sort is needed. Replica r of a pixel
    renders samples [counts + r*chunk, counts + (r+1)*chunk) — the same
    disjoint consecutive coverage as the host driver. `spp` must be a
    chunk multiple (lanes never straddle the budget).

    Returns (L_sum, A_sum, counts, stats) — the render_adaptive
    contract. `on_dispatch(round_wall_s)` is the bench's max-dispatch
    probe hook.
    """
    import functools
    import time as _time
    import jax
    import jax.numpy as jnp
    from raytracingproject_tpu.ops import integrator as integ

    npix = W * H
    n = int(lanes or npix)
    if min_samples is None:
        min_samples = max(spp // 8, 8)
    min_samples = max(int(min_samples), 2)
    assert spp % chunk == 0, "spp must be a multiple of chunk"
    thr = float(threshold)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def round_fn(state):
        counts = state["counts"]                       # (npix,) int32
        L_sum, A_sum, E_sum = (state["L"], state["A"], state["E"])

        # ---- active set (same predicate as the host driver) ----
        mean = jnp.sum(L_sum, -1) / jnp.maximum(counts, 1)
        err = jnp.sum(jnp.abs(L_sum - 2.0 * E_sum), -1) / (
            jnp.maximum(counts, 1)
            * jnp.sqrt(jnp.maximum(mean, 1e-4)))
        active = counts < spp
        if thr > 0.0:
            active &= (counts < min_samples) | (err >= thr)
        A = jnp.maximum(jnp.sum(active.astype(jnp.int32)), 1)

        # rank -> pixel map (scatter; inactive ranks drop out of bounds)
        rank = jnp.cumsum(active.astype(jnp.int32)) - 1
        pix_ids = jnp.arange(npix, dtype=jnp.int32)
        r2p = jnp.zeros((npix,), jnp.int32).at[
            jnp.where(active, rank, npix)].set(pix_ids, mode="drop")

        # closed-form lane -> rank (no sort, no big products): the
        # first `extra` ranks hold base+1 lanes, the rest base
        lane = jnp.arange(n, dtype=jnp.int32)
        base = n // A
        extra = n - base * A
        split = extra * (base + 1)
        in_hi = lane < split
        k_raw = jnp.where(in_hi, lane // jnp.maximum(base + 1, 1),
                          extra + (lane - split) // jnp.maximum(base, 1))
        start_k = jnp.where(in_hi, k_raw * (base + 1),
                            split + (k_raw - extra)
                            * jnp.maximum(base, 1))
        rep_idx = lane - start_k
        k = jnp.minimum(k_raw, A - 1)
        pix = r2p[k]
        s0 = counts[pix] + rep_idx * chunk
        # k_raw >= A only when base == 0 (more active pixels than
        # lanes): those lanes idle this round; the still-behind pixels
        # re-rank into range as others converge or hit the budget
        valid = (s0 + chunk <= spp) & (k_raw < A)

        px = pix % W
        py = pix // W
        L, Al, E = integ.render_samples_adaptive_chunk(
            kg, px, py, pix, s0.astype(jnp.uint32), chunk)
        vm = valid[:, None]
        # several lanes may add into one pixel: on the GPU the
        # scatter-add runs on atomics in no fixed order, so film sums
        # can differ in the last bits from run to run (the adaptive
        # tests compare with tolerances, not bit equality)
        L_sum = L_sum.at[pix].add(jnp.where(vm, L, 0.0))
        A_sum = A_sum.at[pix].add(jnp.where(valid, Al, 0.0))
        E_sum = E_sum.at[pix].add(jnp.where(vm, E, 0.0))
        counts = counts.at[pix].add(
            jnp.where(valid, jnp.int32(chunk), 0))

        # next-round active count (the ONLY host readback)
        mean2 = jnp.sum(L_sum, -1) / jnp.maximum(counts, 1)
        err2 = jnp.sum(jnp.abs(L_sum - 2.0 * E_sum), -1) / (
            jnp.maximum(counts, 1)
            * jnp.sqrt(jnp.maximum(mean2, 1e-4)))
        nxt = counts < spp
        if thr > 0.0:
            nxt &= (counts < min_samples) | (err2 >= thr)
        return {"L": L_sum, "A": A_sum, "E": E_sum, "counts": counts,
                "n_active": jnp.sum(nxt.astype(jnp.int32))}

    state = {"L": jnp.zeros((npix, 3), jnp.float32),
             "A": jnp.zeros((npix,), jnp.float32),
             "E": jnp.zeros((npix, 3), jnp.float32),
             "counts": jnp.zeros((npix,), jnp.int32),
             "n_active": jnp.int32(npix)}
    cap = max_rounds or (spp // chunk + 8) * 4
    dispatches = 0
    for _ in range(cap):
        t0 = _time.time()
        state = round_fn(state)
        na = int(state["n_active"])                    # syncs the round
        dispatches += 1
        if on_dispatch is not None:
            on_dispatch(_time.time() - t0)
        if na == 0:
            break
    counts = np.asarray(state["counts"])
    stats = {
        "samples_rendered": int(counts.sum()),
        "samples_nominal": npix * spp,
        "dispatches": dispatches,
        "lanes_wasted": 0,
        "max_samples": int(counts.max()) if npix else 0,
        "min_samples": int(counts.min()) if npix else 0,
    }
    return (np.asarray(state["L"]), np.asarray(state["A"]), counts,
            stats)


def render_adaptive(kg, W, H, spp, *, threshold, min_samples=None,
                    chunk=4, lanes=None, render_chunk=None,
                    progress=None):
    """Render W x H with error-driven per-pixel sample counts.

    Returns (L_sum (H*W, 3), A_sum (H*W,), counts (H*W,), stats dict).
    The image is L_sum / counts[:, None]. `chunk` is the number of
    consecutive samples one lane renders per dispatch; `lanes` is the
    wavefront width (default W*H). `render_chunk(px, py, pidx, s0)`
    overrides the kernel call (tests); default jits
    integrator.render_samples_adaptive_chunk over `kg`.
    """
    import jax
    import jax.numpy as jnp
    from raytracingproject_tpu.ops import integrator as integ

    npix = W * H
    n = int(lanes or npix)
    if min_samples is None:
        min_samples = max(spp // 8, 8)
    min_samples = max(int(min_samples), 2)

    if render_chunk is None:
        fn = jax.jit(lambda a, b, c, s: integ.render_samples_adaptive_chunk(
            kg, a, b, c, s, chunk))

        def render_chunk(px, py, pidx, s0):
            L, A, E = fn(jnp.asarray(px, jnp.int32),
                         jnp.asarray(py, jnp.int32),
                         jnp.asarray(pidx, jnp.int32),
                         jnp.asarray(s0, jnp.uint32))
            return np.asarray(L), np.asarray(A), np.asarray(E)

    L_sum = np.zeros((npix, 3), np.float32)
    A_sum = np.zeros(npix, np.float32)
    E_sum = np.zeros((npix, 3), np.float32)
    counts = np.zeros(npix, np.int64)
    active = np.arange(npix, dtype=np.int64)
    err_act = None  # per-active-pixel error from the previous test
    dispatches = 0
    lanes_wasted = 0

    while active.size:
        # fill the wavefront: active pixels get floor/ceil(n / A)
        # replicas each; replica r of a pixel covers samples
        # [count, count + chunk) shifted by r*chunk
        A = active.size
        R = n // A
        extra = n - R * A
        reps = np.full(A, R, np.int64)
        reps[:extra] += 1
        # per-dispatch milestone: stop at min_samples for the first
        # convergence check, then at each doubling (ref:
        # kernel_adaptive_sampling.h checks on a power-of-two-ish
        # cadence) — otherwise a wide wavefront (lanes >> active*chunk)
        # would exhaust the whole spp budget in one dispatch and the
        # error estimator never gets to cull anything
        ca = counts[active]
        milestone = np.where(ca < min_samples, min_samples,
                             np.minimum(np.maximum(ca * 2, ca + chunk),
                                        spp))
        cap = np.maximum((milestone - ca + chunk - 1) // chunk, 1)
        reps_c = np.minimum(reps, cap)
        # milestone caps must never turn surplus lanes into padding
        # (round-3 bench: 75% of every dispatch was masked duplicate
        # work — the 6.7x dof regression). Surplus lanes render REAL
        # extra chunks beyond the milestone, highest-error pixels
        # first: the lanes are paid for either way, and the pixels
        # least likely to converge absorb them with the least risk of
        # over-rendering.
        leftover = n - int(reps_c.sum())
        if leftover > 0:
            rem = np.maximum((spp - ca) // chunk - reps_c, 0)
            order = (np.argsort(-err_act, kind="stable")
                     if err_act is not None and err_act.size == A
                     else np.arange(A))
            rs = rem[order]
            # waterfill: largest level m with sum(min(rs, m)) <= leftover
            lo, hi = 0, int(rs.max()) if rs.size else 0
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if int(np.minimum(rs, mid).sum()) <= leftover:
                    lo = mid
                else:
                    hi = mid - 1
            extra_sorted = np.minimum(rs, lo)
            short = leftover - int(extra_sorted.sum())
            if short > 0:
                idxs = np.flatnonzero(rs > lo)[:short]
                extra_sorted[idxs] += 1
            extras = np.zeros(A, np.int64)
            extras[order] = extra_sorted
            reps_c = reps_c + extras
        lane_pix = np.repeat(active, reps_c)
        offs = np.repeat(np.cumsum(reps_c) - reps_c, reps_c)
        rep_idx = np.arange(lane_pix.size, dtype=np.int64) - offs
        # pad the tail cyclically with already-scheduled work; padded
        # lanes are masked out of the accumulation (wasted compute only
        # in the closing chunks when caps bite)
        pad = n - lane_pix.size
        if pad > 0:
            lanes_wasted += pad
            lane_pix = np.concatenate([lane_pix, lane_pix[:pad]]) \
                if lane_pix.size >= pad else np.concatenate(
                    [lane_pix, np.resize(lane_pix, pad)])
            rep_idx = np.concatenate([rep_idx, np.full(pad, -1)])
        live = rep_idx >= 0
        s0 = counts[lane_pix] + np.maximum(rep_idx, 0) * chunk

        px = (lane_pix % W).astype(np.int32)
        py = (lane_pix // W).astype(np.int32)
        L, Al, E = render_chunk(px, py, lane_pix.astype(np.int32),
                                s0.astype(np.uint32))
        dispatches += 1
        lp = lane_pix[live]
        np.add.at(L_sum, lp, L[live])
        np.add.at(A_sum, lp, Al[live])
        np.add.at(E_sum, lp, E[live])
        np.add.at(counts, active, reps_c * chunk)
        if progress is not None:
            progress.add_samples(int(live.sum()) * chunk,
                                 int(counts.max()))

        # convergence test (half-buffer error, ref metric)
        nact = counts[active].astype(np.float64)
        mean = L_sum[active].sum(-1) / np.maximum(nact, 1)
        err = np.abs(L_sum[active] - 2.0 * E_sum[active]).sum(-1) / (
            nact * np.sqrt(np.maximum(mean, 1e-4)))
        keep = counts[active] < spp
        if threshold > 0.0:
            keep &= (counts[active] < min_samples) | (err >= threshold)
        active = active[keep]
        err_act = err[keep]

    stats = {
        "samples_rendered": int(counts.sum()),
        "samples_nominal": npix * spp,
        "dispatches": dispatches,
        "lanes_wasted": int(lanes_wasted),
        "max_samples": int(counts.max()) if npix else 0,
        "min_samples": int(counts.min()) if npix else 0,
    }
    return L_sum, A_sum, counts, stats
