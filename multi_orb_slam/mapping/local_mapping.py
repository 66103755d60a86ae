"""Local mapping stage: local-BA windowing + map write-back.

The reference runs LocalMapping as a free thread (src/LocalMapping.cc:55-157);
here it is a deterministic stage invoked after keyframe insertion
(SURVEY.md §7.1: "Sequential pipeline, batched stages").  This module owns:

- local BA problem extraction (the covisible-KF window of
  Optimizer::LocalBundleAdjustment, src/Optimizer.cc:921-1353: covisible KFs
  free, observing KFs fixed, their points marginalized)
- write-back of optimized poses/points and erasure of outlier observations
  (src/Optimizer.cc:1290-1325)
- map-point culling (src/LocalMapping.cc:225-270)
- keyframe culling (src/LocalMapping.cc:966-1038)
- triangulation of new points and neighbor fusion live in
  `triangulation.py` / `fusion.py`.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig, inv_sigma2_of_level
from ..frontend.tracking import update_point_geometry
from ..geometry import camera as cam_mod
from ..optim import local_ba
from . import map_state as ms


@partial(jax.jit, static_argnums=(2, 3, 4))
def build_local_problem(
    state: ms.MapState,
    center_kf: jnp.ndarray,
    cfg: SlamConfig,
    n_free: int = 12,
    n_fixed: int = 12,
) -> local_ba.BAProblem:
    """Extract the covisibility window around `center_kf` as a BAProblem."""
    K, C, F = state.kf_mp.shape
    M = state.mp_pos.shape[0]
    P = cfg.ba_local_cap

    center_obs = state.kf_mp[center_kf].reshape(-1)
    in_center = jnp.zeros(M, bool).at[
        jnp.where(center_obs >= 0, center_obs, M - 1)
    ].max(center_obs >= 0)
    kfobs = state.kf_mp.reshape(K, -1)
    kfobs_ok = (kfobs >= 0) & state.kf_valid[:, None]
    share = jnp.sum(
        (in_center[jnp.clip(kfobs, 0, M - 1)] & kfobs_ok).astype(jnp.int32),
        axis=-1,
    )
    share = share.at[center_kf].set(1 << 24)  # center always first
    w_free, free_kfs = jax.lax.top_k(share, n_free)
    free_ok = (w_free > 0) & state.kf_valid[free_kfs]

    # local points = points observed by the free window
    fk = jnp.where(free_ok, free_kfs, 0)
    obs_free = state.kf_mp[fk].reshape(n_free, -1)
    obs_free_ok = (obs_free >= 0) & free_ok[:, None]
    local_mask = jnp.zeros(M, bool).at[
        jnp.where(obs_free_ok, obs_free, M - 1).reshape(-1)
    ].max(obs_free_ok.reshape(-1))
    local_mask = local_mask & state.mp_valid

    # fixed KFs: observe local points but are not free
    sees_local = jnp.sum(
        (local_mask[jnp.clip(kfobs, 0, M - 1)] & kfobs_ok).astype(jnp.int32),
        axis=-1,
    )
    is_free = jnp.zeros(K, bool).at[jnp.where(free_ok, free_kfs, K - 1)].max(free_ok)
    sees_local = jnp.where(is_free | ~state.kf_valid, -1, sees_local)
    w_fix, fixed_kfs = jax.lax.top_k(sees_local, n_fixed)
    fixed_ok = w_fix > 0

    # compact local points
    score = local_mask.astype(jnp.int32)
    _, order = jax.lax.top_k(score * (1 << 20) - jnp.arange(M), P)
    sel_ok = local_mask[order]
    mp_slot = jnp.where(sel_ok, order, -1)
    lookup = jnp.full(M, -1, jnp.int32).at[
        jnp.where(sel_ok, order, M - 1)
    ].set(jnp.where(sel_ok, jnp.arange(P, dtype=jnp.int32), -1))

    L = n_free + n_fixed
    kf_slots = jnp.concatenate([free_kfs, fixed_kfs]).astype(jnp.int32)
    kf_ok = jnp.concatenate([free_ok, fixed_ok])
    kf_free = jnp.concatenate([free_ok, jnp.zeros(n_fixed, bool)])
    # gauge anchor: the reference fixes KF id 0 when present
    # (Optimizer.cc:1046); our slot 0 is the first keyframe ever created.
    kf_free = kf_free & ~((kf_slots == 0) & kf_ok)
    # if nothing anchors the gauge (no fixed KFs, KF0 absent), fix the oldest
    has_anchor = jnp.any(kf_ok & ~kf_free)
    fid = jnp.where(kf_ok, state.kf_frame_id[kf_slots], 1 << 30)
    oldest = jnp.argmin(fid)
    kf_free = kf_free & ~(
        (~has_anchor) & (jnp.arange(L) == oldest)
    )

    ks = jnp.where(kf_ok, kf_slots, 0)
    obs_mp_raw = state.kf_mp[ks]  # [L, C, F]
    obs_mp = jnp.where(
        (obs_mp_raw >= 0) & kf_ok[:, None, None]
        & state.kf_feat_valid[ks],
        lookup[jnp.clip(obs_mp_raw, 0, M - 1)],
        -1,
    )
    # dedupe: at most ONE observation of a point per (KF, camera) row, as
    # in the reference (MapPoint::AddObservation keeps one idx per KF,
    # src/MapPoint.cc:138-150; fusion merges can leave two features on the
    # same winner here).  Uniqueness also lets the solver replace its
    # in-loop scatters with gathers through an inverse index map.
    flat = obs_mp.reshape(L * obs_mp.shape[1], obs_mp.shape[2])
    order = jnp.argsort(flat, axis=1)
    sv = jnp.take_along_axis(flat, order, axis=1)
    dup_sorted = jnp.concatenate(
        [jnp.zeros((flat.shape[0], 1), bool),
         (sv[:, 1:] == sv[:, :-1]) & (sv[:, 1:] >= 0)], axis=1)
    rows = jnp.arange(flat.shape[0])[:, None]
    dup = jnp.zeros_like(dup_sorted).at[rows, order].set(dup_sorted)
    obs_mp = jnp.where(dup.reshape(obs_mp.shape), -1, obs_mp)
    obs_uvr = jnp.concatenate(
        [state.kf_xy_und[ks], state.kf_uright[ks][..., None]], axis=-1
    )
    inv_s2 = inv_sigma2_of_level(state.kf_level[ks], cfg)
    return local_ba.BAProblem(
        kf_slot=jnp.where(kf_ok, kf_slots, -1),
        kf_Tcw=state.kf_Tcw[ks],
        kf_free=kf_free,
        kf_valid=kf_ok,
        mp_slot=mp_slot,
        mp_pos=state.mp_pos[jnp.clip(mp_slot, 0, M - 1)],
        mp_valid=sel_ok,
        obs_mp=obs_mp,
        obs_uvr=obs_uvr,
        obs_inv_sigma2=inv_s2,
    )


@partial(jax.jit, static_argnums=(5,))
def apply_ba_result(
    state: ms.MapState,
    prob: local_ba.BAProblem,
    kf_Tcw_new: jnp.ndarray,
    mp_pos_new: jnp.ndarray,
    obs_inlier: jnp.ndarray,
    cfg: SlamConfig,
) -> ms.MapState:
    """Write optimized poses/points back; erase outlier observations.

    Reference: Optimizer.cc:1290-1345 (erase KF<->MP observations whose chi2
    failed, then overwrite poses and point positions).
    """
    K, C, F = state.kf_mp.shape
    M = state.mp_pos.shape[0]
    L = prob.kf_slot.shape[0]

    # poses (free KFs only; dummy writes to reserved slot K-1)
    tgt_kf = jnp.where(prob.kf_valid & prob.kf_free, prob.kf_slot, K - 1)
    put = (prob.kf_valid & prob.kf_free)[:, None, None]
    kf_Tcw = state.kf_Tcw.at[tgt_kf].set(
        jnp.where(put, kf_Tcw_new, state.kf_Tcw[tgt_kf]))

    # points
    tgt_mp = jnp.where(prob.mp_valid, prob.mp_slot, M - 1)
    putp = prob.mp_valid[:, None]
    mp_pos = state.mp_pos.at[tgt_mp].set(
        jnp.where(putp, mp_pos_new, state.mp_pos[tgt_mp]))

    # erase outlier observations
    tgt_rows = jnp.where(prob.kf_valid, prob.kf_slot, K - 1)
    rows = state.kf_mp[tgt_rows]  # [L, C, F]
    erase = (prob.obs_mp >= 0) & ~obs_inlier & prob.kf_valid[:, None, None]
    rows = jnp.where(erase, -1, rows)
    kf_mp = state.kf_mp.at[tgt_rows].set(rows)

    # point geometry refresh is deferred to the end of the mapping stage
    return state._replace(kf_Tcw=kf_Tcw, mp_pos=mp_pos, kf_mp=kf_mp)


def run_local_ba(
    state: ms.MapState,
    center_kf,
    calib: cam_mod.CameraParams,
    cfg: SlamConfig,
    n_free: int = 12,
    n_fixed: int = 12,
    phases: tuple = ((5, True), (8, False)),
) -> ms.MapState:
    """Full local BA pass around a keyframe (build -> solve -> apply).

    Default schedule is 5 Huber + 8 plain LM iterations.  The solver
    carries only small state (poses/points/cost) through its while_loop:
    each iteration linearizes fresh at the current estimate and accepts or
    rejects the trial step with a residual-only cost pass (~30x cheaper
    than a linearization), so a rejected step re-linearizes at the
    unchanged estimate — identical blocks, identical semantics to g2o's
    retained-blocks Levenberg retry, without carrying the ~8 MB block
    tuple through the loop (local_ba.solve_ba).
    """
    prob = build_local_problem(
        state, jnp.asarray(center_kf, jnp.int32), cfg, n_free, n_fixed
    )
    kf_Tcw, mp_pos, inlier = solve_ba_jit(prob, calib.T_rc, calib.K,
                                          calib.bf, phases)
    return apply_ba_result(state, prob, kf_Tcw, mp_pos, inlier, cfg)


@partial(jax.jit, static_argnums=(4,))
def solve_ba_jit(prob, T_rc, K, bf, phases=((5, True), (10, False))):
    return local_ba.solve_ba(prob, T_rc, K, bf, phases=phases)


# ---------------------------------------------------------------------------
# Map point culling (reference LocalMapping::MapPointCulling, :225-270)
# ---------------------------------------------------------------------------


def run_mapping_stage(
    state: ms.MapState,
    kf_slot,
    frame_id,
    calib: cam_mod.CameraParams,
    cfg: SlamConfig,
    do_triangulate: bool = True,
    do_fuse: bool = True,
    do_ba: bool = True,
    do_cull: bool = True,
    covis_hint: int | None = None,
) -> ms.MapState:
    """The full mapping pass after a keyframe insertion.

    Mirrors one loop of LocalMapping::Run (src/LocalMapping.cc:55-157):
    MapPointCulling -> CreateNewMapPoints -> SearchInNeighbors ->
    LocalBundleAdjustment -> KeyFrameCulling, as a deterministic sequence.
    The default all-stages path is ONE jitted dispatch with ZERO host
    syncs (the reference hides mapping latency in a thread; we hide it in
    the device pipeline — the tracker's next fused step chains on the new
    map without the host ever blocking).

    `covis_hint`: a caller-provided covisible-keyframe count for adaptive
    window sizing.  Pass the PREVIOUS keyframe's count (dispatched async
    via `covis_kf_count` and read one KF later, by which time it has
    resolved) to keep this call sync-free; with `ba_adaptive` and no hint,
    the count is computed here at the cost of draining the device queue.
    """
    n_free, n_fixed = cfg.ba_free_kfs, cfg.ba_fixed_kfs
    phases = ((5, True), (8, False))
    if cfg.ba_adaptive:
        # size the window to the actual covisible set (the reference frees
        # the FULL covisible neighborhood, Optimizer.cc:936-1014); bucketed
        # static shapes keep XLA happy.  Larger buckets get a shorter LM
        # budget (_BA_BUCKET_PHASES): the reference's mbAbortBA interrupts
        # exactly these solves under real-time keyframe pressure.
        n_cov = covis_hint if covis_hint is not None else int(
            covis_kf_count(state, jnp.asarray(kf_slot, jnp.int32)))
        for nf in _BA_WINDOW_BUCKETS:
            if nf >= n_cov + 1:
                break
        phases = _BA_BUCKET_PHASES[nf]
        n_free = n_fixed = min(nf, cfg.max_kf // 2)
        if os.environ.get("MOS_MAPPING_DEBUG"):
            import sys as _sys
            print(f"[mapping] covis={n_cov} bucket={nf}",
                  file=_sys.stderr, flush=True)
    if do_triangulate and do_fuse and do_ba and do_cull:
        return _mapping_stage_fused(
            state, jnp.asarray(kf_slot, jnp.int32),
            jnp.asarray(frame_id, jnp.int32), calib, cfg, n_free, n_fixed,
            phases)
    from . import fusion, triangulation

    if do_cull:
        state = cull_map_points(state, jnp.asarray(frame_id, jnp.int32), cfg)
    if do_triangulate:
        state, _ = triangulation.triangulate_new_points(state, kf_slot, calib, cfg)
    if do_fuse:
        state, _ = fusion.fuse_neighbors(state, kf_slot, calib, cfg)
    if do_ba and int(state.n_kf) > 2:
        state = run_local_ba(state, kf_slot, calib, cfg,
                             n_free=n_free, n_fixed=n_fixed, phases=phases)
    if do_cull:
        state = cull_keyframes(state, jnp.asarray(kf_slot, jnp.int32), cfg)
    state = update_point_geometry(state, cfg)
    return state


# adaptive-window buckets: smallest compiled variant covering the covisible
# set wins; the largest is the cap (K=192 maps rarely exceed 32 covisibles).
# Each bucket carries its own LM schedule (huber_iters, plain_iters): the
# per-iteration cost grows ~linearly with the window, and the reference never
# actually runs its full 5+10 schedule on large windows in real time — a
# new keyframe's arrival sets mbAbortBA and Optimizer::LocalBundleAdjustment
# stops at the next g2o iteration boundary (LocalMapping.cc:590-604,
# Optimizer.cc:1213-1225 setForceStopFlag), so at 1 KF / 10-15 frames the
# big-window solves are interrupted after a few iterations.  Scaling the
# deterministic budget down with window size reproduces that effective
# behavior while keeping every solve bit-reproducible.
_BA_WINDOW_BUCKETS = (12, 16, 24, 32)
_BA_BUCKET_PHASES = {
    12: ((5, True), (8, False)),
    16: ((4, True), (6, False)),
    24: ((2, True), (4, False)),
    32: ((2, True), (3, False)),
}


@jax.jit
def covis_kf_count(state: ms.MapState, kf_slot: jnp.ndarray) -> jnp.ndarray:
    """Number of valid keyframes sharing >= 15 observations with kf_slot.

    One matvec against the observation incidence (the reference's
    GetVectorCovisibleKeyFrames set size, src/KeyFrame.cc:486-668)."""
    K, C, F = state.kf_mp.shape
    M = state.mp_pos.shape[0]
    row = state.kf_mp[kf_slot].reshape(-1)
    in_row = jnp.zeros(M, bool).at[
        jnp.where(row >= 0, row, M - 1)].max(row >= 0)
    kfobs = state.kf_mp.reshape(K, -1)
    ok = (kfobs >= 0) & state.kf_valid[:, None]
    share = jnp.sum(
        (in_row[jnp.clip(kfobs, 0, M - 1)] & ok).astype(jnp.int32), axis=-1)
    share = share.at[kf_slot].set(0)
    return jnp.sum((share >= 15).astype(jnp.int32))


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _mapping_stage_fused(
    state: ms.MapState,
    kf_slot: jnp.ndarray,
    frame_id: jnp.ndarray,
    calib: cam_mod.CameraParams,
    cfg: SlamConfig,
    n_free: int = 12,
    n_fixed: int = 12,
    phases: tuple = ((5, True), (8, False)),
) -> ms.MapState:
    from . import fusion, triangulation

    state = cull_map_points(state, frame_id, cfg)
    state, _ = triangulation.triangulate_new_points(state, kf_slot, calib, cfg)
    state, _ = fusion.fuse_neighbors(state, kf_slot, calib, cfg)

    # local BA under lax.cond: skipped until the map has >2 keyframes
    def do_ba_fn(st):
        prob = build_local_problem(st, kf_slot, cfg, n_free, n_fixed)
        kf_Tcw, mp_pos, inlier = local_ba.solve_ba(
            prob, calib.T_rc, calib.K, calib.bf, phases=phases)
        return apply_ba_result(st, prob, kf_Tcw, mp_pos, inlier, cfg)

    state = jax.lax.cond(state.n_kf > 2, do_ba_fn, lambda st: st, state)
    state = cull_keyframes(state, kf_slot, cfg)
    # capacity lifecycle: evict the weakest non-recent points when the
    # store runs hot (telemetry in state.n_alloc_failed either way)
    M = state.mp_pos.shape[0]
    state = jax.lax.cond(
        state.n_mp > int(0.90 * M),
        lambda st: ms.relieve_capacity(st, target_free=max(M // 10, 64)),
        lambda st: st, state)
    return update_point_geometry(state, cfg)


@partial(jax.jit, static_argnums=(2,))
def cull_map_points(
    state: ms.MapState, current_frame_id: jnp.ndarray, cfg: SlamConfig
) -> ms.MapState:
    """Remove low-quality recent points.

    Reference rules (LocalMapping.cc:225-270), with age measured in
    keyframes inserted since creation as the reference does (mnFirstKFid vs
    current KF id): found/visible ratio < 0.25, or >= 2 KFs old with <= 3
    weighted observations; points older than 3 KFs graduate and are kept.
    """
    M = state.mp_pos.shape[0]
    ratio = state.mp_found.astype(jnp.float32) / jnp.maximum(
        state.mp_visible.astype(jnp.float32), 1.0)
    # KFs inserted since the point's creation
    age_kf = jnp.sum(
        (state.kf_frame_id[None, :] > state.mp_first_frame[:, None])
        & state.kf_valid[None, :],
        axis=-1,
    )
    wobs = ms.mp_weighted_obs(state)
    bad = (ratio < 0.25) | ((age_kf >= 2) & (wobs <= 3))
    # grace period: only points still in their probation window get culled
    probation = age_kf <= 3
    kill = state.mp_valid & bad & probation
    mp_valid = state.mp_valid & ~kill
    # drop observations of killed points
    killed_of = kill[jnp.clip(state.kf_mp, 0, M - 1)] & (state.kf_mp >= 0)
    kf_mp = jnp.where(killed_of, -1, state.kf_mp)
    n_killed = jnp.sum(kill.astype(jnp.int32))
    return state._replace(
        mp_valid=mp_valid, kf_mp=kf_mp, n_mp=state.n_mp - n_killed
    )


# ---------------------------------------------------------------------------
# Keyframe culling (reference LocalMapping::KeyFrameCulling, :966-1038)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(2, 3))
def cull_keyframes(
    state: ms.MapState, center_kf: jnp.ndarray, cfg: SlamConfig,
    max_victims: int = 6,
) -> ms.MapState:
    """Discard redundant local keyframes (multi-victim, octave-aware).

    Reference rule (LocalMapping::KeyFrameCulling, LocalMapping.cc:966-1038):
    for each covisibility neighbor of `center_kf`, a CLOSE map point
    (0 < depth < thDepth, the RGB-D gate at :996) is redundant if >= 3 OTHER
    keyframes observe it at the same-or-finer pyramid octave
    (scaleLevel_other <= scaleLevel_here + 1); the keyframe is erased when
    > 90% of its close points are redundant.  The reference erases every
    passing neighbor in one serial loop, each erasure immediately shrinking
    later candidates' support counts; we reproduce that serial semantics as
    a lax.scan over the top-`max_victims` candidates ordered by redundancy
    ratio — a per-point level-histogram is built once, and each accepted
    victim subtracts its own observations from it before the next candidate
    is judged, so mutually-redundant keyframe pairs cannot cull each other.
    Never culls slot 0 (the map origin) or the center keyframe itself.
    """
    K, C, F = state.kf_mp.shape
    M = state.mp_pos.shape[0]
    L = cfg.n_levels
    has = ((state.kf_mp >= 0) & state.kf_feat_valid
           & state.kf_valid[:, None, None])
    close = (state.kf_depth > 0) & (state.kf_depth < cfg.th_depth)
    lvl = jnp.clip(state.kf_level, 0, L - 1)
    # per-point observation count at each pyramid level, over ALL keyframes
    lin = jnp.clip(state.kf_mp, 0, M - 1) * L + lvl          # [K, C, F]
    idx = jnp.where(has, lin, M * L).reshape(-1)
    lvl_cnt = jnp.zeros(M * L + 1, jnp.int32).at[idx].add(
        has.reshape(-1).astype(jnp.int32))

    # per-(keyframe, camera) point -> observation level (127 = none): lets
    # a candidate subtract its OWN per-point observation count over BOTH
    # cameras rather than a constant 1 — a dual-camera self-observation is
    # not an independent supporter (the reference counts observers among
    # OTHER keyframes only, LocalMapping.cc:996-1027)
    k_idx = jnp.broadcast_to(jnp.arange(K)[:, None, None], (K, C, F))
    c_idx = jnp.broadcast_to(jnp.arange(C)[None, :, None], (K, C, F))
    pt_idx = jnp.where(has, jnp.clip(state.kf_mp, 0, M - 1), M)
    lvl_of = jnp.full((K, C, M + 1), 127, jnp.int32).at[
        k_idx, c_idx, pt_idx].min(jnp.where(has, lvl, 127))[:, :, :M]

    def kf_ratio(lvl_cnt, s):
        """Redundant-close-point ratio of keyframe slot s under lvl_cnt."""
        m_s = jnp.clip(state.kf_mp[s], 0, M - 1)             # [C, F]
        cnt = lvl_cnt[:-1].reshape(M, L)[m_s]                # [C, F, L]
        sup_mask = jnp.arange(L) <= (lvl[s] + 1)[..., None]  # [C, F, L]
        # self-observations of the same point (any camera) at qualifying
        # level, to subtract from the histogram total
        self_sup = jnp.sum(
            (lvl_of[s][:, m_s] <= (lvl[s] + 1)[None]).astype(jnp.int32),
            axis=0)                                          # [C, F]
        sup = jnp.sum(jnp.where(sup_mask, cnt, 0), axis=-1) - self_sup
        ok = has[s] & close[s]
        red = ok & (sup >= 3)
        n_pts = jnp.sum(ok.astype(jnp.int32))
        n_red = jnp.sum(red.astype(jnp.int32))
        return n_red.astype(jnp.float32) / jnp.maximum(
            n_pts.astype(jnp.float32), 1.0)

    W = ms.covisibility(state)
    neighbor = W[center_kf] >= 15.0
    cand = (state.kf_valid & neighbor
            & (jnp.arange(K) != 0) & (jnp.arange(K) != center_kf))
    ratio0 = jax.vmap(lambda s: kf_ratio(lvl_cnt, s))(
        jnp.arange(K, dtype=jnp.int32))
    order_score = jnp.where(cand, ratio0, -1.0)
    _, victims = jax.lax.top_k(order_score, max_victims)
    vic_ok = order_score[victims] > 0.0  # only plausible candidates

    def step(carry, xs):
        kf_valid, lvl_cnt, n_culled = carry
        s, ok = xs
        r = kf_ratio(lvl_cnt, s)
        do = ok & (r > 0.9) & kf_valid[s]
        # subtract this KF's observations from the level histogram so the
        # next candidate no longer counts it as a supporter
        sub = has[s] & do
        idx_s = jnp.where(sub, lin[s], M * L).reshape(-1)
        lvl_cnt = lvl_cnt.at[idx_s].add(
            -sub.reshape(-1).astype(jnp.int32))
        kf_valid = kf_valid.at[s].set(kf_valid[s] & ~do)
        return (kf_valid, lvl_cnt, n_culled + do.astype(jnp.int32)), do

    (kf_valid, _, n_culled), dos = jax.lax.scan(
        step, (state.kf_valid, lvl_cnt, jnp.asarray(0, jnp.int32)),
        (victims, vic_ok))
    # erase the victims' observation rows
    erased = jnp.zeros(K, bool).at[victims].max(dos)
    kf_mp = jnp.where(erased[:, None, None], -1, state.kf_mp)
    return state._replace(
        kf_valid=kf_valid, kf_mp=kf_mp,
        n_kf=state.n_kf - n_culled,
    )
