"""Map-point fusion between covisible keyframes.

Replaces `LocalMapping::SearchInNeighbors` + `ORBmatcher::Fuse`
(src/LocalMapping.cc:700-792, src/ORBmatcher.cc:1986-2191): project map
points into a target keyframe's cameras; where a projected point lands on a
feature that already observes another point, merge the two (keep the one
with more observations, reference MapPoint::Replace src/MapPoint.cc:258-296);
where it lands on a free feature, add the observation.

All cameras are searched at once (the reference projects into both cameras
sequentially, ORBmatcher.cc:2030-2158).

Rotation-histogram note: the reference's `Fuse` applies NO rotation
histogram — `grep rotHist` over src/ORBmatcher.cc:1986-2191 is empty
(verified; the histogram lives in the keypoint-to-keypoint matchers,
e.g. SearchByBoW :223-381 and frame-projection :3448-3641, where both
sides carry an IC angle).  A fuse query is a 3D landmark with no
orientation, so there is no angle delta to histogram; the reference's
actual orientation defense here is the 60-degree viewing-angle gate
(ORBmatcher.cc:2073 "Viewing angle must be less than 60 deg"), which this
module applies identically through `use_view_cos=True` in
search_points_in_frame (frustum_check view_cos_limit=0.5).

Deferred-merge design: a fuse group (e.g. the 5+1
targets of SearchInNeighbors) accumulates loser->winner redirections in ONE
[M] replacement table; each step rewrites only its target keyframe row and
redirects its lookups through the table, and the O(K*C*F) full-store remap +
per-row dedupe runs ONCE at the end of the group instead of once per
target.  The sequential merge
semantics of the reference's serial loop are preserved: losers are
invalidated immediately, later steps see earlier merges through the table,
and the weighted observation counter that decides merge direction is
CARRIED through the group — a merge rolls the loser's count into the
winner at once (MapPoint::Replace moves observations immediately,
src/MapPoint.cc:258-296) — so in-group winner decisions match the
reference's serial semantics without a full-store recount per step.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..ops import search
from . import map_state as ms


def _fuse_step(
    state: ms.MapState,
    pts: search.LocalPoints,
    kf_t: jnp.ndarray,
    replace_tot: jnp.ndarray,  # [M] raw id -> live id (path-compressed)
    obs_cnt: jnp.ndarray,      # [M] int32 weighted obs count at LIVE ids,
                               # maintained incrementally across the group
    cfg: SlamConfig,
    calib: cam_mod.CameraParams,
    match_raw: jnp.ndarray | None = None,  # [C, F] precomputed matches
):
    """One fusion target: match, add observations, record merges.

    Touches only the target row of `kf_mp`; merge effects on the rest of the
    store are deferred to `_finalize_merges` via `replace_tot`.  The
    observation counter is carried: a merge rolls the loser's count into
    the winner immediately (MapPoint::Replace moves observations,
    src/MapPoint.cc:258-296), so later in-group winner decisions see the
    absorbed observations without a full-store recount (an
    mp_weighted_obs scatter over the whole [K, C, F] store).
    """
    M = cfg.max_mp
    K, C, F = state.kf_mp.shape
    if match_raw is None:
        # points that lost an earlier merge in this group are dead: skip
        g = jnp.clip(pts.idx, 0, M - 1)
        pts = pts._replace(valid=pts.valid & state.mp_valid[g])
        match_raw, _ = search.search_points_in_frame(
            pts,
            state.kf_xy_und[kf_t], state.kf_uright[kf_t],
            state.kf_level[kf_t],
            state.kf_desc[kf_t], state.kf_feat_valid[kf_t],
            jnp.zeros((C, F), bool),
            state.kf_Tcw[kf_t], calib.T_rc, calib.K, calib.bf,
            cfg.width, cfg.height, cfg.scale_factor, cfg.n_levels,
            th_radius=3.0, nn_ratio=1.0,  # Fuse: no ratio test (TH_LOW only)
            th_hamming=50, use_view_cos=True,
        )
    # redirect both sides through the accumulated merges so conflicts are
    # detected between LIVE landmark ids (a precomputed match against a
    # point merged away earlier in the group redirects to its winner)
    match_mp = jnp.where(
        match_raw >= 0, replace_tot[jnp.clip(match_raw, 0, M - 1)], -1)
    cur_raw = state.kf_mp[kf_t]                    # [C, F]
    cur_mp = jnp.where(
        cur_raw >= 0, replace_tot[jnp.clip(cur_raw, 0, M - 1)], -1)
    new_obs = (match_mp >= 0) & (cur_mp < 0)
    conflict = (match_mp >= 0) & (cur_mp >= 0) & (match_mp != cur_mp)

    # --- add observations on free features; dedupe THIS row only (in the
    # redirected id space, preferring features already on the final id) ---
    row = jnp.where(new_obs, match_mp, cur_raw)
    row_red = jnp.where(row >= 0, replace_tot[jnp.clip(row, 0, M - 1)], -1)
    row_dd = ms.dedupe_obs_rows(row_red, prefer_keep=(row_red == row))
    row = jnp.where(row_dd < 0, -1, row)
    kf_mp = state.kf_mp.at[kf_t].set(row)

    # incremental count update for this row: features that gained an
    # observation (+w), features the dedupe dropped (-w); stereo obs
    # weigh 2 (MapPoint::nObs semantics, src/MapPoint.cc:161-164)
    w_feat = jnp.where(state.kf_uright[kf_t] >= 0, 2, 1).astype(jnp.int32)
    added = (row >= 0) & (cur_raw < 0)
    removed = (cur_raw >= 0) & (row < 0)
    add_at = jnp.where(added, row, M - 1).reshape(-1)        # live ids
    obs_cnt = obs_cnt.at[add_at].add(
        jnp.where(added, w_feat, 0).reshape(-1))
    rem_at = jnp.where(removed, cur_mp, M - 1).reshape(-1)   # live ids
    obs_cnt = obs_cnt.at[rem_at].add(
        -jnp.where(removed, w_feat, 0).reshape(-1))

    # --- merge conflicting pairs: loser -> winner by observation count ---
    # Winner by a STRICT total order (obs count, then lower slot id): both
    # orientations of the same pair agree, so no merge cycles can form.
    a = jnp.where(conflict, match_mp, 0)
    b = jnp.where(conflict, cur_mp, 0)
    key = obs_cnt * M + (M - jnp.arange(M, dtype=jnp.int32))
    a_wins = key[a] > key[b]
    winner = jnp.where(a_wins, a, b)
    loser = jnp.where(a_wins, b, a)
    replace = jnp.arange(M, dtype=jnp.int32)
    cfl = conflict.reshape(-1)
    lfl = jnp.where(conflict, loser, M - 1).reshape(-1)
    wfl = jnp.where(cfl, winner.reshape(-1), replace[lfl])
    replace = replace.at[lfl].set(jnp.where(cfl, wfl, replace[lfl]))
    # path compression: chains (c->b->a) terminate because edges strictly
    # increase the order key (DAG); 4 halvings cover depth 16
    for _ in range(4):
        replace = replace[replace]

    # losers die now (so later steps in the group skip them); their
    # found/visible/observation counters roll into the final winner
    is_loser = replace != jnp.arange(M, dtype=jnp.int32)
    wfin = replace[lfl]
    mp_found = state.mp_found.at[jnp.where(cfl, wfin, M - 1)].add(
        jnp.where(cfl, state.mp_found[lfl], 0))
    mp_visible = state.mp_visible.at[jnp.where(cfl, wfin, M - 1)].add(
        jnp.where(cfl, state.mp_visible[lfl], 0))
    obs_cnt = obs_cnt.at[jnp.where(cfl, wfin, M - 1)].add(
        jnp.where(cfl, obs_cnt[lfl], 0))
    mp_valid = state.mp_valid & ~is_loser
    n_merged = jnp.sum(is_loser.astype(jnp.int32))

    # compose into the group table (replace maps live->live, so the result
    # stays depth-1 / path-compressed)
    replace_tot = replace[replace_tot]

    state = state._replace(
        kf_mp=kf_mp, mp_valid=mp_valid,
        mp_found=mp_found, mp_visible=mp_visible,
        n_mp=state.n_mp - n_merged,
    )
    return state, replace_tot, obs_cnt, n_merged


def _finalize_merges(
    state: ms.MapState, replace_tot: jnp.ndarray
) -> ms.MapState:
    """Apply a fuse group's accumulated merges to the whole store.

    Remap every observation to its live landmark, then erase observations
    the remap made redundant: a (KF, camera) row keeps at most ONE feature
    per landmark, preferring the feature that already observed the winner
    over a remapped loser (MapPoint::Replace erases exactly these,
    src/MapPoint.cc:258-296 — keeping an arbitrary duplicate leaves
    wrong-pixel observations that drag points in BA).
    """
    M = state.mp_pos.shape[0]
    K, C, F = state.kf_mp.shape
    raw = state.kf_mp
    red = jnp.where(raw >= 0, replace_tot[jnp.clip(raw, 0, M - 1)], raw)
    # Narrowed dedupe: the store is dedupe-clean before the group (every
    # row writer — keyframe insertion, fuse steps, BA erasure — preserves
    # the invariant), so ONLY rows the remap changed can have gained a
    # duplicate.  Those are few (rows observing a merged-away loser);
    # gather them, dedupe the small batch, scatter back instead of a
    # full-store [K*C, F] argsort per keyframe.  Falls back to the full pass in
    # the (rare) case more rows changed than the small batch covers.
    flat_red = red.reshape(K * C, F)
    flat_raw = raw.reshape(K * C, F)
    changed = jnp.any(flat_red != flat_raw, axis=-1)
    n_changed = jnp.sum(changed.astype(jnp.int32))
    NR = min(48, K * C)
    _, rows_sel = jax.lax.top_k(
        changed.astype(jnp.int32) * (1 << 20) - jnp.arange(K * C), NR)
    sub_red = flat_red[rows_sel]
    sub_dd = ms.dedupe_obs_rows(
        sub_red, prefer_keep=(sub_red == flat_raw[rows_sel]))
    sub_out = jnp.where(changed[rows_sel][:, None], sub_dd, sub_red)

    kf_mp = jax.lax.cond(
        n_changed <= NR,
        lambda: flat_red.at[rows_sel].set(sub_out).reshape(K, C, F),
        lambda: ms.dedupe_obs_rows(red, prefer_keep=(red == raw)))
    # forward pointers so stale frame matches can be redirected
    # (MapPoint::Replace keeps mpReplaced, src/MapPoint.cc:258-296)
    is_loser = replace_tot != jnp.arange(M, dtype=jnp.int32)
    mp_replaced = jnp.where(is_loser, replace_tot, state.mp_replaced)
    return state._replace(kf_mp=kf_mp, mp_replaced=mp_replaced)


@partial(jax.jit, static_argnums=(3,))
def fuse_into_kf(
    state: ms.MapState,
    src_mask: jnp.ndarray,     # [M] candidate map points to project
    kf_t: jnp.ndarray,         # target keyframe slot
    cfg: SlamConfig,
    calib: cam_mod.CameraParams,
):
    """Project masked points into keyframe kf_t; add observations / merge."""
    M = cfg.max_mp
    pts = search.gather_local_points(
        state, src_mask & state.mp_valid, cfg.local_cap)
    rep0 = jnp.arange(M, dtype=jnp.int32)
    state, rep, _, n_merged = _fuse_step(
        state, pts, kf_t, rep0, ms.mp_weighted_obs(state), cfg, calib)
    return _finalize_merges(state, rep), n_merged


@partial(jax.jit, static_argnums=(3,))
def fuse_into_kfs(
    state: ms.MapState,
    src_mask: jnp.ndarray,     # [M] candidate map points to project
    kf_slots: jnp.ndarray,     # [Kc] int32 target slots; pad with K-1
    cfg: SlamConfig,
    calib: cam_mod.CameraParams,
):
    """Fuse masked points into a BATCH of keyframes in one dispatch.

    lax.scan over the slot batch keeps the sequential merge semantics of
    per-KF fusion (later targets see earlier merges through the deferred
    replacement table) while costing one device round trip instead of Kc,
    and the full-store remap+dedupe runs once, not per target.  Padding
    entries use the reserved dummy slot K-1, whose features are never
    valid — a guaranteed no-op.  Used by loop closing to fuse loop
    landmarks across the WHOLE corrected neighborhood (reference
    SearchAndFuse, src/LoopClosing.cc:824-856).
    """
    M = cfg.max_mp
    pts = search.gather_local_points(
        state, src_mask & state.mp_valid, cfg.local_cap)
    rep0 = jnp.arange(M, dtype=jnp.int32)
    cnt0 = ms.mp_weighted_obs(state)

    def step(carry, slot):
        st, rep, cnt = carry
        st, rep, cnt, n = _fuse_step(st, pts, slot, rep, cnt, cfg, calib)
        return (st, rep, cnt), n

    (state, rep, _), ns = jax.lax.scan(step, (state, rep0, cnt0), kf_slots)
    return _finalize_merges(state, rep), jnp.sum(ns)


@partial(jax.jit, static_argnums=(3, 4))
def fuse_neighbors(
    state: ms.MapState, kf_slot, calib: cam_mod.CameraParams, cfg: SlamConfig,
    n_neighbors: int = 5,
):
    """Two-direction fusion with the top covisible neighbors — ONE dispatch.

    Reference SearchInNeighbors: current KF's points into neighbors, then
    neighbors' points into the current KF (src/LocalMapping.cc:700-792).
    Neighbor top-k and both directions run on device; both directions share
    one deferred replacement table, finalized once.  Empty ranks map to the
    reserved no-op dummy slot K-1.
    """
    M = cfg.max_mp
    K, C, F = state.kf_mp.shape
    W = ms.covisibility(state)
    w, nbrs = jax.lax.top_k(W[kf_slot], n_neighbors)
    ok = w > 0
    slots = jnp.where(ok, nbrs, K - 1).astype(jnp.int32)
    kf_slot = jnp.asarray(kf_slot, jnp.int32)
    rep0 = jnp.arange(M, dtype=jnp.int32)
    cnt0 = ms.mp_weighted_obs(state)

    # direction 1: this KF's points into each neighbor.  The MATCHING is
    # independent of the merge bookkeeping (projection uses keyframe poses
    # and point positions, neither of which a fuse step mutates), so all
    # n_neighbors searches run BATCHED in one vmap; only the cheap merge
    # bookkeeping stays a sequential scan (later fuses see earlier merges
    # through the replacement table — a match against a merged-away loser
    # redirects to its winner inside _fuse_step).
    own = state.kf_mp[kf_slot].reshape(-1)
    own_mask = jnp.zeros(M, bool).at[
        jnp.where(own >= 0, own, M - 1)].max(own >= 0)
    pts_own = search.gather_local_points(
        state, own_mask & state.mp_valid, cfg.local_cap)

    def match_one(slot):
        m, _ = search.search_points_in_frame(
            pts_own,
            state.kf_xy_und[slot], state.kf_uright[slot],
            state.kf_level[slot],
            state.kf_desc[slot], state.kf_feat_valid[slot],
            jnp.zeros((C, F), bool),
            state.kf_Tcw[slot], calib.T_rc, calib.K, calib.bf,
            cfg.width, cfg.height, cfg.scale_factor, cfg.n_levels,
            th_radius=3.0, nn_ratio=1.0, th_hamming=50, use_view_cos=True)
        return m

    match_all = jax.vmap(match_one)(slots)          # [Kc, C, F]

    def step(carry, xs):
        st, rep, cnt = carry
        slot, mraw = xs
        st, rep, cnt, n = _fuse_step(st, pts_own, slot, rep, cnt, cfg,
                                     calib, match_raw=mraw)
        return (st, rep, cnt), n

    (state, rep, cnt), ns = jax.lax.scan(
        step, (state, rep0, cnt0), (slots, match_all))

    # direction 2: neighbors' points into this KF (redirect the mask through
    # the table so winners of direction-1 merges are projected, not losers)
    rows = state.kf_mp[slots]                       # [Kc, C, F], raw ids
    rows = jnp.where(rows >= 0, rep[jnp.clip(rows, 0, M - 1)], rows)
    rows = rows.reshape(n_neighbors, -1)
    rows_ok = (rows >= 0) & ok[:, None]
    neigh_mask = jnp.zeros(M, bool).at[
        jnp.where(rows_ok, rows, M - 1).reshape(-1)].max(rows_ok.reshape(-1))
    pts_n = search.gather_local_points(
        state, neigh_mask & state.mp_valid, cfg.local_cap)
    state, rep, cnt, n2 = _fuse_step(state, pts_n, kf_slot, rep, cnt,
                                     cfg, calib)
    return _finalize_merges(state, rep), jnp.sum(ns) + n2
