"""Data-association searches as dense masked batched ops.

Replaces the reference `ORBmatcher` search family (include/ORBmatcher.h:44-115)
with dense batched kernels.  Key differences from the C++ design:

- No 48x64 feature grid: candidate gating is a dense masked window test over
  the fixed [F] feature axis of each camera (a [Nq, F] comparison fuses into
  the Hamming distance pass).
- The per-camera forward/backward + cross-camera transfer logic of
  `SearchByProjection(Frame&, Frame&, ...)` (src/ORBmatcher.cc:3448-3641)
  becomes: transform every query point into every camera via the rig
  extrinsics and run all cameras in one batch.
- BoW-gated KF<->frame matching (src/ORBmatcher.cc:206-388) is replaced by
  full brute-force mutual-best Hamming matching — affordable dense compute on
  an accelerator, strictly more complete than node-gated search.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..mapping import map_state as ms
from . import hamming

BIG = hamming.BIG


class LocalPoints(NamedTuple):
    """Compacted local map points gathered for a frame search (capacity L)."""

    idx: jnp.ndarray       # [L] map-point slot ids (-1 pad)
    pos: jnp.ndarray       # [L, 3]
    desc: jnp.ndarray      # [L, 8]
    normal: jnp.ndarray    # [L, 3]
    min_dist: jnp.ndarray  # [L]
    max_dist: jnp.ndarray  # [L]
    valid: jnp.ndarray     # [L] bool
    rel: jnp.ndarray | None = None  # [L] relevance of each point (higher
                                    # first; -inf pad) — kept so a cached
                                    # superset can be re-ranked per frame
                                    # without touching the [M] arrays


def _gather_point_records(state: ms.MapState, g: jnp.ndarray):
    """Gather (pos, desc, normal, min_dist, max_dist) for point slots `g`.

    The five per-point columns are packed into ONE [M, 16] f32 record
    (uint32 descriptors bitcast to f32 ride along losslessly) so the
    batch costs a single gather: each separate gather pays this backend's
    fixed dispatch/latency floor regardless of payload, and this runs
    2-3x per mapping stage plus once per keyframe on the tracker side.
    """
    rec = jnp.concatenate([
        state.mp_pos,
        state.mp_normal,
        state.mp_min_dist[:, None],
        state.mp_max_dist[:, None],
        jax.lax.bitcast_convert_type(state.mp_desc, jnp.float32),
    ], axis=-1)                                 # [M, 16]
    got = rec[g]
    return (got[:, 0:3], got[:, 3:6], got[:, 6], got[:, 7],
            jax.lax.bitcast_convert_type(got[:, 8:16], jnp.uint32))


def gather_local_points(
    state: ms.MapState, mask: jnp.ndarray, cap: int,
    priority: jnp.ndarray | None = None,
) -> LocalPoints:
    """Compact up to `cap` masked map points into a dense batch.

    `priority` ([M] float, higher first) ranks points when more than `cap`
    are masked.  Without it the selection falls back to slot order — which
    is ALLOCATION order, so on trajectories that leave old structure behind
    (circuits, corridors) the stale oldest points would crowd the currently
    visible ones out of the batch (observed: cam-0 local-map inliers
    collapsing 36 -> 1 the moment the map outgrew the cap on the circuit
    scenario).  The reference searches the full unbounded local set
    (src/Tracking.cc:1702-1770); a relevance-ranked cap is the fixed-shape
    equivalent.
    """
    if priority is not None:
        key = jnp.where(mask, priority.astype(jnp.float32), -jnp.inf)
        kv, order = jax.lax.top_k(key, cap)
        sel_valid = mask[order]
        idx = jnp.where(sel_valid, order, -1)
        rel = jnp.where(sel_valid, kv, -jnp.inf)
    else:
        score = mask.astype(jnp.int32)
        # stable selection of masked points: rank by (mask, index)
        _, order = jax.lax.top_k(
            score * (1 << 20) - jnp.arange(score.shape[0]), cap)
        sel_valid = mask[order]
        idx = jnp.where(sel_valid, order, -1)
        rel = jnp.where(sel_valid,
                        -jnp.arange(cap, dtype=jnp.float32), -jnp.inf)
    g = jnp.clip(order, 0, None)
    pos, normal, min_d, max_d, desc = _gather_point_records(state, g)
    return LocalPoints(
        idx=idx, pos=pos, desc=desc, normal=normal,
        min_dist=min_d, max_dist=max_d, valid=sel_valid, rel=rel,
    )


def resolve_feature_conflicts(
    best_feat: jnp.ndarray, best_dist: jnp.ndarray, q_ok: jnp.ndarray, n_feat: int
):
    """Per-feature winner among queries that chose it.

    Returns (feat_q [F] int32 winning query index or -1).

    Sort-based: pack (feat, dist, query) into one key, sort, keep the first
    entry of each feature group, then ONE scatter builds the feature-indexed
    output, in place of a scatter-min + scatter-max + scatter-guard trio.
    """
    nq = best_feat.shape[0]
    # pack: feat (<=2^12) | dist (<=2^9 after clip) | query (<=2^?) -- use
    # int64-free packing within int32 ranges via two-level sort key
    dist_c = jnp.clip(best_dist, 0, 511)
    key = jnp.where(q_ok, best_feat, n_feat).astype(jnp.int32) * 512 + dist_c
    # stable sort: ties (same feat+dist) resolve to the lowest query index
    order = jnp.argsort(key, stable=True)
    sf = jnp.where(q_ok, best_feat, n_feat)[order]
    first = jnp.concatenate([jnp.ones(1, bool), sf[1:] != sf[:-1]])
    win = first & (sf < n_feat)
    q_sorted = order
    feat_q = jnp.full((n_feat,), -1, jnp.int32).at[
        jnp.where(win, sf, n_feat - 1)
    ].max(jnp.where(win, q_sorted.astype(jnp.int32), -1))
    # the dummy writes only ever write -1, so no guard scatter is needed
    return feat_q


def search_points_in_frame(
    pts: LocalPoints,
    frame_xy_und: jnp.ndarray,    # [C, F, 2]
    frame_uright: jnp.ndarray,    # [C, F]
    frame_level: jnp.ndarray,     # [C, F]
    frame_desc: jnp.ndarray,      # [C, F, 8]
    frame_valid: jnp.ndarray,     # [C, F]
    frame_taken: jnp.ndarray,     # [C, F] bool: slots already matched
    Tcw: jnp.ndarray,             # [4, 4] rig pose
    T_rc: jnp.ndarray,            # [C, 4, 4]
    K: jnp.ndarray,               # [C, 4]
    bf: jnp.ndarray,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
    th_radius: float = 4.0,
    nn_ratio: float = 0.9,
    th_hamming: int = hamming.TH_HIGH,
    level_slack: int = 1,
    use_view_cos: bool = True,
):
    """Project map points into all rig cameras and match to frame features.

    The core of `SearchByProjection(Frame&, vector<MapPoint*>&, th)`
    (src/ORBmatcher.cc:62-149) and `Tracking::SearchLocalPoints`
    (src/Tracking.cc:1702-1770), run for all cameras at once.

    Returns:
      match_mp: [C, F] int32 map-point slot per frame feature (-1 none)
      visible: [L] bool frustum-visible mask (for IncreaseVisible)
    """
    C = frame_xy_und.shape[0]
    F = frame_xy_und.shape[1]
    L = pts.pos.shape[0]
    sf = jnp.asarray([scale_factor ** l for l in range(n_levels)], jnp.float32)

    def per_cam(c):
        Tcam = T_rc[c] @ Tcw
        mask, uv, invz, dist, view_cos = cam_mod.frustum_check(
            K[c], Tcam, pts.pos, width, height,
            0.8 * pts.min_dist, 1.2 * pts.max_dist, pts.normal,
            view_cos_limit=0.5 if use_view_cos else -2.0,
        )
        mask = mask & pts.valid
        lvl = ms.predict_scale(dist, pts.max_dist, scale_factor, n_levels)
        # radius scales with predicted level; tighter when viewed head-on
        # (reference RadiusByViewingCos, ORBmatcher.cc:151-157)
        r_view = jnp.where(view_cos > 0.998, 2.5, 4.0)
        radius = th_radius / 4.0 * r_view * sf[lvl]
        ur_proj = uv[:, 0] - bf * invz

        du = jnp.abs(uv[:, 0, None] - frame_xy_und[c, None, :, 0])
        dv = jnp.abs(uv[:, 1, None] - frame_xy_und[c, None, :, 1])
        in_win = (du < radius[:, None]) & (dv < radius[:, None])
        lv_ok = (
            (frame_level[c][None, :] >= lvl[:, None] - level_slack)
            & (frame_level[c][None, :] <= lvl[:, None] + level_slack)
        )
        # stereo gate when the feature has a virtual right coord
        dur = jnp.abs(ur_proj[:, None] - frame_uright[c][None, :])
        ur_ok = (frame_uright[c][None, :] < 0) | (dur < radius[:, None])
        cand = (
            in_win & lv_ok & ur_ok
            & frame_valid[c][None, :]
            & (~frame_taken[c])[None, :]
            & mask[:, None]
        )
        d = hamming.pairwise_hamming(pts.desc, frame_desc[c])  # [L, F]
        bi, bd, b2 = hamming.masked_argmin2(d, cand)
        # best level for ratio test (reference applies ratio only when the
        # two best live on the same level, ORBmatcher.cc:135-140)
        blvl = frame_level[c][bi]
        d_no_best = jnp.where(
            jax.nn.one_hot(bi, F, dtype=bool), BIG, jnp.where(cand, d, BIG)
        )
        b2i = jnp.argmin(d_no_best, axis=-1)
        same_lvl = frame_level[c][b2i] == blvl
        ratio_ok = ~same_lvl | (bd.astype(jnp.float32) <= nn_ratio * b2.astype(jnp.float32))
        ok = (bd <= th_hamming) & ratio_ok & (bd < BIG)
        return bi, bd, ok, mask

    bi, bd, ok, vis = jax.vmap(per_cam)(jnp.arange(C))
    # resolve conflicts per camera
    match_mp = []
    for c in range(C):
        feat_q = resolve_feature_conflicts(bi[c], bd[c], ok[c], F)
        mp_of_feat = jnp.where(feat_q >= 0, pts.idx[jnp.clip(feat_q, 0, L - 1)], -1)
        match_mp.append(mp_of_feat)
    visible = jnp.any(vis, axis=0)
    return jnp.stack(match_mp), visible


def search_prev_frame(
    prev_pw: jnp.ndarray,        # [C, F, 3] world points of prev features
    prev_pw_valid: jnp.ndarray,  # [C, F]
    prev_desc: jnp.ndarray,      # [C, F, 8]
    prev_level: jnp.ndarray,     # [C, F]
    prev_angle: jnp.ndarray,     # [C, F]
    prev_mp: jnp.ndarray,        # [C, F] map-point ids of prev matches (-1 ok)
    frame_xy_und: jnp.ndarray,   # [C, F, 2]
    frame_uright: jnp.ndarray,   # [C, F]
    frame_level: jnp.ndarray,    # [C, F]
    frame_angle: jnp.ndarray,    # [C, F]
    frame_desc: jnp.ndarray,     # [C, F, 8]
    frame_valid: jnp.ndarray,    # [C, F]
    Tcw: jnp.ndarray,
    T_rc: jnp.ndarray,
    K: jnp.ndarray,
    bf: jnp.ndarray,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
    th_radius: float = 7.0,
    check_rotation: bool = True,
):
    """Frame-to-frame projection search for motion-model tracking.

    Covers `SearchByProjection(Frame&, Frame&, th, bMono, Calib)`
    (src/ORBmatcher.cc:3448-3641) including its cross-camera point transfer:
    each previous-frame 3D point is projected into EVERY current camera.

    Returns (match_src [C, F] int32 flattened prev index (c*F+f) per current
    feature or -1, match_pw [C, F, 3] the matched world point).
    """
    C, F = frame_valid.shape
    sf = jnp.asarray([scale_factor ** l for l in range(n_levels)], jnp.float32)
    # flatten prev features across cameras: queries [Q = C*F]
    Q = C * F
    pw = prev_pw.reshape(Q, 3)
    q_valid = prev_pw_valid.reshape(Q)
    q_desc = prev_desc.reshape(Q, 8)
    q_level = prev_level.reshape(Q)
    q_angle = prev_angle.reshape(Q)

    def per_cam(c):
        Tcam = T_rc[c] @ Tcw
        Xc = se3.transform_points(Tcam, pw)
        z_ok = Xc[:, 2] > 0.1
        uv = cam_mod.project(K[c], Xc)
        inb = cam_mod.in_image(uv, width, height)
        invz = 1.0 / jnp.maximum(Xc[:, 2], 1e-6)
        ur_proj = uv[:, 0] - bf * invz
        radius = th_radius * sf[q_level]
        du = jnp.abs(uv[:, 0, None] - frame_xy_und[c, None, :, 0])
        dv = jnp.abs(uv[:, 1, None] - frame_xy_und[c, None, :, 1])
        in_win = (du < radius[:, None]) & (dv < radius[:, None])
        lv_ok = (
            (frame_level[c][None, :] >= q_level[:, None] - 1)
            & (frame_level[c][None, :] <= q_level[:, None] + 1)
        )
        dur = jnp.abs(ur_proj[:, None] - frame_uright[c][None, :])
        ur_ok = (frame_uright[c][None, :] < 0) | (dur < radius[:, None])
        cand = (
            in_win & lv_ok & ur_ok
            & frame_valid[c][None, :]
            & (q_valid & z_ok & inb)[:, None]
        )
        d = hamming.pairwise_hamming(q_desc, frame_desc[c])
        bi, bd, _ = hamming.masked_argmin2(d, cand)
        ok = bd <= hamming.TH_HIGH
        if check_rotation:
            delta = q_angle - frame_angle[c][bi]
            ok = hamming.rotation_histogram_filter(delta, ok)
        return bi, bd, ok

    bi, bd, ok = jax.vmap(per_cam)(jnp.arange(C))
    match_src = []
    for c in range(C):
        feat_q = resolve_feature_conflicts(bi[c], bd[c], ok[c], F)
        match_src.append(feat_q)
    match_src = jnp.stack(match_src)  # [C, F] query index into flattened prev
    src = jnp.clip(match_src, 0, Q - 1)
    match_pw = jnp.where((match_src >= 0)[..., None], pw[src], 0.0)
    prev_mp_flat = prev_mp.reshape(Q)
    match_mp = jnp.where(match_src >= 0, prev_mp_flat[src], -1)
    return match_src, match_pw, match_mp


def match_frame_kf_brute(
    kf_desc: jnp.ndarray,     # [C, F, 8]
    kf_feat_valid: jnp.ndarray,
    kf_mp: jnp.ndarray,       # [C, F]
    kf_angle: jnp.ndarray,
    frame_desc: jnp.ndarray,  # [C, F, 8]
    frame_valid: jnp.ndarray,
    frame_angle: jnp.ndarray,
    th: int = hamming.TH_LOW,
    nn_ratio: float = 0.7,
    check_rotation: bool = True,
):
    """Reference-keyframe matching (BoW-search replacement).

    Covers `SearchByBoW(KeyFrame*, Frame&, ...)` (src/ORBmatcher.cc:206-388):
    the reference gates candidate pairs by shared vocabulary node; here a
    full [F, F] Hamming matrix per camera is cheap, so we brute-force with
    mutual-best + ratio + rotation checks.  Same-camera matching only, as in
    the reference (it iterates the per-camera descriptor stacks).

    Returns match_mp [C, F]: map-point id for each frame feature.
    """
    C, F = frame_valid.shape

    def per_cam(c):
        has_mp = kf_mp[c] >= 0
        cand = (kf_feat_valid[c] & has_mp)[:, None] & frame_valid[c][None, :]
        d = hamming.pairwise_hamming(kf_desc[c], frame_desc[c])
        bi, bd, b2 = hamming.masked_argmin2(d, cand)
        ok = (bd <= th) & (
            bd.astype(jnp.float32) <= nn_ratio * b2.astype(jnp.float32)
        )
        if check_rotation:
            delta = kf_angle[c] - frame_angle[c][bi]
            ok = hamming.rotation_histogram_filter(delta, ok)
        return bi, bd, ok

    out = []
    for c in range(C):
        bi, bd, ok = per_cam(c)
        feat_q = resolve_feature_conflicts(bi, bd, ok, F)
        mp = jnp.where(feat_q >= 0, kf_mp[c][jnp.clip(feat_q, 0, F - 1)], -1)
        out.append(mp)
    return jnp.stack(out)
