"""Tracking: the per-frame state machine.

Re-designs the reference `Tracking` class (src/Tracking.cc:339-675 Track())
as a host-side state machine over a small set of jitted stage functions:

- stereo/RGB-D initialization (reference StereoInitialization,
  src/Tracking.cc:680-826)
- motion-model tracking: project last frame's points, match, motion-only BA
  (reference TrackWithMotionModel, src/Tracking.cc:1235-1328)
- reference-keyframe fallback via brute-force descriptor matching
  (reference TrackReferenceKeyFrame, src/Tracking.cc:1060-1119)
- local-map tracking: covisibility-local points, projection search, second
  pose optimization (reference TrackLocalMap + SearchLocalPoints,
  src/Tracking.cc:1340-1405, 1702-1770)
- keyframe decision + insertion with new close map points
  (reference NeedNewKeyFrame / CreateNewKeyFrame, src/Tracking.cc:1411-1696)

All heavy work is inside jit with static shapes; the host reads only a few
scalars per frame (match counts, tracking state).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig, inv_sigma2_of_level
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..mapping import map_state as ms
from ..ops import hamming, orb, search
from ..optim import pose_opt
from . import frame as frame_mod


def unproject_features(
    fr: frame_mod.FrameData, Tcw: jnp.ndarray, calib: cam_mod.CameraParams
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """World positions of all frame features with depth.

    Reference: Frame::UnprojectStereo_camid (src/Frame.cc:1054-1097) —
    camera-frame backprojection mapped through the rig extrinsic and the
    inverse rig pose.
    """
    C = fr.xy.shape[0]
    pw_list = []
    ok_list = []
    for c in range(C):
        Tcam = calib.T_rc[c] @ Tcw
        Twc = se3.inverse(Tcam)
        xc = cam_mod.backproject(calib.K[c], fr.xy_und[c], fr.depth[c])
        pw = se3.transform_points(Twc, xc)
        ok = fr.valid[c] & (fr.depth[c] > 0)
        pw_list.append(pw)
        ok_list.append(ok)
    return jnp.stack(pw_list), jnp.stack(ok_list)


def _pose_obs_from_matches(
    fr: frame_mod.FrameData, pw: jnp.ndarray, matched: jnp.ndarray, cfg: SlamConfig
) -> pose_opt.PoseObs:
    """Flatten [C, F] matches into a PoseObs batch."""
    C, F = matched.shape
    cam_idx = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[:, None], (C, F))
    uvr = jnp.concatenate([fr.xy_und, fr.uright[..., None]], axis=-1)
    return pose_opt.PoseObs(
        pw=pw.reshape(C * F, 3),
        uvr=uvr.reshape(C * F, 3),
        cam_idx=cam_idx.reshape(C * F),
        inv_sigma2=inv_sigma2_of_level(fr.level, cfg).reshape(C * F),
        mask=matched.reshape(C * F),
    )


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(3,))
def initialize_map(
    state: ms.MapState,
    fr: frame_mod.FrameData,
    calib: cam_mod.CameraParams,
    cfg: SlamConfig,
    frame_id: jnp.ndarray,
):
    """StereoInitialization: first KF at identity + map points from depth
    in all cameras (reference src/Tracking.cc:680-826)."""
    Tcw = jnp.eye(4, dtype=jnp.float32)
    state, frame_mp = insert_keyframe_impl(
        state, fr, Tcw, jnp.full(fr.valid.shape, -1, jnp.int32), calib, cfg,
        frame_id, unlimited_new=True,
    )
    return state, Tcw, frame_mp


# ---------------------------------------------------------------------------
# Keyframe insertion (shared by init and CreateNewKeyFrame)
# ---------------------------------------------------------------------------


def insert_keyframe_impl(
    state: ms.MapState,
    fr: frame_mod.FrameData,
    Tcw: jnp.ndarray,
    frame_mp: jnp.ndarray,      # [C, F] matched map points of this frame
    calib: cam_mod.CameraParams,
    cfg: SlamConfig,
    frame_id: jnp.ndarray,
    unlimited_new: bool = False,
):
    """Write the frame as a keyframe; create new close-depth map points.

    Reference: KeyFrame ctor copy of `_total` arrays (src/KeyFrame.cc:31-84)
    + CreateNewKeyFrame's close-point creation (src/Tracking.cc:1525-1696,
    depth-sorted, cap 100/camera) + StereoInitialization when
    `unlimited_new`.
    """
    C, F = fr.valid.shape
    k = jnp.argmin(state.kf_valid)  # first free slot
    # drop stale ids (merged/culled points) before they enter the map
    frame_mp = ms.resolve_mp_ids(state, frame_mp)

    # --- new map point candidates: valid depth, no existing match ---
    close = (fr.depth > 0) & fr.valid & (frame_mp < 0)
    if not unlimited_new:
        close = close & (fr.depth < cfg.th_depth)
        # cap per camera, nearest first (reference sorts by depth, cap 100)
        cap = cfg.new_mp_per_cam
        score = jnp.where(close, -fr.depth, -jnp.inf)
        _, sel = jax.lax.top_k(score, cap)  # [C, cap] nearest per camera
        keep = jnp.zeros((C, F), bool)
        keep = keep.at[jnp.arange(C)[:, None], sel].set(
            jnp.take_along_axis(close, sel, axis=1)
        )
        close = keep

    pw_all, _ = unproject_features(fr, Tcw, calib)  # [C, F, 3]
    want = close.reshape(-1)
    slots = ms.allocate_mp_slots(state.mp_valid, want)  # [C*F]
    created = slots >= 0
    n_failed = jnp.sum((want & ~created).astype(jnp.int32))
    new_mp_grid = jnp.where(created, slots, -1).reshape(C, F)
    kf_mp_new = jnp.where(frame_mp >= 0, frame_mp, new_mp_grid)
    # fusion forward-pointers can map two frame features onto one landmark;
    # a keyframe keeps one observation per landmark per camera (the
    # reference's per-KF observation map, src/MapPoint.cc:138-150)
    kf_mp_new = ms.dedupe_obs_rows(kf_mp_new)

    # rig camera centers for normals / scale ranges
    centers = []
    for c in range(C):
        centers.append(se3.camera_center(calib.T_rc[c] @ Tcw))
    centers = jnp.stack(centers)  # [C, 3]
    cam_of_flat = jnp.broadcast_to(
        jnp.arange(C, dtype=jnp.int32)[:, None], (C, F)
    ).reshape(-1)
    pw_flat = pw_all.reshape(-1, 3)
    po = pw_flat - centers[cam_of_flat]
    dist = jnp.linalg.norm(po, axis=-1)
    normal = po / jnp.maximum(dist[:, None], 1e-9)
    min_d, max_d = ms.scale_range_from_obs(
        dist, fr.level.reshape(-1), cfg.scale_factor, cfg.n_levels
    )
    tgt = jnp.where(created, slots, cfg.max_mp - 1)
    put = created
    mp_pos = state.mp_pos.at[tgt].set(
        jnp.where(put[:, None], pw_flat, state.mp_pos[tgt]))
    mp_valid = state.mp_valid.at[tgt].set(put | state.mp_valid[tgt])
    desc_flat = fr.desc.reshape(-1, 8)
    mp_desc = state.mp_desc.at[tgt].set(
        jnp.where(put[:, None], desc_flat, state.mp_desc[tgt]))
    mp_normal = state.mp_normal.at[tgt].set(
        jnp.where(put[:, None], normal, state.mp_normal[tgt]))
    mp_min = state.mp_min_dist.at[tgt].set(jnp.where(put, min_d, state.mp_min_dist[tgt]))
    mp_max = state.mp_max_dist.at[tgt].set(jnp.where(put, max_d, state.mp_max_dist[tgt]))
    mp_first_kf = state.mp_first_kf.at[tgt].set(jnp.where(put, k, state.mp_first_kf[tgt]))
    mp_first_frame = state.mp_first_frame.at[tgt].set(
        jnp.where(put, frame_id, state.mp_first_frame[tgt]))
    # seed the descriptor buffer
    mp_descbuf = state.mp_descbuf.at[tgt, 0].set(
        jnp.where(put[:, None], desc_flat, state.mp_descbuf[tgt, 0]))
    mp_descbuf_n = state.mp_descbuf_n.at[tgt].set(
        jnp.where(put, 1, state.mp_descbuf_n[tgt]))
    mp_visible = state.mp_visible.at[tgt].set(jnp.where(put, 1, state.mp_visible[tgt]))
    mp_found = state.mp_found.at[tgt].set(jnp.where(put, 1, state.mp_found[tgt]))

    # --- push observation descriptors of existing matches into buffers ---
    obs_flat = kf_mp_new.reshape(-1)
    has_obs = (obs_flat >= 0) & ~created  # existing points observed again
    ot = jnp.where(has_obs, obs_flat, cfg.max_mp - 1)
    slot_in_buf = jnp.where(has_obs, mp_descbuf_n[ot] % ms.DESC_BUF, 0)
    mp_descbuf = mp_descbuf.at[ot, slot_in_buf].set(
        jnp.where(has_obs[:, None], desc_flat, mp_descbuf[ot, slot_in_buf]))
    mp_descbuf_n = mp_descbuf_n.at[ot].add(has_obs.astype(jnp.int32))
    # refresh distinctive descriptors for all points (cheap batched op)
    mp_desc = jnp.where(
        mp_valid[:, None], ms.update_mp_descriptor(mp_descbuf, mp_descbuf_n), mp_desc
    )

    # --- write the keyframe ---
    new_state = state._replace(
        kf_Tcw=state.kf_Tcw.at[k].set(Tcw),
        kf_valid=state.kf_valid.at[k].set(True),
        kf_frame_id=state.kf_frame_id.at[k].set(frame_id),
        kf_xy_und=state.kf_xy_und.at[k].set(fr.xy_und),
        kf_uright=state.kf_uright.at[k].set(fr.uright),
        kf_depth=state.kf_depth.at[k].set(fr.depth),
        kf_level=state.kf_level.at[k].set(fr.level),
        kf_angle=state.kf_angle.at[k].set(fr.angle),
        kf_desc=state.kf_desc.at[k].set(fr.desc),
        kf_feat_valid=state.kf_feat_valid.at[k].set(fr.valid),
        kf_mp=state.kf_mp.at[k].set(kf_mp_new),
        mp_pos=mp_pos,
        mp_valid=mp_valid,
        mp_desc=mp_desc,
        mp_descbuf=mp_descbuf,
        mp_descbuf_n=mp_descbuf_n,
        mp_normal=mp_normal,
        mp_min_dist=mp_min,
        mp_max_dist=mp_max,
        mp_first_kf=mp_first_kf,
        mp_first_frame=mp_first_frame,
        mp_visible=mp_visible,
        mp_found=mp_found,
        n_kf=state.n_kf + 1,
        n_mp=state.n_mp + jnp.sum(created.astype(jnp.int32)),
        next_kf_id=state.next_kf_id + 1,
        n_alloc_failed=state.n_alloc_failed + n_failed,
    )
    # NOTE: normals/scale ranges of re-observed points are refreshed by the
    # mapping stage (update_point_geometry), not here -- it is a full-map
    # pass and must not run on the per-frame tracking path
    return new_state, kf_mp_new


@partial(jax.jit, static_argnums=(1,))
def update_point_geometry(state: ms.MapState, cfg: SlamConfig) -> ms.MapState:
    """Recompute mean viewing normal and scale-invariance range per point.

    Reference: MapPoint::UpdateNormalAndDepth (src/MapPoint.cc:480-557),
    batched over the whole map via scatter-adds.
    """
    K, C, F = state.kf_mp.shape
    M = state.mp_pos.shape[0]
    obs = state.kf_mp.reshape(K, C * F)
    valid = (obs >= 0) & state.kf_valid[:, None] & state.kf_feat_valid.reshape(K, C * F)
    tgt = jnp.where(valid, obs, M - 1)
    # per-(kf,cam) centers: need T_rc; centers of rig cam0 suffice for
    # normals when rig extrinsics are small; for exactness we use rig body
    # center (cam0) as the reference anchors normals to cam1's center too
    # (KeyFrame::GetCameraCenter vs _cam2; difference is the small baseline).
    Ow = se3.camera_center(state.kf_Tcw)  # [K, 3]
    po = state.mp_pos[tgt] - Ow[:, None, :]
    dist = jnp.linalg.norm(po, axis=-1)
    n = po / jnp.maximum(dist[..., None], 1e-9)
    w = valid.astype(jnp.float32)
    nsum = jnp.zeros((M, 3), jnp.float32).at[tgt.reshape(-1)].add(
        (n * w[..., None]).reshape(-1, 3))
    cnt = jnp.zeros((M,), jnp.float32).at[tgt.reshape(-1)].add(w.reshape(-1))
    normal = nsum / jnp.maximum(cnt[:, None], 1e-9)
    normal = normal / jnp.maximum(jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)

    # reference uses the *reference keyframe* (first obs) for the depth range;
    # we approximate with the most recent observation's stats via max-scatter
    level = state.kf_level.reshape(K, C * F)
    min_d, max_d = ms.scale_range_from_obs(
        dist, level, cfg.scale_factor, cfg.n_levels
    )
    # take the observation from the first (creating) keyframe when possible:
    # approximate with mean over observations
    mind_sum = jnp.zeros((M,), jnp.float32).at[tgt.reshape(-1)].add((min_d * w).reshape(-1))
    maxd_sum = jnp.zeros((M,), jnp.float32).at[tgt.reshape(-1)].add((max_d * w).reshape(-1))
    mind = mind_sum / jnp.maximum(cnt, 1e-9)
    maxd = maxd_sum / jnp.maximum(cnt, 1e-9)
    has = cnt > 0
    return state._replace(
        mp_normal=jnp.where(has[:, None], normal, state.mp_normal),
        mp_min_dist=jnp.where(has, mind, state.mp_min_dist),
        mp_max_dist=jnp.where(has, maxd, state.mp_max_dist),
    )


# ---------------------------------------------------------------------------
# Per-frame tracking stages
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(7,))
def track_motion_model(
    state: ms.MapState,
    prev: frame_mod.FrameData,
    prev_Tcw: jnp.ndarray,
    prev_mp: jnp.ndarray,
    velocity: jnp.ndarray,
    cur: frame_mod.FrameData,
    calib: cam_mod.CameraParams,
    cfg: SlamConfig,
):
    """Motion-model tracking: search prev-frame points, pose-optimize.

    Reference TrackWithMotionModel (src/Tracking.cc:1235-1328). The temporal
    'visual odometry' points the reference creates in UpdateLastFrame
    (src/Tracking.cc:1126-1233) are subsumed: every prev feature with depth
    participates, map point or not.
    """
    Tcw_pred = velocity @ prev_Tcw
    # CheckReplacedInLastFrame (Tracking.cc:1020): redirect/drop stale ids
    prev_mp = ms.resolve_mp_ids(state, prev_mp)
    prev_pw, prev_ok = unproject_features(prev, prev_Tcw, calib)
    match_src, match_pw, match_mp = search.search_prev_frame(
        prev_pw, prev_ok, prev.desc, prev.level, prev.angle, prev_mp,
        cur.xy_und, cur.uright, cur.level, cur.angle, cur.desc, cur.valid,
        Tcw_pred, calib.T_rc, calib.K, calib.bf,
        cfg.width, cfg.height, cfg.scale_factor, cfg.n_levels,
        th_radius=7.0,
    )
    matched = match_src >= 0
    n_matches = jnp.sum(matched.astype(jnp.int32))
    obs = _pose_obs_from_matches(cur, match_pw, matched, cfg)
    # The velocity prediction centers the SEARCH windows only; the pose
    # optimization starts from the previous pose.  Initializing at the
    # prediction couples the optimizer's residual init-dependence into the
    # constant-velocity extrapolation, a positive-feedback loop that
    # geometrically amplifies pose noise (observed ~2.3x/frame on static
    # scenes).  With a prev-pose init the loop gain drops to ~0 while the
    # matcher still benefits from the motion prior.
    Tcw, inlier, n_inl = pose_opt.optimize_pose(
        prev_Tcw, obs, calib.T_rc, calib.K, calib.bf
    )
    # frame map-point assignment for inlier matches that were map points
    inl_grid = inlier.reshape(matched.shape)
    frame_mp = jnp.where(matched & inl_grid, match_mp, -1)
    # inliers that correspond to MAP points (not temporal VO points): the
    # reference requires >= 10 of these or falls back to reference-KF
    # tracking (Tracking.cc:1310-1326) — the defense against aliased
    # matches confirming a wrong motion prediction
    n_map_inl = jnp.sum((frame_mp >= 0).astype(jnp.int32))
    return Tcw, frame_mp, n_matches, n_inl, n_map_inl


@partial(jax.jit, static_argnums=(5,))
def track_reference_kf(
    state: ms.MapState,
    ref_kf: jnp.ndarray,
    prev_Tcw: jnp.ndarray,
    cur: frame_mod.FrameData,
    calib: cam_mod.CameraParams,
    cfg: SlamConfig,
):
    """Fallback: match against the reference keyframe's map points.

    Reference TrackReferenceKeyFrame (src/Tracking.cc:1060-1119) with
    brute-force matching standing in for SearchByBoW.
    """
    frame_mp = search.match_frame_kf_brute(
        state.kf_desc[ref_kf], state.kf_feat_valid[ref_kf],
        state.kf_mp[ref_kf], state.kf_angle[ref_kf],
        cur.desc, cur.valid, cur.angle,
        th=hamming.TH_LOW, nn_ratio=0.7,
    )
    matched = frame_mp >= 0
    n_matches = jnp.sum(matched.astype(jnp.int32))
    pw = state.mp_pos[jnp.clip(frame_mp, 0, cfg.max_mp - 1)]
    obs = _pose_obs_from_matches(cur, pw, matched & state.mp_valid[
        jnp.clip(frame_mp, 0, cfg.max_mp - 1)], cfg)
    Tcw, inlier, n_inl = pose_opt.optimize_pose(
        prev_Tcw, obs, calib.T_rc, calib.K, calib.bf
    )
    inl_grid = inlier.reshape(matched.shape)
    frame_mp = jnp.where(matched & inl_grid, frame_mp, -1)
    return Tcw, frame_mp, n_matches, n_inl


@partial(jax.jit, static_argnums=(2,))
def build_local_points_cache(
    state: ms.MapState, anchor_slot: jnp.ndarray, cfg: SlamConfig
) -> search.LocalPoints:
    """Local-map point batch anchored on a keyframe (normally the newest).

    Reference UpdateLocalKeyFrames/Points (src/Tracking.cc:1778-1949)
    rebuilds the local set from the CURRENT frame's matches every frame.
    The set only changes materially when the reference keyframe changes, so
    this build runs once per keyframe insertion (and after mapping/loop
    corrections) instead of on the per-frame hot path: local keyframes =
    those sharing observations with the anchor KF, local points = their
    points, relevance-ranked by the observing KF's covisibility weight so
    the most relevant points fill the capped batch first (a top_k over
    max_mp and 6 full gathers, paid per keyframe instead of per frame).

    The gather takes a SUPERSET (4x local_cap): per frame, track_local_map
    re-ranks the superset excluding points already matched in that frame
    (cheap [S]-sized top_k).  Capping at local_cap here would waste most of
    the batch on the anchor's own points — which the motion model has
    usually already matched — and starve the search of fresh candidates
    (observed: 138/240 frames lost on the outward circuit with a
    tight-capped cache).
    """
    M = cfg.max_mp
    K, C, F = state.kf_mp.shape
    amp = state.kf_mp[anchor_slot].reshape(-1)
    in_anchor = jnp.zeros(M, bool).at[
        jnp.where(amp >= 0, amp, M - 1)].max(amp >= 0)
    # KF weights: shared observation counts with the anchor
    kf_obs = state.kf_mp.reshape(K, -1)
    kf_w = jnp.sum(
        jnp.where((kf_obs >= 0) & state.kf_valid[:, None],
                  in_anchor[jnp.clip(kf_obs, 0, M - 1)], False).astype(jnp.int32),
        axis=-1,
    )
    # local KFs: any sharing (reference caps at 80 KFs)
    n_local = 80
    _, local_kfs = jax.lax.top_k(kf_w, min(n_local, K))
    local_ok = kf_w[local_kfs] > 0
    lk = jnp.where(local_ok, local_kfs, 0)
    obs_of_local = state.kf_mp[lk].reshape(local_ok.shape[0], -1)
    obs_valid = (obs_of_local >= 0) & local_ok[:, None]
    tgt = jnp.where(obs_valid, obs_of_local, M - 1).reshape(-1)
    local_mask = jnp.zeros(M, bool).at[tgt].max(obs_valid.reshape(-1))
    local_mask = local_mask & state.mp_valid
    # relevance ranking for the capped gather: a point inherits the largest
    # share weight among the local keyframes observing it, so the points of
    # the KFs most covisible with the anchor fill the batch first (the
    # reference searches the full unbounded local set)
    w_row = kf_w[lk].astype(jnp.float32)
    rel = jnp.zeros(M, jnp.float32).at[tgt].max(
        jnp.where(obs_valid, w_row[:, None], -jnp.inf).reshape(-1))
    cap = min(4 * cfg.local_cap, cfg.max_mp)
    return search.gather_local_points(state, local_mask, cap, priority=rel)


@partial(jax.jit, static_argnums=(6,))
def track_local_map(
    state: ms.MapState,
    Tcw: jnp.ndarray,
    cur: frame_mod.FrameData,
    frame_mp: jnp.ndarray,
    pts: search.LocalPoints,
    calib: cam_mod.CameraParams,
    cfg: SlamConfig,
):
    """Local-map tracking (reference TrackLocalMap, src/Tracking.cc:1340-1405).

    `pts` is the per-keyframe cached local point batch
    (build_local_points_cache); this per-frame stage only re-validates it
    against the live map (culled/merged points drop out) and excludes points
    already matched by motion-model tracking, then searches + runs the final
    pose optimization.
    """
    M = cfg.max_mp
    # mark current frame's points: cached points already matched in this
    # frame must not search for a second feature
    fmp = frame_mp.reshape(-1)
    in_frame = jnp.zeros(M, bool).at[jnp.where(fmp >= 0, fmp, M - 1)].max(fmp >= 0)
    gi = jnp.clip(pts.idx, 0, M - 1)
    ok = pts.valid & state.mp_valid[gi] & ~in_frame[gi]
    if pts.idx.shape[0] > cfg.local_cap:
        # re-rank the cached superset for THIS frame: drop in-frame /
        # culled points first so the whole search budget goes to fresh
        # candidates, exactly like the old per-frame gather — but over the
        # [S] superset instead of the [M] map (S-sized top_k + row
        # gathers; the [M]-wide scatters/top_k live in the per-KF build)
        key = jnp.where(ok, pts.rel, -jnp.inf)
        _, sel = jax.lax.top_k(key, cfg.local_cap)
        ok_s = ok[sel]
        gsel = jnp.clip(pts.idx[sel], 0, M - 1)
        pts = search.LocalPoints(
            idx=jnp.where(ok_s, pts.idx[sel], -1),
            pos=state.mp_pos[gsel],
            desc=pts.desc[sel],
            normal=pts.normal[sel],
            min_dist=pts.min_dist[sel],
            max_dist=pts.max_dist[sel],
            valid=ok_s,
        )
    else:
        pts = pts._replace(valid=ok, pos=state.mp_pos[gi])
    taken = frame_mp >= 0
    new_mp, visible = search.search_points_in_frame(
        pts, cur.xy_und, cur.uright, cur.level, cur.desc, cur.valid, taken,
        Tcw, calib.T_rc, calib.K, calib.bf,
        cfg.width, cfg.height, cfg.scale_factor, cfg.n_levels,
        th_radius=4.0, nn_ratio=0.8,
    )
    merged = jnp.where(frame_mp >= 0, frame_mp, new_mp)
    matched = merged >= 0
    pw = state.mp_pos[jnp.clip(merged, 0, M - 1)]
    obs = _pose_obs_from_matches(
        cur, pw, matched & state.mp_valid[jnp.clip(merged, 0, M - 1)], cfg
    )
    Tcw_out, inlier, n_inl = pose_opt.optimize_pose(
        Tcw, obs, calib.T_rc, calib.K, calib.bf
    )
    inl_grid = inlier.reshape(matched.shape)
    final_mp = jnp.where(matched & inl_grid, merged, -1)

    # visibility / found bookkeeping (reference IncreaseVisible/Found)
    vis_idx = jnp.where(pts.valid & visible, pts.idx, M - 1)
    mp_visible = state.mp_visible.at[vis_idx].add(
        (pts.valid & visible).astype(jnp.int32))
    fm = final_mp.reshape(-1)
    mp_found = state.mp_found.at[jnp.where(fm >= 0, fm, M - 1)].add(
        (fm >= 0).astype(jnp.int32))
    state = state._replace(mp_visible=mp_visible, mp_found=mp_found)

    # close-point statistics for NeedNewKeyFrame (Tracking.cc:1464-1477):
    # tracked close points vs untracked close depth candidates
    close = (cur.depth > 0) & (cur.depth < cfg.th_depth) & cur.valid
    n_close_tracked = jnp.sum((close & (final_mp >= 0)).astype(jnp.int32))
    n_close_untracked = jnp.sum((close & (final_mp < 0)).astype(jnp.int32))
    return state, Tcw_out, final_mp, n_inl, n_close_tracked, n_close_untracked


# ---------------------------------------------------------------------------
# Fused per-frame step (single dispatch, zero host syncs)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(9,))
def track_frame_fused(
    state: ms.MapState,
    prev: frame_mod.FrameData,
    prev_Tcw: jnp.ndarray,
    prev_mp: jnp.ndarray,
    velocity: jnp.ndarray,
    tstate: jnp.ndarray,       # [3] int32: last_kf_frame, ref_kf_tracked,
                               #            only_tracking flag
    local_pts: search.LocalPoints,
    cur: frame_mod.FrameData,
    calib: cam_mod.CameraParams,
    cfg: SlamConfig,
    frame_id: jnp.ndarray,
):
    """One whole tracking frame as ONE device dispatch.

    Motion-model tracking, conditional reference-KF fallback, local-map
    tracking, the NeedNewKeyFrame decision, and conditional keyframe
    insertion all run on-device (`lax.cond`), so the host performs zero
    synchronizations on the hot path — it reads back one small scalar pack
    one frame later, and the frame costs one dispatch instead of several.

    Returns (new_state, Tcw, frame_mp, velocity_new, tstate_new,
    scalars [8] int32: [ok, n_inl, inserted, kf_slot, n_kf,
    n_close_tracked, n_close_untracked, n_matches]).
    """
    last_kf_frame = tstate[0]
    ref_kf_tracked = tstate[1]
    only_tracking = tstate[2] > 0

    Tcw1, fmp1, n_match1, n_inl1, n_map_inl1 = track_motion_model(
        state, prev, prev_Tcw, prev_mp, velocity, cur, calib, cfg)

    use_fallback = (n_inl1 < cfg.min_matches_motion) | (n_map_inl1 < 10)
    ref_kf = jnp.argmax(
        jnp.where(state.kf_valid, state.kf_frame_id, -1))

    def do_fallback(_):
        T, f, nm, ni = track_reference_kf(
            state, ref_kf, prev_Tcw, cur, calib, cfg)
        return T, f, nm, ni

    def keep(_):
        return Tcw1, fmp1, n_match1, n_inl1

    Tcw2, fmp2, n_match2, n_inl2 = jax.lax.cond(
        use_fallback, do_fallback, keep, None)
    pre_ok = n_inl2 >= cfg.min_matches_motion

    state3, Tcw3, fmp3, n_inl3, n_ct, n_cu = track_local_map(
        state, Tcw2, cur, fmp2, local_pts, calib, cfg)
    ok = pre_ok & (n_inl3 >= cfg.min_inliers_track)

    # keyframe decision (NeedNewKeyFrame) on device
    since_kf = frame_id - last_kf_frame
    C, F = cur.desc.shape[0], cur.desc.shape[1]
    tct, tcu = close_point_thresholds(cfg, C * F)
    need_close = (n_ct < tct) & (n_cu > tcu)
    weak_abs = (cfg.kf_weak_abs if cfg.kf_weak_abs > 0
                else 2 * cfg.min_inliers_track)
    weak = (n_inl3 < (cfg.kf_ref_ratio
                      * jnp.maximum(ref_kf_tracked, 1).astype(jnp.float32))
            ) | (n_inl3 < weak_abs)
    capacity = state3.n_kf < cfg.max_kf - 1
    need_kf = (
        ok & ~only_tracking & capacity & (n_inl3 > 15)
        & ((since_kf >= cfg.max_frames_kf)
           | ((since_kf >= cfg.min_frames_kf) & (weak | need_close)))
    )

    def do_insert(st):
        new_state, kf_mp = insert_keyframe_impl(
            st, cur, Tcw3, fmp3, calib, cfg, frame_id, unlimited_new=False)
        slot = jnp.argmax(
            jnp.where(new_state.kf_valid, new_state.kf_frame_id, -1))
        return new_state, kf_mp, slot.astype(jnp.int32), jnp.asarray(1, jnp.int32)

    def no_insert(st):
        return st, fmp3, jnp.asarray(-1, jnp.int32), jnp.asarray(0, jnp.int32)

    state4, fmp4, kf_slot, inserted = jax.lax.cond(
        need_kf, do_insert, no_insert, state3)

    Tcw_out = jnp.where(ok, Tcw3, prev_Tcw)
    vel_out = jnp.where(ok, Tcw3 @ se3.inverse(prev_Tcw),
                        jnp.eye(4, dtype=Tcw3.dtype))
    tstate_new = jnp.stack([
        jnp.where(inserted > 0, frame_id, last_kf_frame),
        jnp.where(inserted > 0, n_inl3, ref_kf_tracked),
        tstate[2],
    ])
    scalars = jnp.stack([
        ok.astype(jnp.int32), n_inl3, inserted, kf_slot,
        state4.n_kf, n_ct, n_cu, n_match2,
    ])
    # trajectory bookkeeping outputs: the current reference keyframe and
    # its pose, so the host records Tcr without dispatching an extra
    # per-frame gather; also always fresher than the host's
    # pipelined-lagging slot
    ref_slot_out = jnp.argmax(
        jnp.where(state4.kf_valid, state4.kf_frame_id, -1)).astype(jnp.int32)
    ref_pose_out = state4.kf_Tcw[ref_slot_out]
    # the reference KF's frame id rides along so the export path can detect
    # slot recycling (a culled ref KF whose slot was reused would otherwise
    # anchor the recorded relative pose to an arbitrary new keyframe)
    ref_fid_out = state4.kf_frame_id[ref_slot_out]
    return (state4, Tcw_out, fmp4, vel_out, tstate_new, scalars,
            ref_slot_out, ref_pose_out, ref_fid_out)


@partial(jax.jit, static_argnums=(10,))
def track_frame_fused_images(
    state: ms.MapState,
    prev: frame_mod.FrameData,
    prev_Tcw: jnp.ndarray,
    prev_mp: jnp.ndarray,
    velocity: jnp.ndarray,
    tstate: jnp.ndarray,
    local_pts: search.LocalPoints,
    grays: jnp.ndarray,
    depths: jnp.ndarray,
    calib: cam_mod.CameraParams,
    cfg: SlamConfig,
    frame_id: jnp.ndarray,
):
    """Fused step INCLUDING frame building: images in, everything out.

    One device dispatch covers ORB extraction, undistortion, depth
    association, the whole tracking cascade, and conditional keyframe
    insertion — the minimum-dispatch per-frame path.
    """
    fr = frame_mod.build_frame(grays, depths, calib, cfg.orb)
    out = track_frame_fused(
        state, prev, prev_Tcw, prev_mp, velocity, tstate, local_pts, fr,
        calib, cfg, frame_id)
    return (fr,) + tuple(out)


def close_point_thresholds(cfg: SlamConfig, total_feat: int):
    """bNeedToInsertClose thresholds (Tracking.cc:1464-1477: 100 / 70),
    auto-scaled from the reference's 1000+500 feature budget to ours when
    the config leaves them at -1.  Static (python ints) under jit."""
    scale = total_feat / 1500.0
    tct = cfg.kf_close_tracked if cfg.kf_close_tracked > 0 else int(
        round(100 * scale))
    tcu = cfg.kf_close_untracked if cfg.kf_close_untracked > 0 else int(
        round(70 * scale))
    return tct, tcu


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class Tracker:
    """Host orchestration of the jitted stages (one device sync per frame)."""

    def __init__(self, calib: cam_mod.CameraParams, cfg: SlamConfig,
                 pipelined: bool = False, pipeline_depth: int = 1):
        self.calib = calib
        self.cfg = cfg
        self.kf_inserted_cb = None
        self.reset_cb = None  # notified on reset (System: loop-closer reset)
        self.reloc_cb = None  # fn(FrameData) -> (ok, Tcw, frame_mp, n_inl)
        self.reloc_ready_fn = lambda: True  # is a reloc database usable?
        self.only_tracking = False  # localization mode (System.h:75-78)
        # pipelined: per-frame work is ONE fused device dispatch; status
        # scalars are read back `pipeline_depth` frames later (zero syncs on
        # the hot path).  Depth > 1 keeps that many frames in flight so the
        # readback lands on already-finished work and the host never waits
        # on the device; the
        # mapping stage then runs depth-1 frames after its keyframe, the
        # same lag a free-running mapping thread has in the reference.
        self.pipelined = pipelined
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.fuse_extraction = False
        self.reset()

    def reset(self):
        """Tracking::Reset (src/Tracking.cc:2160-2206): clear the map and
        all per-frame state.  Notifies `reset_cb` so map-consuming stages
        (loop closer: pending GBA, keyframe database) reset with us — the
        early-loss self-reset path reaches here without going through
        System."""
        cfg = self.cfg
        if getattr(self, "reset_cb", None) is not None:
            self.reset_cb()
        self.map = ms.make_empty(cfg.max_kf, cfg.n_cams, cfg.max_feat, cfg.max_mp)
        self.state = TrackState.NOT_INITIALIZED
        self.Tcw = jnp.eye(4, dtype=jnp.float32)
        self.velocity = jnp.eye(4, dtype=jnp.float32)
        self.prev_frame = None
        self.prev_mp = None
        self.prev_Tcw = None
        self.frame_id = 0
        self.last_kf_frame = -999
        self.last_kf_slot = 0
        self.ref_kf_tracked = 0
        self._pending = []         # FIFO of deferred fused-step scalar packs
        self._tstate_dev = None    # device [3]: last_kf_frame, ref_tracked, flag
        self._tstate_dirty = True
        self._local_pts = None     # per-KF cached local point batch
        self._pending_pose_corr = None  # [4,4] right-multiplicative pose fix
        self.last_n_inliers = 0
        # (frame_id, timestamp, ref_kf_slot, Tcr ndarray, lost) — relative to
        # the reference KF so later BA/loop corrections propagate into the
        # saved trajectory (reference mlRelativeFramePoses, Tracking.h:113-118)
        self.trajectory = []

    def invalidate_local_cache(self):
        """Drop the per-KF local point batch; rebuilt lazily next frame.

        Call after any external map replacement (loop correction, GBA
        merge, load_map) in addition to the automatic per-KF refresh."""
        self._local_pts = None

    def queue_pose_correction(self, D):
        """Right-multiplicative correction for the live tracking pose.

        When the mapping/loop stage moves the newest keyframe (local BA
        nudges it; a loop correction JUMPS it, reference
        src/LoopClosing.cc:629-727), the live frame rigidly attached to it
        must follow: T' = T @ D with D = inv(Tcw_kf_old) @ Tcw_kf_new.
        The reference gets this implicitly — its Tracking thread reads the
        corrected reference-KF pose through mlRelativeFramePoses; without
        it, the first frame after a loop closure searches the corrected
        map from the uncorrected pose and drops to LOST (observed on the
        circuit at the loop-closure frame).  Velocity (T_t inv(T_{t-1}))
        is right-multiplication invariant, so it needs no fix."""
        self._pending_pose_corr = (
            D if self._pending_pose_corr is None
            else self._pending_pose_corr @ D)

    def _apply_pose_correction(self):
        if self._pending_pose_corr is None:
            return
        D = self._pending_pose_corr
        self._pending_pose_corr = None
        self.Tcw = self.Tcw @ D
        if self.prev_Tcw is not None:
            self.prev_Tcw = self.prev_Tcw @ D

    def _ensure_local_pts(self):
        if self._local_pts is None:
            self._local_pts = build_local_points_cache(
                self.map, jnp.asarray(self.last_kf_slot, jnp.int32),
                self.cfg)
        return self._local_pts

    def process(self, grays: np.ndarray, depths: np.ndarray,
                timestamp: float | None = None):
        # Optional single-dispatch path (extraction folded into the fused
        # step); opt-in until a GPU measurement picks one path (ROADMAP Y1).
        if (self.pipelined and self.fuse_extraction
                and self.state == TrackState.OK):
            self._drain_pending(keep=self.pipeline_depth - 1)
            if self.state == TrackState.OK:  # resolution may flip to LOST
                self._ts = (timestamp if timestamp is not None
                            else self.frame_id / 30.0)
                return self._process_ok_fused_images(
                    jnp.asarray(grays), jnp.asarray(depths))
        fr = frame_mod.build_frame(
            jnp.asarray(grays), jnp.asarray(depths), self.calib, self.cfg.orb
        )
        return self.process_frame(fr, timestamp)

    def _process_ok_fused_images(self, grays, depths):
        cfg = self.cfg
        if self._tstate_dirty or self._tstate_dev is None:
            self._tstate_dev = jnp.asarray(
                [self.last_kf_frame, self.ref_kf_tracked, 0], jnp.int32)
            self._tstate_dirty = False
        tstate = self._tstate_dev.at[2].set(1 if self.only_tracking else 0)
        fid = jnp.asarray(self.frame_id, jnp.int32)
        (fr, self.map, self.Tcw, frame_mp, self.velocity,
         self._tstate_dev, scalars, ref_slot, ref_pose, ref_fid) = \
            track_frame_fused_images(
                self.map, self.prev_frame, self.prev_Tcw, self.prev_mp,
                self.velocity, tstate, self._ensure_local_pts(), grays,
                depths, self.calib, cfg, fid)
        self.prev_frame, self.prev_mp, self.prev_Tcw = fr, frame_mp, self.Tcw
        self._record(ref_slot, ref_pose, ref_fid)
        self._push_pending(scalars)
        self.frame_id += 1
        return self.state

    def _push_pending(self, scalars):
        try:
            scalars.copy_to_host_async()  # start the RTT now, read later
        except AttributeError:
            pass
        self._pending.append({
            "scalars": scalars,
            "frame_id": self.frame_id,
            "traj_idx": len(self.trajectory) - 1,
        })

    def _resolve_pending(self):
        """Read back every outstanding fused-step scalar pack."""
        self._drain_pending(keep=0)

    def _drain_pending(self, keep: int = 0):
        while len(self._pending) > keep:
            self._resolve_oldest()

    def _resolve_oldest(self):
        if not self._pending:
            return
        pending = self._pending.pop(0)
        scal = np.asarray(pending["scalars"])
        ok, n_inl, inserted, kf_slot, _n_kf, _nct, _ncu, _nm = (
            int(v) for v in scal)
        fid = pending["frame_id"]
        traj_idx = pending["traj_idx"]
        self.last_n_inliers = n_inl
        if not ok:
            self.state = TrackState.LOST
            e = self.trajectory[traj_idx]
            self.trajectory[traj_idx] = e[:4] + (True,)
        if inserted:
            self.last_kf_frame = fid
            self.last_kf_slot = kf_slot
            # weak-tracking reference count: inliers at insertion.  The
            # reference uses TrackedMapPoints(>=minObs) here
            # (ms.kf_tracked_points implements it), but our per-cell top-K
            # redetection refinds only ~78% of even a 1-frame-old KF's
            # points, so inl/TrackedMapPoints sits right AT any fixed
            # ratio threshold and the cadence becomes all-or-nothing;
            # inliers-at-insertion decays from 1.0 and crosses the ratio
            # smoothly, reproducing the reference's effective cadence.
            self.ref_kf_tracked = n_inl
            if self.kf_inserted_cb is not None:
                new_map = self.kf_inserted_cb(kf_slot)
                if new_map is not None:
                    self.map = new_map
            # refresh the local point batch against the post-mapping map
            # (new points, fused/culled points, BA-moved positions)
            self.invalidate_local_cache()
            self._apply_pose_correction()

    def _process_ok_fused(self, fr: frame_mod.FrameData):
        cfg = self.cfg
        if self._tstate_dirty or self._tstate_dev is None:
            self._tstate_dev = jnp.asarray(
                [self.last_kf_frame, self.ref_kf_tracked, 0], jnp.int32)
            self._tstate_dirty = False
        tstate = self._tstate_dev.at[2].set(1 if self.only_tracking else 0)
        fid = jnp.asarray(self.frame_id, jnp.int32)
        (self.map, self.Tcw, frame_mp, self.velocity,
         self._tstate_dev, scalars, ref_slot, ref_pose,
         ref_fid) = track_frame_fused(
            self.map, self.prev_frame, self.prev_Tcw, self.prev_mp,
            self.velocity, tstate, self._ensure_local_pts(), fr, self.calib,
            cfg, fid)
        self.prev_frame, self.prev_mp, self.prev_Tcw = fr, frame_mp, self.Tcw
        self._record(ref_slot, ref_pose, ref_fid)
        self._push_pending(scalars)
        self.frame_id += 1
        return self.state

    def process_frame(self, fr: frame_mod.FrameData,
                      timestamp: float | None = None):
        cfg = self.cfg
        if self.pipelined and self.state == TrackState.OK:
            self._drain_pending(keep=self.pipeline_depth - 1)
        if self.state != TrackState.OK:
            self._resolve_pending()  # settle all in-flight work before
                                     # init/LOST handling
        self._ts = timestamp if timestamp is not None else self.frame_id / 30.0
        fid = jnp.asarray(self.frame_id, jnp.int32)
        if self.state == TrackState.NOT_INITIALIZED:
            n_depth = int(jnp.sum((fr.depth > 0) & fr.valid))
            # reference gate: >500 stereo points with nFeatures=1000
            # (Tracking.cc:682); scale with the configured feature budget
            if n_depth >= min(500, cfg.orb.n_features // 2):
                self.map, self.Tcw, frame_mp = initialize_map(
                    self.map, fr, self.calib, cfg, fid
                )
                self.state = TrackState.OK
                self.prev_frame, self.prev_mp = fr, frame_mp
                self.prev_Tcw = self.Tcw
                self.last_kf_frame = self.frame_id
                self.last_kf_slot = 0
                self.ref_kf_tracked = int(jnp.sum(frame_mp >= 0))
                self._tstate_dirty = True
            self._record()
            self.frame_id += 1
            return self.state

        if self.state == TrackState.LOST:
            relocalized = False
            if self.reloc_cb is not None:
                ok, Tcw, frame_mp, n = self.reloc_cb(fr)
                if ok:
                    relocalized = True
                    self.state = TrackState.OK
                    self.Tcw = Tcw
                    self.velocity = jnp.eye(4, dtype=jnp.float32)
                    self.prev_frame, self.prev_mp = fr, frame_mp
                    self.prev_Tcw = Tcw
                    self.last_n_inliers = n
            if not relocalized:
                # early loss with no way to relocalize: full reset, as the
                # reference does (Tracking.cc:634-642 "Track lost soon after
                # initialisation"); with a usable reloc database we keep the
                # map and keep trying instead
                can_reloc = (self.reloc_cb is not None
                             and self.reloc_ready_fn())
                if (int(self.map.n_kf) <= 5 and not self.only_tracking
                        and not can_reloc):
                    self.reset()
                    return self.process_frame(fr, timestamp)
            self._record()
            self.frame_id += 1
            return self.state

        if self.pipelined:
            return self._process_ok_fused(fr)

        # --- motion-model tracking (or ref-KF fallback) ---
        Tcw, frame_mp, n_match, n_inl, n_map_inl = track_motion_model(
            self.map, self.prev_frame, self.prev_Tcw, self.prev_mp,
            self.velocity, fr, self.calib, cfg,
        )
        n_inl, n_map_inl = (int(v) for v in np.asarray(
            jnp.stack([n_inl, n_map_inl])))
        if n_inl < cfg.min_matches_motion or n_map_inl < 10:
            Tcw, frame_mp, n_match, n_inl = track_reference_kf(
                self.map, jnp.asarray(self.last_kf_slot), self.prev_Tcw,
                fr, self.calib, cfg,
            )
            n_inl = int(n_inl)
        if n_inl < cfg.min_matches_motion:
            self.state = TrackState.LOST
            self._record()
            self.frame_id += 1
            return self.state

        # --- local map tracking ---
        (self.map, Tcw, frame_mp, n_inl,
         n_close_tracked, n_close_untracked) = track_local_map(
            self.map, Tcw, fr, frame_mp, self._ensure_local_pts(),
            self.calib, cfg
        )
        n_inl, n_close_tracked, n_close_untracked = (int(v) for v in
            np.asarray(jnp.stack([n_inl, n_close_tracked,
                                  n_close_untracked])))
        if n_inl < cfg.min_inliers_track:
            self.state = TrackState.LOST
            self._record()
            self.frame_id += 1
            return self.state

        self.state = TrackState.OK
        self.velocity = Tcw @ se3.inverse(self.prev_Tcw)
        self.Tcw = Tcw
        self.last_n_inliers = n_inl

        # --- keyframe decision (NeedNewKeyFrame, Tracking.cc:1411-1518) ---
        since_kf = self.frame_id - self.last_kf_frame
        # need close points: few tracked close + enough untracked candidates
        # (the reference's bNeedToInsertClose, Tracking.cc:1477)
        tct, tcu = close_point_thresholds(
            cfg, cfg.n_cams * fr.desc.shape[1])
        need_close = (n_close_tracked < tct and n_close_untracked > tcu)
        weak_abs = (cfg.kf_weak_abs if cfg.kf_weak_abs > 0
                    else 2 * cfg.min_inliers_track)
        weak_tracking = (
            n_inl < cfg.kf_ref_ratio * max(self.ref_kf_tracked, 1)
            or n_inl < weak_abs)
        need_kf = (
            not self.only_tracking and n_inl > 15
            and (since_kf >= cfg.max_frames_kf
                 or (since_kf >= cfg.min_frames_kf
                     and (weak_tracking or need_close)))
        )
        n_kf_now = int(self.map.n_kf)
        if need_kf and n_kf_now < cfg.max_kf - 1:
            self.map, kf_mp = insert_keyframe_jit(
                self.map, fr, Tcw, frame_mp, self.calib, cfg, fid
            )
            self.last_kf_frame = self.frame_id
            self.last_kf_slot = int(jnp.argmax(
                jnp.where(self.map.kf_valid, self.map.kf_frame_id, -1)))
            self._tstate_dirty = True
            frame_mp = kf_mp
            self.ref_kf_tracked = n_inl
            if self.kf_inserted_cb is not None:
                # mapping stage hook: local BA / triangulation / culling;
                # may transform the map (returns the new MapState or None)
                new_map = self.kf_inserted_cb(self.last_kf_slot)
                if new_map is not None:
                    self.map = new_map
            self.invalidate_local_cache()
            if self._pending_pose_corr is not None:
                Tcw = Tcw @ self._pending_pose_corr
                self.Tcw = Tcw
                self._pending_pose_corr = None

        self.prev_frame, self.prev_mp, self.prev_Tcw = fr, frame_mp, Tcw
        self._record()
        self.frame_id += 1
        return self.state

    def _record(self, ref_slot=None, ref_pose=None, ref_fid=None):
        # store device arrays only -- no host sync on the frame path; the
        # relative pose is formed lazily at export time.  The fused path
        # passes the reference slot/pose straight from the step outputs
        # (saves one gather dispatch per frame and is fresher than the
        # host's pipelined-lagging last_kf_slot).
        if ref_pose is None:
            ref_slot = self.last_kf_slot
            ref_pose = self.map.kf_Tcw[self.last_kf_slot]
            ref_fid = self.map.kf_frame_id[self.last_kf_slot]
        self.trajectory.append((
            self.frame_id, self._ts, ref_slot,
            (self.Tcw, ref_pose, ref_fid),
            self.state != TrackState.OK,
        ))

    def absolute_trajectory(self):
        self._resolve_pending()
        """(frame_id, timestamp, Tcw) per frame, with keyframe-pose
        corrections applied through the stored relative poses (reference
        SaveTrajectoryTUM, src/System.cc:353-411).

        Slot-recycling guard: keyframe slots are recycled after culling
        (insert_keyframe_impl takes argmin(kf_valid)); a frame recorded
        against a since-culled reference KF must NOT be corrected through
        whatever new keyframe now occupies the slot.  The recorded frame id
        of the reference KF disambiguates: on mismatch (or an invalidated
        slot) the frame falls back to its recorded absolute pose — the
        reference's SaveTrajectoryTUM walks the spanning tree to a live
        parent instead (System.cc:370-380); the uncorrected pose is the
        deterministic equivalent when the parent chain is not materialized.
        """
        kf_Tcw = np.asarray(self.map.kf_Tcw)
        kf_fid = np.asarray(self.map.kf_frame_id)
        kf_valid = np.asarray(self.map.kf_valid)
        out = []
        for fid, ts, ref, rec, lost in self.trajectory:
            Tcw_rec, ref_pose_rec = rec[0], rec[1]
            ref_fid_rec = rec[2] if len(rec) > 2 else None
            r = int(np.asarray(ref))
            fresh = (ref_fid_rec is None
                     or (kf_valid[r]
                         and kf_fid[r] == int(np.asarray(ref_fid_rec))))
            if fresh:
                Tcr = (np.asarray(Tcw_rec)
                       @ np.linalg.inv(np.asarray(ref_pose_rec)))
                out.append((fid, ts, Tcr @ kf_Tcw[r], lost))
            else:
                out.append((fid, ts, np.asarray(Tcw_rec), lost))
        return out


@partial(jax.jit, static_argnums=(5,))
def insert_keyframe_jit(state, fr, Tcw, frame_mp, calib, cfg, frame_id):
    return insert_keyframe_impl(
        state, fr, Tcw, frame_mp, calib, cfg, frame_id, unlimited_new=False
    )
