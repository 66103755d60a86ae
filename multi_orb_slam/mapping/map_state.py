"""The map as fixed-capacity structure-of-arrays state.

Replaces the reference's pointer graph of `KeyFrame` / `MapPoint` / `Map`
objects (include/KeyFrame.h, include/MapPoint.h, src/Map.cc) with dense
arrays + validity masks, so every stage is a fixed-shape array program:

- keyframe feature stores mirror `Frame`'s `_total` arrays but keep an
  explicit camera axis `[K, C, F, ...]` instead of concatenated indices with
  `keypoint_to_cam` hash maps (reference include/Frame.h:253-261);
- the KF<->MapPoint observation structure is one int array `kf_mp[K, C, F]`
  (the map-point id seen by each keyframe feature slot, -1 if none) — the
  transpose of the reference's per-point `mObservations` map
  (src/MapPoint.cc:138-165);
- covisibility weights are a single [K, K] matmul over the KF x MP incidence
  matrix instead of per-KF std::map counting (reference
  src/KeyFrame.cc:486-668, UpdateConnections).  The cam1-only covisibility
  graph falls out of the same op restricted to camera 0 rows;
- per-point distinctive descriptors come from a small rolling buffer of
  recent observations (min-sum-of-Hamming over the buffer), approximating
  the reference's median-distance selection over all observations
  (src/MapPoint.cc:325-438) with a fixed-size, batchable op.

Slot allocation (new keyframes / map points / culling) happens inside jit via
masked scatter; scalar counters live in the state.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..ops import hamming

DESC_BUF = 4  # rolling descriptor buffer per map point


class MapState(NamedTuple):
    # --- keyframes ---
    kf_Tcw: jnp.ndarray        # [K, 4, 4] rig pose (world -> rig body = cam0)
    kf_valid: jnp.ndarray      # [K] bool
    kf_frame_id: jnp.ndarray   # [K] int32 source frame id (monotonic)
    kf_xy_und: jnp.ndarray     # [K, C, F, 2]
    kf_uright: jnp.ndarray     # [K, C, F]
    kf_depth: jnp.ndarray      # [K, C, F]
    kf_level: jnp.ndarray      # [K, C, F] int32
    kf_angle: jnp.ndarray      # [K, C, F]
    kf_desc: jnp.ndarray       # [K, C, F, 8] uint32
    kf_feat_valid: jnp.ndarray # [K, C, F] bool
    kf_mp: jnp.ndarray         # [K, C, F] int32 map-point id or -1
    # --- map points ---
    mp_pos: jnp.ndarray        # [M, 3]
    mp_valid: jnp.ndarray      # [M] bool
    mp_desc: jnp.ndarray       # [M, 8] uint32 distinctive descriptor
    mp_descbuf: jnp.ndarray    # [M, DESC_BUF, 8] uint32 recent obs descriptors
    mp_descbuf_n: jnp.ndarray  # [M] int32 (monotone insert counter)
    mp_normal: jnp.ndarray     # [M, 3] mean viewing direction
    mp_min_dist: jnp.ndarray   # [M]
    mp_max_dist: jnp.ndarray   # [M]
    mp_first_kf: jnp.ndarray   # [M] int32 kf slot that created it
    mp_first_frame: jnp.ndarray# [M] int32 frame id at creation
    mp_visible: jnp.ndarray    # [M] int32 (IncreaseVisible)
    mp_found: jnp.ndarray      # [M] int32 (IncreaseFound)
    mp_replaced: jnp.ndarray   # [M] int32 forward pointer after fusion merge
                               # (MapPoint::GetReplaced, src/MapPoint.cc:298),
                               # -1 if never merged
    # --- counters ---
    n_kf: jnp.ndarray          # [] int32 number of valid keyframes
    n_mp: jnp.ndarray          # [] int32 number of valid map points
    next_kf_id: jnp.ndarray    # [] int32 monotonic keyframe id counter
    n_alloc_failed: jnp.ndarray  # [] int32 map-point slot requests refused
                               # because the map was full (capacity telemetry
                               # — the reference grows unboundedly, Map.cc:32;
                               # a fixed-capacity design must surface this)


def make_empty(max_kf: int, n_cams: int, max_feat: int, max_mp: int) -> MapState:
    K, C, F, M = max_kf, n_cams, max_feat, max_mp
    f32 = jnp.float32
    return MapState(
        kf_Tcw=jnp.tile(jnp.eye(4, dtype=f32), (K, 1, 1)),
        kf_valid=jnp.zeros(K, bool),
        kf_frame_id=jnp.full(K, -1, jnp.int32),
        kf_xy_und=jnp.zeros((K, C, F, 2), f32),
        kf_uright=jnp.full((K, C, F), -1.0, f32),
        kf_depth=jnp.zeros((K, C, F), f32),
        kf_level=jnp.zeros((K, C, F), jnp.int32),
        kf_angle=jnp.zeros((K, C, F), f32),
        kf_desc=jnp.zeros((K, C, F, 8), jnp.uint32),
        kf_feat_valid=jnp.zeros((K, C, F), bool),
        kf_mp=jnp.full((K, C, F), -1, jnp.int32),
        mp_pos=jnp.zeros((M, 3), f32),
        mp_valid=jnp.zeros(M, bool),
        mp_desc=jnp.zeros((M, 8), jnp.uint32),
        mp_descbuf=jnp.zeros((M, DESC_BUF, 8), jnp.uint32),
        mp_descbuf_n=jnp.zeros(M, jnp.int32),
        mp_normal=jnp.zeros((M, 3), f32),
        mp_min_dist=jnp.zeros(M, f32),
        mp_max_dist=jnp.zeros(M, f32),
        mp_first_kf=jnp.full(M, -1, jnp.int32),
        mp_first_frame=jnp.full(M, -1, jnp.int32),
        mp_visible=jnp.zeros(M, jnp.int32),
        mp_found=jnp.zeros(M, jnp.int32),
        mp_replaced=jnp.full(M, -1, jnp.int32),
        n_kf=jnp.asarray(0, jnp.int32),
        n_mp=jnp.asarray(0, jnp.int32),
        next_kf_id=jnp.asarray(0, jnp.int32),
        n_alloc_failed=jnp.asarray(0, jnp.int32),
    )


# ---------------------------------------------------------------------------
# Incidence / covisibility
# ---------------------------------------------------------------------------


def resolve_mp_ids(state: "MapState", ids: jnp.ndarray) -> jnp.ndarray:
    """Follow fusion forward-pointers and drop dead ids.

    The reference equivalent is Tracking::CheckReplacedInLastFrame
    (src/Tracking.cc:1020-1032): last-frame matches may point at map points
    that were merged away by fusion or culled.
    """
    M = state.mp_pos.shape[0]
    safe = jnp.clip(ids, 0, M - 1)
    fwd = state.mp_replaced[safe]
    # a pointer counts only while its slot is dead: a slot recycled for a
    # new point keeps the pointer of its merged-away predecessor, which must
    # not redirect observations of the new point to an unrelated landmark
    dead = ~state.mp_valid[safe]
    ids2 = jnp.where((ids >= 0) & dead & (fwd >= 0), fwd, ids)
    safe2 = jnp.clip(ids2, 0, M - 1)
    alive = state.mp_valid[safe2]
    return jnp.where((ids2 >= 0) & alive, ids2, -1)


def observation_matrix(state: MapState, cam0_only: bool = False) -> jnp.ndarray:
    """KF x MP incidence as float [K, M]: 1 where kf k observes point m.

    The covisibility substrate: covis = O @ O.T is one matmul.
    """
    M = state.mp_pos.shape[0]
    kf_mp = state.kf_mp[:, :1] if cam0_only else state.kf_mp
    K = kf_mp.shape[0]
    flat = kf_mp.reshape(K, -1)
    valid = flat >= 0
    idx = jnp.where(valid, flat, 0)
    O = jnp.zeros((K, M), jnp.float32)
    O = O.at[jnp.arange(K)[:, None], idx].max(valid.astype(jnp.float32))
    O = O * state.kf_valid[:, None] * state.mp_valid[None, :]
    return O


def covisibility(state: MapState, cam0_only: bool = False) -> jnp.ndarray:
    """[K, K] shared-observation counts (diag zeroed).

    Reference: KeyFrame::UpdateConnections builds the same weights with
    nested maps (src/KeyFrame.cc:486-668); here it is one matmul.  The
    reference keeps both an all-camera and a cam1-only graph
    (include/KeyFrame.h:274-282); `cam0_only` selects the latter.
    """
    O = observation_matrix(state, cam0_only)
    # DEFAULT precision: 0/1 operands are exact at any matmul precision
    # (TF32 included) and the f32 accumulator holds counts exactly;
    # [K, M] @ [M, K] is ~2 GFLOP at K=192, M=24576
    W = jnp.dot(O, O.T, precision=jax.lax.Precision.DEFAULT)
    return W - jnp.diag(jnp.diag(W))


def mp_observation_count(state: MapState) -> jnp.ndarray:
    """[M] number of keyframes observing each point (nObs analog;
    the reference counts stereo observations twice, MapPoint.cc:161-164 —
    use `mp_weighted_obs` for that)."""
    K = state.kf_mp.shape[0]
    flat = state.kf_mp.reshape(K, -1)
    valid = (flat >= 0) & state.kf_valid[:, None]
    M = state.mp_pos.shape[0]
    cnt = jnp.zeros(M, jnp.int32)
    idx = jnp.where(valid, flat, M - 1)
    contrib = valid.astype(jnp.int32)
    # a KF observing the point via multiple cameras still counts per feature,
    # matching the reference (each observation adds)
    cnt = cnt.at[idx.reshape(-1)].add(contrib.reshape(-1))
    return cnt * state.mp_valid


def mp_weighted_obs(state: MapState) -> jnp.ndarray:
    """[M] observation weight: stereo obs count 2, mono 1 (MapPoint::nObs)."""
    K = state.kf_mp.shape[0]
    flat = state.kf_mp.reshape(K, -1)
    ur = state.kf_uright.reshape(K, -1)
    valid = (flat >= 0) & state.kf_valid[:, None]
    w = jnp.where(ur >= 0, 2, 1) * valid.astype(jnp.int32)
    M = state.mp_pos.shape[0]
    idx = jnp.where(valid, flat, M - 1)
    cnt = jnp.zeros(M, jnp.int32)
    cnt = cnt.at[idx.reshape(-1)].add(w.reshape(-1))
    return cnt * state.mp_valid


# ---------------------------------------------------------------------------
# Slot allocation
# ---------------------------------------------------------------------------


def allocate_mp_slots(mp_valid: jnp.ndarray, want: jnp.ndarray) -> jnp.ndarray:
    """Assign free map-point slots to requests.

    Args:
      mp_valid: [M] current occupancy.
      want: [N] bool, which requests need a slot.

    Returns [N] int32 slot ids (-1 if out of capacity or not wanted).

    The last slot (M-1) is reserved as a scatter-dummy target throughout the
    codebase and is never allocated.
    """
    M = mp_valid.shape[0]
    mp_valid = mp_valid.at[M - 1].set(True)
    # free slots ranked first; stable order by index
    free_rank = jnp.cumsum((~mp_valid).astype(jnp.int32)) - 1  # rank among free
    # slot_of_rank[r] = index of r-th free slot
    slot_of_rank = jnp.full(M, -1, jnp.int32)
    slot_of_rank = slot_of_rank.at[jnp.where(~mp_valid, free_rank, M - 1)].set(
        jnp.where(~mp_valid, jnp.arange(M, dtype=jnp.int32), -1)
    )
    n_free = jnp.sum((~mp_valid).astype(jnp.int32))
    req_rank = jnp.cumsum(want.astype(jnp.int32)) - 1
    ok = want & (req_rank < n_free)
    idx = jnp.clip(req_rank, 0, M - 1)
    return jnp.where(ok, slot_of_rank[idx], -1)


# ---------------------------------------------------------------------------
# Map point maintenance
# ---------------------------------------------------------------------------


def update_mp_descriptor(
    descbuf: jnp.ndarray, descbuf_n: jnp.ndarray
) -> jnp.ndarray:
    """Distinctive descriptor per point: min total Hamming to buffer peers.

    Approximates MapPoint::ComputeDistinctiveDescriptors
    (src/MapPoint.cc:325-438) on the rolling buffer.
    """
    B = descbuf.shape[1]
    x = jnp.bitwise_xor(descbuf[:, :, None, :], descbuf[:, None, :, :])
    d = jnp.sum(hamming.popcount32(x), axis=-1)  # [M, B, B]
    slot_used = jnp.arange(B)[None, :] < jnp.minimum(descbuf_n[:, None], B)
    d = jnp.where(slot_used[:, None, :], d, 0)
    tot = jnp.sum(d, axis=-1)  # [M, B]
    tot = jnp.where(slot_used, tot, 1 << 24)
    best = jnp.argmin(tot, axis=-1)  # [M]
    return jnp.take_along_axis(descbuf, best[:, None, None], axis=1)[:, 0]


def scale_range_from_obs(
    dist: jnp.ndarray, level: jnp.ndarray, scale_factor: float, n_levels: int
):
    """(min_dist, max_dist) scale-invariance bounds of an observation.

    Reference: MapPoint::UpdateNormalAndDepth (src/MapPoint.cc:480-557):
    maxDist = dist * scaleFactor^level; minDist = maxDist / scaleFactor^(L-1).
    """
    lf = scale_factor ** level.astype(jnp.float32)
    max_d = dist * lf
    min_d = max_d / (scale_factor ** (n_levels - 1))
    return min_d, max_d


def predict_scale(
    dist: jnp.ndarray, max_dist: jnp.ndarray, scale_factor: float, n_levels: int
) -> jnp.ndarray:
    """MapPoint::PredictScale (src/MapPoint.cc:584-620)."""
    ratio = jnp.maximum(max_dist, 1e-6) / jnp.maximum(dist, 1e-6)
    lvl = jnp.ceil(jnp.log(ratio) / jnp.log(scale_factor)).astype(jnp.int32)
    return jnp.clip(lvl, 0, n_levels - 1)


@partial(jax.jit, static_argnums=(1,))
def relieve_capacity(state: MapState, target_free: int) -> MapState:
    """Evict the weakest map points until >= target_free slots are free.

    Graceful-degradation path for slot exhaustion: the reference's map
    grows without bound (src/Map.cc:32-134); a fixed-capacity SoA map must
    instead shed load.  Eviction priority is the tracking quality ratio
    found/visible (the same signal MapPointCulling keys on,
    LocalMapping.cc:243), with points observed by the NEWEST keyframes
    protected so the active local map is never thinned.
    """
    M = state.mp_pos.shape[0]
    K = state.kf_mp.shape[0]
    # protect points observed by the 12 most recent keyframes
    n_recent = min(12, K)
    fid = jnp.where(state.kf_valid, state.kf_frame_id, -1)
    _, recent = jax.lax.top_k(fid, n_recent)
    obs = state.kf_mp[recent].reshape(n_recent, -1)
    ok = (obs >= 0) & state.kf_valid[recent][:, None]
    protected = jnp.zeros(M, bool).at[
        jnp.where(ok, obs, M - 1).reshape(-1)].max(ok.reshape(-1))

    ratio = state.mp_found.astype(jnp.float32) / jnp.maximum(
        state.mp_visible.astype(jnp.float32), 1.0)
    evictable = state.mp_valid & ~protected
    n_free = jnp.sum((~state.mp_valid).astype(jnp.int32))
    n_needed = jnp.maximum(target_free - n_free, 0)
    # kill the n_needed lowest-ratio evictable points: rank by priority
    prio = jnp.where(evictable, -ratio, -jnp.inf)   # higher = kill first
    _, order = jax.lax.top_k(prio, min(target_free, M))
    rank_ok = jnp.arange(order.shape[0]) < n_needed
    kill_idx = jnp.where(rank_ok & evictable[order], order, M - 1)
    kill = jnp.zeros(M, bool).at[kill_idx].max(rank_ok & evictable[order])
    kill = kill.at[M - 1].set(False)
    mp_valid = state.mp_valid & ~kill
    killed_of = kill[jnp.clip(state.kf_mp, 0, M - 1)] & (state.kf_mp >= 0)
    kf_mp = jnp.where(killed_of, -1, state.kf_mp)
    n_killed = jnp.sum(kill.astype(jnp.int32))
    return state._replace(
        mp_valid=mp_valid, kf_mp=kf_mp, n_mp=state.n_mp - n_killed)


@jax.jit
def kf_tracked_points(state: MapState, kf_slot: jnp.ndarray,
                      min_obs: jnp.ndarray) -> jnp.ndarray:
    """Number of `kf_slot` map points with >= min_obs weighted observations.

    Reference KeyFrame::TrackedMapPoints (src/KeyFrame.cc:396-430), the
    `nRefMatches` quantity of NeedNewKeyFrame's weak-tracking test
    (Tracking.cc:1436: mnMatchesInliers < nRefMatches*0.9).  Using
    inliers-at-insertion instead which over-triggers keyframe insertion
    whenever inlier counts decay monotonically from a strong start.
    """
    M = state.mp_pos.shape[0]
    w = mp_weighted_obs(state)
    obs = state.kf_mp[kf_slot].reshape(-1)
    ok = (obs >= 0) & state.kf_feat_valid[kf_slot].reshape(-1)
    cnt = w[jnp.clip(obs, 0, M - 1)]
    good = ok & state.mp_valid[jnp.clip(obs, 0, M - 1)] & (cnt >= min_obs)
    return jnp.sum(good.astype(jnp.int32))


def dedupe_obs_rows(rows: jnp.ndarray,
                    prefer_keep: jnp.ndarray | None = None) -> jnp.ndarray:
    """Keep at most one occurrence of each point id per [..., F] row.

    Mirrors MapPoint::Replace (src/MapPoint.cc:258-296): when a fusion
    merge would give a keyframe two features on the same landmark, the
    reference ERASES the redundant feature's observation instead of
    keeping both.  Among duplicates the entry with prefer_keep=True wins
    (e.g. the feature that already observed the winner, rather than a
    remapped loser) — keeping an arbitrary one risks keeping the
    wrong-pixel observation, which then drags the landmark in BA.
    """
    F = rows.shape[-1]
    flat = rows.reshape(-1, F)
    if prefer_keep is None:
        pk = jnp.ones_like(flat)
    else:
        pk = prefer_keep.reshape(-1, F).astype(jnp.int32)
    key = flat * 2 + (1 - pk)          # preferred duplicates sort first
    order = jnp.argsort(key, axis=1)
    sv = jnp.take_along_axis(flat, order, axis=1)
    dup_sorted = jnp.concatenate([
        jnp.zeros((flat.shape[0], 1), bool),
        (sv[:, 1:] == sv[:, :-1]) & (sv[:, 1:] >= 0)], axis=1)
    r = jnp.arange(flat.shape[0])[:, None]
    dup = jnp.zeros_like(dup_sorted).at[r, order].set(dup_sorted)
    return jnp.where(dup.reshape(rows.shape), -1, rows)
