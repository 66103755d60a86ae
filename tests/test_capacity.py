"""Capacity lifecycle: slot exhaustion is counted, relieved, and survivable.

Originally `allocate_mp_slots` returned -1 silently on
a full map.  Now exhaustion increments `n_alloc_failed`, and the mapping
stage evicts the weakest points (`map_state.relieve_capacity`) when the
store runs hot — the fixed-capacity answer to the reference's unbounded
`Map` growth (src/Map.cc:32-134).
"""

import numpy as np
import jax.numpy as jnp

from multi_orb_slam.config import SlamConfig
from multi_orb_slam.frontend import tracking
from multi_orb_slam.geometry import align, camera as cam_mod
from multi_orb_slam.io import synthetic
from multi_orb_slam.mapping import local_mapping, map_state as ms
from multi_orb_slam.ops import orb


def test_alloc_failure_counter():
    valid = jnp.ones(64, bool).at[10].set(False)  # one free slot (63 reserved)
    want = jnp.ones(8, bool)
    slots = ms.allocate_mp_slots(valid, want)
    assert int(jnp.sum(slots >= 0)) == 1
    assert int(jnp.sum((slots < 0) & want)) == 7


def test_relieve_capacity_frees_slots_and_drops_observations():
    st = ms.make_empty(max_kf=8, n_cams=1, max_feat=32, max_mp=128)
    M = 128
    st = st._replace(
        mp_valid=jnp.ones(M, bool).at[M - 1].set(False),
        n_mp=jnp.asarray(M - 1, jnp.int32),
        mp_visible=jnp.full(M, 10, jnp.int32),
        # low found ratio for slots < 32 -> eviction order targets them
        mp_found=jnp.where(jnp.arange(M) < 32, 1, 9),
        kf_valid=jnp.zeros(8, bool).at[0].set(True),
        kf_frame_id=jnp.full(8, -1, jnp.int32).at[0].set(0),
        kf_mp=jnp.full((8, 1, 32), -1, jnp.int32).at[0, 0].set(
            jnp.arange(32, dtype=jnp.int32)),  # KF0 observes the weak points
        kf_feat_valid=jnp.zeros((8, 1, 32), bool).at[0].set(True),
    )
    out = ms.relieve_capacity(st, target_free=40)
    n_free = int(jnp.sum(~out.mp_valid))
    assert n_free >= 40
    # protected: points observed by the most recent keyframes stay — here
    # KF0 is the ONLY keyframe, so its points are protected; the evicted
    # points are the unobserved low-ratio ones
    assert bool(jnp.all(out.mp_valid[:32]))
    # observation table never references a dead point
    dead_ref = (out.kf_mp >= 0) & ~out.mp_valid[jnp.clip(out.kf_mp, 0, M - 1)]
    assert not bool(jnp.any(dead_ref))


def test_overflow_run_degrades_gracefully():
    """Track a sequence with a map sized ~2x under what it wants."""
    K = np.array([520.9, 521.0, 160.0, 120.0], np.float32)
    T_rc = np.stack([np.eye(4, dtype=np.float32)])
    seq = synthetic.make_sequence(n_frames=25, K=K, T_rc=T_rc,
                                  height=240, width=320, seed=2,
                                  n_points=4000, trajectory="orbit")
    cfg = SlamConfig(n_cams=1, max_feat=512, max_kf=24, max_mp=768,
                     local_cap=512, ba_local_cap=768, max_frames_kf=5,
                     width=320, height=240,
                     orb=orb.ORBConfig(n_features=512))
    calib = cam_mod.CameraParams(
        K=jnp.asarray(K)[None], dist=jnp.zeros((1, 5)),
        T_rc=jnp.asarray(T_rc), bf=jnp.asarray(40.0), width=320, height=240)
    tr = tracking.Tracker(calib, cfg)
    tr.kf_inserted_cb = lambda s: local_mapping.run_mapping_stage(
        tr.map, s, tr.frame_id, calib, cfg)
    ok_frames = 0
    for g, d in zip(seq.grays, seq.depths):
        tr.process(jnp.asarray(g), jnp.asarray(d))
        ok_frames += int(tr.state == tracking.TrackState.OK)
    # the run survives: tracking holds despite capacity pressure
    assert ok_frames >= 18
    # capacity events were observed and handled, not silent: either some
    # allocations were refused (and counted) or eviction kept the store
    # under the high-water mark
    n_failed = int(tr.map.n_alloc_failed)
    n_mp = int(tr.map.n_mp)
    assert n_mp <= 768
    assert n_failed > 0 or n_mp < int(0.95 * 768)
