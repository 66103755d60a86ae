"""Long-run keyframe cadence + capacity test (>= 500 frames).

Before this test nothing ran longer than 240 frames, and
the KF-decision constants (config.py kf_ref_ratio / kf_weak_abs /
min_frames_kf) carried derivations anchored on a 52-frame bench orbit.
This drives a 520-frame multi-lap outward circuit on the FLAGSHIP
dual-camera ~90-degree rig (single-camera outward rotation is the
drift regime the dual rig exists for — the reference fork's README
motivation — and monocular runs accumulate meters of drift here, on
both systems) and asserts:

1. tracking survives the whole run — with loop closing ENABLED: at the
   first lap re-entry the revisited structure has drifted, and without a
   loop closure the stale lap-1 points poison the local map (measured:
   tracking severs within ~40 frames of re-entry when the loop stage is
   disabled, on both rigs — the reference needs its LoopClosing thread
   here for exactly the same reason);
2. keyframe cadence stays reference-like — the reference inserts ~1 KF
   per 10-15 frames under continuous motion (NeedNewKeyFrame,
   /root/reference/src/Tracking.cc:1411-1518, min/max window 0..fps with
   the mapping-idle throttle);
3. the `kf_weak_abs` absolute weak-tracking trigger (config.py:78-91)
   does not explode cadence across a LOW-TEXTURE stretch (frames
   200-280 rendered at 50% contrast — thins the FAST corner supply and
   weakens tracking, the regime the trigger fires in; 30% was measured
   to be a full blackout that severs tracking outright on both rigs);
4. the map-point allocator never fails (state.n_alloc_failed == 0) and
   keyframe capacity is never saturated.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from multi_orb_slam import system as system_mod
from multi_orb_slam.config import SlamConfig
from multi_orb_slam.frontend import tracking
from multi_orb_slam.geometry import camera as cam_mod, se3
from multi_orb_slam.io import synthetic as syn
from multi_orb_slam.ops import orb as orb_mod
from multi_orb_slam.placerec import database as db_mod
from multi_orb_slam.placerec import vocabulary as vocab_mod

NF = 520
H, W = 240, 320
K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
LOWTEX = (200, 280)   # low-contrast stretch (frame range)


def make_rig():
    Ry = se3.so3_exp(jnp.asarray([0.0, np.pi / 2, 0.0]))
    T_rc1 = (jnp.eye(4).at[:3, :3].set(Ry)
             .at[:3, 3].set(jnp.asarray([0.161, 0.004, -0.071])))
    return jnp.stack([jnp.eye(4), T_rc1]).astype(jnp.float32)


@pytest.fixture(scope="module")
def longrun_frames():
    T_rc = np.asarray(make_rig())
    world = syn.make_box_world(seed=11, n_points=5000, box=(7.0, 4.0, 7.0))
    poses = syn.circuit_trajectory(NF, radius=2.2, laps=2.2)
    frames = []
    for i in range(NF):
        gs, ds = [], []
        for c in range(2):
            g, d = syn.render_rgbd(world, K, T_rc[c] @ poses[i], H, W)
            if LOWTEX[0] <= i < LOWTEX[1]:
                # compress contrast toward the background level: many
                # squares fall under the FAST threshold, thinning the
                # corner supply
                g = 100.0 + (g - 100.0) * 0.5
            gs.append(g)
            ds.append(d)
        frames.append((np.stack(gs).astype(np.float32),
                       np.stack(ds).astype(np.float32)))
    return frames, poses


def test_longrun_cadence_and_capacity(longrun_frames):
    frames, poses = longrun_frames
    cfg = SlamConfig(
        n_cams=2, max_feat=512, max_kf=96, max_mp=16384, local_cap=1024,
        new_mp_per_cam=128, width=W, height=H, th_depth=4.0,
        orb=orb_mod.ORBConfig(n_features=512))
    calib = cam_mod.CameraParams(
        K=jnp.tile(jnp.asarray(K)[None], (2, 1)), dist=jnp.zeros((2, 5)),
        T_rc=make_rig(), bf=jnp.asarray(20.0), width=W, height=H)
    descs = []
    for i in range(0, NF, 8):
        f = orb_mod.extract_orb(jnp.asarray(frames[i][0][0]), cfg.orb)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = vocab_mod.build_vocabulary(
        np.concatenate(descs), k=10, depth=4, iters=3)
    slam = system_mod.System(calib=calib, cfg=cfg,
                             sensor=system_mod.Sensor.DUAL_RGBD,
                             enable_loop_closing=True)
    slam.loop_closer.voc = voc
    slam.loop_closer.db = db_mod.make_empty_db(cfg.max_kf, voc.n_words)
    tracker = slam.tracker
    inserted_at = []
    orig_cb = tracker.kf_inserted_cb

    def kf_cb(kf_slot):
        inserted_at.append(tracker.frame_id)
        return orig_cb(kf_slot)

    tracker.kf_inserted_cb = kf_cb
    lost = 0
    for i, (g, d) in enumerate(frames):
        slam.track_rgbd(g[0], d[0], g[1], d[1])
        if tracker.state != tracking.TrackState.OK:
            lost += 1

    # 1. the whole run tracks (a handful of frames of slack for the
    #    contrast edges / loop-correction instants, relocalization covers
    #    any transient)
    assert lost <= 10, f"{lost}/{NF} frames not OK"

    # 2. overall cadence reference-like: ~1 KF per 6-20 frames created.
    #    (the reference's nominal window is 10-15; culling and the
    #    need-close trigger move both systems around it)
    n_created = len(inserted_at)
    assert NF // 20 <= n_created <= NF // 6, (
        f"{n_created} KFs for {NF} frames "
        f"(cadence 1/{NF / max(n_created, 1):.1f})")

    # 3. kf_weak_abs must not explode cadence on the low-texture stretch:
    #    its local rate stays within 2.5x the overall rate
    in_low = sum(1 for f in inserted_at if LOWTEX[0] <= f < LOWTEX[1])
    rate_low = in_low / (LOWTEX[1] - LOWTEX[0])
    rate_all = n_created / NF
    assert rate_low <= 2.5 * rate_all + 0.02, (
        f"low-texture cadence {rate_low:.3f} KF/frame vs overall "
        f"{rate_all:.3f}")

    # 4. capacity: allocator never failed, KF store never saturated
    st = tracker.map
    assert int(st.n_alloc_failed) == 0
    assert int(st.n_kf) < cfg.max_kf - 1
    assert int(st.n_mp) < cfg.max_mp
