"""END-TO-END loop closure on NATURALLY drifted tracked data.

One RGB-D camera walks 1.25 laps of a circle looking OUTWARD at the walls
of a textured box, so every piece of structure leaves the field of view
and the starting arc is reachable again only through place recognition —
true loop topology (reference LoopClosing.cc:65-102).  A smooth
depth-scale ramp on the first half-lap makes the tracker accumulate real
odometric drift, the same mechanism as a real sensor's depth calibration
error, so the revisit arrives offset and disconnected.  (An out-and-back
corridor along one wall stays covisibility-connected on the return at any
ramp the tracker survives — re-association absorbs the drift and loop
detection is correctly suppressed — so it cannot exercise this chain.)
No dwells: detection must win while moving.  The vocabulary is pre-trained
on scene descriptors, the reference's own deployment model (it ships a
pre-trained ORBvoc.txt; src/System.cc:79-87).

Asserts the full chain fires — detection -> temporal consistency ->
word-gated matching -> Sim3 RANSAC -> Sim3 LM -> correction + essential
graph + async GBA — that the corrected trajectory beats the loop-disabled
control, and that loop closure costs no tracking robustness.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from multi_orb_slam import system as system_mod
from multi_orb_slam.config import SlamConfig
from multi_orb_slam.geometry import align, camera as cam_mod
from multi_orb_slam.io import synthetic as syn
from multi_orb_slam.ops import orb as orb_mod
from multi_orb_slam.placerec import database as db_mod
from multi_orb_slam.placerec import vocabulary as vocab_mod

NF = 240
H, W = 240, 320
K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)


def make_cfg():
    return SlamConfig(
        n_cams=1, max_feat=512, width=W, height=H, max_frames_kf=12,
        th_depth=4.0, local_cap=1024, ba_local_cap=2048,
        orb=orb_mod.ORBConfig(n_features=512))


@pytest.fixture(scope="module")
def circuit():
    world = syn.make_box_world(seed=3, n_points=5000, box=(7.0, 4.0, 7.0))
    poses = syn.circuit_trajectory(NF, radius=2.2, laps=1.25)
    frames = []
    for i in range(NF):
        g, d = syn.render_rgbd(world, K, poses[i], H, W)
        # natural drift: a 15% depth-scale ramp over s in [0.08, 0.60),
        # past the half-lap, so the offset accumulated by the re-entry of
        # the start arc (s ~ 0.8) is large
        s = i / (NF - 1)
        if 0.08 <= s < 0.60:
            t = (s - 0.08) / 0.52
            d = d * (1.0 + 0.15 * np.sin(np.pi * t))
        frames.append((g, d))
    # pre-trained vocabulary from scene descriptors (k=10, depth=4)
    cfg = make_cfg()
    descs = []
    for i in range(0, NF, 8):
        f = orb_mod.extract_orb(jnp.asarray(frames[i][0]), cfg.orb)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = vocab_mod.build_vocabulary(
        np.concatenate(descs), k=10, depth=4, iters=3)
    return frames, poses, voc


def run(frames, poses, voc, enable_loop):
    cfg = make_cfg()
    calib = cam_mod.CameraParams(
        K=jnp.asarray(K)[None], dist=jnp.zeros((1, 5)),
        T_rc=jnp.eye(4)[None], bf=jnp.asarray(20.0), width=W, height=H)
    slam = system_mod.System(calib=calib, cfg=cfg,
                             sensor=system_mod.Sensor.RGBD,
                             enable_loop_closing=enable_loop)
    if enable_loop:
        slam.loop_closer.voc = voc
        slam.loop_closer.db = db_mod.make_empty_db(cfg.max_kf, voc.n_words)
    for g, d in frames:
        slam.track_rgbd(g, d)
    slam.shutdown()  # folds in a still-pending async GBA
    # trajectory through corrected reference-KF poses (the reference's
    # SaveTrajectoryTUM semantics: loop corrections retro-apply through
    # the per-frame relative poses, src/System.cc:353-411)
    traj = slam.tracker.absolute_trajectory()
    est = np.stack([np.linalg.inv(T)[:3, 3] for fid, ts, T, lost in traj])
    gt = np.stack([np.linalg.inv(poses[min(fid, NF - 1)])[:3, 3]
                   for fid, ts, T, lost in traj])
    ate = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
    n_loops = slam.loop_closer.n_loops_closed if enable_loop else 0
    n_lost = sum(1 for *_, lost in traj if lost)
    return ate, n_loops, n_lost


def test_natural_drift_loop_closes_and_corrects(circuit):
    frames, poses, voc = circuit
    ate_loop, n_loops, lost_loop = run(frames, poses, voc, enable_loop=True)
    ate_ctrl, _, lost_ctrl = run(frames, poses, voc, enable_loop=False)
    assert n_loops >= 1, "the loop-closing chain never fired"
    # the corrected trajectory must beat the loop-disabled control
    assert ate_loop < ate_ctrl, (ate_loop, ate_ctrl)
    # tracking must stay robust through the drifted re-entry WITH the loop
    # closer (its correction jumps the map under the live tracker)
    assert lost_loop <= NF // 20, lost_loop
    assert lost_loop <= lost_ctrl, (lost_loop, lost_ctrl)
