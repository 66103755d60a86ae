"""END-TO-END outward-facing circuit with the reference's ~90-deg rig.

The corridor-and-corner scenario the dual-camera fork was built for
(reference src/Tracking.cc:1235-1328 all-cam tracking through
rotation-heavy views; OtherFiles/calibration.txt rotates cam2 ~90 deg
about Y): the camera rig walks a full circle looking OUTWARD at the
surrounding walls, so every piece of structure leaves the field of view
and the starting arc is only reachable again through place recognition.
This defeated an earlier front end: the capped
local-point gather selected by slot order, starving the current view of
map points once the map outgrew the cap.

Asserts the fix end-to-end: zero tracking losses around the full circuit,
a loop closure on re-entering the starting arc (a smooth depth-scale ramp
on the first half-lap accumulates real odometric drift, same mechanism as
test_loop_closure_e2e), and bounded ATE after correction.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from multi_orb_slam import system as system_mod
from multi_orb_slam.config import SlamConfig
from multi_orb_slam.geometry import align, camera as cam_mod, se3
from multi_orb_slam.io import synthetic as syn
from multi_orb_slam.ops import orb as orb_mod
from multi_orb_slam.placerec import database as db_mod
from multi_orb_slam.placerec import vocabulary as vocab_mod

NF = 240
H, W = 240, 320
K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
DRIFT = 0.15


def make_cfg():
    return SlamConfig(
        n_cams=2, max_feat=512, width=W, height=H, max_frames_kf=12,
        th_depth=4.0, local_cap=1024, ba_local_cap=2048,
        orb=orb_mod.ORBConfig(n_features=512))


def make_rig():
    # the reference rig: cam2 rotated ~90 deg about Y with the measured
    # translation (OtherFiles/calibration.txt:1-4)
    Ry = se3.so3_exp(jnp.asarray([0.0, np.pi / 2, 0.0]))
    T_rc1 = (jnp.eye(4).at[:3, :3].set(Ry)
             .at[:3, 3].set(jnp.asarray([0.161, 0.004, -0.071])))
    return jnp.stack([jnp.eye(4), T_rc1]).astype(jnp.float32)


@pytest.fixture(scope="module")
def circuit():
    T_rc = make_rig()
    world = syn.make_box_world(seed=3, n_points=5000, box=(7.0, 4.0, 7.0))
    poses = syn.circuit_trajectory(NF, radius=2.2, laps=1.25)
    frames = []
    for i in range(NF):
        gs, ds = [], []
        s = i / (NF - 1)
        for c in range(2):
            Tcw = np.asarray(T_rc[c]) @ poses[i]
            g, d = syn.render_rgbd(world, K, Tcw, H, W)
            # natural drift: depth-scale ramp on the first half-lap only,
            # so the return to the start arc carries real accumulated
            # offset.  15%: at 5% the round-4 solver tracks the circuit to
            # ~6 cm ATE and the re-entry re-associates (revisit stays
            # covisibility-connected, loop detection CORRECTLY suppressed —
            # verified by covis inspection); at 10% the round-5 gather-free
            # BA restructure tracks through as well (measured: 0-2 lost,
            # connected re-entry).  Each solver improvement absorbs more
            # injected drift before the map disconnects, so the ramp
            # ratchets with it (6% -> 10% -> 15%) to keep this test on the
            # disconnected-revisit topology it exists to exercise; 15%
            # re-measured via tools/circuit_experiment.py (loop fires,
            # 0/240 lost, ATE 0.10 m).
            # window extends past the half-lap (to s=0.60) so the offset
            # accumulated by the s~0.8 re-entry is large enough to
            # disconnect: with the round-5 solver the old (0.08, 0.45)
            # window re-associates at any ramp that tracking survives
            # (measured via tools/circuit_experiment.py: 15%/0.45-window
            # stays connected; 18%+ severs tracking mid-ramp; 15%/0.60
            # disconnects, closes the loop, 0/240 lost, ATE 0.137 m)
            if 0.08 <= s < 0.60:
                t = (s - 0.08) / 0.52
                d = d * (1.0 + DRIFT * np.sin(np.pi * t))
            gs.append(g)
            ds.append(d)
        frames.append((np.stack(gs), np.stack(ds)))
    cfg = make_cfg()
    descs = []
    for i in range(0, NF, 8):
        f = orb_mod.extract_orb(jnp.asarray(frames[i][0][0]), cfg.orb)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = vocab_mod.build_vocabulary(
        np.concatenate(descs), k=10, depth=4, iters=3)
    return frames, poses, voc


def test_circuit_tracks_and_closes(circuit):
    frames, poses, voc = circuit
    cfg = make_cfg()
    T_rc = make_rig()
    calib = cam_mod.CameraParams(
        K=jnp.tile(jnp.asarray(K)[None], (2, 1)), dist=jnp.zeros((2, 5)),
        T_rc=T_rc, bf=jnp.asarray(20.0), width=W, height=H)
    slam = system_mod.System(calib=calib, cfg=cfg,
                             sensor=system_mod.Sensor.DUAL_RGBD,
                             enable_loop_closing=True)
    slam.loop_closer.voc = voc
    slam.loop_closer.db = db_mod.make_empty_db(cfg.max_kf, voc.n_words)
    for g, d in frames:
        slam.track_rgbd(g[0], d[0], g[1], d[1])
    slam.shutdown()

    traj = slam.tracker.absolute_trajectory()
    n_lost = sum(1 for *_, lost in traj if lost)
    # the full outward-facing circuit tracks; at the 15% ramp a single
    # transient drop at the loop-correction instant is within spec (the
    # reference likewise falls back to relocalization for a frame under a
    # harsh correction, src/Tracking.cc:634-642)
    assert n_lost <= 2, f"{n_lost}/{NF} frames lost"
    # the loop chain fired on re-entering the start arc
    assert slam.loop_closer.n_loops_closed >= 1
    # bounded ATE after loop correction (measured 0.084 m; the drift the
    # ramp injects is ~0.5 m before correction)
    est = np.stack([np.linalg.inv(T)[:3, 3] for fid, ts, T, lost in traj])
    gt = np.stack([np.linalg.inv(poses[min(fid, NF - 1)])[:3, 3]
                   for fid, ts, T, lost in traj])
    ate = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
    assert ate < 0.20, ate
