"""End-to-end tracking on Kinect-degraded synthetic input.

The reference's acceptance regime is real TUM RGB-D capture
(/root/reference/OtherFiles/evaluate_ate.py:47-60, README §3); real Kinect
frames carry quadratic depth noise, dropouts, exposure drift, shot noise,
and motion blur.  `io.synthetic.SensorModel` injects all five; this test
asserts the full pipeline (tracking + mapping) survives the committed
default degradation model and holds a bounded ATE — so the synthetic
acceptance numbers are earned on degraded input, not exact renders.
"""

import numpy as np
import jax.numpy as jnp

from multi_orb_slam import system as system_mod
from multi_orb_slam.config import SlamConfig
from multi_orb_slam.geometry import align, camera as cam_mod
from multi_orb_slam.io import synthetic
from multi_orb_slam.ops import orb


def _cfg():
    return SlamConfig(
        n_cams=1, max_feat=512, max_kf=32, max_mp=8192, local_cap=1024,
        new_mp_per_cam=128, width=320, height=240, th_depth=6.0,
        orb=orb.ORBConfig(n_features=512))


def _calib():
    return cam_mod.CameraParams(
        K=jnp.asarray([[260.0, 260.0, 160.0, 120.0]]),
        dist=jnp.zeros((1, 5)), T_rc=jnp.eye(4)[None],
        bf=jnp.asarray(20.0), width=320, height=240)


def test_degraded_sequence_tracks_with_bounded_ate():
    cfg = _cfg()
    calib = _calib()
    clean = synthetic.make_sequence(
        n_frames=40, K=np.asarray(calib.K[0]), height=240, width=320,
        n_points=2500)
    seq = synthetic.degrade_sequence(clean, synthetic.SensorModel(), seed=7)

    # the degradation must actually bite: depth must differ beyond mm noise
    # and some valid depth must be dropped
    d0c = np.asarray(clean.depths[10][0])
    d0n = np.asarray(seq.depths[10][0])
    dropped = np.sum((d0c > 0) & (d0n == 0))
    assert dropped > 100, "depth dropout not applied"
    both = (d0c > 0) & (d0n > 0)
    assert float(np.abs(d0c[both] - d0n[both]).mean()) > 1e-4

    slam = system_mod.System(
        calib=calib, cfg=cfg, sensor=system_mod.Sensor.RGBD,
        enable_loop_closing=False)
    for g, d in zip(seq.grays, seq.depths):
        slam.track_rgbd(g[0], d[0])
    traj = slam.tracker.absolute_trajectory()
    n_lost = sum(1 for *_, lost in traj if lost)
    assert n_lost == 0, f"{n_lost}/40 frames lost on degraded input"
    est = np.stack([np.linalg.inv(T)[:3, 3] for _, _, T, _ in traj])
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in seq.poses_gt])
    rmse = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
    # clean-render bound on this trajectory is 0.05 m (test_tracking);
    # the five-effect Kinect model costs roughly 2x, dominated by the
    # quadratic depth noise at the 2.5-3.5 m wall distances
    assert rmse < 0.10, f"degraded ATE RMSE {rmse:.4f} m"
