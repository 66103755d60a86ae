"""Dual-camera rig end-to-end tests — the reference's flagship configuration
(dual RGB-D rig with ~90-degree separation, OtherFiles/calibration.txt)."""

import jax.numpy as jnp
import numpy as np

from multi_orb_slam import system as system_mod
from multi_orb_slam.config import SlamConfig
from multi_orb_slam.geometry import align, camera as cam_mod, se3
from multi_orb_slam.io import synthetic
from multi_orb_slam.mapping import local_mapping
from multi_orb_slam.frontend import tracking
from multi_orb_slam.ops import orb


def dual_calib(angle=0.9):
    """Rig with camera 1 yawed ~`angle` rad from camera 0 (reference rig is
    ~90 deg about Y with a 16 cm baseline, calibration.txt)."""
    C = 2
    K = jnp.tile(jnp.asarray([[260.0, 260.0, 160.0, 120.0]]), (C, 1))
    Ry = se3.so3_exp(jnp.asarray([0.0, angle, 0.0]))
    # T_rc maps rig->cam; cam1 = inv(T_cam12)
    T_c12 = jnp.eye(4).at[:3, :3].set(Ry).at[:3, 3].set(
        jnp.asarray([0.16, 0.004, -0.07]))
    T_rc = jnp.stack([jnp.eye(4), jnp.linalg.inv(T_c12)])
    return cam_mod.CameraParams(
        K=K, dist=jnp.zeros((C, 5)), T_rc=T_rc, bf=jnp.asarray(20.0),
        width=320, height=240,
    )


def dual_cfg():
    return SlamConfig(
        n_cams=2, max_feat=512, max_kf=32, max_mp=12288,
        local_cap=2048, new_mp_per_cam=128,
        width=320, height=240, th_depth=6.0, max_frames_kf=4,
        orb=orb.ORBConfig(n_features=512),
    )


class TestDualCamera:
    def test_dual_rig_tracking_ate(self):
        cfg = dual_cfg()
        calib = dual_calib()
        seq = synthetic.make_sequence(
            n_frames=15, K=np.asarray(calib.K[0]),
            T_rc=np.asarray(calib.T_rc),
            height=240, width=320, n_points=5000,
        )
        tracker = tracking.Tracker(calib, cfg)
        tracker.kf_inserted_cb = lambda k: local_mapping.run_mapping_stage(
            tracker.map, k, tracker.frame_id, calib, cfg)
        for grays, depths in zip(seq.grays, seq.depths):
            s = tracker.process(grays, depths)
            assert s != tracking.TrackState.LOST
        est = np.stack([np.linalg.inv(T)[:3, 3]
                        for _, _, T, _ in tracker.absolute_trajectory()])
        gt = np.stack([np.linalg.inv(p)[:3, 3] for p in seq.poses_gt])
        rmse = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert rmse < 0.06, f"dual-cam ATE {rmse:.4f}"

    def test_both_cameras_contribute(self):
        cfg = dual_cfg()
        calib = dual_calib()
        seq = synthetic.make_sequence(
            n_frames=6, K=np.asarray(calib.K[0]),
            T_rc=np.asarray(calib.T_rc),
            height=240, width=320, n_points=5000,
        )
        tracker = tracking.Tracker(calib, cfg)
        for grays, depths in zip(seq.grays, seq.depths):
            tracker.process(grays, depths)
        state = tracker.map
        kf_mp = np.asarray(state.kf_mp)
        kfv = np.asarray(state.kf_valid)
        # keyframes must hold observations in BOTH cameras
        obs0 = (kf_mp[kfv, 0] >= 0).sum()
        obs1 = (kf_mp[kfv, 1] >= 0).sum()
        assert obs0 > 100 and obs1 > 100, (obs0, obs1)
        # tracked inliers should exceed what a single camera could provide
        assert tracker.last_n_inliers > 150

    def test_system_dual_api(self):
        cfg = dual_cfg()
        calib = dual_calib()
        sys_ = system_mod.System(
            sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg,
            enable_loop_closing=False,
        )
        seq = synthetic.make_sequence(
            n_frames=6, K=np.asarray(calib.K[0]),
            T_rc=np.asarray(calib.T_rc),
            height=240, width=320, n_points=5000,
        )
        for i, (g, d) in enumerate(zip(seq.grays, seq.depths)):
            Tcw = sys_.track_rgbd(g[0], d[0], g[1], d[1],
                                  timestamp=seq.timestamps[i])
            assert Tcw.shape == (4, 4)
        assert sys_.get_tracking_state() == 1
