import os

import jax.numpy as jnp
import numpy as np

from multi_orb_slam import system as system_mod
from multi_orb_slam.geometry import align, camera as cam_mod
from multi_orb_slam.io import synthetic, tum
from multi_orb_slam.loop import loop_closing

from test_tracking import small_calib, small_cfg


def make_system(enable_loop=False, **cfg_over):
    cfg_over.setdefault("max_frames_kf", 4)
    cfg = small_cfg()._replace(**cfg_over)
    calib = small_calib()
    sys_ = system_mod.System(
        sensor=system_mod.Sensor.RGBD, calib=calib, cfg=cfg,
        enable_loop_closing=enable_loop,
    )
    if enable_loop:
        # small online vocabulary for test-sized maps
        sys_.loop_closer = loop_closing.LoopCloser(
            calib, cfg, vocab_min_descs=1500, vocab_k=6, vocab_depth=3)
    return sys_, cfg, calib


class TestSystemFacade:
    def test_track_and_save_trajectories(self, tmp_path):
        sys_, cfg, calib = make_system()
        seq = synthetic.make_sequence(
            n_frames=10, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=2500,
        )
        for i, (grays, depths) in enumerate(zip(seq.grays, seq.depths)):
            sys_.track_rgbd(grays[0], depths[0], timestamp=seq.timestamps[i])
        assert sys_.get_tracking_state() == 1  # OK

        tum_path = str(tmp_path / "traj.txt")
        sys_.save_trajectory_tum(tum_path)
        traj = tum.read_trajectory_tum(tum_path)
        assert len(traj) == 10
        kf_path = str(tmp_path / "kf.txt")
        sys_.save_keyframe_trajectory_tum(kf_path)
        assert len(tum.read_trajectory_tum(kf_path)) >= 2
        kitti_path = str(tmp_path / "kitti.txt")
        sys_.save_trajectory_kitti(kitti_path)
        assert len(open(kitti_path).readlines()) == 10

    def test_localization_mode(self):
        sys_, cfg, calib = make_system()
        seq = synthetic.make_sequence(
            n_frames=10, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=2500,
        )
        for i in range(6):
            sys_.track_rgbd(seq.grays[i][0], seq.depths[i][0])
        n_kf_before = int(sys_.map.n_kf)
        sys_.activate_localization_mode()
        for i in range(6, 10):
            sys_.track_rgbd(seq.grays[i][0], seq.depths[i][0])
        assert int(sys_.map.n_kf) == n_kf_before  # no new keyframes
        assert sys_.get_tracking_state() == 1

    def test_reset(self):
        sys_, cfg, calib = make_system()
        seq = synthetic.make_sequence(
            n_frames=6, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=2500,
        )
        for i in range(4):
            sys_.track_rgbd(seq.grays[i][0], seq.depths[i][0])
        sys_.reset()
        sys_.track_rgbd(seq.grays[4][0], seq.depths[4][0])
        assert sys_.tracker.frame_id == 1  # restarted

    def test_map_checkpoint_roundtrip(self, tmp_path):
        sys_, cfg, calib = make_system()
        seq = synthetic.make_sequence(
            n_frames=6, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=2500,
        )
        for i in range(6):
            sys_.track_rgbd(seq.grays[i][0], seq.depths[i][0])
        path = str(tmp_path / "map.ckpt")
        sys_.save_map(path)
        sys2, _, _ = make_system()
        sys2.load_map(path)
        assert int(sys2.map.n_kf) == int(sys_.map.n_kf)
        np.testing.assert_array_equal(
            np.asarray(sys2.map.kf_valid), np.asarray(sys_.map.kf_valid))


class TestTumIO:
    def test_associate(self):
        a = {1.00: ["a1"], 1.05: ["a2"], 2.00: ["a3"]}
        b = {1.01: ["b1"], 1.06: ["b2"], 3.00: ["b3"]}
        m = tum.associate(a, b, max_difference=0.02)
        assert m == [(1.00, 1.01), (1.05, 1.06)]

    def test_trajectory_roundtrip(self, tmp_path):
        rng = np.random.RandomState(0)
        from multi_orb_slam.geometry import se3
        poses = []
        for i in range(5):
            xi = jnp.asarray(rng.randn(6).astype(np.float32) * 0.3)
            poses.append((float(i) * 0.1, np.asarray(se3.exp(xi))))
        path = str(tmp_path / "t.txt")
        tum.write_trajectory_tum(path, poses)
        back = tum.read_trajectory_tum(path)
        assert len(back) == 5
        for t, Tcw in poses:
            Twc = np.linalg.inv(Tcw)
            got = back[round(t, 6)]
            np.testing.assert_allclose(got, Twc, atol=1e-5)


class TestLoopClosure:
    def test_out_and_back_closes_loop(self):
        sys_, cfg, calib = make_system(enable_loop=True, max_frames_kf=6)
        seq = synthetic.make_sequence(
            n_frames=40, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=3500, trajectory="out_and_back",
        )
        for i, (grays, depths) in enumerate(zip(seq.grays, seq.depths)):
            sys_.track_rgbd(grays[0], depths[0], timestamp=seq.timestamps[i])
        # tracking survived and the trajectory is accurate
        traj = sys_.tracker.absolute_trajectory()
        est = np.stack([np.linalg.inv(T)[:3, 3] for _, _, T, lost in traj])
        gt = np.stack([np.linalg.inv(T)[:3, 3] for T in seq.poses_gt])
        rmse = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert rmse < 0.06, f"ATE {rmse:.4f}"
        # the loop machinery must have been exercised (vocab trained + DB)
        assert sys_.loop_closer.voc is not None
        assert sys_.loop_closer.db is not None
