import numpy as np

from multi_orb_slam import system as system_mod
from multi_orb_slam.io import config_io, synthetic


class TestConfigIO:
    def test_load_reference_style_settings(self):
        st = config_io.load_settings("configs/multi.yaml", n_cams=2)
        assert abs(st.K[0][0] - 522.6) < 1e-3
        assert st.bf == 40.0
        assert st.n_features == 1000
        assert st.n_features_cam2 == 500  # reference halves cam2 features
        assert st.depth_map_factor == 1000.0
        assert st.n_levels == 8 and abs(st.scale_factor - 1.2) < 1e-6

    def test_load_calibration(self):
        T = config_io.load_calibration("configs/calibration.txt")
        # ~90 deg about Y, translation ~[0.16, 0.004, -0.07]
        assert abs(T[0, 2] - 1.0) < 1e-6
        assert abs(T[2, 0] + 1.0) < 1e-6
        np.testing.assert_allclose(T[:3, 3], [0.161, 0.004, -0.071], atol=1e-6)
        # valid rotation
        R = T[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)

    def test_system_from_files(self):
        sys_ = system_mod.System(
            settings_path="configs/multi.yaml",
            calibration_path="configs/calibration.txt",
            sensor=system_mod.Sensor.DUAL_RGBD,
            enable_loop_closing=False,
        )
        assert sys_.cfg.n_cams == 2
        # ThDepth scaled to meters: bf*ThDepth/fx = 40*40/522.6
        assert abs(sys_.cfg.th_depth - 40.0 * 40.0 / 522.6) < 1e-3
        assert sys_.calib.T_rc.shape == (2, 4, 4)

    def test_change_calibration(self, tmp_path):
        sys_ = system_mod.System(
            settings_path="configs/multi.yaml",
            calibration_path="configs/calibration.txt",
            sensor=system_mod.Sensor.DUAL_RGBD,
            enable_loop_closing=False,
        )
        alt = tmp_path / "alt.yaml"
        alt.write_text(open("configs/multi.yaml").read().replace(
            "Camera.fx: 522.6", "Camera.fx: 600.0"))
        sys_.change_calibration(str(alt), "configs/calibration.txt")
        assert abs(float(sys_.calib.K[0][0]) - 600.0) < 1e-3

    def test_tracked_keypoints_un(self):
        import jax.numpy as jnp
        from test_tracking import small_calib, small_cfg
        calib = small_calib()
        cfg = small_cfg()
        sys_ = system_mod.System(
            sensor=system_mod.Sensor.RGBD, calib=calib, cfg=cfg,
            enable_loop_closing=False, enable_mapping=False)
        seq = synthetic.make_sequence(
            n_frames=3, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=2000)
        for g, d in zip(seq.grays, seq.depths):
            sys_.track_rgbd(g[0], d[0])
        xy, matched = sys_.get_tracked_keypoints_un()
        assert xy.shape[0] > 100
        assert matched.sum() > 50
