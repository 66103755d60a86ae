import jax.numpy as jnp
import numpy as np

from multi_orb_slam import system as system_mod
from multi_orb_slam.frontend import frame as frame_mod, tracking
from multi_orb_slam.geometry import align
from multi_orb_slam.io import synthetic

from test_tracking import small_calib, small_cfg


def render_stereo_seq(calib, n_frames=8, n_points=3000):
    """Left/right pairs: right camera shifted by baseline along +x."""
    K = np.asarray(calib.K[0])
    fx = K[0]
    baseline = float(calib.bf) / fx
    world = synthetic.make_box_world(seed=0, n_points=n_points)
    poses = synthetic.orbit_trajectory(n_frames)
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = -baseline  # right cam: x_right = x_left - b (center at +b)
    lefts, rights, gts = [], [], []
    for i in range(n_frames):
        gl, dl = synthetic.render_rgbd(world, K, poses[i], 240, 320)
        gr, _ = synthetic.render_rgbd(world, K, T_lr @ poses[i], 240, 320)
        lefts.append((gl, dl))
        rights.append(gr)
        gts.append(poses[i])
    return lefts, rights, np.stack(gts)


class TestStereo:
    def test_stereo_depth_accuracy(self):
        calib = small_calib()
        lefts, rights, _ = render_stereo_seq(calib, n_frames=1)
        gl, dl = lefts[0]
        fr = frame_mod.build_frame_stereo(
            jnp.asarray(gl), jnp.asarray(rights[0]), calib,
            small_cfg().orb)
        depth = np.asarray(fr.depth[0])
        valid = np.asarray(fr.valid[0]) & (depth > 0)
        assert valid.sum() > 150, f"only {valid.sum()} stereo matches"
        # compare against rendered ground-truth depth at keypoint locations
        xy = np.asarray(fr.xy[0])
        gt_d = np.array([
            dl[int(round(y)), int(round(x))]
            for x, y in xy
        ])
        ok = valid & (gt_d > 0)
        rel_err = np.abs(depth[ok] - gt_d[ok]) / gt_d[ok]
        # median relative depth error small; disparity quantization limits
        # accuracy at ~0.5-1 px
        assert np.median(rel_err) < 0.05, np.median(rel_err)

    def test_stereo_tracking(self):
        calib = small_calib()
        cfg = small_cfg()
        lefts, rights, gts = render_stereo_seq(calib, n_frames=8)
        sys_ = system_mod.System(
            sensor=system_mod.Sensor.STEREO, calib=calib, cfg=cfg,
            enable_loop_closing=False,
        )
        for i in range(8):
            gl, _ = lefts[i]
            sys_.track_stereo(gl, rights[i], timestamp=i / 30.0)
        assert sys_.get_tracking_state() == 1
        traj = sys_.tracker.absolute_trajectory()
        est = np.stack([np.linalg.inv(T)[:3, 3] for _, _, T, _ in traj])
        gt0 = np.linalg.inv(gts[0])
        gt = np.stack([np.linalg.inv(gts[i] @ gt0)[:3, 3] for i in range(8)])
        rmse = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert rmse < 0.15, f"stereo ATE {rmse:.4f}"
