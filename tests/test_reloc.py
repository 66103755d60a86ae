import jax
import jax.numpy as jnp
import numpy as np

from multi_orb_slam.geometry import se3
from multi_orb_slam.loop import loop_closing
from multi_orb_slam.reloc import pnp, relocalization
from multi_orb_slam.io import synthetic
from multi_orb_slam import system as system_mod

from test_tracking import small_calib, small_cfg
from test_system import make_system


class TestPnP:
    def make(self, seed=0, n=150, n_out=0, noise=0.5):
        rng = np.random.RandomState(seed)
        Xw = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        Xw[:, 2] += 5.0
        Tcw = np.asarray(se3.exp(jnp.asarray(
            [0.2, -0.1, 0.3, 0.1, -0.2, 0.15], jnp.float32)))
        K = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
        Xc = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
        uv = np.stack([
            K[0] * Xc[:, 0] / Xc[:, 2] + K[2],
            K[1] * Xc[:, 1] / Xc[:, 2] + K[3],
        ], -1) + rng.randn(n, 2).astype(np.float32) * noise
        valid = Xc[:, 2] > 0.3
        if n_out:
            idx = rng.choice(np.nonzero(valid)[0], n_out, replace=False)
            uv[idx] += rng.uniform(30, 100, (n_out, 2))
        return Tcw, jnp.asarray(uv), jnp.asarray(Xw), jnp.asarray(valid), jnp.asarray(K)

    def test_recovers_pose(self):
        Tcw, uv, Xw, valid, K = self.make()
        T, inl, n = pnp.pnp_ransac(jax.random.PRNGKey(0), uv, Xw, valid, K)
        d = float(jnp.linalg.norm(se3.log(T @ jnp.linalg.inv(jnp.asarray(Tcw)))))
        assert d < 0.02, d
        assert int(n) > 100

    def test_robust_to_outliers(self):
        Tcw, uv, Xw, valid, K = self.make(n_out=40)
        T, inl, n = pnp.pnp_ransac(jax.random.PRNGKey(1), uv, Xw, valid, K)
        d = float(jnp.linalg.norm(se3.log(T @ jnp.linalg.inv(jnp.asarray(Tcw)))))
        assert d < 0.03, d


class TestRelocalization:
    def test_recover_after_blackout(self):
        sys_, cfg, calib = make_system(enable_loop=True, max_frames_kf=3)
        sys_.loop_closer = loop_closing.LoopCloser(
            calib, cfg, vocab_min_descs=1200, vocab_k=6, vocab_depth=3)
        sys_.tracker.kf_inserted_cb = sys_._on_keyframe
        seq = synthetic.make_sequence(
            n_frames=20, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=3000,
        )
        blank = np.full_like(seq.grays[0], 100.0)
        zero_d = np.zeros_like(seq.depths[0])
        states = []
        for i, (g, d) in enumerate(zip(seq.grays, seq.depths)):
            if 12 <= i < 15:   # blackout: untrackable frames
                states.append(sys_.track_rgbd(blank[0], zero_d[0]) is not None
                              and sys_.get_tracking_state())
            else:
                sys_.track_rgbd(g[0], d[0])
                states.append(sys_.get_tracking_state())
        # vocabulary must exist for relocalization
        assert sys_.loop_closer.voc is not None
        # lost during blackout
        assert 2 in states[12:15]
        # recovered afterwards
        assert states[-1] == 1, states
        # recovered pose accurate (in the map gauge: world = frame-0 camera)
        gt_T = seq.poses_gt[-1] @ np.linalg.inv(seq.poses_gt[0])
        est_c = np.linalg.inv(np.asarray(sys_.tracker.Tcw))[:3, 3]
        gt_c = np.linalg.inv(gt_T)[:3, 3]
        assert np.linalg.norm(est_c - gt_c) < 0.2
