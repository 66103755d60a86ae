import jax.numpy as jnp
import numpy as np

from multi_orb_slam.frontend import tracking
from multi_orb_slam.geometry import align, camera as cam_mod
from multi_orb_slam.io import synthetic
from multi_orb_slam.mapping import map_state as ms
from multi_orb_slam.ops import orb


def small_cfg(n_cams=1):
    return tracking.SlamConfig(
        n_cams=n_cams,
        max_feat=512,
        max_kf=32,
        max_mp=8192,
        local_cap=1024,
        new_mp_per_cam=128,
        width=320,
        height=240,
        th_depth=6.0,
        orb=orb.ORBConfig(n_features=512),
    )


def small_calib(n_cams=1):
    K = jnp.tile(jnp.asarray([[260.0, 260.0, 160.0, 120.0]]), (n_cams, 1))
    dist = jnp.zeros((n_cams, 5))
    T_rc = jnp.tile(jnp.eye(4)[None], (n_cams, 1, 1))
    return cam_mod.CameraParams(
        K=K, dist=dist, T_rc=T_rc, bf=jnp.asarray(20.0), width=320, height=240
    )


class TestMapState:
    def test_allocate_slots(self):
        valid = jnp.zeros(16, bool).at[jnp.asarray([0, 2])].set(True)
        want = jnp.asarray([True, False, True, True])
        slots = np.asarray(ms.allocate_mp_slots(valid, want))
        assert slots[1] == -1
        got = [s for s in slots if s >= 0]
        assert len(set(got)) == 3
        assert all(valid[s] == False for s in got)  # noqa: E712
        assert 15 not in got  # last slot reserved

    def test_covisibility(self):
        state = ms.make_empty(4, 1, 8, 64)
        # kf0 and kf1 share points 1, 2; kf1/kf2 share nothing
        kf_mp = state.kf_mp
        kf_mp = kf_mp.at[0, 0, 0].set(1).at[0, 0, 1].set(2).at[0, 0, 2].set(3)
        kf_mp = kf_mp.at[1, 0, 0].set(1).at[1, 0, 1].set(2)
        kf_mp = kf_mp.at[2, 0, 0].set(5)
        state = state._replace(
            kf_mp=kf_mp,
            kf_valid=state.kf_valid.at[:3].set(True),
            mp_valid=state.mp_valid.at[jnp.asarray([1, 2, 3, 5])].set(True),
        )
        W = np.asarray(ms.covisibility(state))
        assert W[0, 1] == 2 and W[1, 0] == 2
        assert W[0, 2] == 0 and W[1, 2] == 0
        assert W[0, 0] == 0  # diagonal zeroed

    def test_obs_count(self):
        state = ms.make_empty(4, 1, 8, 64)
        kf_mp = state.kf_mp.at[0, 0, 0].set(7).at[1, 0, 3].set(7).at[2, 0, 2].set(7)
        state = state._replace(
            kf_mp=kf_mp,
            kf_valid=state.kf_valid.at[:3].set(True),
            kf_feat_valid=state.kf_feat_valid.at[:3].set(True),
            mp_valid=state.mp_valid.at[7].set(True),
        )
        cnt = np.asarray(ms.mp_observation_count(state))
        assert cnt[7] == 3


class TestOdometry:
    def test_synthetic_sequence_ate(self):
        cfg = small_cfg()
        calib = small_calib()
        seq = synthetic.make_sequence(
            n_frames=15,
            K=np.asarray(calib.K[0]),
            height=240, width=320,
            n_points=2500,
        )
        tracker = tracking.Tracker(calib, cfg)
        states = []
        for grays, depths in zip(seq.grays, seq.depths):
            states.append(tracker.process(grays, depths))
        assert states[0] == tracking.TrackState.OK, "init failed"
        n_ok = sum(1 for s in states if s == tracking.TrackState.OK)
        assert n_ok >= 14, f"tracking lost: {states}"

        est = np.stack([np.linalg.inv(T)[:3, 3] for _, _, T, _ in tracker.absolute_trajectory()])
        gt = np.stack([np.linalg.inv(T)[:3, 3] for T in seq.poses_gt])
        rmse = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert rmse < 0.05, f"ATE RMSE {rmse:.4f} m"

    def test_pipelined_parity(self):
        # the fused zero-sync step must produce the same map/trajectory as
        # the stepwise path; the single-dispatch variant with extraction
        # folded in (fuse_extraction — the bench's hot path) must agree too
        cfg = small_cfg()._replace(max_frames_kf=5)
        calib = small_calib()
        seq = synthetic.make_sequence(
            n_frames=10, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=2500,
        )
        outs = []
        for pipe, fuse in ((False, False), (True, False), (True, True)):
            tracker = tracking.Tracker(calib, cfg, pipelined=pipe)
            tracker.fuse_extraction = fuse
            for grays, depths in zip(seq.grays, seq.depths):
                tracker.process(jnp.asarray(grays), jnp.asarray(depths))
            est = np.stack([T for _, _, T, _ in tracker.absolute_trajectory()])
            outs.append((est, int(tracker.map.n_kf), int(tracker.map.n_mp)))
        for other in outs[1:]:
            np.testing.assert_allclose(outs[0][0], other[0], atol=1e-5)
            assert outs[0][1:] == other[1:]

    def test_keyframes_inserted(self):
        cfg = small_cfg()._replace(max_frames_kf=5)
        calib = small_calib()
        seq = synthetic.make_sequence(
            n_frames=12, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=2500,
        )
        tracker = tracking.Tracker(calib, cfg)
        for grays, depths in zip(seq.grays, seq.depths):
            tracker.process(grays, depths)
        assert int(tracker.map.n_kf) >= 2
        assert int(tracker.map.n_mp) > 200
