import jax.numpy as jnp
import numpy as np

from multi_orb_slam.frontend import tracking
from multi_orb_slam.geometry import align, se3
from multi_orb_slam.io import synthetic
from multi_orb_slam.mapping import local_mapping
from multi_orb_slam.optim import global_ba

from test_tracking import small_calib, small_cfg


def build_map():
    cfg = small_cfg()._replace(max_frames_kf=3)
    calib = small_calib()
    seq = synthetic.make_sequence(
        n_frames=12, K=np.asarray(calib.K[0]), height=240, width=320,
        n_points=2500,
    )
    tracker = tracking.Tracker(calib, cfg)
    tracker.kf_inserted_cb = lambda k: local_mapping.run_mapping_stage(
        tracker.map, k, tracker.frame_id, calib, cfg,
        do_ba=False, do_cull=False,
    )
    for grays, depths in zip(seq.grays, seq.depths):
        tracker.process(grays, depths)
    return tracker, seq, cfg, calib


class TestGlobalBA:
    def test_gba_reduces_perturbation(self):
        tracker, seq, cfg, calib = build_map()
        state = tracker.map
        assert int(state.n_kf) >= 3
        # perturb all KF poses except slot 0 and all points
        rng = np.random.RandomState(0)
        K = state.kf_Tcw.shape[0]
        pert = np.zeros((K, 6), np.float32)
        pert[1:] = rng.randn(K - 1, 6) * 0.05
        Tcw_pert = jnp.asarray(
            np.stack([
                np.asarray(se3.exp(jnp.asarray(pert[k])) @ state.kf_Tcw[k])
                for k in range(K)
            ])
        )
        pos_pert = state.mp_pos + jnp.asarray(
            rng.randn(*state.mp_pos.shape).astype(np.float32) * 0.05
        ) * state.mp_valid[:, None]
        pert_state = state._replace(kf_Tcw=Tcw_pert, mp_pos=pos_pert)

        out = global_ba.run_global_ba(pert_state, calib, cfg, n_outer=8)

        # compare keyframe trajectories against ground truth (Horn-aligned:
        # the map's gauge anchors KF0 at identity, GT has its own frame)
        kf_ids = [k for k in range(K) if bool(state.kf_valid[k])]
        frame_of = {int(state.kf_frame_id[k]): k for k in kf_ids}
        gt_centers = np.stack([
            np.linalg.inv(seq.poses_gt[fid])[:3, 3] for fid in sorted(frame_of)
        ])

        def kf_ate(s):
            est = np.stack([
                np.asarray(se3.camera_center(s.kf_Tcw[frame_of[fid]]))
                for fid in sorted(frame_of)
            ])
            return float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt_centers)))

        ate_orig = kf_ate(state)
        ate_pert = kf_ate(pert_state)
        ate_after = kf_ate(out)
        assert ate_after < ate_pert, (ate_orig, ate_pert, ate_after)
        assert ate_after < 2.0 * ate_orig + 5e-3, (ate_orig, ate_pert, ate_after)

    def test_gba_keeps_first_kf_fixed(self):
        tracker, seq, cfg, calib = build_map()
        state = tracker.map
        out = global_ba.run_global_ba(state, calib, cfg, n_outer=3)
        np.testing.assert_allclose(
            np.asarray(out.kf_Tcw[0]), np.asarray(state.kf_Tcw[0]), atol=1e-7
        )


class TestAsyncGBAMerge:
    def test_merge_gba_propagates_to_new_entities(self):
        """_merge_gba: launch-era KFs/points take GBA output verbatim;
        keyframes/points born during the solve are corrected through their
        spanning-tree parent / creating keyframe (the propagation of
        reference src/LoopClosing.cc:927-989)."""
        from multi_orb_slam.loop.loop_closing import _merge_gba
        from multi_orb_slam.mapping import map_state as ms

        state = ms.make_empty(8, 1, 32, 64)
        # two launch-era keyframes (slots 0, 1) + one born during GBA (2)
        rng = np.random.RandomState(0)
        T0 = jnp.eye(4, dtype=jnp.float32)
        T1 = jnp.asarray(se3.exp(jnp.asarray(
            [0.1, -0.05, 0.2, 0.02, -0.03, 0.01], jnp.float32)))
        T2 = jnp.asarray(se3.exp(jnp.asarray(
            [0.3, 0.1, -0.1, -0.02, 0.04, 0.05], jnp.float32)))
        kf_Tcw = state.kf_Tcw.at[0].set(T0).at[1].set(T1).at[2].set(T2)
        # shared observations make slot 1 the max-covisibility parent of 2
        kf_mp = state.kf_mp
        for j in range(20):
            kf_mp = kf_mp.at[0, 0, j].set(j)
        for j in range(20):
            kf_mp = kf_mp.at[1, 0, j].set(j if j < 16 else 40 + j)
        for j in range(20):
            kf_mp = kf_mp.at[2, 0, j].set(j)  # shares 16 pts with 1, 20 w/ 0
        # ... make parent selection unambiguous: slot 1 shares MORE with 2
        kf_mp = kf_mp.at[2, 0, :16].set(jnp.arange(16))
        kf_mp = kf_mp.at[2, 0, 16:20].set(jnp.arange(56, 60))
        kf_mp = kf_mp.at[1, 0, 16:20].set(jnp.arange(56, 60))
        kf_mp = kf_mp.at[0, 0, 12:20].set(-1)  # 0 shares only 12 with 2
        pos = jnp.asarray(rng.uniform(-1, 1, (64, 3)), jnp.float32)
        state = state._replace(
            kf_Tcw=kf_Tcw, kf_mp=kf_mp,
            kf_valid=state.kf_valid.at[:3].set(True),
            kf_frame_id=state.kf_frame_id.at[:3].set(
                jnp.asarray([0, 10, 20])),
            kf_feat_valid=state.kf_feat_valid.at[:3].set(True),
            mp_pos=pos,
            mp_valid=state.mp_valid.at[:60].set(True),
            mp_first_kf=state.mp_first_kf.at[:56].set(0).at[56:60].set(2),
            mp_first_frame=state.mp_first_frame.at[:56].set(0)
            .at[56:60].set(20),
            n_kf=jnp.asarray(3, jnp.int32),
        )
        # snapshot at launch: slots 0,1 / points 0..55 existed
        old_kf = jnp.zeros(8, bool).at[:2].set(True)
        old_mp = jnp.zeros(64, bool).at[:56].set(True)
        # GBA output: rigidly move the launch-era map by a known transform G
        G = jnp.asarray(se3.exp(jnp.asarray(
            [0.05, 0.02, -0.04, 0.01, 0.02, -0.01], jnp.float32)))
        Ginv = se3.inverse(G)
        Tcw_gba = jnp.einsum("kij,jl->kil", kf_Tcw, Ginv)
        pos_gba = pos @ G[:3, :3].T + G[:3, 3]

        out = _merge_gba(state, Tcw_gba, pos_gba, old_kf,
                         state.kf_frame_id, old_mp, state.mp_first_frame)
        # old KFs: exactly the GBA poses
        np.testing.assert_allclose(np.asarray(out.kf_Tcw[:2]),
                                   np.asarray(Tcw_gba[:2]), atol=1e-5)
        # new KF: corrected through parent 1 -> under a rigid G the child
        # must ALSO land on Tcw @ G^-1
        np.testing.assert_allclose(np.asarray(out.kf_Tcw[2]),
                                   np.asarray(T2 @ Ginv), atol=1e-5)
        # old points: GBA positions; new points (created by KF 2):
        # re-anchored through KF 2's old->new transform = same rigid G
        np.testing.assert_allclose(np.asarray(out.mp_pos[:56]),
                                   np.asarray(pos_gba[:56]), atol=1e-5)
        exp_new = pos[56:60] @ np.asarray(G)[:3, :3].T + np.asarray(G)[:3, 3]
        np.testing.assert_allclose(np.asarray(out.mp_pos[56:60]),
                                   exp_new, atol=1e-5)

    def test_slot_recycling_guard(self):
        """A slot culled and reused during the solve must be treated as
        new, not overwritten with the stale GBA pose."""
        from multi_orb_slam.loop.loop_closing import _merge_gba
        from multi_orb_slam.mapping import map_state as ms

        state = ms.make_empty(4, 1, 8, 16)
        T_new = jnp.asarray(se3.exp(jnp.asarray(
            [0.5, 0.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)))
        state = state._replace(
            kf_Tcw=state.kf_Tcw.at[1].set(T_new),
            kf_valid=state.kf_valid.at[:2].set(True),
            kf_frame_id=state.kf_frame_id.at[0].set(0).at[1].set(99),
            n_kf=jnp.asarray(2, jnp.int32),
        )
        old_kf = jnp.zeros(4, bool).at[:2].set(True)
        fid_launch = jnp.asarray([0, 5, -1, -1], jnp.int32)  # slot1 held f5
        Tcw_gba = jnp.tile(jnp.eye(4, dtype=jnp.float32), (4, 1, 1))
        out = _merge_gba(state, Tcw_gba,
                         state.mp_pos, old_kf, fid_launch,
                         jnp.zeros(16, bool), state.mp_first_frame)
        # slot 1 now holds frame 99 != launch frame 5: GBA pose NOT applied
        np.testing.assert_allclose(np.asarray(out.kf_Tcw[1]),
                                   np.asarray(T_new), atol=1e-6)
