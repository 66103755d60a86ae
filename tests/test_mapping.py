import jax.numpy as jnp
import numpy as np

from multi_orb_slam.frontend import tracking
from multi_orb_slam.geometry import align
from multi_orb_slam.io import synthetic
from multi_orb_slam.mapping import local_mapping

from test_tracking import small_calib, small_cfg


class TestLocalMappingIntegration:
    def test_tracking_with_local_ba(self):
        cfg = small_cfg()._replace(max_frames_kf=4)
        calib = small_calib()
        seq = synthetic.make_sequence(
            n_frames=15, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=2500,
        )
        tracker = tracking.Tracker(calib, cfg)

        def on_kf(kf_slot):
            m = tracker.map
            if int(m.n_kf) > 2:
                m = local_mapping.run_local_ba(
                    m, kf_slot, calib, cfg, n_free=6, n_fixed=6
                )
                m = local_mapping.cull_map_points(
                    m, jnp.asarray(tracker.frame_id, jnp.int32), cfg
                )
            return m

        tracker.kf_inserted_cb = on_kf
        for grays, depths in zip(seq.grays, seq.depths):
            s = tracker.process(grays, depths)
            assert s != tracking.TrackState.LOST

        assert int(tracker.map.n_kf) >= 3
        est = np.stack([np.linalg.inv(T)[:3, 3] for _, _, T, _ in tracker.absolute_trajectory()])
        gt = np.stack([np.linalg.inv(T)[:3, 3] for T in seq.poses_gt])
        rmse = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert rmse < 0.05, f"ATE RMSE with local BA {rmse:.4f} m"

    def test_cull_keyframes_removes_redundant(self):
        # 5 KFs all observing the same 20 close points at octave 0: slots
        # 1-3 are mutually redundant.  Serial culling (the reference's loop,
        # LocalMapping.cc:966-1038) erases victims one at a time, each
        # erasure shrinking later support counts: after two culls every
        # point has 3 observers, so a third cull (support 2 < 3) must NOT
        # happen — the multi-victim scan must reproduce exactly that.
        from multi_orb_slam.mapping import map_state as ms
        cfg = small_cfg()
        state = ms.make_empty(8, 1, 16, 128)
        n_pts = 20
        kf_mp = state.kf_mp
        for k in range(5):
            for j in range(n_pts):
                kf_mp = kf_mp.at[k, 0, j].set(j)
        state = state._replace(
            kf_mp=kf_mp,
            kf_valid=state.kf_valid.at[:5].set(True),
            kf_feat_valid=state.kf_feat_valid.at[:5].set(True),
            kf_depth=state.kf_depth.at[:5, :, :n_pts].set(
                0.5 * cfg.th_depth),  # close points (the RGB-D gate)
            mp_valid=state.mp_valid.at[:n_pts].set(True),
            n_kf=jnp.asarray(5, jnp.int32),
        )
        out = local_mapping.cull_keyframes(state, jnp.asarray(4, jnp.int32), cfg)
        # two redundant KFs culled (never slot 0 or center 4); a third cull
        # would leave points with only 2 observers
        assert int(out.n_kf) == 3
        assert bool(out.kf_valid[0]) and bool(out.kf_valid[4])
        # erased keyframes must have dropped their observation rows
        erased = [k for k in range(1, 4) if not bool(out.kf_valid[k])]
        assert len(erased) == 2
        for k in erased:
            assert int(jnp.sum(out.kf_mp[k] >= 0)) == 0

    def test_cull_keyframes_octave_condition(self):
        # supporters must observe at the same-or-finer octave: 4 KFs observe
        # the same close points but 3 of them at a much COARSER level (3),
        # so for the candidate's level-0 observations only level <= 1
        # observers count and nothing may be culled
        from multi_orb_slam.mapping import map_state as ms
        cfg = small_cfg()
        state = ms.make_empty(8, 1, 16, 128)
        n_pts = 20
        kf_mp = state.kf_mp
        kf_level = state.kf_level
        for k in range(5):
            for j in range(n_pts):
                kf_mp = kf_mp.at[k, 0, j].set(j)
                kf_level = kf_level.at[k, 0, j].set(0 if k in (1, 4) else 3)
        state = state._replace(
            kf_mp=kf_mp, kf_level=kf_level,
            kf_valid=state.kf_valid.at[:5].set(True),
            kf_feat_valid=state.kf_feat_valid.at[:5].set(True),
            kf_depth=state.kf_depth.at[:5, :, :n_pts].set(
                0.5 * cfg.th_depth),
            mp_valid=state.mp_valid.at[:n_pts].set(True),
            n_kf=jnp.asarray(5, jnp.int32),
        )
        out = local_mapping.cull_keyframes(state, jnp.asarray(4, jnp.int32), cfg)
        # slot 1 (level-0 observations) has same-or-finer supporters only at
        # level <= 1, i.e. just KF4 -> 1 < 3 -> MUST be kept despite four
        # coarse observers.  Slots 2 and 3 (level-3 observations) count all
        # other KFs (levels 0 and 3 <= 3+1) as supporters: 2 is culled with
        # 4 supporters, then 3 still has 3 (KFs 0, 1, 4) and is culled too.
        assert int(out.n_kf) == 3
        assert bool(out.kf_valid[1])
        assert not bool(out.kf_valid[2]) and not bool(out.kf_valid[3])


class TestAdaptiveWindow:
    def test_covis_kf_count_matches_covisibility_row(self):
        from multi_orb_slam.mapping import map_state as ms
        rng = np.random.RandomState(3)
        state = ms.make_empty(8, 1, 32, 256)
        kf_mp = np.full((8, 1, 32), -1, np.int32)
        # kf0 shares 20 points with kf1, 15 with kf2, 5 with kf3
        kf_mp[0, 0, :25] = np.arange(25)
        kf_mp[1, 0, :20] = np.arange(20)
        kf_mp[2, 0, :15] = np.arange(15)
        kf_mp[3, 0, :5] = np.arange(5)
        state = state._replace(
            kf_mp=jnp.asarray(kf_mp),
            kf_valid=state.kf_valid.at[:4].set(True),
            kf_feat_valid=state.kf_feat_valid.at[:4].set(True),
            mp_valid=state.mp_valid.at[:25].set(True),
            n_kf=jnp.asarray(4, jnp.int32),
        )
        n = int(local_mapping.covis_kf_count(state, jnp.asarray(0, jnp.int32)))
        W = np.asarray(ms.covisibility(state))
        expect = int(np.sum(W[0] >= 15))
        assert n == expect == 2

    def test_adaptive_mapping_stage_tracks(self):
        # same scenario as test_tracking_with_local_ba but through the full
        # adaptive mapping stage (bucketed window selection)
        cfg = small_cfg()._replace(max_frames_kf=4, ba_adaptive=True)
        calib = small_calib()
        seq = synthetic.make_sequence(
            n_frames=12, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=2500,
        )
        tracker = tracking.Tracker(calib, cfg)
        tracker.kf_inserted_cb = lambda kf_slot: local_mapping.run_mapping_stage(
            tracker.map, kf_slot, tracker.frame_id, calib, cfg)
        for grays, depths in zip(seq.grays, seq.depths):
            s = tracker.process(grays, depths)
            assert s != tracking.TrackState.LOST
        est = np.stack([np.linalg.inv(T)[:3, 3]
                        for _, _, T, _ in tracker.absolute_trajectory()])
        gt = np.stack([np.linalg.inv(T)[:3, 3] for T in seq.poses_gt])
        rmse = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert rmse < 0.05, f"adaptive-window ATE {rmse:.4f} m"
