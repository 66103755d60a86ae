import jax.numpy as jnp
import numpy as np

from multi_orb_slam.frontend import tracking
from multi_orb_slam.geometry import align
from multi_orb_slam.io import synthetic
from multi_orb_slam.mapping import fusion, local_mapping, map_state as ms, triangulation

from test_tracking import small_calib, small_cfg


def run_sequence_with_mapping(n_frames=15, **mapping_kwargs):
    cfg = small_cfg()._replace(max_frames_kf=4)
    calib = small_calib()
    seq = synthetic.make_sequence(
        n_frames=n_frames, K=np.asarray(calib.K[0]), height=240, width=320,
        n_points=2500,
    )
    tracker = tracking.Tracker(calib, cfg)

    def on_kf(kf_slot):
        return local_mapping.run_mapping_stage(
            tracker.map, kf_slot, tracker.frame_id, calib, cfg, **mapping_kwargs
        )

    tracker.kf_inserted_cb = on_kf
    for grays, depths in zip(seq.grays, seq.depths):
        s = tracker.process(grays, depths)
        assert s != tracking.TrackState.LOST
    return tracker, seq


class TestTriangulation:
    def test_triangulation_creates_points(self):
        tracker, _ = run_sequence_with_mapping(
            do_fuse=False, do_ba=False, do_cull=False
        )
        state = tracker.map
        # some points must have been created by triangulation: their
        # first_kf differs from -1 and they lack depth at creation; just
        # check map grew beyond the pure depth-creation path of a run
        # without triangulation
        tracker2, _ = run_sequence_with_mapping(
            do_triangulate=False, do_fuse=False, do_ba=False, do_cull=False
        )
        assert int(state.n_mp) > int(tracker2.map.n_mp)

    def test_triangulated_points_accurate(self):
        tracker, seq = run_sequence_with_mapping(
            do_fuse=False, do_ba=False, do_cull=False
        )
        est = np.stack([np.linalg.inv(T)[:3, 3] for _, _, T, _ in tracker.absolute_trajectory()])
        gt = np.stack([np.linalg.inv(T)[:3, 3] for T in seq.poses_gt])
        rmse = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert rmse < 0.08, f"ATE with triangulation {rmse:.4f}"


class TestFusion:
    def test_fusion_merges_duplicates(self):
        tracker, _ = run_sequence_with_mapping(
            do_ba=False, do_cull=False
        )
        state = tracker.map
        # duplicates merged: every feature slot with a map point id must
        # reference a valid point
        kf_mp = np.asarray(state.kf_mp)
        valid = np.asarray(state.mp_valid)
        referenced = kf_mp[kf_mp >= 0]
        assert valid[referenced].all()

    @staticmethod
    def _fuse_scenario():
        tracker, _ = run_sequence_with_mapping(
            do_fuse=False, do_ba=False, do_cull=False
        )
        state = tracker.map
        cfg = small_cfg()._replace(max_frames_kf=4)
        calib = small_calib()
        M = cfg.max_mp
        K = state.kf_mp.shape[0]
        kf = int(tracker.last_kf_slot)
        own = np.asarray(state.kf_mp[kf]).reshape(-1)
        mask = np.zeros(M, bool)
        mask[own[own >= 0]] = True
        W = np.asarray(ms.covisibility(state))
        nbrs = [int(n) for n in np.argsort(-W[kf])[:3] if W[kf][n] > 0]
        assert nbrs, "scenario must have covisible neighbors"
        return state, cfg, calib, mask, nbrs, M, K

    def test_batched_fuse_single_target_matches_fuse_into_kf(self):
        """A one-real-slot fuse_into_kfs batch (rest padding) must equal
        fuse_into_kf exactly — catches padding-slot corruption and
        replacement-table bugs without multi-step heuristic drift."""
        state, cfg, calib, mask, nbrs, M, K = self._fuse_scenario()
        slots = np.full(4, K - 1, np.int32)
        slots[0] = nbrs[0]
        batched, n_b = fusion.fuse_into_kfs(
            state, jnp.asarray(mask), jnp.asarray(slots), cfg, calib)
        single, n_s = fusion.fuse_into_kf(
            state, jnp.asarray(mask), jnp.asarray(nbrs[0]), cfg, calib)
        assert int(n_b) == int(n_s) and int(n_s) > 0
        np.testing.assert_array_equal(
            np.asarray(batched.kf_mp), np.asarray(single.kf_mp))
        np.testing.assert_array_equal(
            np.asarray(batched.mp_valid), np.asarray(single.mp_valid))
        np.testing.assert_array_equal(
            np.asarray(batched.mp_replaced), np.asarray(single.mp_replaced))
        assert int(batched.n_mp) == int(single.n_mp)

    def test_batched_fuse_chained_invariants(self):
        """Multi-target fuse with chained merges: the carried-count design
        may legally pick different (still serial-consistent) merge
        directions than per-call finalization, so exact state equality is
        not the contract — store INVARIANTS are:
        - every referenced landmark is alive,
        - at most one feature per (KF, camera) row per landmark,
        - mp_replaced chains resolve to live landmarks,
        - n_mp matches the live count and merges were found,
        - the batched and sequential paths agree on n_mp within the
          direction-flip tolerance (identical duplicate structure)."""
        state, cfg, calib, mask, nbrs, M, K = self._fuse_scenario()
        slots = np.full(4, K - 1, np.int32)
        slots[: len(nbrs)] = nbrs

        batched, n_b = fusion.fuse_into_kfs(
            state, jnp.asarray(mask), jnp.asarray(slots), cfg, calib)
        seq_state = state
        n_s = 0
        for s in slots:
            seq_state, n = fusion.fuse_into_kf(
                seq_state, jnp.asarray(mask), jnp.asarray(int(s)), cfg,
                calib)
            n_s += int(n)
        assert int(n_b) > 0 and n_s > 0
        assert abs(int(n_b) - n_s) <= max(3, int(0.15 * n_s)), (
            int(n_b), n_s)

        for out in (batched, seq_state):
            kf_mp = np.asarray(out.kf_mp)
            valid = np.asarray(out.mp_valid)
            refs = kf_mp[kf_mp >= 0]
            assert valid[refs].all(), "observation references a dead point"
            rows = kf_mp.reshape(-1, kf_mp.shape[-1])
            for r in range(rows.shape[0]):
                live = rows[r][rows[r] >= 0]
                assert len(live) == len(set(live.tolist())), r
            rep = np.asarray(out.mp_replaced)
            idx = np.arange(M)
            res = np.where(rep >= 0, rep, idx)
            for _ in range(8):
                res = res[res]
            merged = rep >= 0
            assert valid[res[merged]].all(), \
                "mp_replaced chain ends on a dead landmark"
            assert not valid[merged].any(), "a merged loser is still valid"
            assert int(out.n_mp) == int(valid.sum())

    def test_full_mapping_stage_ate(self):
        tracker, seq = run_sequence_with_mapping()
        est = np.stack([np.linalg.inv(T)[:3, 3] for _, _, T, _ in tracker.absolute_trajectory()])
        gt = np.stack([np.linalg.inv(T)[:3, 3] for T in seq.poses_gt])
        rmse = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert rmse < 0.05, f"ATE with full mapping {rmse:.4f}"
        assert int(tracker.map.n_kf) >= 3
