"""End-to-end loop/place-recognition behavior on a noisy corridor revisit.

With realistic (Kinect-like quadratic) depth noise, odometry drifts on the
outbound leg; on the return the tracker re-associates against the original
map (implicit loop closure through the persistent map — the same behavior
the reference exhibits when covisibility survives).  The explicit loop
detector must therefore: (a) propose no false loops mid-corridor (geometric
verification gates), (b) stay quiet when the revisit is already
covisibility-connected, exactly like the reference's connected-KF exclusion
(KeyFrameDatabase.cc:152-160)."""

import numpy as np
import jax.numpy as jnp

from multi_orb_slam import system as system_mod
from multi_orb_slam.config import SlamConfig
from multi_orb_slam.geometry import align
from multi_orb_slam.io import synthetic
from multi_orb_slam.loop import loop_closing
from multi_orb_slam.mapping import map_state as ms
from multi_orb_slam.ops import orb

from test_tracking import small_calib


def corridor_frames(nf=64, noise=0.003, seed=0):
    rng = np.random.RandomState(seed)
    n = 5000
    pts = np.zeros((n, 3), np.float32)
    pts[:, 0] = rng.uniform(-9, 9, n)
    pts[:, 1] = rng.uniform(-2, 2, n)
    pts[:, 2] = 3.0
    world = synthetic.World(
        pts, rng.uniform(30, 235, (n, 3, 3)).astype(np.float32),
        rng.uniform(0.02, 0.06, n).astype(np.float32),
        np.full(n, 2, np.int32), np.full(n, 3.0, np.float32))
    K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
    poses = synthetic.out_and_back_trajectory(nf, extent=5.0)
    frames = []
    for i in range(nf):
        g, d = synthetic.render_rgbd(world, K, poses[i], 240, 320)
        d = np.where(d > 0,
                     d + rng.randn(*d.shape).astype(np.float32) * noise * d * d,
                     0)
        frames.append((g, d))
    return frames, poses


class TestLoopE2E:
    def test_corridor_revisit(self):
        frames, poses = corridor_frames()
        calib = small_calib()
        cfg = SlamConfig(
            n_cams=1, max_feat=512, max_kf=48, max_mp=12288, local_cap=2048,
            new_mp_per_cam=128, width=320, height=240, th_depth=6.0,
            max_frames_kf=4, orb=orb.ORBConfig(n_features=512))
        sys_ = system_mod.System(
            sensor=system_mod.Sensor.RGBD, calib=calib, cfg=cfg,
            enable_loop_closing=True)
        sys_.loop_closer = loop_closing.LoopCloser(
            calib, cfg, vocab_min_descs=2000, vocab_k=10, vocab_depth=3)
        sys_.tracker.kf_inserted_cb = sys_._on_keyframe
        lost = 0
        for i, (g, d) in enumerate(frames):
            sys_.track_rgbd(g, d, timestamp=i / 30.0)
            lost += sys_.get_tracking_state() == 2
        assert lost <= 3, f"lost {lost} frames"
        # vocabulary + database operational
        assert sys_.loop_closer.voc is not None
        # mid-corridor BoW aliases must have been rejected by geometric
        # verification / recency gates: no spurious loop closures
        assert sys_.loop_closer.n_loops_closed == 0
        # the return leg must re-associate with the outbound map: the last
        # keyframes are covisibility-connected to the first ones
        state = sys_.map
        W = np.asarray(ms.covisibility(state, cam0_only=True))
        fids = np.asarray(state.kf_frame_id)
        valid = np.asarray(state.kf_valid)
        early = [k for k in np.nonzero(valid)[0] if fids[k] <= 8]
        late = [k for k in np.nonzero(valid)[0] if fids[k] >= len(frames) - 10]
        assert early and late
        assert max(W[a, b] for a in early for b in late) >= 15, (
            "return leg failed to re-associate with the outbound map")
        # drift bounded (noisy depth; the far end carries most of the error)
        traj = sys_.tracker.absolute_trajectory()
        est = np.stack([np.linalg.inv(T)[:3, 3] for _, _, T, _ in traj])
        gt = np.stack([np.linalg.inv(p)[:3, 3] for p in poses])
        ate = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
        assert ate < 2.0, f"ATE {ate}"

    def test_correct_loop_reduces_drift(self):
        """Drive _correct_loop directly on a synthetically drifted map."""
        from multi_orb_slam.frontend import tracking
        from multi_orb_slam.geometry import se3, sim3
        from multi_orb_slam.mapping import local_mapping
        from test_tracking import small_cfg

        calib = small_calib()
        cfg = small_cfg()._replace(max_frames_kf=3)
        seq = synthetic.make_sequence(
            n_frames=15, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=2500)
        tr = tracking.Tracker(calib, cfg)
        tr.kf_inserted_cb = lambda k: local_mapping.run_mapping_stage(
            tr.map, k, tr.frame_id, calib, cfg, do_ba=False, do_cull=False)
        for g, d in zip(seq.grays, seq.depths):
            tr.process(g, d)
        state = tr.map
        kfv = np.asarray(state.kf_valid)
        fids = np.asarray(state.kf_frame_id)
        order = sorted(np.nonzero(kfv)[0], key=lambda k: fids[k])
        assert len(order) >= 4
        kf_b, kf_a = int(order[0]), int(order[-1])

        # inject drift: last KF (and its points) shifted by a known offset
        drift = se3.exp(jnp.asarray([0.15, -0.1, 0.08, 0.02, -0.04, 0.03]))
        Tcw_a = state.kf_Tcw[kf_a]
        state_d = state._replace(
            kf_Tcw=state.kf_Tcw.at[kf_a].set(drift @ Tcw_a))

        # ground-truth correction: g_ab maps b-frame rig coords to the TRUE
        # a-frame coords: S_aw_true = g_ab o S_bw
        g_true_a = sim3.from_se3(Tcw_a)
        g_b = sim3.from_se3(state.kf_Tcw[kf_b])
        g_ab = sim3.compose(g_true_a, sim3.inverse(g_b))

        lc = loop_closing.LoopCloser(calib, cfg, run_gba=False)
        out = lc._correct_loop(state_d, kf_a, kf_b, g_ab)

        def err(st):
            d = se3.log(st.kf_Tcw[kf_a] @ se3.inverse(Tcw_a))
            return float(jnp.linalg.norm(d))

        e_before = err(state_d)
        e_after = err(out)
        assert e_after < 0.35 * e_before, (e_before, e_after)
