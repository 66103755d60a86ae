"""Throwaway diagnostic (not collected as test_*): circuit loop forensics.

Run: python -m pytest tests/diag_circuit.py -q -s
"""
import numpy as np
import jax.numpy as jnp

from multi_orb_slam import system as system_mod
from multi_orb_slam.geometry import align, camera as cam_mod
from multi_orb_slam.io import synthetic as syn
from multi_orb_slam.placerec import database as db_mod

from test_circuit_e2e import NF, K, H, W, make_cfg, make_rig, circuit  # noqa


def test_diag(circuit):
    frames, poses, voc = circuit
    cfg = make_cfg()
    T_rc = make_rig()
    calib = cam_mod.CameraParams(
        K=jnp.tile(jnp.asarray(K)[None], (2, 1)), dist=jnp.zeros((2, 5)),
        T_rc=T_rc, bf=jnp.asarray(20.0), width=W, height=H)
    slam = system_mod.System(calib=calib, cfg=cfg,
                             sensor=system_mod.Sensor.DUAL_RGBD,
                             enable_loop_closing=True)
    slam.loop_closer.voc = voc
    slam.loop_closer.db = db_mod.make_empty_db(cfg.max_kf, voc.n_words)
    for g, d in frames:
        slam.track_rgbd(g[0], d[0], g[1], d[1])
    slam.shutdown()
    traj = slam.tracker.absolute_trajectory()
    n_lost = sum(1 for *_, lost in traj if lost)
    est = np.stack([np.linalg.inv(T)[:3, 3] for fid, ts, T, lost in traj])
    gt = np.stack([np.linalg.inv(poses[min(fid, NF - 1)])[:3, 3]
                   for fid, ts, T, lost in traj])
    ate = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
    end_err = float(np.linalg.norm(est[-1] - gt[-1]))
    st = slam.tracker.map
    from multi_orb_slam.mapping import map_state as ms
    Wc = np.asarray(ms.covisibility(st, cam0_only=True))
    kv = np.asarray(st.kf_valid)
    fid_arr = np.asarray(st.kf_frame_id)
    # per-KF: nearest GT position and frame id, is the last KF connected to
    # the first-arc KFs?
    print(f"\nDIAG: n_lost={n_lost} loops={slam.loop_closer.n_loops_closed} "
          f"ate={ate:.4f} end_err={end_err:.4f} n_kf={int(st.n_kf)}")
    slots = [s for s in np.nonzero(kv)[0]]
    early = [s for s in slots if fid_arr[s] < NF // 4]
    late = [s for s in slots if fid_arr[s] > 3 * NF // 4]
    for s in late:
        conn = [int(e) for e in early if Wc[s, e] >= 15]
        print(f"  late KF slot={s} fid={fid_arr[s]} "
              f"connected-to-early={conn}")
    print(f"  early KFs: {[(int(s), int(fid_arr[s])) for s in early]}")
