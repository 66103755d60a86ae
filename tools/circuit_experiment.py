"""Exploration: outward-facing circuit with the real ~90-deg rig.

Drives the dual-camera system through `io/synthetic.circuit_trajectory`
(the corridor-and-corner analog the fork was built for: all-cam tracking
through rotation-heavy views, reference src/Tracking.cc:1235-1328) and
reports tracked fraction, keyframe count, loop closures, and ATE.

Usage: python tools/circuit_experiment.py [n_frames] [drift]
"""
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from multi_orb_slam import system as system_mod
from multi_orb_slam.config import SlamConfig
from multi_orb_slam.geometry import align, camera as cam_mod, se3
from multi_orb_slam.io import synthetic as syn
from multi_orb_slam.ops import orb as orb_mod
from multi_orb_slam.placerec import database as db_mod
from multi_orb_slam.placerec import vocabulary as vocab_mod

NF = int(sys.argv[1]) if len(sys.argv) > 1 else 240
DRIFT = float(sys.argv[2]) if len(sys.argv) > 2 else 0.05
DRIFT_END = float(sys.argv[3]) if len(sys.argv) > 3 else 0.45
H, W = 240, 320
K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)


def main():
    cfg = SlamConfig(
        n_cams=2, max_feat=512, width=W, height=H, max_frames_kf=12,
        th_depth=4.0, local_cap=1024, ba_local_cap=2048,
        orb=orb_mod.ORBConfig(n_features=512))
    # the reference rig: cam2 rotated ~90 deg about Y (calibration.txt)
    Ry = se3.so3_exp(jnp.asarray([0.0, np.pi / 2, 0.0]))
    T_rc1 = (jnp.eye(4).at[:3, :3].set(Ry)
             .at[:3, 3].set(jnp.asarray([0.161, 0.004, -0.071])))
    T_rc = jnp.stack([jnp.eye(4), T_rc1]).astype(jnp.float32)
    calib = cam_mod.CameraParams(
        K=jnp.tile(jnp.asarray(K)[None], (2, 1)), dist=jnp.zeros((2, 5)),
        T_rc=T_rc, bf=jnp.asarray(20.0), width=W, height=H)

    world = syn.make_box_world(seed=3, n_points=5000, box=(7.0, 4.0, 7.0))
    poses = syn.circuit_trajectory(NF, radius=2.2, laps=1.25)
    t0 = time.time()
    frames = []
    for i in range(NF):
        gs, ds = [], []
        s = i / (NF - 1)
        for c in range(2):
            Tcw = np.asarray(T_rc[c]) @ poses[i]
            g, d = syn.render_rgbd(world, K, Tcw, H, W)
            # natural drift: depth-scale ramp on the first half-lap
            if DRIFT > 0 and 0.08 <= s < DRIFT_END:
                t = (s - 0.08) / (DRIFT_END - 0.08)
                d = d * (1.0 + DRIFT * np.sin(np.pi * t))
            gs.append(g)
            ds.append(d)
        frames.append((np.stack(gs), np.stack(ds)))
    print(f"rendered {NF} dual frames in {time.time()-t0:.1f}s", flush=True)

    descs = []
    for i in range(0, NF, 8):
        f = orb_mod.extract_orb(jnp.asarray(frames[i][0][0]), cfg.orb)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = vocab_mod.build_vocabulary(np.concatenate(descs), k=10, depth=4,
                                     iters=3)
    print(f"vocab {voc.n_words} words", flush=True)

    slam = system_mod.System(calib=calib, cfg=cfg,
                             sensor=system_mod.Sensor.DUAL_RGBD,
                             enable_loop_closing=True)
    slam.loop_closer.voc = voc
    slam.loop_closer.db = db_mod.make_empty_db(cfg.max_kf, voc.n_words)
    t0 = time.time()
    for i, (g, d) in enumerate(frames):
        slam.track_rgbd(g[0], d[0], g[1], d[1])
        if i % 40 == 0:
            print(f"  frame {i}: state={slam.tracker.state} "
                  f"n_kf={int(slam.map.n_kf)} "
                  f"loops={slam.loop_closer.n_loops_closed}", flush=True)
    slam.shutdown()
    traj = slam.tracker.absolute_trajectory()
    est = np.stack([np.linalg.inv(T)[:3, 3] for fid, ts, T, lost in traj])
    gt = np.stack([np.linalg.inv(poses[min(fid, NF - 1)])[:3, 3]
                   for fid, ts, T, lost in traj])
    ate = float(align.ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
    n_lost = sum(1 for *_, lost in traj if lost)
    lost_fids = [fid for fid, ts, T, lost in traj if lost]
    if lost_fids:
        print(f"lost frame ids: {lost_fids}", flush=True)
    print(f"DONE in {time.time()-t0:.1f}s: lost={n_lost}/{NF} "
          f"n_kf={int(slam.map.n_kf)} "
          f"loops={slam.loop_closer.n_loops_closed} ate={ate:.4f} m",
          flush=True)


if __name__ == "__main__":
    main()
