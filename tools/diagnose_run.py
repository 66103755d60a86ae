#!/usr/bin/env python3
"""Per-frame diagnostic run over a TUM-layout dataset (CPU or GPU).

Prints, for every frame: tracking state, #tracked map points, per-frame
translational error vs groundtruth (associated by timestamp), and keyframe
count — the visibility the reference gets from its FrameDrawer status bar
(src/FrameDrawer.cc:168-204) plus ground-truth error the reference never had.

Usage:
  [JAX_PLATFORMS=cpu] python tools/diagnose_run.py DATASET_DIR [--frames N]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("--frames", type=int, default=10**9)
    ap.add_argument("--out", default="DiagTrajectory.txt")
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--save-map", default=None,
                    help="save the final MapState (System.save_map) here")
    args = ap.parse_args()

    import cv2

    from multi_orb_slam import system as system_mod
    from multi_orb_slam.io import tum

    ds = args.dataset
    slam = system_mod.System(
        settings_path=f"{ds}/settings.yaml",
        calibration_path=f"{ds}/calibration.txt",
        sensor=system_mod.Sensor.DUAL_RGBD,
        pipelined=args.pipelined,
    )
    inv_f = 1.0 / slam.depth_map_factor

    def load_assoc(path):
        out = []
        for line in open(path):
            line = line.strip()
            if line and not line.startswith("#"):
                v = line.split()
                out.append((float(v[0]), v[1], float(v[2]), v[3]))
        return out

    pairs1 = load_assoc(f"{ds}/associations.txt")
    pairs2 = load_assoc(f"{ds}/associations2.txt")
    gt = tum.read_trajectory_tum(f"{ds}/groundtruth.txt")
    gt_ts = np.array(sorted(gt.keys()))

    n = min(len(pairs1), len(pairs2), args.frames)
    for i in range(n):
        t_rgb, rgb_rel, _, d_rel = pairs1[i]
        im1 = cv2.imread(f"{ds}/{rgb_rel}", cv2.IMREAD_GRAYSCALE)
        d1 = cv2.imread(f"{ds}/{d_rel}", cv2.IMREAD_UNCHANGED)
        _, rgb2, _, dd2 = pairs2[i]
        im2 = cv2.imread(f"{ds}/{rgb2}", cv2.IMREAD_GRAYSCALE)
        d2 = cv2.imread(f"{ds}/{dd2}", cv2.IMREAD_UNCHANGED)
        t0 = time.perf_counter()
        slam.track_rgbd(
            im1.astype(np.float32), d1.astype(np.float32) * inv_f,
            im2.astype(np.float32), d2.astype(np.float32) * inv_f,
            timestamp=t_rgb)
        dt = time.perf_counter() - t0

        tr = slam.tracker
        state = int(tr.state)
        n_mp = slam.get_tracked_map_points()
        mstate = slam.map
        n_kf = int(np.sum(np.asarray(mstate.kf_valid)))
        n_pts = int(np.sum(np.asarray(mstate.mp_valid)))
        # per-frame error vs GT
        j = int(np.argmin(np.abs(gt_ts - t_rgb)))
        Twc_gt = gt[float(gt_ts[j])]
        Tcw = np.asarray(tr.Tcw)
        Twc = np.linalg.inv(Tcw)
        err = np.nan
        if state == 1:  # OK
            err = float(np.linalg.norm(Twc[:3, 3] - Twc_gt[:3, 3]))
        extra = ""
        if hasattr(tr, "last_n_inliers"):
            extra = f" matches={tr.last_n_inliers}"
        print(f"f{i:04d} t={t_rgb:8.3f} state={state} mp_tracked={n_mp:4d} "
              f"kf={n_kf:3d} pts={n_pts:5d} err={err*100:7.2f}cm "
              f"dt={dt*1e3:6.1f}ms{extra}", flush=True)

    slam.shutdown()
    slam.save_trajectory_tum(args.out)
    if args.save_map:
        slam.save_map(args.save_map)
        print(f"map saved to {args.save_map}")
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
