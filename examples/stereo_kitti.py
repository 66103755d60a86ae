#!/usr/bin/env python3
"""KITTI stereo driver.

Reference counterpart: Examples/Stereo/stereo_kitti.cc (stock, excluded from
the reference build — CMakeLists.txt:105-126 — but part of the capability
surface; settings in Examples/Stereo/KITTI00-02.yaml).

    python examples/stereo_kitti.py settings.yaml kitti_sequence_dir \
        [--out trajectory_kitti.txt]

Expects KITTI layout: image_0/ (left), image_1/ (right), times.txt.
Saves the trajectory in KITTI 3x4 row-major format
(reference SaveTrajectoryKITTI, src/System.cc:450-503).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from multi_orb_slam import system as system_mod  # noqa: E402
from multi_orb_slam.utils import compile_cache  # noqa: E402


def main():
    compile_cache.enable()
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--out", default="CameraTrajectory_kitti.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    args = ap.parse_args()

    import cv2

    left_dir = os.path.join(args.sequence, "image_0")
    right_dir = os.path.join(args.sequence, "image_1")
    times_path = os.path.join(args.sequence, "times.txt")
    names = sorted(os.listdir(left_dir))
    times = [float(x) for x in open(times_path)] if os.path.exists(times_path) \
        else [i / 10.0 for i in range(len(names))]
    if args.max_frames:
        names = names[:args.max_frames]

    slam = system_mod.System(
        settings_path=args.settings, sensor=system_mod.Sensor.STEREO)
    print(f"Start processing KITTI sequence ({len(names)} stereo pairs) ...")
    track_times = []
    for i, name in enumerate(names):
        im_l = cv2.imread(os.path.join(left_dir, name), cv2.IMREAD_GRAYSCALE)
        im_r = cv2.imread(os.path.join(right_dir, name), cv2.IMREAD_GRAYSCALE)
        if im_l is None or im_r is None:
            print(f"Failed to load pair {name}")
            return 1
        t0 = time.perf_counter()
        slam.track_stereo(im_l.astype(np.float32), im_r.astype(np.float32),
                          timestamp=times[i])
        track_times.append(time.perf_counter() - t0)

    slam.shutdown()
    tt = np.sort(track_times)
    print("-------")
    print(f"median tracking time: {tt[len(tt) // 2]:.4f}")
    print(f"mean tracking time: {np.mean(tt):.4f}")
    slam.save_trajectory_kitti(args.out)
    print(f"trajectory saved to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
