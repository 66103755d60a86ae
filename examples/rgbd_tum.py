#!/usr/bin/env python3
"""TUM RGB-D driver — parity with the reference's only built example.

Reference: Examples/RGB-D/rgbd_tum.cc (218 LoC):
    ./rgbd_tum vocabulary settings sequence assoc1 [assoc2 calibration]

This driver:
    python examples/rgbd_tum.py settings.yaml seq_dir assoc1.txt \
        [--assoc2 assoc2.txt --seq2 seq2_dir --calibration calib.txt] \
        [--out trajectory.txt --kf-out kf.txt]

- loads associations (rgb<->depth per camera, as produced by associate.py /
  io.tum.associate)
- feeds frames at dataset rate, prints median/mean tracking time like
  rgbd_tum.cc:160-169
- saves TUM trajectories on exit (rgbd_tum.cc:183-186)

No vocabulary file argument: the engine trains its bag-of-words vocabulary
online (the reference's pre-trained ORBvoc.txt is not redistributable here).
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from multi_orb_slam import system as system_mod  # noqa: E402
from multi_orb_slam.utils import compile_cache  # noqa: E402
from multi_orb_slam.io import tum  # noqa: E402


def load_assoc_pairs(path):
    """Association file: `t_rgb rgb_path t_depth depth_path` per line."""
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            pairs.append((float(v[0]), v[1], float(v[2]), v[3]))
    return pairs


def main():
    compile_cache.enable()
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("assoc1")
    ap.add_argument("--assoc2")
    ap.add_argument("--seq2")
    ap.add_argument("--calibration")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--kf-out", default="KeyFrameTrajectory.txt")
    ap.add_argument("--no-realtime", action="store_true",
                    help="don't sleep to match dataset timestamps")
    ap.add_argument("--native-loader", action="store_true",
                    help="prefetch+decode frames with the C++ async loader")
    ap.add_argument("--pipelined", action="store_true",
                    help="zero-sync fused tracking (status lags one frame)")
    args = ap.parse_args()

    import cv2

    dual = args.assoc2 is not None
    sensor = system_mod.Sensor.DUAL_RGBD if dual else system_mod.Sensor.RGBD
    slam = system_mod.System(
        settings_path=args.settings,
        calibration_path=args.calibration,
        sensor=sensor,
        pipelined=args.pipelined,
    )
    inv_depth_factor = 1.0 / slam.depth_map_factor

    native = None
    if args.native_loader and not dual:
        from multi_orb_slam.io import native_loader
        if native_loader.native_available():
            pairs = load_assoc_pairs(args.assoc1)
            items = [(f"{args.sequence}/{p1}", f"{args.sequence}/{p3}")
                     for _, p1, _, p3 in pairs]
            native = native_loader.AsyncRGBDLoader(
                items, slam.cfg.height, slam.cfg.width,
                depth_factor=slam.depth_map_factor)
            print("using native async loader")
        else:
            print("native loader unavailable; falling back to cv2")

    if native is not None:
        pairs = load_assoc_pairs(args.assoc1)
        track_times = []
        for i, (gray, depth) in enumerate(native):
            t0 = time.perf_counter()
            slam.track_rgbd(gray, depth, timestamp=pairs[i][0])
            track_times.append(time.perf_counter() - t0)
        native.close()
        slam.shutdown()
        tt = np.sort(track_times)
        print("-------")
        print(f"median tracking time: {tt[len(tt) // 2]:.4f}")
        print(f"mean tracking time: {np.mean(tt):.4f}")
        slam.save_trajectory_tum(args.out)
        slam.save_keyframe_trajectory_tum(args.kf_out)
        print(f"trajectory saved to {args.out}")
        return 0

    pairs1 = load_assoc_pairs(args.assoc1)
    pairs2 = load_assoc_pairs(args.assoc2) if dual else None
    n = len(pairs1) if not dual else min(len(pairs1), len(pairs2))
    print(f"Start processing sequence ({n} images, "
          f"{'dual' if dual else 'single'} camera) ...")

    track_times = []
    for i in range(n):
        t_rgb, rgb_rel, _, d_rel = pairs1[i]
        im1 = cv2.imread(f"{args.sequence}/{rgb_rel}", cv2.IMREAD_GRAYSCALE)
        d1 = cv2.imread(f"{args.sequence}/{d_rel}", cv2.IMREAD_UNCHANGED)
        if im1 is None or d1 is None:
            print(f"Failed to load image at {args.sequence}/{rgb_rel}")
            return 1
        d1 = d1.astype(np.float32) * inv_depth_factor
        if dual:
            _, rgb2, _, dd2 = pairs2[i]
            seq2 = args.seq2 or args.sequence
            im2 = cv2.imread(f"{seq2}/{rgb2}", cv2.IMREAD_GRAYSCALE)
            d2 = cv2.imread(f"{seq2}/{dd2}", cv2.IMREAD_UNCHANGED)
            d2 = d2.astype(np.float32) * inv_depth_factor
        else:
            im2 = d2 = None

        t0 = time.perf_counter()
        slam.track_rgbd(im1.astype(np.float32), d1,
                        im2.astype(np.float32) if im2 is not None else None,
                        d2, timestamp=t_rgb)
        dt = time.perf_counter() - t0
        track_times.append(dt)

        if not args.no_realtime and i + 1 < n:
            gap = pairs1[i + 1][0] - t_rgb
            if dt < gap:
                time.sleep(gap - dt)

    slam.shutdown()
    tt = np.sort(track_times)
    print("-------")
    print(f"median tracking time: {tt[len(tt) // 2]:.4f}")
    print(f"mean tracking time: {np.mean(tt):.4f}")
    slam.save_trajectory_tum(args.out)
    slam.save_keyframe_trajectory_tum(args.kf_out)
    print(f"trajectory saved to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
