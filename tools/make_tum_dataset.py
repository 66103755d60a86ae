"""Export a synthetic dual-camera RGB-D sequence in TUM dataset layout.

Produces the exact on-disk layout the reference driver consumes
(/root/reference/Examples/RGB-D/rgbd_tum.cc:40-46: sequence dir + two
association files) so the SAME data can be run through both the reference
C++ binary and our driver for a measured baseline (BASELINE.md protocol):

  outdir/
    rgb/ depth/ rgb2/ depth2/        16-bit depth PNGs (factor 1000 = mm)
    associations.txt associations2.txt
    groundtruth.txt                  TUM format (cam-to-world of the rig)
    settings.yaml calibration.txt    reference-compatible config

Usage: python tools/make_tum_dataset.py OUTDIR [n_frames] [trajectory]
           [seed] [n_points] [--degrade]

--degrade applies the committed five-effect Kinect sensor model
(io/synthetic.SensorModel defaults: quadratic depth noise, dropouts,
exposure drift, shot noise, motion blur) to the rendered frames before
export, so BOTH systems can be baselined on degraded input.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DEPTH_FACTOR = 1000.0  # mm, matches DepthMapFactor below


def rot_to_quat(R):
    """Rotation matrix -> (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = np.argmax(np.diag(R))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qw = (R[k, j] - R[j, k]) / s
        qx, qy, qz = q[0], q[1], q[2]
    return qx, qy, qz, qw


SETTINGS_YAML = """%YAML:1.0

Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}

# k1 must be nonzero: the reference's Frame::UndistortKeyPoints[_cam2]
# (src/Frame.cc:673-741) early-returns when k1 == 0 WITHOUT filling
# mvKeysUn_total, which empties every BoW/undistorted-keypoint consumer
# (SearchByBoW matches drop to 0 and tracking is lost on frame 2).  A
# numerically-negligible k1 routes it through the normal undistort path.
Camera.k1: 1.0e-9
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0

Camera.width: {w}
Camera.height: {h}

Camera.fps: 30.0

Camera.bf: 40.0

Camera.RGB: 1

ThDepth: 40.0

DepthMapFactor: {depth_factor}

ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

Viewer.KeyFrameSize: 0.05
Viewer.KeyFrameLineWidth: 1
Viewer.GraphLineWidth: 0.9
Viewer.PointSize: 2
Viewer.CameraSize: 0.08
Viewer.CameraLineWidth: 3
Viewer.ViewpointX: 0
Viewer.ViewpointY: -0.7
Viewer.ViewpointZ: -1.8
Viewer.ViewpointF: 500
"""


def main():
    import cv2

    from multi_orb_slam.geometry import se3 as _  # noqa: F401 (repo path check)
    from multi_orb_slam.io import synthetic

    args = [a for a in sys.argv[1:] if a != "--degrade"]
    degrade = "--degrade" in sys.argv[1:]
    outdir = args[0]
    n_frames = int(args[1]) if len(args) > 1 else 120
    traj = args[2] if len(args) > 2 else "orbit"
    seed = int(args[3]) if len(args) > 3 else 0
    n_points = int(args[4]) if len(args) > 4 else 4000

    H, W = 480, 640
    K = np.array([520.9, 521.0, 320.0, 240.0], np.float32)
    # the REAL reference rig: cam2 ~90 deg about Y, measured translation
    # (/root/reference/OtherFiles/calibration.txt:1-4)
    ang = np.pi / 2
    Ry = np.array([[np.cos(ang), 0, np.sin(ang)],
                   [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    T_rc1 = np.eye(4, dtype=np.float32)
    T_rc1[:3, :3] = Ry
    T_rc1[:3, 3] = [0.161, 0.004, -0.071]
    T_rc = np.stack([np.eye(4, dtype=np.float32), T_rc1])

    seq = synthetic.make_sequence(
        n_frames=n_frames, K=K, T_rc=T_rc, height=H, width=W, seed=seed,
        n_points=n_points, trajectory=traj)
    if degrade:
        seq = synthetic.degrade_sequence(seq, synthetic.SensorModel(),
                                         seed=7)

    for sub in ("rgb", "depth", "rgb2", "depth2"):
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)

    assoc1, assoc2, gt = [], [], []
    for i, (grays, depths) in enumerate(zip(seq.grays, seq.depths)):
        t = seq.timestamps[i]
        name = f"{t:.6f}.png"
        for c, (rgbd, depd) in enumerate((("rgb", "depth"), ("rgb2", "depth2"))):
            g8 = np.clip(grays[c], 0, 255).astype(np.uint8)
            d16 = np.clip(depths[c] * DEPTH_FACTOR, 0, 65535).astype(np.uint16)
            cv2.imwrite(os.path.join(outdir, rgbd, name), g8)
            cv2.imwrite(os.path.join(outdir, depd, name), d16)
        assoc1.append(f"{t:.6f} rgb/{name} {t:.6f} depth/{name}")
        assoc2.append(f"{t:.6f} rgb2/{name} {t:.6f} depth2/{name}")
        Tcw = seq.poses_gt[i]
        Twc = np.linalg.inv(Tcw)
        qx, qy, qz, qw = rot_to_quat(Twc[:3, :3])
        tx, ty, tz = Twc[:3, 3]
        gt.append(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                  f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}")

    with open(os.path.join(outdir, "associations.txt"), "w") as f:
        f.write("\n".join(assoc1) + "\n")
    with open(os.path.join(outdir, "associations2.txt"), "w") as f:
        f.write("\n".join(assoc2) + "\n")
    with open(os.path.join(outdir, "groundtruth.txt"), "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        f.write("\n".join(gt) + "\n")
    with open(os.path.join(outdir, "settings.yaml"), "w") as f:
        f.write(SETTINGS_YAML.format(fx=K[0], fy=K[1], cx=K[2], cy=K[3],
                                     w=W, h=H, depth_factor=DEPTH_FACTOR))
    # calibration.txt: rows 1-3 = Rcam12, row 4 = tcam12 where
    # x_cam1 = Rcam12 @ x_cam2 + tcam12 — the reference's convention
    # (System.cc:63-72 parse; Frame.cc:1066 `mRwc*(mRcam12*x3Dc_cam2+mtcam12)`).
    # T_rc1 here maps rig(cam1)->cam2, so the file carries its INVERSE.
    # (Round-2 fix: the file used to carry T_rc1 directly, which handed both
    # systems an inverted rig extrinsic — the reference shrugged it off
    # because its per-frame pose optimization is cam1-only, ours drifted.)
    T_21 = np.linalg.inv(T_rc1)
    with open(os.path.join(outdir, "calibration.txt"), "w") as f:
        for r in range(3):
            f.write(" ".join(f"{v:.9f}" for v in T_21[r, :3]) + "\n")
        f.write(" ".join(f"{v:.9f}" for v in T_21[:3, 3]) + "\n")
    print(f"wrote {n_frames} frames to {outdir}")


if __name__ == "__main__":
    main()
