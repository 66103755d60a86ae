"""End-to-end CLI driver tests: run the actual example drivers on generated
TUM-layout / KITTI-layout datasets (PNG images on disk, association files),
exactly as a user of the reference would."""

import os
import subprocess
import sys

import numpy as np
import pytest

from multi_orb_slam.io import synthetic, tum


def write_tum_dataset(root, n_frames=8, h=240, w=320):
    import cv2

    world = synthetic.make_box_world(seed=0, n_points=2500)
    K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
    poses = synthetic.orbit_trajectory(n_frames)
    os.makedirs(f"{root}/rgb", exist_ok=True)
    os.makedirs(f"{root}/depth", exist_ok=True)
    assoc = []
    for i in range(n_frames):
        g, d = synthetic.render_rgbd(world, K, poses[i], h, w)
        t = i / 30.0
        rgb_rel = f"rgb/{t:.6f}.png"
        dep_rel = f"depth/{t:.6f}.png"
        cv2.imwrite(f"{root}/{rgb_rel}", g.astype(np.uint8))
        cv2.imwrite(f"{root}/{dep_rel}", (d * 5000.0).astype(np.uint16))
        assoc.append(f"{t:.6f} {rgb_rel} {t:.6f} {dep_rel}")
    with open(f"{root}/assoc.txt", "w") as f:
        f.write("\n".join(assoc) + "\n")
    return poses


def write_settings(path, h=240, w=320):
    with open(path, "w") as f:
        f.write("""%YAML:1.0
Camera.fx: 260.0
Camera.fy: 260.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.width: {w}
Camera.height: {h}
Camera.bf: 20.0
Camera.fps: 30.0
Camera.RGB: 1
ThDepth: 78.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
""".format(h=h, w=w))


class TestRgbdTumDriver:
    def test_driver_end_to_end(self, tmp_path):
        root = str(tmp_path / "seq")
        write_tum_dataset(root)
        settings = str(tmp_path / "settings.yaml")
        write_settings(settings)
        out = str(tmp_path / "traj.txt")
        kf_out = str(tmp_path / "kf.txt")
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run(
            [sys.executable, "examples/rgbd_tum.py", settings, root,
             f"{root}/assoc.txt", "--out", out, "--kf-out", kf_out,
             "--no-realtime"],
            capture_output=True, text=True, timeout=900, env=env,
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "median tracking time" in r.stdout
        traj = tum.read_trajectory_tum(out)
        assert len(traj) == 8
        assert len(tum.read_trajectory_tum(kf_out)) >= 1


class TestKittiDriver:
    def test_stereo_driver_end_to_end(self, tmp_path):
        import cv2

        root = str(tmp_path / "kitti")
        os.makedirs(f"{root}/image_0", exist_ok=True)
        os.makedirs(f"{root}/image_1", exist_ok=True)
        world = synthetic.make_box_world(seed=0, n_points=3000)
        K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
        baseline = 20.0 / 260.0
        poses = synthetic.orbit_trajectory(6)
        T_lr = np.eye(4, dtype=np.float32)
        T_lr[0, 3] = -baseline
        times = []
        for i in range(6):
            gl, _ = synthetic.render_rgbd(world, K, poses[i], 240, 320)
            gr, _ = synthetic.render_rgbd(world, K, T_lr @ poses[i], 240, 320)
            cv2.imwrite(f"{root}/image_0/{i:06d}.png", gl.astype(np.uint8))
            cv2.imwrite(f"{root}/image_1/{i:06d}.png", gr.astype(np.uint8))
            times.append(f"{i / 10.0:.6f}")
        open(f"{root}/times.txt", "w").write("\n".join(times) + "\n")
        settings = str(tmp_path / "settings.yaml")
        write_settings(settings)
        out = str(tmp_path / "kitti_traj.txt")
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run(
            [sys.executable, "examples/stereo_kitti.py", settings, root,
             "--out", out],
            capture_output=True, text=True, timeout=900, env=env,
        )
        assert r.returncode == 0, r.stdout + r.stderr
        lines = open(out).read().strip().splitlines()
        assert len(lines) == 6
        assert len(lines[0].split()) == 12  # 3x4 row-major


class TestDualRgbdDriver:
    def test_dual_driver_end_to_end(self, tmp_path):
        """The reference's flagship invocation: two association files plus
        the 4x3 calibration.txt (rgbd_tum.cc:40-46)."""
        import cv2

        rng = np.random.RandomState(0)
        world = synthetic.make_box_world(seed=0, n_points=4000)
        K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
        # dual rig: camera 2 yawed 0.5 rad (calibration.txt = T_cam12)
        from multi_orb_slam.geometry import se3
        import jax.numpy as jnp
        Ry = np.asarray(se3.so3_exp(jnp.asarray([0.0, 0.5, 0.0])))
        T_c12 = np.eye(4, dtype=np.float32)
        T_c12[:3, :3] = Ry
        T_c12[:3, 3] = [0.16, 0.004, -0.07]
        T_rc = np.stack([np.eye(4, dtype=np.float32),
                         np.linalg.inv(T_c12).astype(np.float32)])
        poses = synthetic.orbit_trajectory(6)
        root = str(tmp_path / "seq")
        for cam in (1, 2):
            os.makedirs(f"{root}/rgb{cam}", exist_ok=True)
            os.makedirs(f"{root}/depth{cam}", exist_ok=True)
        for suffix, Trc in (("1", T_rc[0]), ("2", T_rc[1])):
            assoc = []
            for i in range(6):
                Tcw = Trc @ poses[i]
                g, d = synthetic.render_rgbd(world, K, Tcw, 240, 320)
                t = i / 30.0
                rgb_rel = f"rgb{suffix}/{t:.6f}.png"
                dep_rel = f"depth{suffix}/{t:.6f}.png"
                cv2.imwrite(f"{root}/{rgb_rel}", g.astype(np.uint8))
                cv2.imwrite(f"{root}/{dep_rel}",
                            (d * 5000.0).astype(np.uint16))
                assoc.append(f"{t:.6f} {rgb_rel} {t:.6f} {dep_rel}")
            with open(f"{root}/assoc{suffix}.txt", "w") as f:
                f.write("\n".join(assoc) + "\n")
        calib_path = str(tmp_path / "calibration.txt")
        with open(calib_path, "w") as f:
            for row in T_c12[:3, :3]:
                f.write(" ".join(str(v) for v in row) + "\n")
            f.write(" ".join(str(v) for v in T_c12[:3, 3]) + "\n")
        settings = str(tmp_path / "settings.yaml")
        write_settings(settings)
        out = str(tmp_path / "traj.txt")
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run(
            [sys.executable, "examples/rgbd_tum.py", settings, root,
             f"{root}/assoc1.txt", "--assoc2", f"{root}/assoc2.txt",
             "--calibration", calib_path, "--out", out,
             "--kf-out", str(tmp_path / "kf.txt"), "--no-realtime"],
            capture_output=True, text=True, timeout=900, env=env,
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert len(tum.read_trajectory_tum(out)) == 6


class TestNativeLoaderDriver:
    def test_driver_with_native_loader(self, tmp_path):
        from multi_orb_slam.io import native_loader
        if not native_loader.native_available():
            import pytest
            pytest.skip("native toolchain unavailable")
        root = str(tmp_path / "seq")
        write_tum_dataset(root, n_frames=6)
        settings = str(tmp_path / "settings.yaml")
        write_settings(settings)
        out = str(tmp_path / "traj.txt")
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run(
            [sys.executable, "examples/rgbd_tum.py", settings, root,
             f"{root}/assoc.txt", "--out", out,
             "--kf-out", str(tmp_path / "kf.txt"), "--no-realtime",
             "--native-loader", "--pipelined"],
            capture_output=True, text=True, timeout=900, env=env,
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "native async loader" in r.stdout
        assert len(tum.read_trajectory_tum(out)) == 6
