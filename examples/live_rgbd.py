#!/usr/bin/env python3
"""Live RGB-D ingestion: stream frames into the tracker over a socket/stdin.

Covers the reference's live-capture capability row (ROS nodes,
Examples/ROS/ORB_SLAM2/src/ros_rgbd.cc:76-86 — a message_filters
subscriber pushing synchronized RGB+depth pairs into TrackRGBD).  This
container has no ROS; the transport here is a minimal length-prefixed
binary protocol over a TCP socket or stdin, which any producer (camera
daemon, rosbag bridge, netcat) can speak:

    header:  magic  b"MOSL"
             uint32 n_cams, height, width
    frame:   uint64 timestamp_ns
             per camera: float32[H*W] gray, float32[H*W] depth_meters
    trailer: uint64 0xFFFFFFFFFFFFFFFF ends the stream

Run:  python examples/live_rgbd.py settings.yaml [--calibration C]
          [--listen PORT | --stdin] [--out traj.txt]
Feed: python examples/live_rgbd.py --selftest   (spawns itself and streams
      a synthetic sequence through a local socket end-to-end)
"""

import argparse
import socket
import struct
import sys

import numpy as np

sys.path.insert(0, ".")

from multi_orb_slam.utils import compile_cache  # noqa: E402

MAGIC = b"MOSL"
END_TS = 0xFFFFFFFFFFFFFFFF


def _read_exact(f, n):
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise EOFError("stream closed mid-frame")
        buf += chunk
    return buf


def serve(stream, slam, n_cams, h, w):
    """Consume frames from a binary stream until the end marker."""
    frame_bytes = h * w * 4
    n = 0
    while True:
        ts = struct.unpack("<Q", _read_exact(stream, 8))[0]
        if ts == END_TS:
            break
        grays, depths = [], []
        for _ in range(n_cams):
            g = np.frombuffer(_read_exact(stream, frame_bytes),
                              np.float32).reshape(h, w)
            d = np.frombuffer(_read_exact(stream, frame_bytes),
                              np.float32).reshape(h, w)
            grays.append(g)
            depths.append(d)
        if n_cams == 2:
            slam.track_rgbd(grays[0], depths[0], grays[1], depths[1],
                            timestamp=ts * 1e-9)
        else:
            slam.track_rgbd(grays[0], depths[0], timestamp=ts * 1e-9)
        n += 1
    return n


def producer_main(port, n_frames=20):
    """Self-test producer: stream a synthetic sequence to the server."""
    from multi_orb_slam.io import synthetic

    seq = synthetic.make_sequence(n_frames=n_frames, height=240, width=320,
                                  n_points=2500)
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    f = sock.makefile("wb")
    f.write(MAGIC + struct.pack("<III", 1, 240, 320))
    for i, (g, d) in enumerate(zip(seq.grays, seq.depths)):
        f.write(struct.pack("<Q", int(seq.timestamps[i] * 1e9)))
        f.write(np.ascontiguousarray(g[0], np.float32).tobytes())
        f.write(np.ascontiguousarray(d[0], np.float32).tobytes())
    f.write(struct.pack("<Q", END_TS))
    f.flush()
    sock.close()


def main():
    compile_cache.enable()
    ap = argparse.ArgumentParser()
    ap.add_argument("settings", nargs="?")
    ap.add_argument("--calibration")
    ap.add_argument("--listen", type=int, default=0)
    ap.add_argument("--stdin", action="store_true")
    ap.add_argument("--out", default="LiveTrajectory.txt")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--produce", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.produce:
        producer_main(args.produce)
        return 0

    if args.selftest:
        import subprocess

        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        prod = subprocess.Popen(
            [sys.executable, __file__, "--produce", str(port)])
        conn, _ = srv.accept()
        stream = conn.makefile("rb")
        n = _serve_header_and_track(stream, None, args)
        prod.wait()
        print(f"selftest: tracked {n} streamed frames")
        return 0

    if args.stdin:
        stream = sys.stdin.buffer
    elif args.listen:
        srv = socket.socket()
        srv.bind(("0.0.0.0", args.listen))
        srv.listen(1)
        print(f"listening on :{args.listen}")
        conn, addr = srv.accept()
        print(f"producer connected from {addr}")
        stream = conn.makefile("rb")
    else:
        print("need --listen PORT, --stdin, or --selftest")
        return 1
    n = _serve_header_and_track(stream, None, args)
    print(f"tracked {n} streamed frames")
    return 0


def _serve_header_and_track(stream, _unused, args):
    from multi_orb_slam import system as system_mod

    magic = _read_exact(stream, 4)
    assert magic == MAGIC, f"bad stream magic {magic!r}"
    n_cams, h, w = struct.unpack("<III", _read_exact(stream, 12))

    if args.settings:
        sensor = (system_mod.Sensor.DUAL_RGBD if n_cams == 2
                  else system_mod.Sensor.RGBD)
        slam = system_mod.System(settings_path=args.settings,
                                 calibration_path=args.calibration,
                                 sensor=sensor)
    else:
        # selftest: defaults matching the synthetic producer
        import jax.numpy as jnp
        from multi_orb_slam.config import SlamConfig
        from multi_orb_slam.geometry import camera as cam_mod
        from multi_orb_slam.ops import orb
        cfg = SlamConfig(n_cams=1, max_feat=512, width=w, height=h,
                         orb=orb.ORBConfig(n_features=512))
        calib = cam_mod.CameraParams(
            K=jnp.asarray([[520.9, 521.0, w / 2.0, h / 2.0]]),
            dist=jnp.zeros((1, 5)), T_rc=jnp.eye(4)[None],
            bf=jnp.asarray(40.0), width=w, height=h)
        slam = system_mod.System(calib=calib, cfg=cfg,
                                 sensor=system_mod.Sensor.RGBD)
    n = serve(stream, slam, n_cams, h, w)
    slam.shutdown()
    slam.save_trajectory_tum(args.out)
    return n


if __name__ == "__main__":
    sys.exit(main())
