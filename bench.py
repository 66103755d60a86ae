"""Benchmark: end-to-end dual-camera RGB-D tracking throughput on one GPU.

Prints the card (nvidia-smi name and power limit), then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...}.  Fails when JAX finds no
GPU: a CPU number is not a device measurement.

Baseline: the reference (AlterPang/Multi_ORB_SLAM) built and run on this
machine (BASELINE_MEASURED.md) sustains 30.1 fps median on a synthetic
TUM-layout dual-camera sequence with 1000+500 ORB features
(OtherFiles/multi.yaml:23, rgbd_tum.cc:144-152) — which matches the 30 fps
real-time camera budget, so vs_baseline = our frames/s / 30.

Workload: TWO scenes at the reference's REAL rig geometry — cam2 rotated
90 deg about Y with the measured translation (OtherFiles/calibration.txt:1-4) —
  - orbit: 60 frames inside a textured box, smooth arc (the steady-state
    tracking regime)
  - circuit: 160 frames of the outward-facing circular walk (the
    rotation-heavy regime the dual rig exists for; every view leaves the
    FOV, KF cadence is much higher)
204 frames measured total (>= 200 over >= 2 scenes).

The measured path is the FULL pipeline: dual-camera ORB pyramid extraction,
motion-model projection search, motion-only BA, local-map search, second BA,
keyframe insertion, AND the mapping stage (culling, triangulation, fusion,
local BA, KF culling) at every keyframe — unlike the reference's median
tracking time, which hides mapping on a parallel thread, the headline fps
here includes it.  Per-KF mapping latency is reported separately.
"""

import json
import os
import subprocess
import time

import numpy as np

from multi_orb_slam.utils import compile_cache

# rendered frames are kept beside the compile cache, inside the checkout
FRAME_CACHE = os.path.join(compile_cache.CACHE_ROOT, "frames",
                           "bench_v3_{name}.npz")
WARMUP = 8


def load_scene(name, n_frames, K, T_rc, H, W):
    """Render (or reload) one synthetic benchmark scene."""
    from multi_orb_slam.io import synthetic

    path = FRAME_CACHE.format(name=name)
    if os.path.exists(path):
        try:
            z = np.load(path)
            if z["grays"].shape[0] == n_frames:
                return z["grays"], z["depths"]
        except Exception:
            pass
    if name == "circuit":
        world = synthetic.make_box_world(seed=3, n_points=5000,
                                         box=(7.0, 4.0, 7.0))
        poses = synthetic.circuit_trajectory(n_frames, radius=2.2, laps=1.1)
        grays, depths = [], []
        for i in range(n_frames):
            gs, ds = [], []
            for c in range(T_rc.shape[0]):
                Tcw = np.asarray(T_rc[c]) @ poses[i]
                g, d = synthetic.render_rgbd(world, np.asarray(K[0]), Tcw,
                                             H, W)
                gs.append(g)
                ds.append(d)
            grays.append(np.stack(gs))
            depths.append(np.stack(ds))
        grays = np.stack(grays).astype(np.float32)
        depths = np.stack(depths).astype(np.float32)
    else:
        seq = synthetic.make_sequence(
            n_frames=n_frames, K=np.asarray(K[0]), T_rc=np.asarray(T_rc),
            height=H, width=W, n_points=4000)
        grays = np.stack(seq.grays).astype(np.float32)
        depths = np.stack(seq.depths).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, grays=grays, depths=depths)
    return grays, depths


def run_scene(name, grays, depths, calib, cfg):
    """Track one scene; returns (times, n_kf_mapped, final_tracker)."""
    import jax
    import jax.numpy as jnp

    from multi_orb_slam.frontend import tracking
    from multi_orb_slam.mapping import local_mapping

    n_frames = grays.shape[0]
    tracker = tracking.Tracker(calib, cfg, pipelined=True, pipeline_depth=3)
    tracker.fuse_extraction = True
    n_kf_mapped = [0]
    covis_pending = [None]

    def kf_cb(kf_slot):
        # async, like the reference's mapping thread: dispatch the mapping
        # work and return the (device-future) map; the tracker's next step
        # chains on it without a host sync.  The adaptive-BA window hint is
        # the previous KF's covisible count (resolved one KF later).
        n_kf_mapped[0] += 1
        hint = (int(covis_pending[0])
                if covis_pending[0] is not None else None)
        m = local_mapping.run_mapping_stage(
            tracker.map, kf_slot, tracker.frame_id, calib, cfg,
            covis_hint=hint)
        if cfg.ba_adaptive:
            covis_pending[0] = local_mapping.covis_kf_count(
                m, jnp.asarray(kf_slot, jnp.int32))
        return m

    tracker.kf_inserted_cb = kf_cb

    # pre-stage all frames on device (the data-loading path is measured
    # separately; the reference's median likewise excludes image loading)
    dev_frames = [(jnp.asarray(grays[i]), jnp.asarray(depths[i]))
                  for i in range(n_frames)]
    jax.block_until_ready(dev_frames)

    for i in range(WARMUP):
        tracker.process(*dev_frames[i])
    # compile the mapping stage up front so the first real keyframe in the
    # measured window doesn't pay the compile
    jax.block_until_ready(local_mapping.run_mapping_stage(
        tracker.map, 0, tracker.frame_id, calib, cfg))
    n_kf_mapped[0] = 0
    jax.block_until_ready(tracker.Tcw)

    times = []
    t_start = time.perf_counter()
    for i in range(WARMUP, n_frames):
        t0 = time.perf_counter()
        tracker.process(*dev_frames[i])
        times.append(time.perf_counter() - t0)
    tracker._resolve_pending()
    jax.block_until_ready((tracker.Tcw, tracker.map))
    total = time.perf_counter() - t_start
    return times, total, n_kf_mapped[0], tracker


def main():
    import jax
    import jax.numpy as jnp

    from multi_orb_slam.config import SlamConfig
    from multi_orb_slam.geometry import camera as cam_mod, se3
    from multi_orb_slam.mapping import local_mapping
    from multi_orb_slam.ops import orb

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: no GPU found (JAX device: {dev.platform})")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    H, W = 480, 640
    C = 2
    cfg = SlamConfig(
        n_cams=C, width=W, height=H,
        orb=orb.ORBConfig(n_features=1024),
    )
    K = jnp.tile(jnp.asarray([[520.9, 521.0, 320.0, 240.0]]), (C, 1))
    # the REAL reference rig: cam2 ~90 deg about Y, measured translation
    # (OtherFiles/calibration.txt:1-4)
    Ry = se3.so3_exp(jnp.asarray([0.0, np.pi / 2, 0.0]))
    T_rc1 = jnp.eye(4).at[:3, :3].set(Ry).at[:3, 3].set(
        jnp.asarray([0.161, 0.004, -0.071]))
    T_rc = jnp.stack([jnp.eye(4), T_rc1])
    calib = cam_mod.CameraParams(
        K=K, dist=jnp.zeros((C, 5)), T_rc=T_rc, bf=jnp.asarray(40.0),
        width=W, height=H)

    scenes = (("orbit", 60), ("circuit", 160))
    all_times = []
    total_time = 0.0
    total_kf = 0
    per_scene = {}
    last_tracker = None
    for name, nf in scenes:
        grays, depths = load_scene(name, nf, K, T_rc, H, W)
        times, total, nkf, tracker = run_scene(name, grays, depths, calib,
                                               cfg)
        all_times += times
        total_time += total
        total_kf += nkf
        per_scene[name] = {
            "fps": round(len(times) / total, 2),
            "median_ms": round(float(np.median(times)) * 1e3, 2),
            "frames": len(times),
            "keyframes": nkf,
        }
        last_tracker = tracker

    fps = len(all_times) / total_time
    median = float(np.median(all_times))

    # standalone per-KF mapping-stage latency on the final (largest) map,
    # measured separately so the throughput path stays async
    tracker = last_tracker
    jax.block_until_ready(tracker.map)
    t0 = time.perf_counter()
    jax.block_until_ready(local_mapping.run_mapping_stage(
        tracker.map, int(tracker.last_kf_slot), tracker.frame_id, calib, cfg))
    mapping_ms = (time.perf_counter() - t0) * 1e3

    result = {
        "metric": "tracking_fps_dual_cam_640x480",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 3),
        "median_ms": round(median * 1e3, 2),
        "frames_measured": len(all_times),
        "keyframes_mapped": total_kf,
        "mapping_ms_per_kf": round(mapping_ms, 2),
        "scenes": per_scene,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
