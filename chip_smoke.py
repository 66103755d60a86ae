#!/usr/bin/env python3
"""Bring-up check: the dual RGB-D SLAM path on one GPU.

    python chip_smoke.py               # one GPU, every phase below
    python chip_smoke.py --four-cards  # only the 4-GPU path and its 1-GPU twin

Phases, in order (any failure raises, so the exit code is non-zero):
  1. device    JAX's first device must be a GPU (no CPU fallback); prints
               the card as nvidia-smi names it and its power limit.
  2. kernels   the front-end ops compiled for the card against plain
               references at real widths: FAST at every pyramid level,
               the 45x45 patch gather, all-pairs Hamming, descriptors
               against the CPU's, and the float32 matmul default.
  3. system    `System(configs/multi.yaml, configs/calibration.txt,
               DUAL_RGBD)` tracks a rendered outward-facing circuit with a
               depth-drift ramp: tracking, local mapping at every keyframe,
               loop detection, Sim3, correction, essential graph and GBA.
  4. fused     the pipelined tracker with extraction fused into its step
               (the path bench.py times) on a short scene.
  5. memory    compile seconds, the fused step's memory analysis, and the
               device's peak bytes in use.
The last stdout line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SETTINGS = os.path.join(ROOT, "configs", "multi.yaml")
CALIBRATION = os.path.join(ROOT, "configs", "calibration.txt")

# The main-path scene: the outward-facing circuit of tests/test_circuit_e2e.py
# at the deployment's own 640x480 and 1000 features per camera.  The depth
# ramp is 10%, not the test's 15%: at full width both close the loop, but
# 15% lands the CPU's ATE within 0.02 m of the bound.
CIRCUIT_FRAMES = 240
CIRCUIT_LAPS = 1.25
CIRCUIT_DRIFT = 0.10          # depth-scale ramp on s in [0.08, 0.60)
MAX_LOST = 2
MAX_ATE_M = 0.20
# ATE of `run_circuit()` under JAX_PLATFORMS=cpu on the same frames
# (recorded in CHANGES.md); printed beside the GPU's for comparison.  The
# GPU's scatter-adds are atomic, so its ATE varies from run to run.
CPU_REHEARSAL_ATE_M = 0.09578529745340347
CPU_ATE_BAND_M = 0.10
FUSED_FRAMES = 48
MIN_DESC_BIT_AGREEMENT = 0.99
# --four-cards problem: examples/bench_dist_ba.py's default size
DIST_KFS, DIST_POINTS, DIST_OBS_PER_KF = 128, 16384, 512

_compile_s = []


def _on_duration(event, duration, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _compile_s.append(duration)


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def require_gpu():
    """The JAX devices, if the first one is a GPU; raises otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX's first device is {devs[0].platform!r}")
    return devs


def card_name_and_power_limit() -> str:
    # a child process that stays off JAX
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_device():
    devs = require_gpu()
    print(card_name_and_power_limit(), flush=True)
    log("device", platform=devs[0].platform, kind=devs[0].device_kind,
        count=len(devs),
        cv2_importable=importlib.util.find_spec("cv2") is not None)
    return devs


# ---------------------------------------------------------------------------
# 2. kernels against plain references
# ---------------------------------------------------------------------------


def _popcount_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """All-pairs Hamming distance of uint32 [N, 8] x [M, 8] in numpy."""
    table = np.array([bin(i).count("1") for i in range(256)], np.int32)
    out = np.empty((a.shape[0], b.shape[0]), np.int32)
    for i in range(0, a.shape[0], 256):
        x = (a[i:i + 256, None, :] ^ b[None]).view(np.uint8)
        out[i:i + 256] = table[x].sum(-1)
    return out


def phase_kernels():
    import jax
    import jax.numpy as jnp

    from multi_orb_slam.ops import hamming, orb

    rng = np.random.RandomState(0)
    cfg = orb.ORBConfig(n_features=1000)

    score = jax.jit(orb.fast_score)
    for h0, w0 in ((480, 640), (376, 1241)):
        worst = 0.0
        shapes = orb.pyramid_shapes(h0, w0, cfg)
        for h, w in shapes:
            img = rng.uniform(0, 255, (h, w)).astype(np.float32)
            got = np.asarray(score(jnp.asarray(img)))[3:-3, 3:-3]
            ref = orb.fast_score_numpy(img)[3:-3, 3:-3]
            worst = max(worst, float(np.abs(got - ref).max()))
        log("kernels", op="fast_score", image=f"{h0}x{w0}",
            levels=[f"{h}x{w}" for h, w in shapes], max_abs_diff=worst,
            tolerance=0.0, precision="f32 subtract/min/max (exact)")
        assert worst == 0.0, worst

    L, H, W, F, side = cfg.n_levels, 480, 640, 2 * 1000, 45
    canvas = rng.uniform(0, 255, (L, H, W)).astype(np.float32)
    level = rng.randint(0, L, F).astype(np.int32)
    yc = rng.randint(-8, H + 8, F).astype(np.int32)   # borders included
    xc = rng.randint(-8, W + 8, F).astype(np.int32)
    got = np.asarray(jax.jit(orb.gather_patches, static_argnums=4)(
        jnp.asarray(canvas), jnp.asarray(level), jnp.asarray(yc),
        jnp.asarray(xc), side))
    y0 = np.clip(yc - side // 2, 0, H - side)
    x0 = np.clip(xc - side // 2, 0, W - side)
    ref = np.stack([canvas[l, y:y + side, x:x + side]
                    for l, y, x in zip(level, y0, x0)])
    n_bad = int((got != ref).sum())
    log("kernels", op="gather_patches", features=F, patch=f"{side}x{side}",
        canvas=f"{L}x{H}x{W}", mismatches=n_bad, tolerance=0,
        precision="f32 copy (exact)")
    assert n_bad == 0, n_bad

    a = rng.randint(0, 2 ** 32, (2048, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2 ** 32, (2048, 8), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(jax.jit(hamming.pairwise_hamming)(
        jnp.asarray(a), jnp.asarray(b)))
    n_bad = int((got != _popcount_rows(a, b)).sum())
    log("kernels", op="pairwise_hamming", shape="2048x2048", mismatches=n_bad,
        tolerance=0, precision="bf16 +-1 operands, f32 accumulation (exact)")
    assert n_bad == 0, n_bad

    # descriptors: the GPU's against the CPU's on a rendered 480x640 view
    from multi_orb_slam.io import synthetic

    world = synthetic.make_box_world(seed=3, n_points=5000, box=(7.0, 4.0, 7.0))
    Tcw = synthetic.circuit_trajectory(8, radius=2.2)[0]
    img, _ = synthetic.render_rgbd(
        world, np.array([522.6, 522.6, 320.0, 240.0], np.float32), Tcw, H, W)
    cpu = jax.devices("cpu")[0]
    fg = jax.device_get(orb.extract_orb(jnp.asarray(img), cfg))
    fc = jax.device_get(orb.extract_orb(jax.device_put(img, cpu), cfg))

    def keyed(f):
        return {(int(l), float(x), float(y)): d for l, (x, y), d, v in zip(
            f.level, f.xy, f.desc, f.valid) if v}

    kg, kc = keyed(fg), keyed(fc)
    common = sorted(set(kg) & set(kc))
    diff = np.stack([kg[k] ^ kc[k] for k in common])
    agree = 1.0 - float(np.unpackbits(diff.view(np.uint8)).mean())
    log("kernels", op="extract_orb descriptors", image=f"{H}x{W}",
        features_gpu=len(kg), features_cpu=len(kc), common_keypoints=len(common),
        bit_agreement=agree, bound=MIN_DESC_BIT_AGREEMENT,
        precision="blur conv at DEFAULT (TF32 on the GPU) vs f32 on the CPU")
    assert len(common) >= 0.95 * max(len(kg), len(kc)), len(common)
    assert agree >= MIN_DESC_BIT_AGREEMENT, agree

    # the package-wide float32 matmul default keeps geometry out of TF32
    x = rng.randn(512, 512).astype(np.float32)
    y = rng.randn(512, 512).astype(np.float32)
    exact = x.astype(np.float64) @ y.astype(np.float64)
    scale = np.abs(exact).max()
    err_f32 = float(np.abs(np.asarray(jnp.dot(x, y)) - exact).max() / scale)
    err_default = float(np.abs(np.asarray(jnp.dot(
        x, y, precision=jax.lax.Precision.DEFAULT)) - exact).max() / scale)
    log("kernels", op="f32 matmul 512x512", default_precision=str(
        jax.config.jax_default_matmul_precision), rel_err_package_default=
        err_f32, rel_err_explicit_DEFAULT=err_default, bound=1e-5)
    assert err_f32 < 1e-5, err_f32


# ---------------------------------------------------------------------------
# 3. the main path through System
# ---------------------------------------------------------------------------


def render_circuit(calib, n_frames: int, laps: float, drift: float):
    """Rig frames of the outward-facing circuit; the depth of the first
    half-lap is scaled by a smooth ramp so the return to the start arc
    carries real odometric drift and is reached only through place
    recognition (tests/test_circuit_e2e.py explains the ramp)."""
    from multi_orb_slam.io import synthetic

    world = synthetic.make_box_world(seed=3, n_points=5000, box=(7.0, 4.0, 7.0))
    poses = synthetic.circuit_trajectory(n_frames, radius=2.2, laps=laps)
    K = np.asarray(calib.K)
    T_rc = np.asarray(calib.T_rc)
    frames = []
    for i in range(n_frames):
        views = [synthetic.render_rgbd(world, K[c], T_rc[c] @ poses[i],
                                       calib.height, calib.width)
                 for c in range(T_rc.shape[0])]
        grays = np.stack([g for g, _ in views])
        depths = np.stack([d for _, d in views])
        s = i / (n_frames - 1)
        if 0.08 <= s < 0.60:
            depths = depths * (1.0 + drift * np.sin(np.pi * (s - 0.08) / 0.52))
        frames.append((grays, depths))
    return frames, poses


def trajectory_ate(traj, poses) -> float:
    from multi_orb_slam.geometry import align

    est = np.stack([np.linalg.inv(T)[:3, 3] for _, _, T, _ in traj])
    gt = np.stack([np.linalg.inv(poses[min(fid, len(poses) - 1)])[:3, 3]
                   for fid, _, _, _ in traj])
    return float(align.ate_rmse(est, gt))


def run_circuit(n_frames: int = CIRCUIT_FRAMES, laps: float = CIRCUIT_LAPS,
                drift: float = CIRCUIT_DRIFT) -> dict:
    """The deployment's full path on the default JAX device; returns its
    outcome.  Also the CPU rehearsal: run under JAX_PLATFORMS=cpu."""
    import jax.numpy as jnp

    from multi_orb_slam import system as system_mod
    from multi_orb_slam.ops import orb
    from multi_orb_slam.placerec import database, vocabulary

    t0 = time.perf_counter()
    slam = system_mod.System(settings_path=SETTINGS,
                             calibration_path=CALIBRATION,
                             sensor=system_mod.Sensor.DUAL_RGBD)
    frames, poses = render_circuit(slam.calib, n_frames, laps, drift)
    render_s = time.perf_counter() - t0
    # in-run vocabulary from camera 0 of every 8th frame (nothing loaded)
    descs = []
    for grays, _ in frames[::8]:
        f = orb.extract_orb(jnp.asarray(grays[0]), slam.cfg.orb)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = vocabulary.build_vocabulary(np.concatenate(descs), k=10, depth=4,
                                      iters=3)
    slam.loop_closer.voc = voc
    slam.loop_closer.db = database.make_empty_db(slam.cfg.max_kf, voc.n_words)

    frame_s = []
    t1 = time.perf_counter()
    for grays, depths in frames:
        t = time.perf_counter()
        slam.track_rgbd(grays[0], depths[0], grays[1], depths[1])
        frame_s.append(time.perf_counter() - t)
    slam.shutdown()
    traj = slam.tracker.absolute_trajectory()
    track_s = time.perf_counter() - t1
    return {
        "frames": n_frames, "laps": laps, "drift": drift,
        "image": f"{slam.cfg.height}x{slam.cfg.width}",
        "features_per_cam": slam.cfg.orb.n_features,
        "cams": slam.cfg.n_cams,
        "lost": sum(1 for *_, lost in traj if lost),
        "loops_closed": slam.loop_closer.n_loops_closed,
        "keyframes": int(np.asarray(slam.map.n_kf)),
        "ate_m": trajectory_ate(traj, poses),
        "render_s": render_s, "track_s": track_s,
        "first_frame_s": frame_s[0],
        "median_frame_ms": float(np.median(frame_s)) * 1e3,
    }


def phase_system():
    out = run_circuit()
    log("system", **out, cpu_rehearsal_ate_m=CPU_REHEARSAL_ATE_M,
        bounds={"lost": MAX_LOST, "loops_closed": 1, "ate_m": MAX_ATE_M,
                "abs_ate_minus_cpu_m": CPU_ATE_BAND_M})
    assert out["lost"] <= MAX_LOST, out
    assert out["loops_closed"] >= 1, out
    assert out["ate_m"] < MAX_ATE_M, out
    assert abs(out["ate_m"] - CPU_REHEARSAL_ATE_M) < CPU_ATE_BAND_M, out


# ---------------------------------------------------------------------------
# 4-5. the fused pipelined tracker, compile time and memory
# ---------------------------------------------------------------------------


def phase_fused():
    import jax
    import jax.numpy as jnp

    from multi_orb_slam.frontend import tracking
    from multi_orb_slam.io import synthetic
    from multi_orb_slam.mapping import local_mapping
    from multi_orb_slam import system as system_mod

    proto = system_mod.System(settings_path=SETTINGS,
                              calibration_path=CALIBRATION,
                              sensor=system_mod.Sensor.DUAL_RGBD,
                              enable_loop_closing=False)
    calib, cfg = proto.calib, proto.cfg
    seq = synthetic.make_sequence(
        n_frames=FUSED_FRAMES, K=np.asarray(calib.K[0]),
        T_rc=np.asarray(calib.T_rc), height=cfg.height, width=cfg.width,
        n_points=4000)
    tracker = tracking.Tracker(calib, cfg, pipelined=True, pipeline_depth=3)
    tracker.fuse_extraction = True

    def on_keyframe(kf_slot):
        return local_mapping.run_mapping_stage(
            tracker.map, kf_slot, tracker.frame_id, calib, cfg)

    tracker.kf_inserted_cb = on_keyframe
    n0 = len(_compile_s)
    t0 = time.perf_counter()
    for g, d in zip(seq.grays, seq.depths):
        tracker.process(jnp.asarray(g), jnp.asarray(d))
    traj = tracker.absolute_trajectory()
    jax.block_until_ready(tracker.map)
    wall = time.perf_counter() - t0
    lost = sum(1 for *_, lost in traj if lost)
    ate = trajectory_ate(traj, seq.poses_gt)
    log("fused", frames=FUSED_FRAMES, lost=lost, ate_m=ate, wall_s=wall,
        compiles=len(_compile_s) - n0,
        compile_s=float(sum(_compile_s[n0:])),
        keyframes=int(np.asarray(tracker.map.n_kf)))
    assert tracker.state == tracking.TrackState.OK
    assert lost == 0, lost
    assert ate < 0.05, ate

    g, d = jnp.asarray(seq.grays[-1]), jnp.asarray(seq.depths[-1])
    t0 = time.perf_counter()
    compiled = tracking.track_frame_fused_images.lower(
        tracker.map, tracker.prev_frame, tracker.prev_Tcw, tracker.prev_mp,
        tracker.velocity, tracker._tstate_dev, tracker._ensure_local_pts(),
        g, d, calib, cfg, jnp.asarray(tracker.frame_id, jnp.int32)).compile()
    mem = compiled.memory_analysis()
    log("memory", fused_step_compile_s=time.perf_counter() - t0,
        fused_step_memory_analysis={
            k: getattr(mem, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes",
                "alias_size_in_bytes") if hasattr(mem, k)},
        compile_s_total=float(sum(_compile_s)), compiles_total=len(_compile_s),
        peak_bytes_in_use=jax.devices()[0].memory_stats()["peak_bytes_in_use"])


# ---------------------------------------------------------------------------
# --four-cards: distributed GBA and place recognition, 4 GPUs against 1
# ---------------------------------------------------------------------------


def _timed(fn, *args, reps: int = 3):
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    return out, (time.perf_counter() - t0) / reps


def _shard_devices(x) -> list:
    return sorted({s.device.id for s in x.addressable_shards})


def phase_four_cards(devs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from multi_orb_slam.parallel import dist_ba, dist_placerec
    from multi_orb_slam.placerec import vocabulary

    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, JAX has {len(devs)}")
    kfs, points, obs = DIST_KFS, DIST_POINTS, DIST_OBS_PER_KF
    res = {}
    for n in (1, 4):
        mesh = Mesh(np.array(devs[:n]), ("data",))
        flat, T_rc, K, bf = dist_ba.synthetic_problem(kfs, points, obs, n)
        sharded = NamedSharding(mesh, P("data"))
        flat = flat._replace(**{
            f: jax.device_put(getattr(flat, f), sharded) for f in (
                "obs_kf", "obs_cam", "obs_mp", "obs_uvr", "obs_is2",
                "mp_pos", "mp_valid")})
        step = dist_ba.make_dist_ba_step(mesh, n_outer=6, cg_iters=40)
        (Tcw, pos, costs), dt = _timed(step, flat, T_rc, K, bf)
        res[n] = (np.asarray(Tcw), np.asarray(costs), dt, _shard_devices(pos))
    d_pose = float(np.abs(res[4][0] - res[1][0]).max())
    log("four_cards", op="dist_ba GBA", kfs=kfs, points=points,
        obs_per_kf=obs, s_per_step={n: res[n][2] for n in res},
        point_shard_devices={n: res[n][3] for n in res},
        cost_first_last={n: [res[n][1][0], res[n][1][-1]] for n in res},
        max_abs_pose_diff_4_vs_1=d_pose, tolerance=5e-4)
    assert res[4][3] == sorted(d.id for d in devs[:4]), res[4][3]
    assert res[4][1][-1] < res[4][1][0]
    assert d_pose < 5e-4, d_pose

    # place recognition: a 128-keyframe BoW store, 512 words each
    rng = np.random.RandomState(0)
    n_words, B = 10 ** 4, 512
    ids = np.stack([rng.choice(n_words, B, replace=False)
                    for _ in range(kfs)]).astype(np.int32)
    vals = rng.rand(kfs, B).astype(np.float32)
    vals /= vals.sum(1, keepdims=True)
    q_ids, q_vals = jnp.asarray(ids[5]), jnp.asarray(vals[5])
    ref, dt1 = _timed(jax.jit(vocabulary.score_sparse_many, static_argnums=4),
                      q_ids, q_vals, jnp.asarray(ids), jnp.asarray(vals),
                      n_words)
    mesh = Mesh(np.array(devs[:4]), ("data",))
    d_ids, d_vals = dist_placerec.shard_database(mesh, ids, vals)
    scorer = dist_placerec.make_dist_scorer(mesh, n_words)
    out, dt4 = _timed(scorer, q_ids, q_vals, d_ids, d_vals)
    d_score = float(np.abs(np.asarray(out) - np.asarray(ref)).max())
    log("four_cards", op="dist_placerec scores", keyframes=kfs,
        words_per_kf=B, s_per_query={1: dt1, 4: dt4},
        db_shard_devices=_shard_devices(d_ids),
        max_abs_score_diff_4_vs_1=d_score, tolerance=1e-6,
        best_match=int(jnp.argmax(out)))
    assert _shard_devices(d_ids) == sorted(d.id for d in devs[:4])
    assert d_score < 1e-6, d_score
    assert int(jnp.argmax(out)) == 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only distributed GBA and place recognition "
                         "on 4 GPUs against 1")
    args = ap.parse_args(argv)

    import jax

    from multi_orb_slam.utils import compile_cache

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    compile_cache.enable()
    devs = phase_device()
    if args.four_cards:
        phase_four_cards(devs)
    else:
        phase_kernels()
        phase_system()
        phase_fused()
        # nothing on the path may need OpenCV
        assert "cv2" not in sys.modules
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
