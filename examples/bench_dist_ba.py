#!/usr/bin/env python3
"""Distributed global-BA step time on a 1-D device mesh.

Runs `parallel/dist_ba.py` on a synthetic problem (default 128 keyframes,
16,384 points, 512 observations per keyframe) and prints one JSON line with
the seconds per outer LM iteration.

- On one machine with several GPUs: `python examples/bench_dist_ba.py
  --devices N` for N = 1, 2, 4 and compare.
- With several processes, set JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
  JAX_PROCESS_ID in each (`parallel/multihost.py`).
- On the CPU: `--devices 8 --platform cpu` exercises the sharded program on
  8 virtual devices (CPU wall time is not a scaling measurement).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0,
                    help="0 = all available devices")
    ap.add_argument("--platform", default=None,
                    help="cpu = run on virtual CPU devices")
    ap.add_argument("--kfs", type=int, default=128)
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--obs-per-kf", type=int, default=512)
    ap.add_argument("--outer", type=int, default=6)
    args = ap.parse_args()

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        if args.platform == "cpu" and args.devices:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={args.devices}")

    import jax
    import numpy as np
    from jax.sharding import Mesh

    from multi_orb_slam.parallel import dist_ba, multihost
    from multi_orb_slam.utils import compile_cache

    compile_cache.enable()
    multihost.initialize()
    devs = jax.devices()
    n_dev = args.devices or len(devs)
    mesh = Mesh(np.array(devs[:n_dev]), ("data",))

    flat, T_rc, K_intr, bf = dist_ba.synthetic_problem(
        args.kfs, args.points, args.obs_per_kf, n_dev)
    step = dist_ba.make_dist_ba_step(mesh, n_outer=args.outer, cg_iters=40)

    out = jax.block_until_ready(step(flat, T_rc, K_intr, bf))
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(step(flat, T_rc, K_intr, bf))
    dt = (time.perf_counter() - t0) / reps
    costs = np.asarray(out[2])
    print(json.dumps({
        "metric": "dist_gba_s_per_outer_iter",
        "value": dt / args.outer,
        "unit": "s",
        "devices": n_dev,
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "kfs": args.kfs, "points": int(flat.mp_pos.shape[0]),
        "cost_first": float(costs[0]), "cost_last": float(costs[-1]),
    }))


if __name__ == "__main__":
    main()
