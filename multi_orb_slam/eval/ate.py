"""ATE evaluation — the acceptance metric.

Re-implements OtherFiles/evaluate_ate.py (Horn closed-form alignment +
translational RMSE, the reference's only quantitative check, SURVEY.md §4)
in python3 on top of geometry.align.  Usable as a library or CLI:

    python -m multi_orb_slam.eval.ate groundtruth.txt estimated.txt
"""

from __future__ import annotations

import sys

import numpy as np
import jax.numpy as jnp

from ..geometry import align
from ..io import tum


def evaluate_ate(gt_file: str, est_file: str,
                 max_difference: float = 0.02) -> dict:
    gt = tum.read_trajectory_tum(gt_file)
    est = tum.read_trajectory_tum(est_file)
    matches = tum.associate(
        {t: [0] for t in gt}, {t: [0] for t in est},
        max_difference=max_difference)
    if len(matches) < 2:
        raise ValueError(
            "Couldn't find matching timestamp pairs between groundtruth and "
            "estimated trajectory!")
    gt_xyz = np.stack([gt[ta][:3, 3] for ta, _ in matches])
    est_xyz = np.stack([est[tb][:3, 3] for _, tb in matches])
    # align est -> gt (rigid, like evaluate_ate.py:47-60)
    s, R, t = align.umeyama(
        jnp.asarray(est_xyz), jnp.asarray(gt_xyz), with_scale=False)
    aligned = est_xyz @ np.asarray(R).T + np.asarray(t)
    err = aligned - gt_xyz
    dists = np.linalg.norm(err, axis=1)
    return {
        "compared_pose_pairs": len(matches),
        "absolute_translational_error.rmse": float(
            np.sqrt(np.mean(dists ** 2))),
        "absolute_translational_error.mean": float(np.mean(dists)),
        "absolute_translational_error.median": float(np.median(dists)),
        "absolute_translational_error.std": float(np.std(dists)),
        "absolute_translational_error.min": float(np.min(dists)),
        "absolute_translational_error.max": float(np.max(dists)),
    }


def main():
    if len(sys.argv) < 3:
        print(__doc__)
        sys.exit(1)
    res = evaluate_ate(sys.argv[1], sys.argv[2])
    for k, v in res.items():
        print(f"{k} {v}")


if __name__ == "__main__":
    main()
