"""Monocular two-view initialization (frontend/initializer.py).

Synthetic two-view problems with known (R, t): a general 3D scene must
select the fundamental path and recover the pose; a planar scene must
select the homography path.  Mirrors the reference Initializer's
acceptance behavior (src/Initializer.cc:33-124).
"""

import numpy as np
import jax
import jax.numpy as jnp

from multi_orb_slam.frontend import initializer
from multi_orb_slam.geometry import se3

K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)


def project(X, R, t):
    Xc = X @ R.T + t
    return np.stack([K[0] * Xc[:, 0] / Xc[:, 2] + K[2],
                     K[1] * Xc[:, 1] / Xc[:, 2] + K[3]], -1), Xc[:, 2]


def make_views(planar, n=300, noise=0.3, outliers=0.1, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform([-2, -1.5, 4.0], [2, 1.5, 8.0], (n, 3)).astype(np.float32)
    if planar:
        # tilted plane with realistic surface roughness: an EXACT plane
        # leaves the homography's twisted-pair decomposition unfalsifiable
        # (both interpretations reproject perfectly) and the reference's
        # dominance gate would likewise defer initialization
        X[:, 2] = (6.0 + 0.3 * X[:, 0] + 0.1 * X[:, 1]
                   + rng.randn(n).astype(np.float32) * 0.05)
    R = np.asarray(se3.so3_exp(jnp.asarray([0.02, 0.12, -0.03])))
    t = np.array([0.4, 0.05, 0.1], np.float32)
    t = t / np.linalg.norm(t)
    uv1, z1 = project(X, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    uv2, z2 = project(X, R, t)
    uv1 += rng.randn(n, 2) * noise
    uv2 += rng.randn(n, 2) * noise
    n_out = int(n * outliers)
    idx = rng.choice(n, n_out, replace=False)
    uv2[idx] += rng.uniform(20, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    mask = (z1 > 0) & (z2 > 0)
    return (jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask),
            R, t, X, idx)


def angle_between(R_est, R_true):
    dR = R_est @ R_true.T
    c = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(c))


def test_general_scene_uses_f_and_recovers_pose():
    uv1, uv2, mask, R, t, X, out_idx = make_views(planar=False)
    res = initializer.initialize_two_view(
        jax.random.PRNGKey(0), uv1, uv2, mask, 256, jnp.asarray(K))
    assert bool(res.ok)
    assert not bool(res.used_homography)
    assert angle_between(np.asarray(res.R), R) < 1.0
    # translation up to scale and known sign
    t_est = np.asarray(res.t)
    assert np.abs(np.dot(t_est, t)) > 0.995
    # triangulated inliers land near the true points (up to global scale)
    good = np.asarray(res.is_good)
    assert good.sum() > 150
    Xe = np.asarray(res.points)[good]
    Xt = X[good]
    s = np.median(Xt[:, 2] / np.maximum(Xe[:, 2], 1e-9))
    err = np.linalg.norm(Xe * s - Xt, axis=-1)
    assert np.median(err) < 0.15
    # none of the injected outliers survive
    assert not good[out_idx].any()


def test_planar_scene_selects_homography():
    uv1, uv2, mask, R, t, X, _ = make_views(planar=True)
    res = initializer.initialize_two_view(
        jax.random.PRNGKey(1), uv1, uv2, mask, 256, jnp.asarray(K))
    assert bool(res.used_homography)
    assert bool(res.ok)
    assert angle_between(np.asarray(res.R), R) < 2.0
    assert np.abs(np.dot(np.asarray(res.t), t)) > 0.99
