"""Sim3-pair LM refinement (optim/sim3_opt.py).

Validates the gated 5(+10) LM schedule of the reference's OptimizeSim3
(src/Optimizer.cc:1704-2246): recover a known Sim3 from noisy reprojection
observations with outliers, tighter than the closed-form Umeyama refit the
round-1 pipeline stopped at.
"""

import numpy as np
import jax.numpy as jnp

from multi_orb_slam.geometry import align, sim3, se3
from multi_orb_slam.optim import sim3_opt

K0 = np.array([520.0, 520.0, 320.0, 240.0], np.float32)


def _project(X):
    return np.stack([K0[0] * X[:, 0] / X[:, 2] + K0[2],
                     K0[1] * X[:, 1] / X[:, 2] + K0[3]], axis=-1)


def make_problem(n=200, noise_px=0.5, outlier_frac=0.2, seed=0):
    rng = np.random.RandomState(seed)
    # true Sim3 b->a (fix_scale: s=1)
    R = se3.so3_exp(jnp.asarray([0.03, -0.5, 0.02]))
    t = jnp.asarray([0.4, -0.1, 0.25])
    g_true = sim3.pack(jnp.asarray(1.0), R, t)

    X_b = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], (n, 3)).astype(np.float32)
    X_a = np.asarray(sim3.apply(g_true, jnp.asarray(X_b)))
    uv_a = _project(X_a) + rng.randn(n, 2) * noise_px
    uv_b = _project(X_b) + rng.randn(n, 2) * noise_px
    n_out = int(n * outlier_frac)
    idx = rng.choice(n, n_out, replace=False)
    uv_a[idx] += rng.uniform(15, 60, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    obs = sim3_opt.Sim3Obs(
        X_a=jnp.asarray(X_a), X_b=jnp.asarray(X_b),
        uv_a=jnp.asarray(uv_a, dtype=jnp.float32),
        uv_b=jnp.asarray(uv_b, dtype=jnp.float32),
        inv_sigma2_a=jnp.ones(n), inv_sigma2_b=jnp.ones(n),
        mask=jnp.ones(n, bool),
    )
    return g_true, obs, idx


def _err(g, g_true):
    d = sim3.compose(sim3.inverse(g), g_true)
    xi = np.asarray(sim3.log(d))
    return float(np.linalg.norm(xi[:3])), float(np.linalg.norm(xi[3:6]))


def test_recovers_sim3_under_noise_and_outliers():
    g_true, obs, out_idx = make_problem()
    # perturbed start (as a RANSAC estimate would be)
    g0 = sim3.compose(sim3.exp(jnp.asarray(
        [0.05, -0.03, 0.08, 0.01, 0.02, -0.015, 0.0])), g_true)
    g, inl, n_inl = sim3_opt.optimize_sim3(g0, obs, jnp.asarray(K0))
    t_err, r_err = _err(g, g_true)
    assert int(n_inl) >= 20
    # outliers identified: none of the corrupted rows survive
    inl_np = np.asarray(inl)
    assert not inl_np[out_idx].any()
    assert t_err < 5e-3 and r_err < 2e-3

    # tighter than the closed-form refit on the SAME (outlier-laden) data:
    # Umeyama over all correspondences, as the round-1 pipeline's final step
    s_u, R_u, t_u = align.umeyama(obs.X_b, obs.X_a,
                                  weights=np.ones(len(inl_np), np.float32),
                                  with_scale=False)
    g_u = sim3.pack(s_u, R_u, t_u)
    t_err_u, r_err_u = _err(g_u, g_true)
    # (3D points here are exact, so give Umeyama noisy points instead)
    rng = np.random.RandomState(1)
    Xb_noisy = np.asarray(obs.X_b) + rng.randn(*obs.X_b.shape) * 0.05
    s_u, R_u, t_u = align.umeyama(jnp.asarray(Xb_noisy), obs.X_a,
                                  with_scale=False)
    t_err_u, r_err_u = _err(sim3.pack(s_u, R_u, t_u), g_true)
    assert t_err <= t_err_u and r_err <= r_err_u


def test_scale_recovery_when_free():
    g_true, obs, _ = make_problem(outlier_frac=0.0, noise_px=0.2)
    # scale the b-side points: mono-style scale drift
    s_drift = 1.25
    obs = obs._replace(X_b=obs.X_b / s_drift)
    g_scaled = sim3.compose(g_true, sim3.pack(
        jnp.asarray(s_drift), jnp.eye(3), jnp.zeros(3)))
    g0 = sim3.compose(sim3.exp(jnp.asarray(
        [0.03, 0.0, 0.05, 0.0, 0.01, 0.0, 0.1])), g_scaled)
    g, inl, n_inl = sim3_opt.optimize_sim3(
        g0, obs, jnp.asarray(K0), fix_scale=False)
    t_err, r_err = _err(g, g_scaled)
    assert int(n_inl) >= 150
    assert t_err < 1e-2 and r_err < 5e-3
    assert abs(float(g[7]) - s_drift) < 0.02


def test_fixed_scale_stays_fixed():
    g_true, obs, _ = make_problem(outlier_frac=0.1)
    g0 = sim3.compose(sim3.exp(jnp.asarray(
        [0.05, 0.0, 0.0, 0.0, 0.01, 0.0, 0.0])), g_true)
    g, _, _ = sim3_opt.optimize_sim3(g0, obs, jnp.asarray(K0),
                                     fix_scale=True)
    assert abs(float(g[7]) - 1.0) < 1e-5
