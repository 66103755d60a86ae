"""Camera-aware Sim3 RANSAC + LM with cam-1 observations.

The reference's Sim3Solver stores a per-point camera id because loop
matches can land on second-camera features (src/Sim3Solver.cc:117-135),
and OptimizeSim3_cam1 routes those edges through the rig extrinsic
(src/Optimizer.cc:1704-2246).  These tests exercise exactly that: half of
the matched landmarks are observed only by the ~90-deg-rotated camera 1,
so any cam-0-only treatment puts them behind the projecting camera.
"""

import numpy as np
import jax
import jax.numpy as jnp

from multi_orb_slam.geometry import camera as cam_mod, se3, sim3
from multi_orb_slam.loop import sim3_solver
from multi_orb_slam.optim import sim3_opt

K2 = jnp.asarray([[260.0, 260.0, 160.0, 120.0],
                  [260.0, 260.0, 160.0, 120.0]], jnp.float32)


def make_rig():
    Ry = se3.so3_exp(jnp.asarray([0.0, np.pi / 2, 0.0]))
    T_rc1 = (jnp.eye(4).at[:3, :3].set(Ry)
             .at[:3, 3].set(jnp.asarray([0.161, 0.004, -0.071])))
    return jnp.stack([jnp.eye(4), T_rc1]).astype(jnp.float32)


def make_pair(n=256, seed=0, noise=0.0):
    """Matched landmark pairs seen from two rig poses, half in camera 1.

    Returns (g_ab true Sim3 b->a, pts_a, pts_b [N,3] rig coords, cams [N]).
    """
    rng = np.random.RandomState(seed)
    T_rc = make_rig()
    # half the landmarks sit in front of cam0 (+z), half in front of cam1
    # (which looks along the rig's rotated axis)
    cams = np.repeat(np.arange(2), n // 2).astype(np.int32)
    pts_cam = rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 4.0],
                          (n, 3)).astype(np.float32)
    # camera-frame -> rig frame through the observing camera's extrinsic
    Trc = np.asarray(T_rc)[cams]
    Rcr = Trc[:, :3, :3]
    tcr = Trc[:, :3, 3]
    pts_a = np.einsum("nij,nj->ni", Rcr.transpose(0, 2, 1),
                      pts_cam - tcr)  # rig-a coords
    # true relative transform a->b (rigid, scale 1 for RGB-D)
    R_ab = np.asarray(se3.so3_exp(jnp.asarray([0.02, 0.3, -0.05])))
    t_ab = np.array([0.4, -0.1, 0.25], np.float32)
    g_ab = sim3.pack(jnp.asarray(1.0), jnp.asarray(R_ab),
                     jnp.asarray(t_ab))  # maps b -> a
    g_ba = sim3.inverse(g_ab)
    pts_b = np.asarray(sim3.apply(g_ba, jnp.asarray(pts_a)))
    if noise:
        pts_b = pts_b + rng.normal(0, noise, pts_b.shape).astype(np.float32)
    return g_ab, (pts_a.astype(np.float32), pts_b.astype(np.float32),
                  cams, T_rc)


def test_ransac_recovers_with_cam1_points():
    g_true, (pts_a, pts_b, cams, T_rc) = make_pair()
    n = pts_a.shape[0]
    valid = jnp.ones(n, bool)
    g, inl, n_inl = sim3_solver.solve_sim3_ransac(
        jax.random.PRNGKey(0), jnp.asarray(pts_a), jnp.asarray(pts_b),
        jnp.asarray(cams), jnp.asarray(cams), valid, T_rc, K2)
    assert int(n_inl) >= int(0.95 * n)
    # translation/rotation of the recovered Sim3 match the truth
    assert float(jnp.linalg.norm(g[4:7] - g_true[4:7])) < 1e-2
    assert float(jnp.linalg.norm(g[:4] - g_true[:4])) < 1e-2


def test_ransac_cam_ids_matter():
    """Mislabeling cam-1 observations as cam-0 must hurt the inlier count:
    the inlier check projects them into the wrong camera (behind it)."""
    g_true, (pts_a, pts_b, cams, T_rc) = make_pair()
    n = pts_a.shape[0]
    valid = jnp.ones(n, bool)
    _, _, n_good = sim3_solver.solve_sim3_ransac(
        jax.random.PRNGKey(0), jnp.asarray(pts_a), jnp.asarray(pts_b),
        jnp.asarray(cams), jnp.asarray(cams), valid, T_rc, K2)
    _, _, n_zeros = sim3_solver.solve_sim3_ransac(
        jax.random.PRNGKey(0), jnp.asarray(pts_a), jnp.asarray(pts_b),
        jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32), valid, T_rc, K2)
    assert int(n_good) > int(n_zeros) + n // 4


def test_lm_refines_through_rig_extrinsic():
    g_true, (pts_a, pts_b, cams, T_rc) = make_pair(noise=0.002)
    n = pts_a.shape[0]
    # measured pixels: project each landmark into ITS observing camera
    def cam_uv(X, T):
        Xr = np.asarray(X)
        Trc = np.asarray(T_rc)[cams]
        Xc = np.einsum("nij,nj->ni", Trc[:, :3, :3], Xr) + Trc[:, :3, 3]
        Kc = np.asarray(K2)[cams]
        return np.stack([Kc[:, 0] * Xc[:, 0] / Xc[:, 2] + Kc[:, 2],
                         Kc[:, 1] * Xc[:, 1] / Xc[:, 2] + Kc[:, 3]], -1)

    uv_a = cam_uv(pts_a, None)
    uv_b = cam_uv(pts_b, None)
    obs = sim3_opt.Sim3Obs(
        X_a=jnp.asarray(pts_a), X_b=jnp.asarray(pts_b),
        uv_a=jnp.asarray(uv_a.astype(np.float32)),
        uv_b=jnp.asarray(uv_b.astype(np.float32)),
        inv_sigma2_a=jnp.ones(n), inv_sigma2_b=jnp.ones(n),
        mask=jnp.ones(n, bool),
        cam_a=jnp.asarray(cams), cam_b=jnp.asarray(cams))
    g0 = sim3.compose(sim3.exp(jnp.asarray(
        [0.02, -0.01, 0.03, 0.05, -0.04, 0.02, 0.0])), g_true)
    g, inl, n_inl = sim3_opt.optimize_sim3(
        g0, obs, K2, T_rc=T_rc, fix_scale=True)
    assert int(n_inl) >= int(0.9 * n)
    assert float(jnp.linalg.norm(g[4:7] - g_true[4:7])) < 5e-3
    assert float(jnp.linalg.norm(g[:4] - g_true[:4])) < 5e-3
