"""Batched P3P/PnP RANSAC for relocalization.

Replaces `PnPsolver` (src/PnPsolver.cc, stock EPnP + RANSAC used at
Tracking.cc:2049-2050): given 2D-3D correspondences with no pose prior,
estimate the camera pose.  Design per SURVEY.md §7.3: instead of EPnP's
sequential control-point refinement, generate a large batch of minimal
hypotheses at once — each from 3 correspondences via the closed-form
Kneip/Grunert P3P (solved here with the algebraic Lambda-Twist-style quartic)
— score all hypotheses in parallel by reprojection, then LM-polish the best.

For robustness with a fixed op count we use a simpler minimal solver: each
hypothesis aligns the 3 back-projected unit rays to the 3 world points by
solving the depth quartic; degenerate samples are masked out.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import align, camera as cam_mod, se3


def _p3p_depths(rays: jnp.ndarray, Xw: jnp.ndarray):
    """Grunert's P3P: rays [3,3] unit bearing vectors, Xw [3,3] world points.

    Returns up to 4 candidate depth triples [4, 3] + validity [4].
    Solves the quartic in v = d2/d1 numerically via companion eigenvalues —
    replaced here by a fixed-iteration polynomial root finder (Durand-
    Kerner), which is jit/batch friendly.
    """
    # pairwise data
    a = jnp.linalg.norm(Xw[1] - Xw[2])  # opposite vertex 0... use convention
    b = jnp.linalg.norm(Xw[0] - Xw[2])
    c = jnp.linalg.norm(Xw[0] - Xw[1])
    cos_al = jnp.dot(rays[1], rays[2])
    cos_be = jnp.dot(rays[0], rays[2])
    cos_ga = jnp.dot(rays[0], rays[1])

    a2, b2, c2 = a * a, b * b, c * c
    p = 2.0 * cos_al
    q = 2.0 * cos_be
    r = 2.0 * cos_ga
    # Law-of-cosines system with x = d1/d3, y = d2/d3:
    # d1^2 + d3^2 - d1 d3 q = b2   (angle beta between rays 0,2)
    # d2^2 + d3^2 - d2 d3 p = a2   (alpha between 1,2)
    # d1^2 + d2^2 - d1 d2 r = c2   (gamma between 0,1)
    # Set d1 = x d3, d2 = y d3:
    #   d3^2 (x^2 + 1 - x q) = b2
    #   d3^2 (y^2 + 1 - y p) = a2
    #   d3^2 (x^2 + y^2 - x y r) = c2
    # => (x^2+1-xq)/b2 = (y^2+1-yp)/a2 = (x^2+y^2-xyr)/c2
    # Two polynomial equations in (x, y); eliminate to a quartic in x.
    # For batch-friendliness, solve by 2D Newton from several starts instead
    # of symbolic elimination.
    def F(xy):
        x, y = xy[0], xy[1]
        f1 = a2 * (x * x + 1.0 - x * q) - b2 * (y * y + 1.0 - y * p)
        f2 = c2 * (x * x + 1.0 - x * q) - b2 * (x * x + y * y - x * y * r)
        return jnp.stack([f1, f2])

    def newton(xy0):
        def body(_, xy):
            J = jax.jacfwd(F)(xy)
            f = F(xy)
            det = J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
            det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
            inv = jnp.array([[J[1, 1], -J[0, 1]], [-J[1, 0], J[0, 0]]]) / det
            return xy - inv @ f
        return jax.lax.fori_loop(0, 12, body, xy0)

    starts = jnp.array(
        [[1.0, 1.0], [0.5, 1.5], [1.5, 0.5], [2.0, 2.0]], rays.dtype)
    sols = jax.vmap(newton)(starts)  # [4, 2]
    x, y = sols[:, 0], sols[:, 1]
    denom = x * x + 1.0 - x * q
    ok = (denom > 1e-9) & (x > 0) & (y > 0)
    d3 = jnp.sqrt(b2 / jnp.maximum(denom, 1e-9))
    d1 = x * d3
    d2 = y * d3
    resid = jnp.linalg.norm(jax.vmap(F)(sols), axis=-1)
    ok = ok & (resid < 1e-3 * b2)
    return jnp.stack([d1, d2, d3], axis=-1), ok  # [4, 3], [4]


@partial(jax.jit, static_argnums=(5,))
def pnp_ransac(
    key: jnp.ndarray,
    uv: jnp.ndarray,       # [N, 2] undistorted pixel observations (one cam)
    Xw: jnp.ndarray,       # [N, 3] world points
    valid: jnp.ndarray,    # [N]
    K: jnp.ndarray,        # [4] fx fy cx cy
    n_hyp: int = 256,
    inlier_px: float = 5.991,
):
    """Returns (Tcw [4,4], inliers [N], n_inliers). Pose maps world->cam."""
    N = uv.shape[0]
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    rays = jnp.stack(
        [(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, jnp.ones(N)], axis=-1)
    rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)

    keys = jax.random.split(key, n_hyp)

    def sample3(k):
        g = jax.random.gumbel(k, (N,)) + jnp.where(valid, 0.0, -1e9)
        _, idx = jax.lax.top_k(g, 3)
        return idx

    tri = jax.vmap(sample3)(keys)  # [H, 3]

    def hyp_poses(idx):
        r3 = rays[idx]            # [3, 3]
        X3 = Xw[idx]
        depths, ok = _p3p_depths(r3, X3)   # [4, 3], [4]
        # camera-frame points for each depth solution
        Xc = depths[:, :, None] * r3[None, :, :]   # [4, 3, 3]
        # absolute orientation: camera points <- world points
        def abs_or(Xc3):
            s, R, t = align.umeyama(X3[None], Xc3[None], with_scale=False)
            return se3.from_rt(R[0], t[0])
        Ts = jax.vmap(abs_or)(Xc)  # [4, 4, 4]
        return Ts, ok

    Ts, oks = jax.vmap(hyp_poses)(tri)      # [H, 4, 4, 4], [H, 4]
    Ts = Ts.reshape(-1, 4, 4)
    oks = oks.reshape(-1)

    def score(T):
        Xc = se3.transform_points(T, Xw)
        okz = Xc[:, 2] > 0.01
        u = fx * Xc[:, 0] / jnp.maximum(Xc[:, 2], 1e-6) + cx
        v = fy * Xc[:, 1] / jnp.maximum(Xc[:, 2], 1e-6) + cy
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        inl = valid & okz & (e2 < inlier_px)
        return jnp.sum(inl.astype(jnp.int32)), inl

    n_inl, inls = jax.vmap(score)(Ts)
    n_inl = jnp.where(oks, n_inl, -1)
    best = jnp.argmax(n_inl)
    T_best = Ts[best]
    # polish on the inlier set (the reference refines via the Gauss-Newton
    # stage inside EPnP + the follow-up PoseOptimization)
    from ..optim import pose_opt
    uvr = jnp.concatenate([uv, -jnp.ones((N, 1), uv.dtype)], axis=-1)
    obs = pose_opt.PoseObs(
        pw=Xw, uvr=uvr, cam_idx=jnp.zeros(N, jnp.int32),
        inv_sigma2=jnp.ones(N, uv.dtype), mask=inls[best])
    T_ref, inl_ref, n_ref = pose_opt.optimize_pose(
        T_best, obs, jnp.eye(4, dtype=uv.dtype)[None], K[None],
        jnp.zeros((), uv.dtype), n_rounds=2)
    better = n_ref >= n_inl[best]
    T_out = jnp.where(better, T_ref, T_best)
    inl_out = jnp.where(better, inl_ref, inls[best])
    return T_out, inl_out, jnp.maximum(jnp.where(better, n_ref, n_inl[best]), 0)
