"""Sim3-pair optimization: gated LM refinement of a loop-closure transform.

Replaces `Optimizer::OptimizeSim3[_cam1]` (reference src/Optimizer.cc:
1704-2246): one Sim3 vertex g_ab relating two keyframes, two families of
reprojection edges —

  e1_i = uv_a_i - proj_0( g_ab  (X_b_i) )     (b's landmark seen in a)
  e2_i = uv_b_i - proj_0( g_ab^-1 (X_a_i) )   (a's landmark seen in b)

with per-level information, Huber kernels, and the reference's schedule:
5 LM iterations, drop correspondences whose e1 OR e2 chi2 exceeds 10
(Optimizer.cc:2149-2172 `th2 = 10`), then 10 more iterations (5 if nothing
was dropped), and count surviving inliers.  The caller accepts the result
when >= 20 inliers remain (LoopClosing.cc:461).

The whole schedule is ONE jit — fixed-capacity [N] edge arrays
with masks, Jacobians by forward-mode autodiff of the 7-dof tangent
(scale frozen for stereo/RGB-D, the reference's bFixScale=true), and the
7x7 normal system solved directly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import sim3

CHI2_TH = 10.0  # reference th2, Optimizer.cc:2149


class Sim3Obs(NamedTuple):
    """Fixed-capacity correspondence set between two keyframes.

    X_a / X_b are the SAME physical landmark's positions in each keyframe's
    rig (camera-0) coordinates; uv_a / uv_b the matched feature positions.
    `cam_a` / `cam_b` are the observing camera of each feature (None means
    all camera 0): the reference's `OptimizeSim3_cam1` routes cam-2
    observations through the rig extrinsic (src/Optimizer.cc:1704-2246,
    VertexSim3Expmap_Multi edges).
    """

    X_a: jnp.ndarray          # [N, 3]
    X_b: jnp.ndarray          # [N, 3]
    uv_a: jnp.ndarray         # [N, 2]
    uv_b: jnp.ndarray         # [N, 2]
    inv_sigma2_a: jnp.ndarray # [N]
    inv_sigma2_b: jnp.ndarray # [N]
    mask: jnp.ndarray         # [N] bool
    cam_a: jnp.ndarray | None = None  # [N] int32 observing camera in a
    cam_b: jnp.ndarray | None = None  # [N] int32 observing camera in b


def _project(K, X):
    z = jnp.maximum(X[..., 2], 1e-6)
    u = K[0] * X[..., 0] / z + K[2]
    v = K[1] * X[..., 1] / z + K[3]
    return jnp.stack([u, v], axis=-1), X[..., 2] > 1e-3


@partial(jax.jit, static_argnums=(4, 5, 6))
def optimize_sim3(
    g_ab0: jnp.ndarray,   # [8] initial Sim3 (b -> a), e.g. from RANSAC
    obs: Sim3Obs,
    K0: jnp.ndarray,      # [4] cam-0 intrinsics, or [C, 4] with T_rc given
    T_rc: jnp.ndarray | None = None,  # [C, 4, 4] rig extrinsics (with
                                      # obs.cam_a/cam_b: camera-aware edges)
    fix_scale: bool = True,
    n_iters_first: int = 5,
    n_iters_second: int = 10,
):
    """Returns (g_ab [8], inlier_mask [N], n_inliers int32)."""
    delta = jnp.sqrt(CHI2_TH)
    multi = T_rc is not None and obs.cam_a is not None

    def proj_into(cams, X):
        """Project rig-frame points into each observation's camera."""
        if not multi:
            return _project(K0, X)
        Trc = T_rc[cams]
        Xc = jnp.einsum("nij,nj->ni", Trc[:, :3, :3], X) + Trc[:, :3, 3]
        Kc = K0[cams]
        z = jnp.maximum(Xc[..., 2], 1e-6)
        u = Kc[:, 0] * Xc[..., 0] / z + Kc[:, 2]
        v = Kc[:, 1] * Xc[..., 1] / z + Kc[:, 3]
        return jnp.stack([u, v], axis=-1), Xc[..., 2] > 1e-3

    def residuals(xi, g_base):
        g = sim3.compose(sim3.exp(xi), g_base)
        uv1, ok1 = proj_into(obs.cam_a, sim3.apply(g, obs.X_b))
        uv2, ok2 = proj_into(obs.cam_b,
                             sim3.apply(sim3.inverse(g), obs.X_a))
        e1 = obs.uv_a - uv1
        e2 = obs.uv_b - uv2
        return e1, e2, ok1 & ok2

    def chi2_of(e1, e2):
        c1 = jnp.sum(e1 * e1, -1) * obs.inv_sigma2_a
        c2 = jnp.sum(e2 * e2, -1) * obs.inv_sigma2_b
        return c1, c2

    def lm_phase(g_init, active, n_iters, use_huber):
        def linearize(g):
            zero = jnp.zeros(7, g.dtype)
            e1, e2, okz = residuals(zero, g)
            J = jax.jacfwd(lambda x: jnp.concatenate(
                residuals(x, g)[:2], axis=0))(zero)      # [2N, 2, 7]
            N = obs.mask.shape[0]
            J1, J2 = J[:N], J[N:]
            c1, c2 = chi2_of(e1, e2)
            act = active & okz
            # Huber IRLS weights per edge family
            def hw(c):
                r = jnp.sqrt(jnp.maximum(c, 1e-12))
                return jnp.where(use_huber & (r > delta), delta / r, 1.0)
            w1 = obs.inv_sigma2_a * hw(c1) * act
            w2 = obs.inv_sigma2_b * hw(c2) * act
            H = (jnp.einsum("nri,n,nrj->ij", J1, w1, J1)
                 + jnp.einsum("nri,n,nrj->ij", J2, w2, J2))
            g_vec = (jnp.einsum("nri,n,nr->i", J1, w1, e1)
                     + jnp.einsum("nri,n,nr->i", J2, w2, e2))
            def rho(c):
                r = jnp.sqrt(jnp.maximum(c, 1e-12))
                return jnp.where(use_huber & (r > delta),
                                 delta * (2.0 * r - delta), c)
            total = jnp.sum(jnp.where(act, rho(c1) + rho(c2), 0.0))
            return H, g_vec, total

        def body(_, carry):
            g_cur, H, gv, chi2_cur, lam = carry
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(
                7, dtype=H.dtype)
            if fix_scale:
                # freeze sigma: unit row/col with zero gradient coupling
                Hd = Hd.at[6, :].set(0.0).at[:, 6].set(0.0).at[6, 6].set(1.0)
                gv_s = gv.at[6].set(0.0)
            else:
                gv_s = gv
            dx = -jnp.linalg.solve(Hd, gv_s)
            g_try = sim3.compose(sim3.exp(dx), g_cur)
            H_t, gv_t, chi2_t = linearize(g_try)
            accept = chi2_t < chi2_cur
            return (
                jnp.where(accept, g_try, g_cur),
                jnp.where(accept, H_t, H),
                jnp.where(accept, gv_t, gv),
                jnp.where(accept, chi2_t, chi2_cur),
                jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6),
            )

        H0, gv0, chi20 = linearize(g_init)
        out = jax.lax.fori_loop(
            0, n_iters,
            body, (g_init, H0, gv0, chi20, jnp.asarray(1e-3, g_init.dtype)))
        return out[0]

    def classify(g, active):
        e1, e2, okz = residuals(jnp.zeros(7, g.dtype), g)
        c1, c2 = chi2_of(e1, e2)
        # reference drops a correspondence when EITHER direction fails
        # (Optimizer.cc:2157: e12->chi2()>th2 || e21->chi2()>th2)
        return active & okz & (c1 <= CHI2_TH) & (c2 <= CHI2_TH)

    active = obs.mask
    g1 = lm_phase(g_ab0, active, n_iters_first, jnp.asarray(True))
    survivors = classify(g1, active)
    g2 = lm_phase(g1, survivors, n_iters_second, jnp.asarray(False))
    inliers = classify(g2, survivors)
    return g2, inliers, jnp.sum(inliers.astype(jnp.int32))
