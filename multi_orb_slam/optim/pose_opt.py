"""Motion-only bundle adjustment (pose optimization), batched LM.

Replaces both reference overloads of `Optimizer::PoseOptimization`:
- single-camera (src/Optimizer.cc:352-618)
- all-camera with per-edge rig transform `Tcim_quat`
  (src/Optimizer.cc:620-898, using the fork's `_multi` unary edges
  Thirdparty/g2o/.../types_six_dof_expmap.h:204-313)

One function covers both: every observation carries a camera index that picks
its rig extrinsic, so the "cam1-only" variant is just a mask.  The reference's
schedule is preserved:
- 4 rounds x 10 LM iterations, re-starting each round from the input pose
  (Optimizer.cc:527-538)
- chi2 gates 5.991 (mono) / 7.815 (stereo) re-classify inliers between rounds
- Huber kernel active for rounds 0-1, dropped from round 2
  (Optimizer.cc:584: `if(it==2) e->setRobustKernel(0)`)

The whole schedule runs inside one jit: the per-edge graph build of g2o
becomes dense batched residual/Jacobian evaluation; the 6x6 normal system is
solved directly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from . import residuals

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObs(NamedTuple):
    """Flat observation set for one frame (fixed capacity N, masked)."""

    pw: jnp.ndarray         # [N, 3] world points
    uvr: jnp.ndarray        # [N, 3] (u, v, u_right); u_right < 0 => mono
    cam_idx: jnp.ndarray    # [N] int32 camera of each observation
    inv_sigma2: jnp.ndarray # [N] information scale (1/sigma^2 of the level)
    mask: jnp.ndarray       # [N] bool valid observation


class _CamGathers(NamedTuple):
    """Per-observation camera quantities, constant across LM iterations.

    Hoisted out of the iteration loop: the [N]-sized gathers of rig
    extrinsics/intrinsics depend only on `obs`, not on the pose, so
    computing them once removes ~40 gather chains from the critical path
    of the 4x10 schedule.
    """

    Trc: jnp.ndarray   # [N, 4, 4] rig->cam extrinsic per observation
    Ko: jnp.ndarray    # [N, 4] (fx, fy, cx, cy)
    bfo: jnp.ndarray   # [N]


def _precompute_cams(obs: PoseObs, T_rc, K, bf) -> _CamGathers:
    return _CamGathers(
        Trc=T_rc[obs.cam_idx], Ko=K[obs.cam_idx],
        bfo=jnp.broadcast_to(bf, obs.cam_idx.shape),
    )


def _residual_jacobian(Tcw, obs: PoseObs, T_rc, K, bf, cams=None,
                       want_jac=True):
    """Residuals e [N, 3], Jacobians J = de/dxi [N, 3, 6], stereo mask [N].

    e = obs - (u, v, ur) of the predicted projection;
    J = -A @ R_rc @ [I | -hat(Xr)] with A = dproj/dXc.
    Mirrors the fork's analytic `linearizeOplus` chain with `Tcim_quat`
    (types_six_dof_expmap.cpp:600-698), vectorized over observations.
    Delegates to residuals.reproj_residual: one shared implementation of
    the chain with the row-unrolled broadcast arithmetic (a batched
    3x3 einsum lowers as N tiny matmuls).
    """
    if cams is None:
        cams = _precompute_cams(obs, T_rc, K, bf)
    e, J, _, is_stereo, z_ok = residuals.reproj_residual(
        Tcw, obs.pw, cams.Trc, cams.Ko, cams.bfo, obs.uvr,
        want_jac=want_jac)
    valid = obs.mask & z_ok
    return e, J, is_stereo, valid


@partial(jax.jit, static_argnums=(5, 6))
def optimize_pose(
    Tcw0: jnp.ndarray,
    obs: PoseObs,
    T_rc: jnp.ndarray,   # [C, 4, 4]
    K: jnp.ndarray,      # [C, 4]
    bf: jnp.ndarray,     # [] scalar
    n_rounds: int = 4,
    n_iters: int = 10,
):
    """Run the reference's 4x10 motion-only BA schedule.

    Returns (Tcw [4,4], inlier_mask [N], n_inliers int32).
    """
    delta_mono = jnp.sqrt(CHI2_MONO)
    delta_stereo = jnp.sqrt(CHI2_STEREO)
    cams = _precompute_cams(obs, T_rc, K, bf)

    def lm_round(Tcw_init, inlier, use_huber):
        # One residual/Jacobian evaluation per iteration (g2o-style): the
        # trial linearization doubles as the acceptance check, and on
        # rejection the RETAINED (H, g) are re-solved with a larger lambda —
        # exactly OptimizationAlgorithmLevenberg's retry loop, at half the
        # evaluation count of a naive accept-then-relinearize scheme.
        def linearize(Tcw):
            e, J, is_st, valid = _residual_jacobian(Tcw, obs, T_rc, K, bf,
                                                    cams)
            act = inlier & valid
            row = jnp.where(is_st[:, None],
                            jnp.ones_like(e),
                            jnp.broadcast_to(jnp.array([1.0, 1.0, 0.0], e.dtype), e.shape))
            chi2 = jnp.sum(e * e * row, axis=-1) * obs.inv_sigma2
            # Huber IRLS weight on the whitened residual norm
            delta = jnp.where(is_st, delta_stereo, delta_mono)
            r = jnp.sqrt(jnp.maximum(chi2, 1e-12))
            hw = jnp.where(use_huber & (r > delta), delta / r, 1.0)
            w = obs.inv_sigma2 * hw * act.astype(e.dtype)
            Jw = J * (row * w[:, None])[..., None]       # [N, 3, 6]
            Jf = J.reshape(-1, 6)
            H = jnp.dot(Jw.reshape(-1, 6).T, Jf,
                        preferred_element_type=jnp.float32)
            g = jnp.einsum("nri,nr->i", Jw, e)
            rho = jnp.where(use_huber & (r > delta),
                            delta * (2.0 * r - delta), chi2)
            total = jnp.sum(jnp.where(act, rho, 0.0))
            return H, g, total

        def cond(carry):
            i, _, _, _, _, lam, no_prog = carry
            return (i < n_iters) & (no_prog < 2)

        def body(carry):
            i, Tcw_base, H, g, chi2_base, lam, no_prog = carry
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6, dtype=H.dtype)
            dx = -jnp.linalg.solve(Hd, g)
            Tcw_try = se3.exp(dx) @ Tcw_base
            H_t, g_t, chi2_t = linearize(Tcw_try)
            accept = chi2_t < chi2_base
            rel_dec = (chi2_base - chi2_t) / jnp.maximum(chi2_base, 1e-12)
            Tcw_out = jnp.where(accept, Tcw_try, Tcw_base)
            H_out = jnp.where(accept, H_t, H)
            g_out = jnp.where(accept, g_t, g)
            chi2_out = jnp.where(accept, chi2_t, chi2_base)
            lam_out = jnp.clip(
                jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
            # convergence exit (g2o terminate action): two consecutive
            # no-progress iterations — accepted with negligible decrease,
            # or rejected once lambda is already large — end the round;
            # in tracking steady state this cuts ~10 iterations to ~3-5
            stall = jnp.where(accept, rel_dec < 1e-3, lam_out >= 1e2)
            no_prog_out = jnp.where(stall, no_prog + 1, 0)
            return (i + 1, Tcw_out, H_out, g_out, chi2_out, lam_out,
                    no_prog_out)

        H0, g0, chi20 = linearize(Tcw_init)
        init = (jnp.asarray(0, jnp.int32), Tcw_init, H0, g0, chi20,
                jnp.asarray(1e-3, Tcw_init.dtype),
                jnp.asarray(0, jnp.int32))
        _, Tcw, _, _, _, _, _ = jax.lax.while_loop(cond, body, init)
        return Tcw

    def reclassify(Tcw, _inlier):
        e, _, is_st, valid = _residual_jacobian(Tcw, obs, T_rc, K, bf, cams,
                                                want_jac=False)
        row = jnp.where(is_st[:, None],
                        jnp.ones_like(e),
                        jnp.broadcast_to(jnp.array([1.0, 1.0, 0.0], e.dtype), e.shape))
        chi2 = jnp.sum(e * e * row, axis=-1) * obs.inv_sigma2
        th = jnp.where(is_st, CHI2_STEREO, CHI2_MONO)
        return (chi2 <= th) & valid

    inlier = obs.mask
    Tcw = Tcw0
    # `settled` = the previous round left the inlier set unchanged.  A
    # round is a deterministic function of (Tcw0, inlier, huber) — the
    # reference restarts every round from the frame's input pose with the
    # refined inlier set (Optimizer.cc:529-538) — so when the
    # classification reaches a fixed point, every remaining round with the
    # SAME Huber flag reproduces the identical pose and can be skipped
    # exactly (zero semantic change).  The flag resets at the Huber
    # drop-off (round 2), whose result genuinely differs.
    settled = jnp.asarray(False)
    for it in range(n_rounds):
        use_huber = jnp.asarray(it < 2)
        if it == 2:
            settled = jnp.asarray(False)
        Tcw = jax.lax.cond(
            settled, lambda t: t[1],
            lambda t: lm_round(t[0], inlier, use_huber), (Tcw0, Tcw))
        new_inlier = jax.lax.cond(
            settled, lambda _: inlier, lambda _: reclassify(Tcw, inlier),
            None)
        settled = settled | jnp.all(new_inlier == inlier)
        inlier = new_inlier
    n_inliers = jnp.sum(inlier.astype(jnp.int32))
    return Tcw, inlier, n_inliers
