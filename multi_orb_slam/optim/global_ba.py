"""Global bundle adjustment, matrix-free Schur + preconditioned CG.

Replaces `Optimizer::GlobalBundleAdjustemnt` / `BundleAdjustment`
(src/Optimizer.cc:47-330): all keyframes free (first fixed), all points
marginalized.  The local-BA solver materializes a dense [P, L, 6, 3] W_cp,
which at global scope (P ~ 2.5e4, L ~ 200) would be hundreds of MB; instead
the reduced camera system

    S dx = (H_cc - W H_pp^-1 W^T) dx

is applied matrix-free: each matvec is two segment-sum passes over the
observation incidence (gather pose blocks -> per-observation U_i^T x ->
scatter to points -> H_pp^-1 -> scatter back to poses), solved with
block-Jacobi preconditioned conjugate gradient.  This formulation is also
the distributed one: sharding observations/points over devices turns the
segment-sums into per-shard sums + `psum` (see parallel/dist_ba.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import SlamConfig, inv_sigma2_of_level
from ..geometry import se3
from . import residuals
from .pose_opt import CHI2_MONO, CHI2_STEREO


def _damp_blocks(H, lam):
    d = jnp.diagonal(H, axis1=-2, axis2=-1)
    tr = jnp.sum(d, axis=-1, keepdims=True)
    dd = lam * d + 1e-6 * tr + 1e-9
    return H + dd[..., :, None] * jnp.eye(H.shape[-1], dtype=H.dtype)


def make_global_ba(cfg: SlamConfig):
    """Build the jitted global BA function for a static config."""

    def step(kf_Tcw, kf_valid, kf_free, kf_mp, obs_uvr, obs_is2,
             mp_pos, mp_valid, T_rc, K_intr, bf,
             n_outer, cg_iters, obs_gate=None):
        K, C, F = kf_mp.shape
        M = mp_pos.shape[0]
        N = K * C * F
        dtype = mp_pos.dtype

        obs_kf = jnp.broadcast_to(
            jnp.arange(K, dtype=jnp.int32)[:, None, None], (K, C, F)).reshape(N)
        obs_mp = kf_mp.reshape(N)
        uvr = obs_uvr.reshape(N, 3)
        is2 = obs_is2.reshape(N)
        mp_idx = jnp.clip(obs_mp, 0, M - 1)
        obs_ok = (obs_mp >= 0) & kf_valid[obs_kf] & mp_valid[mp_idx]
        if obs_gate is not None:
            obs_ok = obs_ok & obs_gate.reshape(N)

        delta_m = jnp.sqrt(CHI2_MONO)
        delta_s = jnp.sqrt(CHI2_STEREO)

        def residual_state(Tcw_all, pos_all):
            # structured-broadcast residual pass: pose/extrinsic enter as
            # [K,1,1]/[1,C,1] broadcasts over the [K, C, F] layout instead
            # of [N]-wide gathers (N = K*C*F is ~786k at full capacity —
            # the Tcw gather alone materialized 50 MB per pass)
            out = residuals.reproj_residual(
                Tcw_all[:, None, None], pos_all[mp_idx].reshape(K, C, F, 3),
                T_rc[None, :, None], K_intr[None, :, None], bf,
                uvr.reshape(K, C, F, 3))
            e, Jc, Jp, is_st, posd = out
            return (e.reshape(N, 3), Jc.reshape(N, 3, 6),
                    Jp.reshape(N, 3, 3), is_st.reshape(N), posd.reshape(N))

        def outer(carry, _):
            Tcw_all, pos_all, lam = carry
            e, Jc, Jp, is_st, posd = residual_state(Tcw_all, pos_all)
            act = obs_ok & posd
            row = residuals.row_weights(is_st, dtype)
            chi2 = jnp.sum(e * e * row, -1) * is2
            delta = jnp.where(is_st, delta_s, delta_m)
            r = jnp.sqrt(jnp.maximum(chi2, 1e-12))
            hw = jnp.where(r > delta, delta / r, 1.0)
            w = is2 * hw * act.astype(dtype)
            Wr = row * w[:, None]

            free_o = kf_free[obs_kf]
            Jc_eff = Jc * free_o[:, None, None].astype(dtype)
            JTcW = Jc_eff * Wr[:, :, None]
            JTpW = Jp * Wr[:, :, None]

            # block products via residuals.outer_rows/jte_rows (unrolled
            # broadcast arithmetic; the einsum forms lower as N batched
            # tiny matmuls — see residuals.bmv)
            Hcc = jnp.zeros((K, 6, 6), dtype).at[obs_kf].add(
                residuals.outer_rows(JTcW, Jc_eff))
            bc = jnp.zeros((K, 6), dtype).at[obs_kf].add(
                residuals.jte_rows(JTcW, e))
            Hpp = jnp.zeros((M, 3, 3), dtype).at[mp_idx].add(
                residuals.outer_rows(JTpW, Jp))
            bp = jnp.zeros((M, 3), dtype).at[mp_idx].add(
                residuals.jte_rows(JTpW, e))
            # per-observation camera-point coupling block U_n [6, 3]
            U = residuals.outer_rows(JTcW, Jp)

            Hcc_d = _damp_blocks(Hcc, lam)
            Hpp_d = _damp_blocks(Hpp, lam) + jnp.where(
                mp_valid, 0.0, 1.0)[:, None, None] * jnp.eye(3, dtype=dtype)
            Hpp_inv = jnp.linalg.inv(Hpp_d)

            def S_matvec(x):  # x [K, 6]
                # y_p = sum_obs U^T x_kf  -> [M, 3]
                Ux = residuals.bmtv(U, x[obs_kf])
                y = jnp.zeros((M, 3), dtype).at[mp_idx].add(Ux)
                z = residuals.bmv(Hpp_inv, y)
                # back: sum_obs U z_p -> [K, 6]
                Uz = residuals.bmv(U, z[mp_idx])
                WHWx = jnp.zeros((K, 6), dtype).at[obs_kf].add(Uz)
                Hx = residuals.bmv(Hcc_d, x)
                out = Hx - WHWx
                return out * kf_free[:, None]

            # rhs = bc - W Hpp_inv bp
            zb = residuals.bmv(Hpp_inv, bp)
            Uzb = residuals.bmv(U, zb[mp_idx])
            rhs = bc - jnp.zeros((K, 6), dtype).at[obs_kf].add(Uzb)
            rhs = rhs * kf_free[:, None]

            # block-Jacobi preconditioner from damped Hcc
            Pinv = jnp.linalg.inv(
                Hcc_d + jnp.where(kf_free, 0.0, 1.0)[:, None, None]
                * jnp.eye(6, dtype=dtype))

            def precond(v):
                return residuals.bmv(Pinv, v) * kf_free[:, None]

            # PCG for S dx = -rhs
            b_cg = -rhs

            def cg_body(_, cgc):
                x, rr, p, rz = cgc
                Sp = S_matvec(p)
                pSp = jnp.sum(p * Sp)
                alpha = rz / jnp.where(jnp.abs(pSp) < 1e-20, 1e-20, pSp)
                x = x + alpha * p
                rr = rr - alpha * Sp
                z = precond(rr)
                rz_new = jnp.sum(rr * z)
                beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
                p = z + beta * p
                return (x, rr, p, rz_new)

            x0 = jnp.zeros((K, 6), dtype)
            r0 = b_cg
            z0 = precond(r0)
            dxc, _, _, _ = jax.lax.fori_loop(
                0, cg_iters, cg_body, (x0, r0, z0, jnp.sum(r0 * z0)))
            dxc = dxc * kf_free[:, None]

            # back-substitute points: dp = -Hpp_inv (bp + W^T dxc)
            Ux = residuals.bmtv(U, dxc[obs_kf])
            WTdx = jnp.zeros((M, 3), dtype).at[mp_idx].add(Ux)
            dp = -residuals.bmv(Hpp_inv, bp + WTdx)
            dp = dp * mp_valid[:, None]

            Tcw_new = jax.vmap(lambda d, T: se3.exp(d) @ T)(dxc, Tcw_all)
            pos_new = pos_all + dp
            e2, _, _, is_st2, posd2 = residual_state(Tcw_new, pos_new)
            chi2n = jnp.sum(e2 * e2 * row, -1) * is2

            def rho(c2):
                rr_ = jnp.sqrt(jnp.maximum(c2, 1e-12))
                return jnp.where(rr_ > delta, delta * (2 * rr_ - delta), c2)

            tot_new = jnp.sum(jnp.where(obs_ok & posd2, rho(chi2n), 0.0))
            tot_old = jnp.sum(jnp.where(act, rho(chi2), 0.0))
            accept = tot_new < tot_old
            Tcw_out = jnp.where(accept, Tcw_new, Tcw_all)
            pos_out = jnp.where(accept, pos_new, pos_all)
            lam_out = jnp.clip(
                jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
            return (Tcw_out, pos_out, lam_out), tot_old

        def run(kf_Tcw, mp_pos, n_outer):
            (Tcw, pos, _), _ = jax.lax.scan(
                outer, (kf_Tcw, mp_pos, jnp.asarray(1e-4, dtype)),
                None, length=n_outer)
            return Tcw, pos

        return run(kf_Tcw, mp_pos, n_outer)

    return step


@partial(jax.jit, static_argnums=(3, 4))
def run_global_ba_jit(state_arrays, calib_arrays, free_spec, cfg: SlamConfig,
                      n_outer: int = 10):
    (kf_Tcw, kf_valid, kf_mp, obs_uvr, obs_is2, mp_pos, mp_valid) = state_arrays
    (T_rc, K_intr, bf) = calib_arrays
    kf_free = free_spec
    fn = make_global_ba(cfg)
    # Annealed outlier gating: before each stage, re-gate at the CURRENT
    # state with a loosening->strict chi2 scale.  Gross outliers (the
    # reference erases them incrementally during mapping) are dropped
    # immediately; genuinely good observations inflated by the initial
    # perturbation re-enter as the state converges.
    Tcw, pos = kf_Tcw, mp_pos
    stages = [(64.0, 0.98, max(n_outer // 3, 1)),
              (8.0, 0.97, max(n_outer // 3, 1)),
              (1.0, None, max(n_outer - 2 * (n_outer // 3), 1))]
    for scale, keep_frac, iters in stages:
        gate = _chi2_gate(Tcw, kf_mp, obs_uvr, obs_is2, pos,
                          T_rc, K_intr, bf, scale=scale, keep_frac=keep_frac)
        Tcw, pos = fn(Tcw, kf_valid, kf_free, jnp.where(gate, kf_mp, -1),
                      obs_uvr, obs_is2, pos, mp_valid, T_rc, K_intr, bf,
                      iters, 60)
    return Tcw, pos


def _chi2_gate(kf_Tcw, kf_mp, obs_uvr, obs_is2, mp_pos, T_rc, K_intr, bf,
               scale=1.0, keep_frac=None):
    K, C, F = kf_mp.shape
    M = mp_pos.shape[0]
    N = K * C * F
    mp_idx = jnp.clip(kf_mp.reshape(N), 0, M - 1)
    e, _, _, is_st, posd = residuals.reproj_residual(
        kf_Tcw[:, None, None], mp_pos[mp_idx].reshape(K, C, F, 3),
        T_rc[None, :, None], K_intr[None, :, None], bf,
        obs_uvr.reshape(K, C, F, 3), want_jac=False)
    e = e.reshape(N, 3)
    is_st = is_st.reshape(N)
    posd = posd.reshape(N)
    row = residuals.row_weights(is_st, e.dtype)
    chi2 = jnp.sum(e * e * row, -1) * obs_is2.reshape(N)
    th = jnp.where(is_st, CHI2_STEREO, CHI2_MONO) * scale
    if keep_frac is not None:
        # never drop more than (1 - keep_frac) of the valid observations:
        # early stages must not mistake a large initial perturbation for
        # outliers (threshold floors at the keep_frac quantile)
        valid = kf_mp.reshape(N) >= 0
        c = jnp.where(valid, chi2, -1.0)
        q = jnp.quantile(jnp.sort(c), 1.0 - (1.0 - keep_frac) *
                         jnp.mean(valid.astype(chi2.dtype)))
        th = jnp.maximum(th, q)
    return ((chi2 <= th) & posd).reshape(K, C, F)


def dispatch_global_ba(state, calib, cfg: SlamConfig, n_outer: int = 10):
    """Enqueue full-map BA on the device; return (kf_Tcw, mp_pos) futures.

    The async-GBA primitive (reference spawns a GBA thread,
    src/LoopClosing.cc:812): the caller keeps working against the old map
    and folds these results in later (LoopCloser.merge_pending_gba)."""
    kf_free = state.kf_valid & (jnp.arange(state.kf_valid.shape[0]) != 0)
    obs_uvr = jnp.concatenate(
        [state.kf_xy_und, state.kf_uright[..., None]], axis=-1)
    obs_is2 = inv_sigma2_of_level(state.kf_level, cfg)
    # mask invalid feature slots out of the problem
    kf_mp = jnp.where(state.kf_feat_valid, state.kf_mp, -1)
    return run_global_ba_jit(
        (state.kf_Tcw, state.kf_valid, kf_mp, obs_uvr, obs_is2,
         state.mp_pos, state.mp_valid),
        (calib.T_rc, calib.K, calib.bf),
        kf_free, cfg, n_outer)


def run_global_ba(state, calib, cfg: SlamConfig, n_outer: int = 10):
    """Full-map BA (reference GBA: 10 iterations, first KF fixed,
    src/LoopClosing.cc:898).  Returns updated MapState."""
    Tcw, pos = dispatch_global_ba(state, calib, cfg, n_outer)
    return state._replace(kf_Tcw=Tcw, mp_pos=pos)
