"""Local bundle adjustment with an explicit Schur complement.

Replaces `Optimizer::LocalBundleAdjustment` (src/Optimizer.cc:921-1353):
covisible keyframes free, observer keyframes fixed, points marginalized.
Where g2o builds a sparse block solver and marginalizes point blocks inside
Cholesky (`BlockSolver_6_3` + `setMarginalized(true)`), this design makes
the Schur complement explicit and dense-batched:

  H_cc (per-KF 6x6 blocks)      <- segment-sum of J_c^T W J_c over obs
  H_pp (per-point 3x3 blocks)   <- segment-sum of J_p^T W J_p
  W_cp [P, L, 6, 3]             <- scatter-add of J_c^T W J_p
  S = H_cc - sum_p W_cp Hpp^-1 W_cp^T    (one big matmul)
  solve dense S dx_c = rhs; back-substitute points.

Schedule mirrors the reference: optimize(5) with Huber -> chi2 gate
(5.991 / 7.815, negative depth) -> optimize(10) without Huber -> report
outlier observations for erasure (Optimizer.cc:1212-1325).

The same solver at full scope (all KFs free except the first) implements
`GlobalBundleAdjustemnt` (src/Optimizer.cc:47-330); see `global_ba.py`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3
from . import residuals
from .pose_opt import CHI2_MONO, CHI2_STEREO


class BAProblem(NamedTuple):
    """A windowed BA problem with static capacities L (KFs) and P (points).

    Observations stay in the [L, C, F] keyframe-feature layout.
    """

    kf_slot: jnp.ndarray     # [L] map KF slot ids (-1 pad)
    kf_Tcw: jnp.ndarray      # [L, 4, 4]
    kf_free: jnp.ndarray     # [L] bool: pose is optimized
    kf_valid: jnp.ndarray    # [L] bool
    mp_slot: jnp.ndarray     # [P] map MP slot ids (-1 pad)
    mp_pos: jnp.ndarray      # [P, 3]
    mp_valid: jnp.ndarray    # [P] bool
    obs_mp: jnp.ndarray      # [L, C, F] local point index or -1
    obs_uvr: jnp.ndarray     # [L, C, F, 3]
    obs_inv_sigma2: jnp.ndarray  # [L, C, F]


def solve_ba(
    prob: BAProblem,
    T_rc: jnp.ndarray,    # [C, 4, 4]
    K: jnp.ndarray,       # [C, 4]
    bf: jnp.ndarray,
    phases: tuple = ((5, True), (10, False)),
    chi2_gate_between: bool = True,
    early_exit_rtol: float = 1e-3,
):
    """Run the phased LM schedule. Returns (kf_Tcw, mp_pos, obs_inlier).

    obs_inlier [L, C, F]: observations that survived the chi2 gates — the
    caller erases the rest from the map (reference Optimizer.cc:1290-1325).

    The whole schedule is ONE lax.while_loop: the Huber flag and the
    between-phase chi2 re-gate (Optimizer.cc:1212-1259) switch ON-DEVICE at
    the phase boundary instead of unrolling one compiled loop per phase
    (saves a redundant initial linearization per extra phase), and the loop
    exits early once the final phase stops making progress — two
    consecutive iterations with relative cost decrease < `early_exit_rtol`
    (g2o's terminate action on chi2 stagnation).  In tracking steady state
    the window is near-converged and most of the 5+8 budget is skipped.
    """
    L, C, F = prob.obs_mp.shape
    P = prob.mp_pos.shape[0]
    dtype = prob.mp_pos.dtype

    delta_m = jnp.sqrt(CHI2_MONO)
    delta_s = jnp.sqrt(CHI2_STEREO)

    # ---- One-time re-layout: feature-indexed [L, C, F] observations ->
    # point-indexed [L, C, P] rows, making the LM inner loop GATHER-FREE.
    # In the point-indexed layout the pose enters as an [L,1,1] broadcast,
    # the rig extrinsic/intrinsics as [1,C,1], and the point position as a
    # [1,1,P] broadcast — so a residual pass touches NO gather/scatter at
    # all, and the point-block sums (H_pp, b_p) become plain axis
    # reductions while W_cp falls out directly in its [P, L, 6, 3] Schur
    # layout, with no [N]-wide gather in the residual pass.  Requires at
    # most one observation of a point per (KF,
    # camera) row — guaranteed by build_local_problem's dedupe pass,
    # matching the reference's one-idx-per-KF observation map
    # (src/MapPoint.cc:138-150).
    obs_mp_f = prob.obs_mp                       # [L, C, F]
    obs_ok_f = (
        (obs_mp_f >= 0)
        & prob.kf_valid[:, None, None]
        & prob.mp_valid[jnp.clip(obs_mp_f, 0, P - 1)]
    )
    pidx = jnp.where(obs_ok_f, obs_mp_f, P)      # [L, C, F]
    l_ix = jnp.arange(L)[:, None, None]
    c_ix = jnp.arange(C)[None, :, None]
    inv = jnp.full((L, C, P + 1), -1, jnp.int32).at[
        l_ix, c_ix, pidx].set(
        jnp.broadcast_to(jnp.arange(F, dtype=jnp.int32), (L, C, F))
    )[:, :, :P]
    obs_valid = inv >= 0                         # [L, C, P]
    ginv = jnp.clip(inv, 0, F - 1)[..., None]
    uvr_g = jnp.take_along_axis(prob.obs_uvr, ginv, axis=2)   # [L, C, P, 3]
    # missing slots read as mono zeros; every use is masked through
    # `obs_valid` so the value only needs to be finite
    uvr_g = jnp.where(obs_valid[..., None], uvr_g,
                      jnp.asarray([0.0, 0.0, -1.0], dtype))
    obs_is2 = jnp.where(
        obs_valid,
        jnp.take_along_axis(prob.obs_inv_sigma2, ginv[..., 0], axis=2), 0.0)

    def inv3(H):
        """Batched closed-form 3x3 inverse (adjugate/det) — avoids the
        sequential LU path of linalg.inv on [P, 3, 3] blocks."""
        a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
        d, e_, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
        g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
        A = e_ * i - f * h
        B = c * h - b * i
        Cc = b * f - c * e_
        D = f * g - d * i
        E = a * i - c * g
        Ff = c * d - a * f
        G = d * h - e_ * g
        Hh = b * g - a * h
        I = a * e_ - b * d
        det = a * A + b * D + c * G
        det = jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
        adj = jnp.stack([
            jnp.stack([A, B, Cc], -1),
            jnp.stack([D, E, Ff], -1),
            jnp.stack([G, Hh, I], -1),
        ], -2)
        return adj / det[..., None, None]

    def residual_state(kf_Tcw, mp_pos, want_jac=True):
        """Gather-free residual pass over the [L, C, P] layout: every input
        enters as a broadcast (pose [L,1,1], extrinsics/intrinsics [1,C,1],
        point positions [1,1,P], measurements resident in-layout)."""
        return residuals.reproj_residual(
            kf_Tcw[:, None, None], mp_pos[None, None, :],
            T_rc[None, :, None], K[None, :, None], bf, uvr_g,
            want_jac=want_jac)

    def chi2_of(e, is_st):
        row = residuals.row_weights(is_st, dtype)
        return jnp.sum(e * e * row, axis=-1) * obs_is2

    def cost_eval(kf_Tcw, mp_pos, active, use_huber):
        """Residual-only robust cost + (chi2, posd) — the trial-acceptance
        check.  No Jacobians, no normal-equation blocks (the blocks are
        what cost memory traffic), which is what lets the LM loop carry
        only small state."""
        e, _, _, is_st, posd = residual_state(kf_Tcw, mp_pos,
                                              want_jac=False)
        act = active & obs_valid & posd
        chi2 = chi2_of(e, is_st)
        delta = jnp.where(is_st, delta_s, delta_m)
        r = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        rho_c = jnp.where(
            use_huber & (r > delta), delta * (2.0 * r - delta), chi2)
        total = jnp.sum(jnp.where(act, rho_c, 0.0))
        return total, chi2, posd

    def linearize(kf_Tcw, mp_pos, active, use_huber):
            """ONE residual pass -> undamped normal-equation blocks + cost.

            g2o's Levenberg loop evaluates once per iteration: the trial
            linearization doubles as the acceptance check, and a rejected
            step re-solves the RETAINED blocks with a larger lambda
            (OptimizationAlgorithmLevenberg) — half the evaluation count
            of accept-then-relinearize."""
            e, Jc, Jp, is_st, posd = residual_state(kf_Tcw, mp_pos)
            act = active & obs_valid & posd
            row = residuals.row_weights(is_st, dtype)   # [L, C, P, 3]
            chi2 = chi2_of(e, is_st)
            delta = jnp.where(is_st, delta_s, delta_m)
            r = jnp.sqrt(jnp.maximum(chi2, 1e-12))
            hw = jnp.where(use_huber & (r > delta), delta / r, 1.0)
            w = obs_is2 * hw * act.astype(dtype)        # [L, C, P]
            Wr = row * w[..., None]                     # [L, C, P, 3]

            Jc_eff = Jc * prob.kf_free[
                :, None, None, None, None].astype(dtype)

            # H_cc blocks [L, 6, 6] and rhs: the KF index is the structured
            # leading axis — a plain contraction over the per-KF block, NO
            # scatter.  The contraction runs over the flattened (row, col)
            # axis of 18 — [L, CP, 18] x same — and the true H comes from
            # summing the three row-diagonal 6x6 blocks of the [18, 18]
            # result, one batched matmul instead of a direct
            # "lnri,lnrj->lij" einsum over tiny blocks.
            JTc = Jc_eff * Wr[..., None]                # weighted rows
            CP = C * P
            A18 = JTc.reshape(L, CP, 18)
            B18 = Jc_eff.reshape(L, CP, 18)
            H18 = jax.lax.dot_general(
                A18, B18, (((1,), (1,)), ((0,), (0,))))   # [L, 18, 18]
            H18 = H18.reshape(L, 3, 6, 3, 6)
            Hcc = H18[:, 0, :, 0, :] + H18[:, 1, :, 1, :] + H18[:, 2, :, 2, :]
            bc = jnp.einsum(
                "lnri,lnr->li", JTc.reshape(L, CP, 3, 6), e.reshape(L, CP, 3))

            # point blocks: in the point-indexed layout these are plain
            # reductions over (L, C, row) — no gather, no scatter, and
            # W_cp lands directly in its [P, L, 6, 3] Schur layout.  The
            # residual-row contraction (r, extent 3) is UNROLLED into
            # broadcast products: an einsum here lowers as thousands of
            # 3x3 matmuls batched over (L, C, P); see
            # residuals.reproj_residual.
            JTp = Jp * Wr[..., None]                    # [L, C, P, 3, 3]
            Hpp = jnp.sum(residuals.outer_rows(JTp, Jp), axis=(0, 1))
            bp = jnp.sum(residuals.jte_rows(JTp, e), axis=(0, 1))  # [P, 3]
            Wcp = jnp.sum(residuals.outer_rows(JTc, Jp), axis=1)
            Wcp = Wcp.transpose(1, 0, 2, 3)                    # [P, L, 6, 3]

            return (Hcc, bc, Hpp, bp, Wcp)

    eye3 = jnp.eye(3, dtype=dtype)
    eye6 = jnp.eye(6, dtype=dtype)

    def solve_step(lin, lam):
        Hcc, bc, Hpp, bp, Wcp = lin[:5]

        # Multiplicative LM damping: scales with each block, keeping
        # the f32 condition number bounded (absolute damping NaNs the
        # batched inverse on thin-triangulation point blocks).
        def damp(H, eye):
            d = jnp.diagonal(H, axis1=-2, axis2=-1)
            tr = jnp.sum(d, axis=-1, keepdims=True)
            dd = lam * d + 1e-6 * tr + 1e-9
            return H + dd[..., :, None] * eye

        Hcc_d = damp(Hcc, eye6)
        # invalid points get an identity block so the inverse is defined
        Hpp_d = damp(Hpp, eye3) + jnp.where(
            prob.mp_valid, 0.0, 1.0
        )[:, None, None] * eye3
        Hpp_inv = inv3(Hpp_d)

        # Schur: S = blockdiag(Hcc) - sum_p W_p Hpp_p^-1 W_p^T.  Factor
        # Hpp^-1 = R R^T with a closed-form 3x3 Cholesky so the point
        # sum becomes ONE [L6, P3] x [P3, L6] matmul of Y' = W R
        # with itself.
        l11 = jnp.sqrt(jnp.maximum(Hpp_inv[:, 0, 0], 1e-20))
        l21 = Hpp_inv[:, 1, 0] / l11
        l31 = Hpp_inv[:, 2, 0] / l11
        l22 = jnp.sqrt(jnp.maximum(Hpp_inv[:, 1, 1] - l21 * l21, 1e-20))
        l32 = (Hpp_inv[:, 2, 1] - l31 * l21) / l22
        l33 = jnp.sqrt(jnp.maximum(
            Hpp_inv[:, 2, 2] - l31 * l31 - l32 * l32, 1e-20))
        c0 = (Wcp[..., 0] * l11[:, None, None]
              + Wcp[..., 1] * l21[:, None, None]
              + Wcp[..., 2] * l31[:, None, None])
        c1 = (Wcp[..., 1] * l22[:, None, None]
              + Wcp[..., 2] * l32[:, None, None])
        c2 = Wcp[..., 2] * l33[:, None, None]
        Yc = jnp.stack([c0, c1, c2], axis=-1)               # [P, L, 6, 3]
        Yr = Yc.transpose(0, 3, 1, 2).reshape(P * 3, L * 6)
        S = -Yr.T @ Yr                                      # [L6, L6]
        Wr_flat = Wcp.transpose(0, 3, 1, 2).reshape(P * 3, L * 6)
        bp3 = bp.reshape(P, 3)
        # batched 3x3 matvec as broadcast-multiply + reduce (an einsum
        # lowers as P tiny matmuls)
        hb = jnp.sum(Hpp_inv * bp3[:, None, :], axis=-1)
        li = jnp.arange(L)
        S = S.reshape(L, 6, L, 6)
        S = S.at[li, :, li, :].add(Hcc_d)
        S = S.reshape(L * 6, L * 6)
        # gauge: freeze non-free KFs by forcing identity rows
        free6 = jnp.repeat(prob.kf_free, 6)
        S = jnp.where(free6[:, None] & free6[None, :], S, 0.0)
        S = S + jnp.diag(jnp.where(free6, 0.0, 1.0))
        rhs = bc.reshape(L * 6) - Wr_flat.T @ hb.reshape(P * 3)
        rhs = jnp.where(free6, rhs, 0.0)

        dxc = -jnp.linalg.solve(S, rhs)
        dxc = jnp.where(free6, dxc, 0.0).reshape(L, 6)
        WTdx = (Wr_flat @ dxc.reshape(L * 6)).reshape(P, 3)
        dp = -jnp.sum(Hpp_inv * (bp3 + WTdx)[:, None, :], axis=-1)
        dp = dp * prob.mp_valid[:, None]
        return dxc, dp

    # stereo flag / chi2 threshold per observation is state-independent;
    # the between-phase and final chi2 gates (Optimizer.cc:1212-1259)
    # evaluate against the chi2/posd carried from the last accepted
    # cost_eval pass
    th_const = jnp.where(uvr_g[..., 2] >= 0, CHI2_STEREO, CHI2_MONO)

    # schedule as data: per-iteration Huber flag + gate-before-iteration
    # flag, consumed by ONE device loop
    iters_list = [int(p[0]) for p in phases]
    n_total = int(sum(iters_list))
    starts = np.cumsum([0] + iters_list[:-1])
    huber_np = np.zeros(max(n_total, 1), bool)
    gate_np = np.zeros(max(n_total, 1), bool)
    next_b_np = np.zeros(max(n_total, 1), np.int32)
    for ph, (it0, nit) in enumerate(zip(starts, iters_list)):
        huber_np[it0:it0 + nit] = bool(phases[ph][1])
        next_b_np[it0:it0 + nit] = it0 + nit
        if ph > 0 and chi2_gate_between:
            gate_np[it0] = True
    last_start = int(starts[-1]) if len(starts) else 0
    huber_arr = jnp.asarray(huber_np)
    gate_arr = jnp.asarray(gate_np)
    next_b_arr = jnp.asarray(next_b_np)

    def cond_fn(carry):
        it, _, _, _, _, conv, _, _, _ = carry
        # stagnation in the FINAL phase ends the schedule (the jump out of
        # earlier phases happens in the body)
        return (it < n_total) & ((conv < 2) | (it < last_start))

    # The loop carry holds ONLY small state: pose/point estimates, the
    # active mask, and the (cost, chi2, posd) of the CURRENT point.  The
    # normal-equation blocks (Hcc/Hpp/Wcp, ~8 MB at L=48) are NOT carried:
    # each iteration linearizes fresh at the current estimate.  g2o's
    # rejected-step retry re-solves RETAINED blocks with a larger lambda;
    # linearizing again at the (unchanged) reverted estimate produces the
    # IDENTICAL blocks, so semantics are preserved while the per-iteration
    # where-merge of the whole block tuple disappears.  The trial
    # acceptance check is a residual-only cost pass (no Jacobians/blocks).
    def body_fn(carry):
        it, kf_cur, mp_cur, active, lam, conv, cost, chi2c, posdc = carry
        use_huber = huber_arr[it]

        regate_now = gate_arr[it]
        # phase boundary: re-gate actives at the current state (from the
        # carried chi2 — no extra residual pass); LM restarts its damping
        # like a fresh optimize() call, and the stagnation counter resets
        # (a stale no-progress count from the Huber phase would end the
        # re-gated final phase after a single iteration)
        gate_a = obs_valid & (chi2c <= th_const) & posdc
        active = jnp.where(regate_now, gate_a, active)
        lam = jnp.where(regate_now, jnp.asarray(1e-4, dtype), lam)
        conv = jnp.where(regate_now, 0, conv)
        # the Huber flag flips at the boundary, so the carried cost is
        # re-evaluated under the new (mask, kernel) for a fair acceptance
        # comparison.  Guarded by lax.cond: the boundary fires on 1-2 of
        # ~13 iterations and the residual pass is the loop's unit of cost —
        # evaluating it unconditionally wasted one pass per iteration.
        cost = jax.lax.cond(
            regate_now,
            lambda: cost_eval(kf_cur, mp_cur, active, use_huber)[0],
            lambda: cost)

        lin = linearize(kf_cur, mp_cur, active, use_huber)
        dxc, dp = solve_step(lin, lam)
        kf_new = jax.vmap(lambda d, T: se3.exp(d) @ T)(dxc, kf_cur)
        mp_new = mp_cur + dp
        cost_t, chi2_t, posd_t = cost_eval(kf_new, mp_new, active, use_huber)
        accept = cost_t < cost
        rel_dec = (cost - cost_t) / jnp.maximum(cost, 1e-12)
        kf_out = jnp.where(accept, kf_new, kf_cur)
        mp_out = jnp.where(accept, mp_new, mp_cur)
        cost_out = jnp.where(accept, cost_t, cost)
        chi2_out = jnp.where(accept, chi2_t, chi2c)
        posd_out = jnp.where(accept, posd_t, posdc)
        lam_out = jnp.clip(
            jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
        # early-exit bookkeeping: two consecutive no-progress iterations
        # end the phase — in the final phase that ends the schedule
        # (cond_fn); in an earlier phase the loop JUMPS to the next phase
        # boundary, where gate_arr triggers the re-gate.
        # A REJECTED step is only no-progress once lambda has grown large
        # (a rejection right after the phase-boundary lambda reset is
        # normal LM adaptation, not stagnation — counting those exited
        # after 2 iterations and cost 0.14 m on the reloc recovery test)
        no_prog = jnp.where(accept, rel_dec < early_exit_rtol,
                            lam_out >= 1e2)
        conv_t = jnp.where(no_prog, conv + 1, 0)
        jump = (conv_t >= 2) & (it < last_start)
        it_out = jnp.where(jump, next_b_arr[it], it + 1)
        conv_out = jnp.where(jump, 0, conv_t)
        return (it_out, kf_out, mp_out, active, lam_out, conv_out,
                cost_out, chi2_out, posd_out)

    kf_Tcw = prob.kf_Tcw
    mp_pos = prob.mp_pos
    active0 = obs_valid
    cost0, chi20, posd0 = cost_eval(kf_Tcw, mp_pos, active0, huber_arr[0])
    init = (jnp.asarray(0, jnp.int32), kf_Tcw, mp_pos, active0,
            jnp.asarray(1e-4, dtype), jnp.asarray(0, jnp.int32),
            cost0, chi20, posd0)
    (_, kf_Tcw, mp_pos, _, _, _, _, chi2_fin, posd_fin) = jax.lax.while_loop(
        cond_fn, body_fn, init)

    # final inlier gate from the carried chi2 of the last ACCEPTED state
    # (rejected trials are never merged into the carry), mapped back from
    # the point-indexed [L, C, P] layout to the caller's feature-indexed
    # [L, C, F] via the observation ids (one gather, outside the loop)
    active = obs_valid & (chi2_fin <= th_const) & posd_fin
    act_f = jnp.take_along_axis(
        active, jnp.clip(obs_mp_f, 0, P - 1), axis=2) & obs_ok_f
    return kf_Tcw, mp_pos, act_f
