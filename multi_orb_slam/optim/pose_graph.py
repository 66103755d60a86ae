"""Essential-graph Sim3 pose optimization.

Replaces `Optimizer::OptimizeEssentialGraph` (src/Optimizer.cc:1373-1702):
a Sim3 pose graph over all keyframes with spanning-tree edges, loop edges,
and strong-covisibility edges (weight >= 100 on the cam0 graph,
Optimizer.cc:1472,1581); scale fixed for RGB-D rigs.

Design: per-edge residuals e = log(S_meas * S_i * S_j^-1) batched over a
fixed-capacity edge list; per-edge 7x7 Jacobian blocks from vmapped forward
autodiff through the Sim3 exp/log (no hand-derived Jacobians); dense damped
normal-equation solve over [7K, 7K] (K <= a few hundred keyframes) — small
enough for one dense solve in place of sparse bookkeeping.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import sim3


def edge_residual(g_all, xi_all, i, j, meas):
    """e = log(meas * S_i * S_j^-1) with S = exp(xi) o g."""
    Si = sim3.compose(sim3.exp(xi_all[i]), g_all[i])
    Sj = sim3.compose(sim3.exp(xi_all[j]), g_all[j])
    return sim3.log(sim3.compose(meas, sim3.compose(Si, sim3.inverse(Sj))))


@partial(jax.jit, static_argnums=(6, 7))
def optimize_essential_graph(
    g_init: jnp.ndarray,     # [K, 8] Sim3 world->kf per slot
    kf_free: jnp.ndarray,    # [K] bool (False = fixed, e.g. the loop KF)
    e_i: jnp.ndarray,        # [E] int32 edge endpoints
    e_j: jnp.ndarray,        # [E]
    e_meas: jnp.ndarray,     # [E, 8] Sim3 measurements S_ji
    e_ok: jnp.ndarray,       # [E] bool
    n_iters: int = 20,
    fix_scale: bool = True,
):
    """Returns optimized [K, 8] Sim3 poses."""
    K = g_init.shape[0]
    E = e_i.shape[0]
    dtype = g_init.dtype
    dof = jnp.asarray(
        [1, 1, 1, 1, 1, 1, 0.0 if fix_scale else 1.0], dtype)

    def residuals_and_jacs(g_all):
        zeros = jnp.zeros((2, 7), dtype)

        def one(idx):
            ii, jj, m = e_i[idx], e_j[idx], e_meas[idx]

            def r_of(x2):
                Si = sim3.compose(sim3.exp(x2[0] * dof), g_all[ii])
                Sj = sim3.compose(sim3.exp(x2[1] * dof), g_all[jj])
                return sim3.log(
                    sim3.compose(m, sim3.compose(Si, sim3.inverse(Sj))))

            e0 = r_of(zeros)
            J = jax.jacfwd(r_of)(zeros)  # [7, 2, 7]
            return e0, J[:, 0, :], J[:, 1, :]

        return jax.vmap(one)(jnp.arange(E))

    def body(it, carry):
        g_all, lam, _ = carry
        e0, Ji, Jj = residuals_and_jacs(g_all)
        w = e_ok.astype(dtype)
        # assemble normal equations over free dofs
        H = jnp.zeros((K, 7, K, 7), dtype)
        b = jnp.zeros((K, 7), dtype)
        JiT = Ji * w[:, None, None]
        H = H.at[e_i, :, e_i, :].add(jnp.einsum("eri,erj->eij", JiT, Ji))
        H = H.at[e_j, :, e_j, :].add(
            jnp.einsum("eri,erj->eij", Jj * w[:, None, None], Jj))
        H = H.at[e_i, :, e_j, :].add(jnp.einsum("eri,erj->eij", JiT, Jj))
        H = H.at[e_j, :, e_i, :].add(
            jnp.einsum("eri,erj->eij", Jj * w[:, None, None], Ji))
        b = b.at[e_i].add(jnp.einsum("eri,er->ei", JiT, e0))
        b = b.at[e_j].add(jnp.einsum("eri,er->ei", Jj * w[:, None, None], e0))

        free7 = (kf_free[:, None] * jnp.ones((1, 7), dtype)
                 * dof[None, :]).reshape(K * 7) > 0
        Hf = H.reshape(K * 7, K * 7)
        d = jnp.diag(Hf)
        Hf = Hf + jnp.diag(lam * d + 1e-6)
        Hf = jnp.where(free7[:, None] & free7[None, :], Hf, 0.0)
        Hf = Hf + jnp.diag(jnp.where(free7, 0.0, 1.0))
        rhs = jnp.where(free7, b.reshape(K * 7), 0.0)
        dx = -jnp.linalg.solve(Hf, rhs)
        dx = jnp.where(free7, dx, 0.0).reshape(K, 7) * dof[None, :]

        g_new = jax.vmap(lambda d_, g_: sim3.compose(sim3.exp(d_), g_))(
            dx, g_all)
        # accept/reject
        e1, _, _ = residuals_and_jacs(g_new)
        c_new = jnp.sum(w * jnp.sum(e1 * e1, -1))
        c_old = jnp.sum(w * jnp.sum(e0 * e0, -1))
        accept = c_new < c_old
        g_out = jnp.where(accept, g_new, g_all)
        lam_out = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0),
                           1e-9, 1e6)
        return (g_out, lam_out, jnp.where(accept, c_new, c_old))

    init = (g_init, jnp.asarray(1e-4, dtype), jnp.asarray(jnp.inf, dtype))
    g_out, _, _ = jax.lax.fori_loop(0, n_iters, body, init)
    return g_out


def build_essential_edges(
    covis_w, kf_valid, kf_frame_id, g_old, g_corrected,
    loop_pairs, strong_th: float = 100.0, max_edges: int = 2048,
):
    """Host-side edge assembly (runs once per loop closure).

    Edge set per the reference (Optimizer.cc:1439-1616):
    - spanning tree: each KF -> best-covisible earlier KF
    - loop pairs (current + accumulated past loop edges)
    - strong covisibility pairs (weight >= strong_th)
    Measurements are computed from the UNCORRECTED poses except for edges
    incident to corrected keyframes, which use the corrected Sim3s
    (mirroring the NonCorrectedSim3/CorrectedSim3 maps of the reference).
    """
    import numpy as np

    covis_w = np.asarray(covis_w)
    kf_valid = np.asarray(kf_valid)
    kf_frame_id = np.asarray(kf_frame_id)
    g_old_np = np.asarray(g_old)
    K = covis_w.shape[0]
    edges = set()
    valid_ids = np.nonzero(kf_valid)[0]
    order = valid_ids[np.argsort(kf_frame_id[valid_ids])]
    for idx, k in enumerate(order):
        if idx == 0:
            continue
        earlier = order[:idx]
        w = covis_w[k][earlier]
        if w.max() > 0:
            parent = int(earlier[int(w.argmax())])
            edges.add((min(parent, int(k)), max(parent, int(k))))
    for a, b in loop_pairs:
        edges.add((min(a, b), max(a, b)))
    strong = np.argwhere(covis_w >= strong_th)
    for a, b in strong:
        if a < b and kf_valid[a] and kf_valid[b]:
            edges.add((int(a), int(b)))
    edges = sorted(edges)[:max_edges]

    import jax.numpy as jnp_
    E = max_edges
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    meas = np.tile(np.asarray(sim3.identity()), (E, 1))
    ok = np.zeros(E, bool)
    g_old_j = jnp_.asarray(g_old_np)
    if g_corrected is not None:
        g_corr_arr, corr_mask = g_corrected
        g_corr_arr = jnp_.asarray(np.asarray(g_corr_arr))
        corr_mask = np.asarray(corr_mask)
    else:
        corr_mask = np.zeros(K, bool)
        g_corr_arr = g_old_j

    def pose_of(k):
        return g_corr_arr[k] if corr_mask[k] else g_old_j[k]

    loop_set = {(min(a, b), max(a, b)) for a, b in loop_pairs}
    for n, (a, b) in enumerate(edges):
        ei[n] = a
        ej[n] = b
        # S_ba = S_b * S_a^-1; loop edges and edges touching corrected
        # keyframes use the corrected Sim3s (reference CorrectedSim3 map,
        # Optimizer.cc:1439-1520), everything else the pre-correction poses
        if (a, b) in loop_set or corr_mask[a] or corr_mask[b]:
            m = sim3.compose(pose_of(b), sim3.inverse(pose_of(a)))
        else:
            m = sim3.compose(g_old_j[b], sim3.inverse(g_old_j[a]))
        meas[n] = np.asarray(m)
        ok[n] = True
    return (jnp_.asarray(ei), jnp_.asarray(ej), jnp_.asarray(meas),
            jnp_.asarray(ok))
