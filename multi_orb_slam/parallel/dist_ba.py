"""Distributed global bundle adjustment over a device mesh.

The communication layer the reference never had (it is a single-process
pthread design, SURVEY.md §2.4); this is the BASELINE.json north star:
map-point blocks and their observations are sharded over devices, each
device builds its local point system and partial camera system, and the
reduced Schur camera system is combined with `psum` over the mesh — the
only cross-device traffic inside the CG loop is one [K, 6] psum per matvec
(a few KB over NVLink on one machine's GPUs).

Layout:
- `mp_pos` is sharded along the point axis; observations are pre-grouped so
  every observation lives on the shard that owns its point (obs reference
  points by LOCAL index, poses by GLOBAL index).
- `kf_Tcw` is replicated; pose updates are computed identically everywhere
  (the psum makes them bitwise-consistent across devices).

The math matches `optim/global_ba.py` (matrix-free Schur + block-Jacobi
PCG + LM outer loop).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import se3
from ..optim import residuals
from ..optim.pose_opt import CHI2_MONO, CHI2_STEREO


class FlatBA(NamedTuple):
    """Flat, shardable BA problem.

    N observations grouped by owning point shard; M points; K poses.
    `obs_mp` indexes the GLOBAL point axis (converted to local inside the
    shard); `obs_kf` indexes the replicated pose axis.
    """

    obs_kf: jnp.ndarray      # [N] int32
    obs_cam: jnp.ndarray     # [N] int32
    obs_mp: jnp.ndarray      # [N] int32 global point index (-1 pad)
    obs_uvr: jnp.ndarray     # [N, 3]
    obs_is2: jnp.ndarray     # [N]
    kf_Tcw: jnp.ndarray      # [K, 4, 4]
    kf_free: jnp.ndarray     # [K] bool
    mp_pos: jnp.ndarray      # [M, 3]
    mp_valid: jnp.ndarray    # [M] bool


def flatten_problem(
    kf_Tcw, kf_valid, kf_free, kf_mp, obs_uvr_grid, obs_is2_grid,
    mp_pos, mp_valid, n_shards: int,
) -> FlatBA:
    """Host-side: flatten [K, C, F] observations and group them by the point
    shard that owns their map point; pad each shard to equal length."""
    kf_mp = np.asarray(kf_mp)
    K, C, F = kf_mp.shape
    M = np.asarray(mp_pos).shape[0]
    assert M % n_shards == 0, "point capacity must divide the mesh"
    blk = M // n_shards
    obs_kf = np.repeat(np.arange(K, dtype=np.int32), C * F)
    obs_cam = np.tile(np.repeat(np.arange(C, dtype=np.int32), F), K)
    obs_mp = kf_mp.reshape(-1)
    uvr = np.asarray(obs_uvr_grid).reshape(-1, 3)
    is2 = np.asarray(obs_is2_grid).reshape(-1)
    ok = (obs_mp >= 0) & np.asarray(kf_valid)[obs_kf] & np.asarray(mp_valid)[
        np.clip(obs_mp, 0, M - 1)]

    shard_of = np.where(ok, obs_mp // blk, -1)
    counts = [(shard_of == d).sum() for d in range(n_shards)]
    cap = int(max(max(counts), 1))
    # round up for alignment
    cap = ((cap + 127) // 128) * 128
    N = cap * n_shards
    f_kf = np.zeros(N, np.int32)
    f_cam = np.zeros(N, np.int32)
    f_mp = np.full(N, -1, np.int32)
    f_uvr = np.zeros((N, 3), np.float32)
    f_is2 = np.ones(N, np.float32)
    for d in range(n_shards):
        sel = np.nonzero(shard_of == d)[0]
        base = d * cap
        n = len(sel)
        f_kf[base:base + n] = obs_kf[sel]
        f_cam[base:base + n] = obs_cam[sel]
        f_mp[base:base + n] = obs_mp[sel]
        f_uvr[base:base + n] = uvr[sel]
        f_is2[base:base + n] = is2[sel]
    return FlatBA(
        obs_kf=jnp.asarray(f_kf), obs_cam=jnp.asarray(f_cam),
        obs_mp=jnp.asarray(f_mp), obs_uvr=jnp.asarray(f_uvr),
        obs_is2=jnp.asarray(f_is2),
        kf_Tcw=jnp.asarray(kf_Tcw), kf_free=jnp.asarray(kf_free),
        mp_pos=jnp.asarray(mp_pos), mp_valid=jnp.asarray(mp_valid),
    )


def synthetic_problem(kfs: int, points: int, obs_per_kf: int,
                      n_shards: int, seed: int = 0):
    """A GBA problem of `kfs` poses along a line viewing `points` points,
    each pose observing `obs_per_kf` of them with 0.5 px noise (one camera,
    stereo observations).  `points` is rounded down to divide the mesh.

    Returns (flat, T_rc, K_intr, bf) ready for `make_dist_ba_step`.
    """
    rng = np.random.RandomState(seed)
    M = (points // n_shards) * n_shards
    kf_Tcw = np.tile(np.eye(4, dtype=np.float32), (kfs, 1, 1))
    kf_Tcw[:, 0, 3] = 0.05 * np.arange(kfs)
    kf_free = np.ones(kfs, bool)
    kf_free[0] = False
    pts = rng.uniform(-4, 4, (M, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    K_intr = np.array([[500.0, 500.0, 320.0, 240.0]], np.float32)
    bf = np.float32(40.0)
    kf_mp = np.full((kfs, 1, obs_per_kf), -1, np.int32)
    uvr = np.zeros((kfs, 1, obs_per_kf, 3), np.float32)
    for k in range(kfs):
        sel = rng.choice(M, obs_per_kf, replace=False)
        Xc = pts[sel] + kf_Tcw[k, :3, 3]
        ok = Xc[:, 2] >= 0.3
        u = K_intr[0, 0] * Xc[:, 0] / Xc[:, 2] + K_intr[0, 2]
        v = K_intr[0, 1] * Xc[:, 1] / Xc[:, 2] + K_intr[0, 3]
        noise = rng.randn(obs_per_kf, 2).astype(np.float32) * 0.5
        kf_mp[k, 0] = np.where(ok, sel, -1)
        uvr[k, 0] = np.stack([u + noise[:, 0], v + noise[:, 1],
                              u - bf / Xc[:, 2]], -1)
    flat = flatten_problem(
        kf_Tcw, np.ones(kfs, bool), kf_free, kf_mp, uvr,
        np.ones((kfs, 1, obs_per_kf), np.float32), pts, np.ones(M, bool),
        n_shards)
    return (flat, jnp.asarray(np.eye(4, dtype=np.float32)[None]),
            jnp.asarray(K_intr), jnp.asarray(bf))


def _damp_blocks(H, lam):
    d = jnp.diagonal(H, axis1=-2, axis2=-1)
    tr = jnp.sum(d, axis=-1, keepdims=True)
    dd = lam * d + 1e-6 * tr + 1e-9
    return H + dd[..., :, None] * jnp.eye(H.shape[-1], dtype=H.dtype)


def make_dist_ba_step(mesh: Mesh, axis: str = "data",
                      n_outer: int = 8, cg_iters: int = 40):
    """Build the pjit-able distributed BA step for a mesh.

    Returns step(flat: FlatBA, T_rc, K_intr, bf) -> (kf_Tcw, mp_pos).
    """

    def local_step(obs_kf, obs_cam, obs_mp, obs_uvr, obs_is2,
                   kf_Tcw, kf_free, mp_pos, mp_valid, T_rc, K_intr, bf):
        # shapes inside shard_map: obs_* [N/n], mp_* [M/n]; kf_* replicated
        Ml = mp_pos.shape[0]
        K = kf_Tcw.shape[0]
        dtype = mp_pos.dtype
        d_idx = jax.lax.axis_index(axis)
        # global -> local point index
        mp_local = obs_mp - d_idx * Ml
        obs_ok = (obs_mp >= 0) & (mp_local >= 0) & (mp_local < Ml)
        mp_idx = jnp.clip(mp_local, 0, Ml - 1)
        obs_ok = obs_ok & mp_valid[mp_idx]

        delta_m = jnp.sqrt(CHI2_MONO)
        delta_s = jnp.sqrt(CHI2_STEREO)

        def residual_state(Tcw_all, pos_local):
            return residuals.reproj_residual(
                Tcw_all[obs_kf], pos_local[mp_idx], T_rc[obs_cam],
                K_intr[obs_cam], bf, obs_uvr)

        def outer(carry, _):
            Tcw_all, pos_local, lam = carry
            e, Jc, Jp, is_st, posd = residual_state(Tcw_all, pos_local)
            act = obs_ok & posd
            row = residuals.row_weights(is_st, dtype)
            chi2 = jnp.sum(e * e * row, -1) * obs_is2
            delta = jnp.where(is_st, delta_s, delta_m)
            r = jnp.sqrt(jnp.maximum(chi2, 1e-12))
            hw = jnp.where(r > delta, delta / r, 1.0)
            w = obs_is2 * hw * act.astype(dtype)
            Wr = row * w[:, None]

            free_o = kf_free[obs_kf]
            Jc_eff = Jc * free_o[:, None, None].astype(dtype)
            JTcW = Jc_eff * Wr[:, :, None]
            JTpW = Jp * Wr[:, :, None]

            # camera system: partial sums + psum across the mesh
            Hcc = jax.lax.psum(
                jnp.zeros((K, 6, 6), dtype).at[obs_kf].add(
                    residuals.outer_rows(JTcW, Jc_eff)), axis)
            bc = jax.lax.psum(
                jnp.zeros((K, 6), dtype).at[obs_kf].add(
                    residuals.jte_rows(JTcW, e)), axis)
            # point system: fully local (observations co-located)
            Hpp = jnp.zeros((Ml, 3, 3), dtype).at[mp_idx].add(
                residuals.outer_rows(JTpW, Jp))
            bp = jnp.zeros((Ml, 3), dtype).at[mp_idx].add(
                residuals.jte_rows(JTpW, e))
            U = residuals.outer_rows(JTcW, Jp)

            Hcc_d = _damp_blocks(Hcc, lam)
            Hpp_d = _damp_blocks(Hpp, lam) + jnp.where(
                mp_valid, 0.0, 1.0)[:, None, None] * jnp.eye(3, dtype=dtype)
            Hpp_inv = jnp.linalg.inv(Hpp_d)

            def S_matvec(x):
                Ux = residuals.bmtv(U, x[obs_kf])
                y = jnp.zeros((Ml, 3), dtype).at[mp_idx].add(Ux)
                z = residuals.bmv(Hpp_inv, y)
                Uz = residuals.bmv(U, z[mp_idx])
                WHWx = jax.lax.psum(
                    jnp.zeros((K, 6), dtype).at[obs_kf].add(Uz), axis)
                Hx = residuals.bmv(Hcc_d, x)
                return (Hx - WHWx) * kf_free[:, None]

            zb = residuals.bmv(Hpp_inv, bp)
            Uzb = residuals.bmv(U, zb[mp_idx])
            rhs = bc - jax.lax.psum(
                jnp.zeros((K, 6), dtype).at[obs_kf].add(Uzb), axis)
            rhs = rhs * kf_free[:, None]

            Pinv = jnp.linalg.inv(
                Hcc_d + jnp.where(kf_free, 0.0, 1.0)[:, None, None]
                * jnp.eye(6, dtype=dtype))

            def precond(v):
                return residuals.bmv(Pinv, v) * kf_free[:, None]

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
                return (x, rr, z + beta * p, rz_new)

            x0 = jnp.zeros((K, 6), dtype)
            z0 = precond(b_cg)
            dxc, _, _, _ = jax.lax.fori_loop(
                0, cg_iters, cg_body, (x0, b_cg, z0, jnp.sum(b_cg * z0)))
            dxc = dxc * kf_free[:, None]

            Ux = residuals.bmtv(U, dxc[obs_kf])
            WTdx = jnp.zeros((Ml, 3), dtype).at[mp_idx].add(Ux)
            dp = -residuals.bmv(Hpp_inv, bp + WTdx)
            dp = dp * mp_valid[:, None]

            Tcw_new = jax.vmap(lambda d, T: se3.exp(d) @ T)(dxc, Tcw_all)
            pos_new = pos_local + dp
            e2, _, _, _, posd2 = residual_state(Tcw_new, pos_new)
            chi2n = jnp.sum(e2 * e2 * row, -1) * obs_is2

            def rho(c2):
                rr_ = jnp.sqrt(jnp.maximum(c2, 1e-12))
                return jnp.where(rr_ > delta, delta * (2 * rr_ - delta), c2)

            tot_new = jax.lax.psum(
                jnp.sum(jnp.where(obs_ok & posd2, rho(chi2n), 0.0)), axis)
            tot_old = jax.lax.psum(
                jnp.sum(jnp.where(act, rho(chi2), 0.0)), axis)
            accept = tot_new < tot_old
            Tcw_out = jnp.where(accept, Tcw_new, Tcw_all)
            pos_out = jnp.where(accept, pos_new, pos_local)
            lam_out = jnp.clip(
                jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
            return (Tcw_out, pos_out, lam_out), tot_old

        (Tcw, pos, _), costs = jax.lax.scan(
            outer, (kf_Tcw, mp_pos, jnp.asarray(1e-4, dtype)),
            None, length=n_outer)
        return Tcw, pos, costs

    sharded = P(axis)
    repl = P()
    step = jax.jit(
        jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(sharded, sharded, sharded, sharded, sharded,
                      repl, repl, sharded, sharded, repl, repl, repl),
            out_specs=(repl, sharded, repl),
            check_vma=False,
        )
    )

    def run(flat: FlatBA, T_rc, K_intr, bf):
        return step(flat.obs_kf, flat.obs_cam, flat.obs_mp, flat.obs_uvr,
                    flat.obs_is2, flat.kf_Tcw, flat.kf_free,
                    flat.mp_pos, flat.mp_valid, T_rc, K_intr, bf)

    return run
