"""Shared reprojection residuals/Jacobians for all BA problems.

The math of the fork's rig-aware g2o edges
(Thirdparty/g2o/g2o/types/types_six_dof_expmap.h:98-156: error =
obs - cam_project(Tcim.map(Tcw.map(Xw))), with analytic Jacobians in
types_six_dof_expmap.cpp:110-145, 324-338), vectorized over observation
batches.  Used by motion-only BA, local BA, and global BA.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..geometry import se3


def reproj_residual(
    Tcw: jnp.ndarray,      # [..., 4, 4] rig pose per observation
    Xw: jnp.ndarray,       # [..., 3] world point per observation
    T_rc: jnp.ndarray,     # [..., 4, 4] rig->camera extrinsic per observation
    K: jnp.ndarray,        # [..., 4] per-observation intrinsics
    bf: jnp.ndarray,       # [] or broadcastable
    uvr: jnp.ndarray,      # [..., 3] measured (u, v, ur); ur<0 => mono
    want_jac: bool = True,
):
    """Returns (e [...,3], J_pose [...,3,6], J_point [...,3,3],
    is_stereo [...], pos_depth [...]).

    Batch dims broadcast: a structured caller (local/global BA, [L, C, F]
    observation layout) passes Tcw as [L, 1, 1, 4, 4] and T_rc/K as
    [1, C, 1, ...] so XLA broadcasts the row-constant pose/extrinsics —
    replacing three [N]-wide gathers per residual pass (Tcw[obs_kf],
    T_rc[obs_cam], K[obs_cam]), each of which pays this backend's gather
    latency floor regardless of payload.

    e rows for mono observations must be masked with row weights
    [1, 1, 0] by the caller.  J_pose is wrt a left-multiplied se3 tangent on
    Tcw; J_point is wrt Xw.
    """
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    Xr = jnp.einsum("...ij,...j->...i", R, Xw) + t
    Rm = T_rc[..., :3, :3]
    tm = T_rc[..., :3, 3]
    Xc = jnp.einsum("...ij,...j->...i", Rm, Xr) + tm
    fx, fy = K[..., 0], K[..., 1]
    cx, cy = K[..., 2], K[..., 3]

    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    bfo = jnp.broadcast_to(bf, jnp.broadcast_shapes(
        jnp.shape(bf), fx.shape, x.shape))
    pos_depth = z > 1e-3
    zs = jnp.where(pos_depth, z, 1.0)
    invz = 1.0 / zs
    invz2 = invz * invz
    u = fx * x * invz + cx
    v = fy * y * invz + cy
    ur = u - bfo * invz
    pred = jnp.stack([u, v, ur], axis=-1)
    is_stereo = uvr[..., 2] >= 0
    target = jnp.where(is_stereo[..., None], uvr,
                       jnp.concatenate([uvr[..., :2], ur[..., None]],
                                       axis=-1))
    e = target - pred
    if not want_jac:
        return e, None, None, is_stereo, pos_depth

    # A = dproj/dXc is sparse (row 2 = row 0 + bf*invz2 * e3), so ARm and
    # the downstream products expand into pure broadcast arithmetic that
    # fuses into the residual pass instead of batches of tiny matmuls.
    r0 = (fx * invz)[..., None] * Rm[..., 0, :] \
        - (fx * x * invz2)[..., None] * Rm[..., 2, :]
    r1 = (fy * invz)[..., None] * Rm[..., 1, :] \
        - (fy * y * invz2)[..., None] * Rm[..., 2, :]
    r2 = r0 + (bfo * invz2)[..., None] * Rm[..., 2, :]
    ARm = jnp.stack([r0, r1, r2], axis=-2)          # [..., 3, 3]
    # ARm @ hat(Xr): M @ hat(v) columns are cross-structured combinations
    vx, vy, vz = Xr[..., 0, None], Xr[..., 1, None], Xr[..., 2, None]
    c0 = vz * ARm[..., :, 1] - vy * ARm[..., :, 2]
    c1 = -vz * ARm[..., :, 0] + vx * ARm[..., :, 2]
    c2 = vy * ARm[..., :, 0] - vx * ARm[..., :, 1]
    ARm_hat = jnp.stack([c0, c1, c2], axis=-1)      # [..., 3, 3]
    J_pose = jnp.concatenate([-ARm, ARm_hat], axis=-1)  # [..., 3, 6]
    # ARm @ R as three broadcast row combinations
    J_point = -(ARm[..., :, 0, None] * R[..., None, 0, :]
                + ARm[..., :, 1, None] * R[..., None, 1, :]
                + ARm[..., :, 2, None] * R[..., None, 2, :])
    return e, J_pose, J_point, is_stereo, pos_depth


def bmv(M: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched matvec [..., i, j] @ [..., j] -> [..., i] as broadcast
    multiply + reduce.  An einsum here lowers as a batch of tiny matmuls;
    the broadcast form fuses into one elementwise pass."""
    return jnp.sum(M * v[..., None, :], axis=-1)


def bmtv(M: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched M^T v: [..., i, j] with [..., i] -> [..., j] (see bmv)."""
    return jnp.sum(M * v[..., :, None], axis=-2)


def outer_rows(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """sum_r A[..., r, i] B[..., r, j] -> [..., i, j], r unrolled (=3).

    The J^T J / J^T W J block products of every BA variant (see bmv)."""
    return (A[..., 0, :, None] * B[..., 0, None, :]
            + A[..., 1, :, None] * B[..., 1, None, :]
            + A[..., 2, :, None] * B[..., 2, None, :])


def jte_rows(A: jnp.ndarray, e: jnp.ndarray) -> jnp.ndarray:
    """sum_r A[..., r, i] e[..., r] -> [..., i], r unrolled (=3)."""
    return (A[..., 0, :] * e[..., 0, None]
            + A[..., 1, :] * e[..., 1, None]
            + A[..., 2, :] * e[..., 2, None])


def row_weights(is_stereo: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """[..., 3] row mask: mono rows drop the virtual-right residual."""
    ones = jnp.ones(is_stereo.shape + (3,), dtype)
    mono = jnp.broadcast_to(jnp.asarray([1.0, 1.0, 0.0], dtype), ones.shape)
    return jnp.where(is_stereo[..., None], ones, mono)
