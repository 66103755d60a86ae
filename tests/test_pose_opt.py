import jax
import jax.numpy as jnp
import numpy as np

from multi_orb_slam.geometry import se3
from multi_orb_slam.optim import pose_opt


def make_problem(seed=0, n=200, noise=0.5, n_outliers=0, n_cams=1, stereo=True):
    rng = np.random.RandomState(seed)
    pw = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    pw[:, 2] += 5.0
    Tcw_true = np.asarray(se3.exp(jnp.asarray(
        [0.1, -0.05, 0.08, 0.02, -0.03, 0.05], jnp.float32)))
    K = np.tile(np.array([520.0, 520.0, 320.0, 240.0], np.float32), (n_cams, 1))
    bf = np.float32(40.0)
    # rig: cam0 identity; cam1 rotated 30deg about y with small offset
    T_rc = np.stack([np.eye(4, dtype=np.float32) for _ in range(n_cams)])
    if n_cams > 1:
        Ry = np.asarray(se3.so3_exp(jnp.array([0.0, 0.5, 0.0])))
        T_rc[1, :3, :3] = Ry
        T_rc[1, :3, 3] = [0.16, 0.0, -0.07]
    cam_idx = rng.randint(0, n_cams, size=n).astype(np.int32)

    Xr = pw @ Tcw_true[:3, :3].T + Tcw_true[:3, 3]
    uvr = np.zeros((n, 3), np.float32)
    keep = np.ones(n, bool)
    for i in range(n):
        Trc = T_rc[cam_idx[i]]
        Xc = Trc[:3, :3] @ Xr[i] + Trc[:3, 3]
        if Xc[2] < 0.1:
            keep[i] = False
            continue
        u = K[cam_idx[i], 0] * Xc[0] / Xc[2] + K[cam_idx[i], 2]
        v = K[cam_idx[i], 1] * Xc[1] / Xc[2] + K[cam_idx[i], 3]
        ur = u - bf / Xc[2] if stereo else -1.0
        uvr[i] = [u + rng.randn() * noise, v + rng.randn() * noise,
                  (ur + rng.randn() * noise) if stereo else -1.0]
    if n_outliers:
        idx = rng.choice(np.nonzero(keep)[0], n_outliers, replace=False)
        uvr[idx, :2] += rng.uniform(30, 80, size=(n_outliers, 2))
    obs = pose_opt.PoseObs(
        pw=jnp.asarray(pw),
        uvr=jnp.asarray(uvr),
        cam_idx=jnp.asarray(cam_idx),
        inv_sigma2=jnp.ones(n, jnp.float32),
        mask=jnp.asarray(keep),
    )
    return Tcw_true, obs, jnp.asarray(T_rc), jnp.asarray(K), jnp.asarray(bf)


def pose_error(Ta, Tb):
    d = np.asarray(se3.log(jnp.asarray(Ta) @ jnp.linalg.inv(jnp.asarray(Tb))))
    return np.linalg.norm(d)


class TestPoseOpt:
    def test_converges_from_perturbed(self):
        Tcw_true, obs, T_rc, K, bf = make_problem(noise=0.3)
        T0 = se3.exp(jnp.asarray([0.05, 0.05, -0.05, 0.02, 0.02, -0.02])) @ jnp.asarray(Tcw_true)
        Tcw, inl, n = pose_opt.optimize_pose(T0, obs, T_rc, K, bf)
        assert pose_error(Tcw, Tcw_true) < 5e-3
        assert int(n) > 150

    def test_rejects_outliers(self):
        Tcw_true, obs, T_rc, K, bf = make_problem(noise=0.3, n_outliers=40)
        T0 = se3.exp(jnp.asarray([0.03, -0.03, 0.03, 0.01, -0.01, 0.01])) @ jnp.asarray(Tcw_true)
        Tcw, inl, n = pose_opt.optimize_pose(T0, obs, T_rc, K, bf)
        assert pose_error(Tcw, Tcw_true) < 8e-3
        # outliers should be classified out
        assert int(n) < 200 - 30

    def test_multicam(self):
        Tcw_true, obs, T_rc, K, bf = make_problem(noise=0.3, n_cams=2)
        T0 = se3.exp(jnp.asarray([0.04, 0.02, -0.03, -0.02, 0.01, 0.02])) @ jnp.asarray(Tcw_true)
        Tcw, inl, n = pose_opt.optimize_pose(T0, obs, T_rc, K, bf)
        assert pose_error(Tcw, Tcw_true) < 5e-3

    def test_mono_only(self):
        Tcw_true, obs, T_rc, K, bf = make_problem(noise=0.3, stereo=False)
        T0 = se3.exp(jnp.asarray([0.02, 0.02, -0.02, 0.01, 0.01, -0.01])) @ jnp.asarray(Tcw_true)
        Tcw, inl, n = pose_opt.optimize_pose(T0, obs, T_rc, K, bf)
        assert pose_error(Tcw, Tcw_true) < 1e-2

    def test_jacobian_matches_autodiff(self):
        Tcw_true, obs, T_rc, K, bf = make_problem(n=32, noise=0.0)
        Tcw = jnp.asarray(Tcw_true)

        e0, J, is_st, valid = pose_opt._residual_jacobian(Tcw, obs, T_rc, K, bf)

        def res_fn(xi):
            T = se3.exp(xi) @ Tcw
            e, _, _, _ = pose_opt._residual_jacobian(T, obs, T_rc, K, bf)
            return e

        J_auto = jax.jacfwd(res_fn)(jnp.zeros(6))
        m = np.asarray(valid)
        np.testing.assert_allclose(
            np.asarray(J)[m], np.asarray(J_auto)[m], rtol=1e-3, atol=1e-3
        )
