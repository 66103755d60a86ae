import jax.numpy as jnp
import numpy as np

from multi_orb_slam.geometry import se3
from multi_orb_slam.optim import local_ba


def make_ba_problem(
    seed=0, n_free=4, n_fixed=2, n_pts=120, noise_px=0.1,
    pose_noise=0.03, point_noise=0.15, n_cams=1, F=64,
):
    """Synthetic windowed BA problem with ground truth."""
    rng = np.random.RandomState(seed)
    L = n_free + n_fixed
    C = n_cams
    K = np.tile(np.array([400.0, 400.0, 320.0, 240.0], np.float32), (C, 1))
    bf = np.float32(80.0)
    T_rc = np.stack([np.eye(4, dtype=np.float32) for _ in range(C)])
    if C > 1:
        T_rc[1][:3, 3] = [0.1, 0.0, 0.0]

    pts_gt = rng.uniform(-3, 3, size=(n_pts, 3)).astype(np.float32)
    pts_gt[:, 2] += 4.0
    poses_gt = []
    for i in range(L):
        xi = np.zeros(6, np.float32)
        xi[0] = 0.3 * (i - L / 2)  # translate along x
        xi[4] = 0.05 * (i - L / 2)
        poses_gt.append(np.asarray(se3.exp(jnp.asarray(xi))))
    poses_gt = np.stack(poses_gt)

    obs_mp = np.full((L, C, F), -1, np.int32)
    obs_uvr = np.zeros((L, C, F, 3), np.float32)
    for l in range(L):
        for c in range(C):
            Tcam = T_rc[c] @ poses_gt[l]
            Xc = pts_gt @ Tcam[:3, :3].T + Tcam[:3, 3]
            sel = np.nonzero(Xc[:, 2] > 0.5)[0]
            rng.shuffle(sel)
            sel = sel[:F]
            for j, p in enumerate(sel):
                u = K[c, 0] * Xc[p, 0] / Xc[p, 2] + K[c, 2]
                v = K[c, 1] * Xc[p, 1] / Xc[p, 2] + K[c, 3]
                ur = u - bf / Xc[p, 2]
                obs_mp[l, c, j] = p
                obs_uvr[l, c, j] = [
                    u + rng.randn() * noise_px,
                    v + rng.randn() * noise_px,
                    ur + rng.randn() * noise_px,
                ]

    # perturb free poses and all points
    poses_init = poses_gt.copy()
    for l in range(n_fixed, L):  # free = last n_free? we'll mark below
        pass
    kf_free = np.zeros(L, bool)
    kf_free[n_fixed:] = True
    for l in range(L):
        if kf_free[l]:
            xi = rng.randn(6).astype(np.float32) * pose_noise
            poses_init[l] = np.asarray(se3.exp(jnp.asarray(xi))) @ poses_init[l]
    pts_init = pts_gt + rng.randn(n_pts, 3).astype(np.float32) * point_noise

    prob = local_ba.BAProblem(
        kf_slot=jnp.arange(L, dtype=jnp.int32),
        kf_Tcw=jnp.asarray(poses_init),
        kf_free=jnp.asarray(kf_free),
        kf_valid=jnp.ones(L, bool),
        mp_slot=jnp.arange(n_pts, dtype=jnp.int32),
        mp_pos=jnp.asarray(pts_init),
        mp_valid=jnp.ones(n_pts, bool),
        obs_mp=jnp.asarray(obs_mp),
        obs_uvr=jnp.asarray(obs_uvr),
        obs_inv_sigma2=jnp.ones((L, C, F), jnp.float32),
    )
    return prob, poses_gt, pts_gt, jnp.asarray(T_rc), jnp.asarray(K), jnp.asarray(bf)


def pose_err(Ta, Tb):
    return float(jnp.linalg.norm(se3.log(jnp.asarray(Ta) @ se3.inverse(jnp.asarray(Tb)))))


class TestLocalBA:
    def test_recovers_geometry(self):
        prob, poses_gt, pts_gt, T_rc, K, bf = make_ba_problem()
        kf_Tcw, mp_pos, inlier = local_ba.solve_ba(prob, T_rc, K, bf)
        for l in range(prob.kf_Tcw.shape[0]):
            if bool(prob.kf_free[l]):
                e_before = pose_err(prob.kf_Tcw[l], poses_gt[l])
                e_after = pose_err(kf_Tcw[l], poses_gt[l])
                assert e_after < 0.3 * e_before + 2e-3, (l, e_before, e_after)
        pt_err_before = float(jnp.mean(jnp.linalg.norm(prob.mp_pos - pts_gt, axis=-1)))
        pt_err_after = float(jnp.mean(jnp.linalg.norm(mp_pos - pts_gt, axis=-1)))
        assert pt_err_after < 0.3 * pt_err_before + 1e-3

    def test_fixed_kfs_unchanged(self):
        prob, poses_gt, pts_gt, T_rc, K, bf = make_ba_problem()
        kf_Tcw, _, _ = local_ba.solve_ba(prob, T_rc, K, bf)
        for l in range(prob.kf_Tcw.shape[0]):
            if not bool(prob.kf_free[l]):
                np.testing.assert_allclose(
                    np.asarray(kf_Tcw[l]), np.asarray(prob.kf_Tcw[l]), atol=1e-7
                )

    def test_outlier_observations_flagged(self):
        prob, poses_gt, pts_gt, T_rc, K, bf = make_ba_problem()
        # corrupt 20 observations badly
        uvr = np.asarray(prob.obs_uvr).copy()
        corrupted = []
        rng = np.random.RandomState(3)
        for _ in range(20):
            l = rng.randint(uvr.shape[0])
            j = rng.randint(uvr.shape[2])
            if np.asarray(prob.obs_mp)[l, 0, j] >= 0:
                uvr[l, 0, j, :2] += rng.uniform(20, 50, 2)
                corrupted.append((l, 0, j))
        prob = prob._replace(obs_uvr=jnp.asarray(uvr))
        _, _, inlier = local_ba.solve_ba(prob, T_rc, K, bf)
        inl = np.asarray(inlier)
        flagged = sum(1 for (l, c, j) in corrupted if not inl[l, c, j])
        assert flagged >= 0.8 * len(corrupted), (flagged, len(corrupted))

    def test_multicam_rig(self):
        prob, poses_gt, pts_gt, T_rc, K, bf = make_ba_problem(n_cams=2)
        kf_Tcw, mp_pos, _ = local_ba.solve_ba(prob, T_rc, K, bf)
        for l in range(prob.kf_Tcw.shape[0]):
            if bool(prob.kf_free[l]):
                assert pose_err(kf_Tcw[l], poses_gt[l]) < 5e-3
