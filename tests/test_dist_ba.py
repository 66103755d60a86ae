import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from multi_orb_slam.geometry import se3
from multi_orb_slam.parallel import dist_ba

from test_local_ba import make_ba_problem


def flat_from_ba_problem(prob, n_shards):
    L, C, F = prob.obs_mp.shape
    uvr = np.asarray(prob.obs_uvr)
    is2 = np.asarray(prob.obs_inv_sigma2)
    return dist_ba.flatten_problem(
        prob.kf_Tcw, np.asarray(prob.kf_valid), np.asarray(prob.kf_free),
        np.asarray(prob.obs_mp), uvr, is2,
        prob.mp_pos, np.asarray(prob.mp_valid), n_shards,
    )


def pose_err(Ta, Tb):
    return float(jnp.linalg.norm(se3.log(jnp.asarray(Ta) @ se3.inverse(jnp.asarray(Tb)))))


class TestDistBA:
    def _run(self, n_dev):
        prob, poses_gt, pts_gt, T_rc, K, bf = make_ba_problem(n_pts=120)
        devs = np.array(jax.devices()[:n_dev])
        mesh = Mesh(devs, ("data",))
        flat = flat_from_ba_problem(prob, n_dev)
        step = dist_ba.make_dist_ba_step(mesh, n_outer=8, cg_iters=30)
        Tcw, pos, costs = step(flat, T_rc, K, bf)
        return prob, poses_gt, pts_gt, Tcw, pos, costs

    def test_single_device(self):
        prob, poses_gt, pts_gt, Tcw, pos, costs = self._run(1)
        for l in range(Tcw.shape[0]):
            if bool(prob.kf_free[l]):
                e_b = pose_err(prob.kf_Tcw[l], poses_gt[l])
                e_a = pose_err(Tcw[l], poses_gt[l])
                assert e_a < 0.5 * e_b + 2e-3, (l, e_b, e_a)

    def test_eight_devices_matches(self):
        assert len(jax.devices()) >= 8
        prob, poses_gt, pts_gt, Tcw8, pos8, costs8 = self._run(8)
        _, _, _, Tcw1, pos1, costs1 = self._run(1)
        # same optimization on 1 vs 8 devices: near-identical results
        np.testing.assert_allclose(
            np.asarray(Tcw8), np.asarray(Tcw1), atol=5e-4
        )
        # cost must decrease over outer iterations
        c = np.asarray(costs8)
        assert c[-1] < c[0]

    def test_fixed_pose_untouched(self):
        prob, poses_gt, pts_gt, Tcw, pos, _ = self._run(4)
        for l in range(Tcw.shape[0]):
            if not bool(prob.kf_free[l]):
                np.testing.assert_allclose(
                    np.asarray(Tcw[l]), np.asarray(prob.kf_Tcw[l]), atol=1e-7
                )
