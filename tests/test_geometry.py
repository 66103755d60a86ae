import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_orb_slam.geometry import se3, sim3, camera, align


def rand_rotations(key, n):
    """Random rotations via QR of Gaussians."""
    A = jax.random.normal(key, (n, 3, 3))
    Q, R = jnp.linalg.qr(A)
    d = jnp.sign(jnp.diagonal(R, axis1=-2, axis2=-1))
    Q = Q * d[:, None, :]
    det = jnp.linalg.det(Q)
    Q = Q.at[:, :, 0].multiply(det[:, None])
    return Q


class TestSE3:
    def test_exp_log_roundtrip(self):
        key = jax.random.PRNGKey(0)
        xi = jax.random.normal(key, (64, 6)) * 1.5
        T = se3.exp(xi)
        xi2 = se3.log(T)
        T2 = se3.exp(xi2)
        np.testing.assert_allclose(np.asarray(T), np.asarray(T2), atol=2e-4)

    def test_exp_small_angle(self):
        xi = jnp.array([[1e-9, 2e-9, -1e-9, 1e-10, -1e-10, 1e-10]])
        T = se3.exp(xi)
        np.testing.assert_allclose(np.asarray(T[0, :3, :3]), np.eye(3), atol=1e-6)
        np.testing.assert_allclose(np.asarray(T[0, :3, 3]), np.asarray(xi[0, :3]), atol=1e-6)

    def test_inverse_compose(self):
        key = jax.random.PRNGKey(1)
        xi = jax.random.normal(key, (16, 6))
        T = se3.exp(xi)
        I = se3.compose(T, se3.inverse(T))
        np.testing.assert_allclose(
            np.asarray(I), np.broadcast_to(np.eye(4), (16, 4, 4)), atol=1e-5
        )

    def test_transform_points(self):
        R = se3.so3_exp(jnp.array([0.0, 0.0, jnp.pi / 2]))
        T = se3.from_rt(R, jnp.array([0.1, -0.2, 0.3]))
        p = jnp.array([[1.0, 0.0, 0.0]])
        out = se3.transform_points(T, p)
        # 90 deg about z: (1,0,0) -> (0,1,0), plus translation
        np.testing.assert_allclose(
            np.asarray(out[0]), [0.1, 0.8, 0.3], atol=1e-5
        )

    def test_quaternion_roundtrip(self):
        key = jax.random.PRNGKey(2)
        R = rand_rotations(key, 32)
        q = se3.to_quaternion(R)
        R2 = se3.from_quaternion(q)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=1e-5)

    def test_log_near_pi(self):
        # rotation by pi about a random-ish axis
        axis = jnp.array([0.6, -0.64, 0.48])
        axis = axis / jnp.linalg.norm(axis)
        R = se3.so3_exp(axis * jnp.pi)
        w = se3.so3_log(R)
        # axis*pi or -axis*pi both valid
        err = min(
            float(jnp.linalg.norm(w - axis * jnp.pi)),
            float(jnp.linalg.norm(w + axis * jnp.pi)),
        )
        assert err < 1e-2

    def test_camera_center(self):
        T = se3.exp(jnp.array([0.3, 0.1, -0.2, 0.2, -0.1, 0.4]))
        Ow = se3.camera_center(T)
        # transforming Ow by T should give origin
        out = se3.transform_points(T, Ow)
        np.testing.assert_allclose(np.asarray(out), np.zeros(3), atol=1e-6)


class TestSim3:
    def test_exp_log_roundtrip(self):
        key = jax.random.PRNGKey(3)
        xi = jax.random.normal(key, (64, 7)) * 0.8
        g = sim3.exp(xi)
        xi2 = sim3.log(g)
        g2 = sim3.exp(xi2)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g2), atol=3e-4)

    def test_compose_inverse(self):
        key = jax.random.PRNGKey(4)
        xi = jax.random.normal(key, (16, 7)) * 0.5
        g = sim3.exp(xi)
        ident = sim3.compose(g, sim3.inverse(g))
        expect = np.broadcast_to(np.asarray(sim3.identity()), (16, 8))
        got = np.asarray(ident)
        # quaternion sign ambiguity: compare via action on points
        key2 = jax.random.PRNGKey(5)
        pts = jax.random.normal(key2, (16, 10, 3))
        np.testing.assert_allclose(
            np.asarray(sim3.apply(ident, pts)), np.asarray(pts), atol=1e-4
        )
        np.testing.assert_allclose(got[:, 7], expect[:, 7], atol=1e-5)

    def test_action_matches_sRt(self):
        s = jnp.array(2.0)
        R = se3.so3_exp(jnp.array([0.0, 0.0, jnp.pi / 2]))
        t = jnp.array([1.0, 2.0, 3.0])
        g = sim3.pack(s, R, t)
        x = jnp.array([1.0, 0.0, 0.0])
        out = sim3.apply(g, x)
        np.testing.assert_allclose(np.asarray(out), [1.0, 4.0, 3.0], atol=1e-5)

    def test_se3_agreement(self):
        # sigma = 0 => Sim3 exp == SE3 exp
        key = jax.random.PRNGKey(6)
        xi6 = jax.random.normal(key, (8, 6))
        xi7 = jnp.concatenate([xi6, jnp.zeros((8, 1))], axis=-1)
        g = sim3.exp(xi7)
        T = se3.exp(xi6)
        np.testing.assert_allclose(
            np.asarray(g[:, :3]), np.asarray(T[:, :3, 3]), atol=1e-4
        )
        _, Rg, _ = sim3.unpack(g)
        np.testing.assert_allclose(np.asarray(Rg), np.asarray(T[:, :3, :3]), atol=1e-4)


class TestCamera:
    K = jnp.array([520.9, 521.0, 325.1, 249.7])
    dist = jnp.array([0.2312, -0.7849, -0.0033, -0.0001, 0.9172])

    def test_project_backproject(self):
        xc = jnp.array([[0.3, -0.2, 2.0], [0.0, 0.0, 1.0], [-1.0, 1.0, 5.0]])
        uv = camera.project(self.K, xc)
        back = camera.backproject(self.K, uv, xc[:, 2])
        np.testing.assert_allclose(np.asarray(back), np.asarray(xc), atol=1e-4)

    def test_undistort_inverts_distort(self):
        key = jax.random.PRNGKey(7)
        xc = jnp.concatenate(
            [
                jax.random.uniform(key, (128, 2), minval=-0.4, maxval=0.4),
                jnp.ones((128, 1)),
            ],
            axis=-1,
        )
        uv_dist = camera.distort_project(self.K, self.dist, xc)
        uv_undist = camera.undistort_pixels(self.K, self.dist, uv_dist, iters=10)
        uv_true = camera.project(self.K, xc)
        np.testing.assert_allclose(
            np.asarray(uv_undist), np.asarray(uv_true), atol=0.05
        )

    def test_virtual_right(self):
        bf = jnp.array(40.0)
        u = jnp.array([100.0, 200.0])
        d = jnp.array([2.0, 0.0])
        ur = camera.virtual_right_u(bf, u, d)
        np.testing.assert_allclose(np.asarray(ur), [80.0, -1.0], atol=1e-5)

    def test_frustum(self):
        Tcw = se3.identity()
        pw = jnp.array([[0.0, 0.0, 2.0], [0.0, 0.0, -1.0], [100.0, 0.0, 1.0]])
        normal = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (3, 1))
        mask, uv, invz, dist, vcos = camera.frustum_check(
            self.K, Tcw, pw, 640, 480,
            jnp.zeros(3), jnp.full((3,), 10.0), normal,
        )
        assert bool(mask[0])
        assert not bool(mask[1])  # behind camera
        assert not bool(mask[2])  # out of image


class TestAlign:
    def test_umeyama_recovers_sim3(self):
        key = jax.random.PRNGKey(8)
        src = jax.random.normal(key, (50, 3))
        R = se3.so3_exp(jnp.array([0.3, -0.5, 0.2]))
        s, t = 1.7, jnp.array([0.5, -1.0, 2.0])
        dst = s * src @ R.T + t
        s_est, R_est, t_est = align.umeyama(src, dst, with_scale=True)
        np.testing.assert_allclose(float(s_est), s, atol=1e-4)
        np.testing.assert_allclose(np.asarray(R_est), np.asarray(R), atol=1e-4)
        np.testing.assert_allclose(np.asarray(t_est), np.asarray(t), atol=1e-4)

    def test_umeyama_fixed_scale(self):
        key = jax.random.PRNGKey(9)
        src = jax.random.normal(key, (50, 3))
        R = se3.so3_exp(jnp.array([0.1, 0.2, -0.3]))
        t = jnp.array([1.0, 0.0, -0.5])
        dst = src @ R.T + t
        s_est, R_est, t_est = align.umeyama(src, dst, with_scale=False)
        assert float(s_est) == 1.0
        np.testing.assert_allclose(np.asarray(R_est), np.asarray(R), atol=1e-4)

    def test_umeyama_weighted_ignores_outliers(self):
        key = jax.random.PRNGKey(10)
        src = jax.random.normal(key, (60, 3))
        R = se3.so3_exp(jnp.array([0.0, 0.4, 0.0]))
        t = jnp.array([0.2, 0.3, 0.4])
        dst = src @ R.T + t
        dst = dst.at[:10].add(5.0)  # corrupt 10 points
        w = jnp.concatenate([jnp.zeros(10), jnp.ones(50)])
        _, R_est, t_est = align.umeyama(src, dst, weights=w, with_scale=False)
        np.testing.assert_allclose(np.asarray(R_est), np.asarray(R), atol=1e-4)
        np.testing.assert_allclose(np.asarray(t_est), np.asarray(t), atol=1e-4)

    def test_ate_rmse_zero_for_rigid_offset(self):
        key = jax.random.PRNGKey(11)
        gt = jnp.cumsum(jax.random.normal(key, (100, 3)) * 0.1, axis=0)
        R = se3.so3_exp(jnp.array([0.0, 0.0, 1.0]))
        est = gt @ R.T + jnp.array([5.0, 5.0, 5.0])
        rmse = align.ate_rmse(est, gt)
        assert float(rmse) < 1e-4
