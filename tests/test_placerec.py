import jax
import jax.numpy as jnp
import numpy as np

from multi_orb_slam.geometry import se3, sim3
from multi_orb_slam.loop import sim3_solver
from multi_orb_slam.optim import pose_graph
from multi_orb_slam.placerec import vocabulary as vocab_mod


def random_descs(rng, n):
    return rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def perturb_descs(rng, descs, n_bits):
    """Flip n_bits random bits in each descriptor."""
    out = descs.copy()
    for i in range(len(out)):
        for _ in range(n_bits):
            w = rng.randint(8)
            b = rng.randint(32)
            out[i, w] ^= np.uint32(1 << b)
    return out


class TestVocabulary:
    def test_build_and_transform(self):
        rng = np.random.RandomState(0)
        descs = random_descs(rng, 2000)
        voc = vocab_mod.build_vocabulary(descs, k=5, depth=3)
        assert voc.n_words > 50
        words = np.asarray(vocab_mod.transform_words(voc, jnp.asarray(descs[:100])))
        assert (words >= 0).all() and (words < voc.n_words).all()

    def test_similar_images_score_higher(self):
        rng = np.random.RandomState(1)
        corpus = random_descs(rng, 3000)
        voc = vocab_mod.build_vocabulary(corpus, k=6, depth=3)
        img_a = corpus[:300]
        img_a_noisy = perturb_descs(rng, img_a, 8)   # same place, slight noise
        img_b = corpus[1000:1300]                     # different place
        ones = jnp.ones(300, bool)
        va = vocab_mod.bow_vector(voc, jnp.asarray(img_a), ones)
        va2 = vocab_mod.bow_vector(voc, jnp.asarray(img_a_noisy), ones)
        vb = vocab_mod.bow_vector(voc, jnp.asarray(img_b), ones)
        s_same = float(vocab_mod.score_l1(va, va2))
        s_diff = float(vocab_mod.score_l1(va, vb))
        assert s_same > s_diff + 0.2, (s_same, s_diff)

    def test_score_range(self):
        rng = np.random.RandomState(2)
        corpus = random_descs(rng, 1000)
        voc = vocab_mod.build_vocabulary(corpus, k=5, depth=2)
        ones = jnp.ones(100, bool)
        v = vocab_mod.bow_vector(voc, jnp.asarray(corpus[:100]), ones)
        assert abs(float(vocab_mod.score_l1(v, v)) - 1.0) < 1e-5


class TestSim3Solver:
    def test_recovers_transform_with_outliers(self):
        rng = np.random.RandomState(3)
        n = 128
        pts_b = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        pts_b[:, 2] += 4.0
        R = np.asarray(se3.so3_exp(jnp.asarray([0.1, 0.4, -0.2])))
        t = np.array([0.5, -0.2, 0.3], np.float32)
        g_true = sim3.pack(jnp.asarray(1.0), jnp.asarray(R), jnp.asarray(t))
        pts_a = pts_b @ R.T + t
        # 25% outliers
        n_out = n // 4
        pts_a[:n_out] += rng.uniform(1.0, 2.0, (n_out, 3))
        K = jnp.asarray([[400.0, 400.0, 320.0, 240.0]])
        T_rc = jnp.eye(4)[None]
        g, inl, n_inl = sim3_solver.solve_sim3_ransac(
            jax.random.PRNGKey(0),
            jnp.asarray(pts_a), jnp.asarray(pts_b),
            jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
            jnp.ones(n, bool), T_rc, K,
        )
        assert int(n_inl) > 0.6 * (n - n_out)
        # check recovered transform on clean points
        x = jnp.asarray(pts_b[n_out:])
        err = jnp.linalg.norm(sim3.apply(g, x) - jnp.asarray(pts_b[n_out:] @ R.T + t), axis=-1)
        assert float(jnp.median(err)) < 0.02


class TestPoseGraph:
    def test_closes_drift(self):
        # chain of 20 poses with accumulated drift; loop edge to the start
        K = 24
        rng = np.random.RandomState(4)
        g_true = [np.asarray(sim3.identity())]
        step = np.asarray(sim3.exp(jnp.asarray([0.5, 0, 0, 0, 0.1, 0, 0])))
        for i in range(1, 20):
            g_true.append(np.asarray(sim3.compose(jnp.asarray(step), jnp.asarray(g_true[-1]))))
        g_true = np.stack(g_true + [np.asarray(sim3.identity())] * (K - 20))

        # drifted estimates: small error each step accumulates
        g_est = [g_true[0]]
        for i in range(1, 20):
            noise = sim3.exp(jnp.asarray(
                np.concatenate([rng.randn(6) * 0.02, [0.0]]).astype(np.float32)))
            rel = sim3.compose(jnp.asarray(g_true[i]), sim3.inverse(jnp.asarray(g_true[i - 1])))
            g_est.append(np.asarray(sim3.compose(
                sim3.compose(noise, rel), jnp.asarray(g_est[-1]))))
        g_est = np.stack(g_est + [np.asarray(sim3.identity())] * (K - 20))

        kf_free = np.zeros(K, bool)
        kf_free[1:20] = True
        # edges: consecutive (measurements from TRUE relative poses = odometry
        # beliefs) + loop edge 19 -> 0 with the true relative pose
        E = 64
        ei = np.zeros(E, np.int32)
        ej = np.zeros(E, np.int32)
        meas = np.tile(np.asarray(sim3.identity()), (E, 1))
        ok = np.zeros(E, bool)
        n = 0
        for i in range(19):
            ei[n], ej[n] = i, i + 1
            meas[n] = np.asarray(sim3.compose(
                jnp.asarray(g_true[i + 1]), sim3.inverse(jnp.asarray(g_true[i]))))
            ok[n] = True
            n += 1
        ei[n], ej[n] = 0, 19
        meas[n] = np.asarray(sim3.compose(
            jnp.asarray(g_true[19]), sim3.inverse(jnp.asarray(g_true[0]))))
        ok[n] = True

        g_opt = pose_graph.optimize_essential_graph(
            jnp.asarray(g_est), jnp.asarray(kf_free),
            jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(meas),
            jnp.asarray(ok), n_iters=25,
        )

        def traj_err(g_arr):
            errs = []
            for i in range(20):
                d = sim3.log(sim3.compose(
                    jnp.asarray(g_arr[i]), sim3.inverse(jnp.asarray(g_true[i]))))
                errs.append(float(jnp.linalg.norm(d)))
            return np.mean(errs)

        e_before = traj_err(g_est)
        e_after = traj_err(np.asarray(g_opt))
        assert e_after < 0.3 * e_before, (e_before, e_after)

    def test_fixed_vertex_unchanged(self):
        K = 8
        g = np.tile(np.asarray(sim3.identity()), (K, 1))
        g[1] = np.asarray(sim3.exp(jnp.asarray([1, 0, 0, 0, 0, 0, 0.0])))
        kf_free = np.ones(K, bool)
        kf_free[0] = False
        ei = np.asarray([0], np.int32)
        ej = np.asarray([1], np.int32)
        meas = np.asarray(sim3.identity())[None]
        ok = np.ones(1, bool)
        g_opt = pose_graph.optimize_essential_graph(
            jnp.asarray(g), jnp.asarray(kf_free), jnp.asarray(ei),
            jnp.asarray(ej), jnp.asarray(meas), jnp.asarray(ok), n_iters=10)
        np.testing.assert_allclose(np.asarray(g_opt[0]), g[0], atol=1e-6)
        # vertex 1 pulled toward identity-relative measurement
        d = float(jnp.linalg.norm(sim3.log(sim3.compose(
            jnp.asarray(g_opt[1]), sim3.inverse(jnp.asarray(g[0]))))))
        assert d < 0.1


class TestMultihostHelpers:
    def test_single_process_noop_and_mesh(self):
        from multi_orb_slam.parallel import multihost
        multihost.initialize()  # no-op without coordinator env
        mesh = multihost.global_mesh()
        assert mesh.devices.size >= 1
        assert mesh.axis_names == ("data",)
