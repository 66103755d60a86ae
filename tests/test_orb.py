import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_orb_slam.io import synthetic
from multi_orb_slam.ops import hamming, orb


def render_test_image(seed=0):
    world = synthetic.make_box_world(seed=seed, n_points=1500)
    K = np.array([520.0, 520.0, 320.0, 240.0], np.float32)
    Tcw = np.eye(4, dtype=np.float32)
    gray, depth = synthetic.render_rgbd(world, K, Tcw, 480, 640)
    return gray, depth


class TestHamming:
    def test_popcount(self):
        rng = np.random.RandomState(0)
        x = rng.randint(0, 2**32, size=100, dtype=np.uint64).astype(np.uint32)
        got = np.asarray(hamming.popcount32(jnp.asarray(x)))
        want = np.array([bin(int(v)).count("1") for v in x])
        np.testing.assert_array_equal(got, want)

    def test_pairwise(self):
        rng = np.random.RandomState(1)
        a = rng.randint(0, 2**32, size=(16, 8), dtype=np.uint64).astype(np.uint32)
        b = rng.randint(0, 2**32, size=(24, 8), dtype=np.uint64).astype(np.uint32)
        got = np.asarray(hamming.pairwise_hamming(jnp.asarray(a), jnp.asarray(b)))
        want = np.zeros((16, 24), np.int32)
        for i in range(16):
            for j in range(24):
                want[i, j] = sum(
                    bin(int(a[i, k]) ^ int(b[j, k])).count("1") for k in range(8)
                )
        np.testing.assert_array_equal(got, want)

    def test_masked_argmin2(self):
        d = jnp.array([[3, 1, 2], [9, 9, 9]], jnp.int32)
        m = jnp.array([[True, True, True], [True, False, True]])
        idx, best, second = hamming.masked_argmin2(d, m)
        assert int(idx[0]) == 1 and int(best[0]) == 1 and int(second[0]) == 2
        assert int(best[1]) == 9 and int(second[1]) == 9

    def test_mutual_best(self):
        d = jnp.array([[0, 5], [5, 0]], jnp.int32)
        m = jnp.ones((2, 2), bool)
        mj, bd = hamming.mutual_best(d, m)
        np.testing.assert_array_equal(np.asarray(mj), [0, 1])

    def test_rotation_histogram(self):
        # 95 matches at delta=0, 5 outliers at delta=pi (5 < 0.1*95 so the
        # outlier bin is dropped, per the reference's ComputeThreeMaxima rule)
        delta = jnp.concatenate([jnp.zeros(95), jnp.full((5,), jnp.pi)])
        mask = jnp.ones(100, bool)
        out = hamming.rotation_histogram_filter(delta, mask)
        assert bool(jnp.all(out[:95]))
        assert not bool(jnp.any(out[95:]))


class TestORB:
    def test_detects_corners(self):
        gray, _ = render_test_image()
        feats = orb.extract_orb(jnp.asarray(gray))
        n_valid = int(jnp.sum(feats.valid))
        assert n_valid > 500, f"only {n_valid} features"
        # all valid keypoints inside image
        xy = np.asarray(feats.xy)[np.asarray(feats.valid)]
        assert xy[:, 0].min() >= 0 and xy[:, 0].max() < 640
        assert xy[:, 1].min() >= 0 and xy[:, 1].max() < 480

    def test_level_distribution(self):
        gray, _ = render_test_image()
        feats = orb.extract_orb(jnp.asarray(gray))
        lv = np.asarray(feats.level)[np.asarray(feats.valid)]
        # coarse levels should still get some features
        assert (lv == 0).sum() > 100
        assert (lv >= 1).sum() > 50

    def test_translation_matching(self):
        gray, _ = render_test_image()
        shift = 12
        gray2 = np.full_like(gray, 100.0)
        gray2[:, shift:] = gray[:, :-shift]
        f1 = orb.extract_orb(jnp.asarray(gray))
        f2 = orb.extract_orb(jnp.asarray(gray2))
        d = hamming.pairwise_hamming(f1.desc, f2.desc)
        mask = f1.valid[:, None] & f2.valid[None, :]
        mj, bd = hamming.mutual_best(d, mask)
        mj = np.asarray(mj)
        bd = np.asarray(bd)
        xy1 = np.asarray(f1.xy)
        xy2 = np.asarray(f2.xy)
        matched = (mj >= 0) & (bd < hamming.TH_LOW)
        assert matched.sum() > 150, f"only {matched.sum()} strong matches"
        dx = xy2[mj[matched], 0] - xy1[matched, 0]
        dy = xy2[mj[matched], 1] - xy1[matched, 1]
        good = (np.abs(dx - shift) < 2.0) & (np.abs(dy) < 2.0)
        frac = good.mean()
        assert frac > 0.7, f"only {frac:.2f} of matches consistent with shift"

    def test_descriptor_determinism(self):
        gray, _ = render_test_image()
        f1 = orb.extract_orb(jnp.asarray(gray))
        f2 = orb.extract_orb(jnp.asarray(gray))
        np.testing.assert_array_equal(np.asarray(f1.desc), np.asarray(f2.desc))
        np.testing.assert_array_equal(np.asarray(f1.xy), np.asarray(f2.xy))


class TestFastScoreReference:
    # a plain shape, an odd pyramid level of 480x640 (level 6) and the
    # coarsest level of KITTI's 376x1241
    @pytest.mark.parametrize("shape", [(64, 96), (161, 214), (105, 346)])
    def test_matches_numpy_segment_test(self, shape):
        img = np.random.RandomState(sum(shape)).uniform(
            0, 255, shape).astype(np.float32)
        got = np.asarray(jax.jit(orb.fast_score)(jnp.asarray(img)))
        want = orb.fast_score_numpy(img)
        # the roll-based version wraps at the edges; the caller's border
        # mask hides the outer 3 px, so compare inside it, exactly
        np.testing.assert_array_equal(got[3:-3, 3:-3], want[3:-3, 3:-3])


def test_gather_patches_matches_numpy_at_borders():
    rng = np.random.RandomState(5)
    L, H, W, side = 3, 60, 80, 45
    canvas = rng.uniform(0, 255, (L, H, W)).astype(np.float32)
    # corners, edges and the interior; windows at the borders shift inside
    yc = np.array([0, 0, H - 1, H - 1, 30, 2, 57, 22, -4, H + 3], np.int32)
    xc = np.array([0, W - 1, 0, W - 1, 40, 40, 3, 79, 50, -6], np.int32)
    level = (np.arange(yc.size) % L).astype(np.int32)
    got = np.asarray(orb.gather_patches(
        jnp.asarray(canvas), jnp.asarray(level), jnp.asarray(yc),
        jnp.asarray(xc), side))
    for i, (l, y, x) in enumerate(zip(level, yc, xc)):
        y0 = min(max(y - side // 2, 0), H - side)
        x0 = min(max(x - side // 2, 0), W - side)
        np.testing.assert_array_equal(got[i], canvas[l, y0:y0 + side,
                                                     x0:x0 + side])


@pytest.mark.gpu
def test_extract_orb_on_gpu_matches_cpu(gpu):
    """Nearly all of the GPU's keypoints are the CPU's (the pyramid's
    resampling rounds differently, which can reorder near-tied corners);
    on those, descriptor bits may flip only where the TF32 blur lands on a
    comparison threshold."""
    gray, _ = render_test_image()
    cfg = orb.ORBConfig(n_features=1000)
    fg = jax.device_get(orb.extract_orb(jax.device_put(gray, gpu), cfg))
    fc = jax.device_get(orb.extract_orb(
        jax.device_put(gray, jax.devices("cpu")[0]), cfg))

    def keyed(f):
        return {(int(l), float(x), float(y)): d for l, (x, y), d, v in zip(
            f.level, f.xy, f.desc, f.valid) if v}

    kg, kc = keyed(fg), keyed(fc)
    common = sorted(set(kg) & set(kc))
    assert len(common) >= 0.95 * max(len(kg), len(kc))
    diff = np.stack([kg[k] ^ kc[k] for k in common])
    assert np.unpackbits(diff.view(np.uint8)).mean() <= 0.01
