"""Distributed place recognition: 1-vs-8-device numerics parity.

Mirrors test_dist_ba's scheme: the same sparse BoW scoring must produce
identical scores on a single device and sharded over the virtual 8-device
CPU mesh (conftest forces 8 host devices).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from multi_orb_slam.parallel import dist_placerec
from multi_orb_slam.placerec import vocabulary as vocab_mod


def make_db(K=32, B=64, n_words=5000, seed=0):
    rng = np.random.RandomState(seed)
    ids = np.full((K, B), -1, np.int32)
    vals = np.zeros((K, B), np.float32)
    for k in range(K):
        n = rng.randint(B // 2, B)
        w = rng.choice(n_words, n, replace=False).astype(np.int32)
        v = rng.rand(n).astype(np.float32)
        v /= v.sum()
        ids[k, :n] = w
        vals[k, :n] = v
    return jnp.asarray(ids), jnp.asarray(vals)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_dist_scores_match_single_device():
    n_words = 5000
    ids, vals = make_db(K=32, B=64, n_words=n_words)
    q_ids, q_vals = ids[5], vals[5]

    ref = vocab_mod.score_sparse_many(q_ids, q_vals, ids, vals, n_words)

    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    d_ids, d_vals = dist_placerec.shard_database(mesh, ids, vals)
    scorer = dist_placerec.make_dist_scorer(mesh, n_words)
    out = scorer(q_ids, q_vals, d_ids, d_vals)

    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    # sanity: the self-match is the best score and ~1.0
    assert int(jnp.argmax(out)) == 5
    assert abs(float(out[5]) - 1.0) < 1e-5
