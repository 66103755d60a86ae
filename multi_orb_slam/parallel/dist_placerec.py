"""Distributed place recognition over a device mesh.

SURVEY §2.4 north star: in a multi-host deployment each host tracks its own
camera rig and owns a shard of the keyframe database; loop/relocalization
queries must be scored against EVERY host's keyframes.  The reference has
no equivalent (single-process inverted file, src/KeyFrameDatabase.cc).

Design: the sparse BoW store (placerec/database.py: word ids + tf-idf
values, [K, B] per shard) is sharded along the keyframe axis; a query is
replicated.  Each device scores its local block with the same
scatter+gather kernel used on one chip (`vocabulary.score_sparse_many`),
then one `all_gather` of the [K_local] score vectors — a few KB — makes
the full score table visible everywhere.  No BoW matrices ever
move between devices; only scores do.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..placerec import vocabulary as vocab_mod


def make_dist_scorer(mesh: Mesh, n_words: int, axis: str = "data"):
    """Returns score(q_ids, q_vals, db_ids, db_vals) -> [K] scores.

    db_ids/db_vals are [K, B] sharded along axis 0 on `axis`; the query is
    replicated.  Output is the replicated full score vector (every device
    sees all K scores after the all_gather).
    """

    def local_score(q_ids, q_vals, db_ids, db_vals):
        s = vocab_mod.score_sparse_many(
            q_ids, q_vals, db_ids, db_vals, n_words)   # [K_local]
        return jax.lax.all_gather(s, axis, tiled=True)  # [K]

    fn = shard_map(
        local_score, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,  # the tiled all_gather makes the output replicated
    )
    return jax.jit(fn)


def shard_database(mesh: Mesh, db_ids, db_vals, axis: str = "data"):
    """Place the [K, B] sparse BoW store across the mesh's keyframe shards."""
    sh = NamedSharding(mesh, P(axis))
    return jax.device_put(db_ids, sh), jax.device_put(db_vals, sh)
