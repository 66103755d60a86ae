"""Bag-of-binary-words vocabulary as dense arrays.

Replaces DBoW2's `TemplatedVocabulary<FORB>` (Thirdparty/DBoW2/DBoW2/
TemplatedVocabulary.h, ~1666 LoC): a k-ary tree of 256-bit centroids with
TF-IDF weights.  Array design:

- the tree is a [n_nodes, k] child table + [n_nodes, 8] uint32 centroids;
  `transform` descends all descriptors in parallel (L levels of Hamming
  argmin over k children — a handful of batched XOR/popcount passes)
- a frame/keyframe BoW vector is a dense [n_words] float (tf-idf,
  L1-normalized); similarity scoring of one query against every keyframe is
  a single matvec, replacing DBoW2's inverted-file walk
- vocabularies are trained with k-medians over binary descriptors
  (bit-majority centroids), the same scheme DBoW2's `create` uses

The reference ships a pre-trained 1M-word vocabulary (stripped from this
mirror, .MISSING_LARGE_BLOBS); instead we train small task-specific
vocabularies (build_vocabulary) which serve the same discriminative role
for loop closure / relocalization within a session.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import hamming


class Vocabulary(NamedTuple):
    children: jnp.ndarray   # [n_nodes, k] int32 child node ids (-1 none)
    node_desc: jnp.ndarray  # [n_nodes, 8] uint32 centroids
    word_id: jnp.ndarray    # [n_nodes] int32 word index for leaves (-1 inner)
    word_weight: jnp.ndarray  # [n_words] float32 idf weights
    k: int
    depth: int
    n_words: int


def _bit_majority(descs: np.ndarray) -> np.ndarray:
    """Majority vote per bit over [N, 8] uint32 -> [8] uint32 centroid
    (FORB::meanValue, Thirdparty/DBoW2/DBoW2/FORB.cpp)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=1)
    mean = bits.mean(axis=0) >= 0.5
    return np.packbits(mean.astype(np.uint8)).view(np.uint32)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = (a[:, None, :] ^ b[None, :, :]).view(np.uint8)
    return np.unpackbits(x, axis=-1).sum(-1)


def _kmedians(descs: np.ndarray, k: int, iters: int, rng) -> tuple:
    """Binary k-medians: returns (centroids [k', 8], assign [N])."""
    n = descs.shape[0]
    k = min(k, n)
    sel = rng.choice(n, k, replace=False)
    cent = descs[sel].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming_np(descs, cent)
        assign = d.argmin(1)
        for j in range(k):
            m = assign == j
            if m.any():
                cent[j] = _bit_majority(descs[m])
    return cent, assign


def build_vocabulary(
    descriptors: np.ndarray, k: int = 10, depth: int = 3,
    iters: int = 5, seed: int = 0, weight_descs: np.ndarray | None = None,
) -> Vocabulary:
    """Train a k^depth-word tree from [N, 8] uint32 descriptors."""
    rng = np.random.RandomState(seed)
    descriptors = np.asarray(descriptors, np.uint32)
    max_nodes = sum(k ** (l + 1) for l in range(depth)) + 1
    children = np.full((max_nodes, k), -1, np.int32)
    node_desc = np.zeros((max_nodes, 8), np.uint32)
    word_id = np.full(max_nodes, -1, np.int32)
    next_node = 1
    next_word = 0

    # BFS expansion
    queue = [(0, descriptors, 0)]  # (node, descs, level)
    while queue:
        node, descs, level = queue.pop(0)
        if level == depth or len(descs) <= 1:
            word_id[node] = next_word
            next_word += 1
            continue
        cent, assign = _kmedians(descs, k, iters, rng)
        for j in range(cent.shape[0]):
            m = assign == j
            if not m.any():
                continue
            cid = next_node
            next_node += 1
            children[node, j] = cid
            node_desc[cid] = cent[j]
            queue.append((cid, descs[m], level + 1))
    n_words = next_word

    voc = Vocabulary(
        children=jnp.asarray(children[:next_node]),
        node_desc=jnp.asarray(node_desc[:next_node]),
        word_id=jnp.asarray(word_id[:next_node]),
        word_weight=jnp.ones(n_words, jnp.float32),
        k=k, depth=depth, n_words=n_words,
    )
    # idf weights from the training corpus (TemplatedVocabulary::setWeights)
    train = weight_descs if weight_descs is not None else descriptors
    words = np.asarray(transform_words(voc, jnp.asarray(train)))
    n_docs_proxy = max(len(train), 1)
    counts = np.bincount(words, minlength=n_words).astype(np.float32)
    idf = np.log(n_docs_proxy / np.maximum(counts, 1.0) + 1.0)
    return voc._replace(word_weight=jnp.asarray(idf))


def transform_words(voc: Vocabulary, descs: jnp.ndarray,
                    beam: int = 3) -> jnp.ndarray:
    """Descend the tree: [N, 8] descriptors -> [N] word ids.

    Beam search (default width 3) instead of DBoW2's greedy descent: a
    descriptor near a decision boundary at an upper level otherwise lands
    in an entirely different subtree under small appearance change, which
    is the dominant failure mode of place recognition across revisits —
    the beam keeps the candidate subtrees alive and picks the closest
    LEAF centroid, a strictly better quantizer at ~beam x the (tiny)
    transform cost.  beam=1 reproduces the reference's greedy descent.
    """
    n = descs.shape[0]
    k = voc.children.shape[1]
    BIGD = jnp.int32(1 << 20)
    nodes = jnp.zeros((n, beam), jnp.int32)       # beam of live nodes
    # invalid beam slots point at node 0 with +inf distance
    dist = jnp.full((n, beam), BIGD).at[:, 0].set(0)
    for _ in range(voc.depth):
        ch = voc.children[nodes]                   # [N, B, k]
        ch_safe = jnp.clip(ch, 0, voc.children.shape[0] - 1)
        cd = voc.node_desc[ch_safe]                # [N, B, k, 8]
        d = jnp.sum(hamming.popcount32(
            jnp.bitwise_xor(cd, descs[:, None, None, :])), axis=-1)
        # children of exhausted/invalid slots: carry the node itself (a
        # leaf reached above this level keeps competing with its distance)
        d = jnp.where((ch >= 0) & (dist[..., None] < BIGD), d, BIGD)
        cand_nodes = jnp.where(ch >= 0, ch, nodes[..., None])
        leaf_self = jnp.all(ch < 0, axis=-1) & (dist < BIGD)  # [N, B]
        d_self = jnp.where(leaf_self, dist, BIGD)
        flat_d = jnp.concatenate([d.reshape(n, beam * k), d_self], axis=1)
        flat_n = jnp.concatenate(
            [cand_nodes.reshape(n, beam * k), nodes], axis=1)
        top_d, top_i = jax.lax.top_k(-flat_d, beam)
        dist = -top_d
        nodes = jnp.take_along_axis(flat_n, top_i, axis=1)
    best = jnp.argmin(dist, axis=1)
    node = jnp.take_along_axis(nodes, best[:, None], axis=1)[:, 0]
    w = voc.word_id[node]
    return jnp.where(w >= 0, w, 0)


def bow_vector(voc: Vocabulary, descs: jnp.ndarray,
               valid: jnp.ndarray) -> jnp.ndarray:
    """[F, 8] descriptors (+mask) -> L1-normalized tf-idf vector [n_words].

    Replaces `transform(features, BowVector, ...)` + the BowVector map
    (reference include/ORBVocabulary.h:26-34 usage)."""
    words = transform_words(voc, descs)
    tgt = jnp.where(valid, words, voc.n_words - 1)
    v = jnp.zeros(voc.n_words, jnp.float32).at[tgt].add(
        jnp.where(valid, 1.0, 0.0))
    v = v * voc.word_weight
    n = jnp.sum(jnp.abs(v))
    return v / jnp.maximum(n, 1e-9)


def score_l1(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 score in [0, 1] (ScoringObject.cpp L1Scoring):
    s = 1 - 0.5 * |va - vb|_1 for L1-normalized va, vb.
    Broadcasts: a [..., W], b [..., W]."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(a - b), axis=-1)


def bow_sparse(voc: Vocabulary, descs: jnp.ndarray, valid: jnp.ndarray,
               budget: int | None = None):
    """[F, 8] descriptors (+mask) -> sparse L1-normalized tf-idf vector.

    Returns (word ids [B] int32 with -1 padding, values [B] float32).
    A frame has at most F distinct words, so a [B = F] budget is lossless —
    this is what lets the database scale to DBoW2's 10^6-word vocabularies
    without any [K, n_words] dense store.  Built with a sort + segment-sum
    (no [n_words]-sized intermediate).
    """
    F = descs.shape[0]
    B = budget or F
    words = transform_words(voc, descs)
    w = jnp.where(valid, voc.word_weight[words], 0.0)
    key = jnp.where(valid, words, jnp.int32(1 << 30))
    order = jnp.argsort(key)
    sw = key[order]
    sv = w[order]
    # segment sums over runs of equal word id
    csum = jnp.cumsum(sv)
    last = jnp.concatenate([sw[1:] != sw[:-1], jnp.ones(1, bool)])
    # compact: gather run ends in order (padding indices repeat the final
    # run end, whose differenced value is exactly 0 — harmless)
    idx_end = jnp.nonzero(last, size=F, fill_value=F - 1)[0]
    run_word = sw[idx_end]
    ends = csum[idx_end]
    starts = jnp.concatenate([jnp.zeros(1, ends.dtype), ends[:-1]])
    run_val = ends - starts
    ok = run_word < (1 << 30)
    total = jnp.sum(jnp.where(ok, run_val, 0.0))
    run_val = jnp.where(ok, run_val / jnp.maximum(total, 1e-9), 0.0)
    ids = jnp.where(ok, run_word, -1)
    if B > F:
        ids = jnp.concatenate([ids, jnp.full(B - F, -1, ids.dtype)])
        run_val = jnp.concatenate([run_val, jnp.zeros(B - F, run_val.dtype)])
    return ids[:B].astype(jnp.int32), run_val[:B].astype(jnp.float32)


def score_sparse_many(q_ids, q_vals, db_ids, db_vals, n_words: int):
    """L1 score of one sparse query against a [K, B] sparse database.

    For L1-normalized non-negative vectors,
      1 - 0.5*|a-b|_1  =  0.5 * sum_shared (a_i + b_i - |a_i - b_i|),
    so only shared words contribute: scatter the query dense once
    ([n_words] floats — a few MB even at 10^6 words), gather it at every
    stored word id, reduce per row.  Replaces the inverted-file walk of
    KeyFrameDatabase with one gather + row-sum.
    """
    qd = jnp.zeros(n_words + 1, q_vals.dtype).at[
        jnp.where(q_ids >= 0, q_ids, n_words)].add(
            jnp.where(q_ids >= 0, q_vals, 0.0))
    ok = db_ids >= 0
    qg = qd[jnp.where(ok, db_ids, n_words)]
    v = jnp.where(ok, db_vals, 0.0)
    contrib = qg + v - jnp.abs(qg - v)
    return 0.5 * jnp.sum(jnp.where(ok, contrib, 0.0), axis=-1)


def load_dbow2_text(path: str) -> Vocabulary:
    """Load a DBoW2 text-format vocabulary (ORBvoc.txt).

    Parses the exact format of TemplatedVocabulary::loadFromTextFile
    (reference Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1339-1421):
    header "k L scoring weighting", then one BFS-ordered node line
    "parent is_leaf d0..d31 weight".  This makes any vocabulary usable by
    the reference binary (including its shipped 1M-word ORBvoc.txt) usable
    here, and vice versa (tools/make_ref_vocab.py emits the same format).
    """
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        parents, leaves, descs, weights = [], [], [], []
        for line in f:
            v = line.split()
            if len(v) < 35:
                continue
            parents.append(int(v[0]))
            leaves.append(int(v[1]))
            descs.append([int(x) for x in v[2:34]])
            weights.append(float(v[34]))
    n = len(parents)
    parents_np = np.asarray(parents, np.int64)
    # text file omits the root: node ids are 1-based relative to the file
    children = np.full((n + 1, k), -1, np.int32)
    node_desc = np.zeros((n + 1, 8), np.uint32)
    word_id = np.full(n + 1, -1, np.int32)
    child_count = np.zeros(n + 1, np.int32)
    w_leaf = []
    next_word = 0
    for i in range(n):
        nid = i + 1
        p = parents_np[i]
        children[p, child_count[p]] = nid
        child_count[p] += 1
        node_desc[nid] = np.packbits(
            np.unpackbits(np.asarray(descs[i], np.uint8))).view(np.uint32)
        if leaves[i]:
            word_id[nid] = next_word
            w_leaf.append(weights[i])
            next_word += 1
    return Vocabulary(
        children=jnp.asarray(children),
        node_desc=jnp.asarray(node_desc),
        word_id=jnp.asarray(word_id),
        word_weight=jnp.asarray(np.asarray(w_leaf, np.float32)),
        k=k, depth=depth, n_words=next_word,
    )
