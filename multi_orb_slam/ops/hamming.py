"""Batched Hamming distance and masked matching primitives.

Replaces the reference's scalar `DescriptorDistance` popcount loop
(src/ORBmatcher.cc:3994-4018) and the per-point argmin searches inside the 18
ORBmatcher methods with dense masked matrix ops.  Descriptors are [N, 8]
uint32 (256 bits).

Thresholds mirror the reference (src/ORBmatcher.cc:36-38):
TH_HIGH = 100, TH_LOW = 50, HISTO_LENGTH = 30.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30

BIG = jnp.int32(1 << 20)  # sentinel distance for masked entries


def popcount32(x: jnp.ndarray) -> jnp.ndarray:
    """Per-lane popcount of uint32 via SWAR bit tricks."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def hamming_distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise Hamming distance between (..., 8) descriptor pairs."""
    return jnp.sum(popcount32(jnp.bitwise_xor(a, b)), axis=-1)


def unpack_pm1(d: jnp.ndarray) -> jnp.ndarray:
    """[..., 8] uint32 descriptors -> [..., 256] bf16 in {-1, +1}."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (d[..., :, None] >> shifts) & jnp.uint32(1)   # [..., 8, 32]
    pm1 = bits.astype(jnp.bfloat16) * 2 - 1
    return pm1.reshape(d.shape[:-1] + (256,))


def pairwise_hamming(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming distances: a [N, 8], b [M, 8] -> [N, M] int32.

    Computed as a matmul: with descriptors unpacked to s in {-1,+1}^256,
    <s_a, s_b> = 256 - 2*hamming, so one [N, 256] @ [256, M] product gives
    every distance exactly (products are +-1; partial sums <= 256 are exact
    in bf16 inputs with f32 accumulation), instead of an XOR+popcount
    reduction over [N, M, 8].
    """
    pa = unpack_pm1(a)
    pb = unpack_pm1(b)
    # explicit DEFAULT precision: +-1 products are exact in bf16 with f32
    # accumulation, so the package-wide float32 matmul default (needed for
    # geometry) would only slow the hottest matmul of the system (every
    # SearchBy* call) for no accuracy
    dot = jnp.dot(pa, pb.T, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.DEFAULT)
    return ((256.0 - dot) * 0.5).astype(jnp.int32)


def masked_argmin2(
    dist: jnp.ndarray, mask: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-row best and second-best over masked columns.

    Returns (best_idx [N], best_dist [N], second_dist [N]).  Masked-out
    entries read as BIG.  This is the core of every SearchBy* ratio test
    (e.g. reference src/ORBmatcher.cc:124-143 bestDist/bestDist2 logic).
    """
    d = jnp.where(mask, dist, BIG)
    best_idx = jnp.argmin(d, axis=-1)
    best = jnp.take_along_axis(d, best_idx[..., None], axis=-1)[..., 0]
    d2 = jnp.where(
        jax.nn.one_hot(best_idx, d.shape[-1], dtype=bool), BIG, d
    )
    second = jnp.min(d2, axis=-1)
    return best_idx, best, second


def mutual_best(dist: jnp.ndarray, mask: jnp.ndarray):
    """Cross-check matching: i<->j only if each is the other's best.

    Returns (match_j [N] int32 with -1 for unmatched, best_dist [N]).
    """
    d = jnp.where(mask, dist, BIG)
    best_j = jnp.argmin(d, axis=1)
    best_i = jnp.argmin(d, axis=0)
    n = d.shape[0]
    rows = jnp.arange(n)
    ok = best_i[best_j] == rows
    bd = jnp.take_along_axis(d, best_j[:, None], axis=1)[:, 0]
    ok = ok & (bd < BIG)
    return jnp.where(ok, best_j, -1), bd


def rotation_histogram_filter(
    angle_delta: jnp.ndarray, match_mask: jnp.ndarray, n_bins: int = HISTO_LENGTH,
    keep_top: int = 3,
) -> jnp.ndarray:
    """Rotation-consistency check used by every matcher in the reference
    (e.g. src/ORBmatcher.cc:3600-3639 ComputeThreeMaxima): histogram the
    per-match angle difference, keep only matches in the top-3 bins.

    Args:
      angle_delta: [N] radians (cur_angle - ref_angle).
      match_mask: [N] bool, which rows are candidate matches.

    Returns: [N] bool mask of surviving matches.
    """
    two_pi = 2.0 * jnp.pi
    frac = jnp.mod(angle_delta, two_pi) / two_pi  # [0, 1)
    bins = jnp.clip((frac * n_bins).astype(jnp.int32), 0, n_bins - 1)
    counts = jnp.zeros(n_bins, jnp.int32).at[bins].add(match_mask.astype(jnp.int32))
    top_vals, top_idx = jax.lax.top_k(counts, keep_top)
    # mimic reference: drop bins 2,3 if much smaller than bin 1
    # (ComputeThreeMaxima: if max2 < 0.1*max1 -> ind2 invalid, same for max3)
    limit = 0.1 * top_vals[0].astype(jnp.float32)
    keep_bin_valid = top_vals.astype(jnp.float32) >= limit
    in_top = jnp.zeros(n_bins, bool).at[top_idx].set(keep_bin_valid)
    return match_mask & in_top[bins]
