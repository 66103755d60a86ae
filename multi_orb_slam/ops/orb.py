"""ORB feature extraction, batched over pyramid levels.

Functional re-design of the reference extractor (src/ORBextractor.cc):

- 8-level x1.2 image pyramid (reference: ORBextractor.cc:1109-1134)
- FAST-16 corner scoring per pixel, fully vectorized over the image instead
  of per-cell scalar loops (reference: ComputeKeyPointsOctTree,
  ORBextractor.cc:766-855)
- spatially-uniform selection via per-cell top-K + global top-N, replacing the
  inherently sequential quadtree `DistributeOctTree`
  (reference: ORBextractor.cc:540-765) with an equal-capability batched op
- intensity-centroid orientation (reference: IC_Angle, ORBextractor.cc:77-104)
- Gaussian blur + 256-bit steered BRIEF (reference: computeOrbDescriptor,
  ORBextractor.cc:105-150).  The sampling pattern is our own deterministic
  Gaussian pattern (seeded), NOT OpenCV's learned `bit_pattern_31_`: the whole
  stack (matching, vocabulary) is self-consistent, so bit-parity with OpenCV
  is not required, only discriminability.

Everything uses fixed capacities + validity masks (XLA static shapes).
Outputs are in level-0 (full resolution) pixel coordinates.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


class ORBConfig(NamedTuple):
    n_features: int = 1024          # per camera (multi.yaml: 1000 cam1 / 500 cam2)
    n_levels: int = 8               # multi.yaml ORBextractor.nLevels
    scale_factor: float = 1.2       # multi.yaml ORBextractor.scaleFactor
    fast_threshold: float = 20.0    # iniThFAST (multi.yaml:53)
    fast_threshold_min: float = 7.0 # minThFAST (multi.yaml:54)
    cell_size: int = 32             # selection cell, ~reference's 30-35px cells
    cell_top_k: int = 8             # candidates kept per cell before global top-N
    edge_margin: int = 19           # EDGE_THRESHOLD in the reference


def pyramid_shapes(height: int, width: int, cfg: ORBConfig) -> list[tuple[int, int]]:
    shapes = []
    for lvl in range(cfg.n_levels):
        s = cfg.scale_factor ** lvl
        shapes.append((max(int(round(height / s)), 32), max(int(round(width / s)), 32)))
    return shapes


def level_feature_counts(cfg: ORBConfig) -> list[int]:
    """Per-level feature budget, geometric decay as in the reference
    (ORBextractor.cc:1118-1133)."""
    factor = 1.0 / cfg.scale_factor
    n_desired = cfg.n_features * (1.0 - factor) / (1.0 - factor ** cfg.n_levels)
    counts, total = [], 0
    for lvl in range(cfg.n_levels - 1):
        c = int(round(n_desired * factor ** lvl))
        counts.append(c)
        total += c
    counts.append(max(cfg.n_features - total, 0))
    return counts


# ---------------------------------------------------------------------------
# Deterministic BRIEF pattern (our own, not OpenCV's learned table)
# ---------------------------------------------------------------------------


def make_brief_pattern(seed: int = 1234, n_bits: int = 256, patch_radius: int = 13):
    """256 point pairs ~ N(0, (patch/5)^2), clipped into the patch.

    ORB paper's random-Gaussian BRIEF variant; rejection-sample pairs that are
    too close together to carry signal.
    """
    rng = np.random.RandomState(seed)
    sigma = patch_radius / 2.0
    pairs = np.zeros((n_bits, 4), np.float32)
    count = 0
    while count < n_bits:
        p = rng.randn(4) * sigma
        p = np.clip(p, -patch_radius, patch_radius)
        if (p[0] - p[2]) ** 2 + (p[1] - p[3]) ** 2 < 4.0:
            continue
        pairs[count] = p
        count += 1
    return jnp.asarray(pairs)  # [256, 4] = (x1, y1, x2, y2)


BRIEF_PATTERN = make_brief_pattern()

# --- quantized-rotation BRIEF as one-hot matmul weights -------------------
# The steered BRIEF is computed as PATCH @ W[bin] instead of 512 random
# per-keypoint gathers: the angle is quantized to N_ROT bins (the ORB
# paper's 2*pi/30 discretization) and each bin's difference-of-one-hots
# matrix turns the 256 comparisons into one matmul over the gathered patch.
N_ROT = 30
DESC_PATCH_R = 19  # covers rotated pattern offsets (13 * sqrt(2) ~ 18.4)


def _make_rot_weights(pattern: np.ndarray, n_rot: int, radius: int):
    side = 2 * radius + 1
    W = np.zeros((n_rot, side * side, 256), np.float32)
    pat = np.asarray(pattern)
    for b in range(n_rot):
        th = 2.0 * np.pi * b / n_rot
        ca, sa = np.cos(th), np.sin(th)
        for s in range(256):
            x1, y1, x2, y2 = pat[s]
            for (px, py, sign) in ((x1, y1, -1.0), (x2, y2, 1.0)):
                rx = int(round(ca * px - sa * py))
                ry = int(round(sa * px + ca * py))
                rx = int(np.clip(rx, -radius, radius))
                ry = int(np.clip(ry, -radius, radius))
                W[b, (ry + radius) * side + (rx + radius), s] += sign
    return W


ROT_BRIEF_W = jnp.asarray(
    _make_rot_weights(np.asarray(BRIEF_PATTERN), N_ROT, DESC_PATCH_R),
    jnp.bfloat16,
)


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------


def build_pyramid(img: jnp.ndarray, cfg: ORBConfig) -> list[jnp.ndarray]:
    """Grayscale [H, W] float32 -> list of [H_l, W_l] per level."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, cfg)
    out = [img]
    for lvl in range(1, cfg.n_levels):
        out.append(
            jax.image.resize(img, shapes[lvl], method="bilinear", antialias=True)
        )
    return out


# ---------------------------------------------------------------------------
# FAST corner score (vectorized over the whole image)
# ---------------------------------------------------------------------------

# Bresenham circle of radius 3, 16 offsets in order (dy, dx)
_FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def fast_score(img: jnp.ndarray) -> jnp.ndarray:
    """Segment-test corner strength per pixel.

    score(p) = max(max_k min_{j in arc9(k)} (I_j - I_p),
                   max_k min_{j in arc9(k)} (I_p - I_j))
    i.e. the largest threshold t for which p passes the FAST-9/16 test — the
    same quantity OpenCV's FAST score computes by binary search
    (used via cv::FAST at reference ORBextractor.cc:822,839).
    """
    h, w = img.shape
    # circle samples via static rolls (shifted copies); border handled by caller
    ring = jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(0, 1)) for dy, dx in _FAST_OFFSETS],
        axis=0,
    )  # [16, H, W]
    d = ring - img[None, :, :]  # I_j - I_p
    # min over each arc of 9 consecutive samples (16 wrapped arcs)
    d2 = jnp.concatenate([d, d[:8]], axis=0)  # [24, H, W]
    # windows of 9: use cummin-style stacked minimum
    arc_min = d2[:16]
    for j in range(1, 9):
        arc_min = jnp.minimum(arc_min, d2[j : j + 16])
    bright = jnp.max(arc_min, axis=0)  # largest t with all arc samples > I_p + t
    arc_max = d2[:16]
    for j in range(1, 9):
        arc_max = jnp.maximum(arc_max, d2[j : j + 16])
    dark = jnp.max(-arc_max, axis=0)
    return jnp.maximum(bright, dark)


def fast_score_numpy(img: np.ndarray) -> np.ndarray:
    """Plain-numpy FAST-9/16 segment test, the reference for `fast_score`.

    For every pixel and each of the 16 wrapped runs of 9 contiguous ring
    samples, the largest t with every sample > I_p + t (or < I_p - t).
    Pixels whose ring leaves the image read zeros; compare >= 3 px inside.
    """
    img = np.asarray(img, np.float32)
    h, w = img.shape
    pad = np.pad(img, 3)
    ring = np.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                     for dy, dx in _FAST_OFFSETS]) - img   # [16, H, W]
    score = np.full((h, w), -np.inf, np.float32)
    for k in range(16):
        arc = ring[[(k + j) % 16 for j in range(9)]]
        score = np.maximum(score, np.maximum(arc.min(0), -arc.max(0)))
    return score


def _maxpool3x3(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )


# ---------------------------------------------------------------------------
# Per-level detection: per-cell top-K + global top-N
# ---------------------------------------------------------------------------


def detect_level(
    img_l: jnp.ndarray,
    n_target: int,
    cfg: ORBConfig,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Detect up to n_target FAST corners on one pyramid level.

    Returns (xy [n_target, 2] float32 level coords, response [n_target],
    valid [n_target] bool).
    """
    h, w = img_l.shape
    score = fast_score(img_l)
    # 3x3 non-max suppression
    is_max = score >= _maxpool3x3(score)
    score = jnp.where(is_max, score, 0.0)
    # threshold: keep >= min threshold (the ini/min two-phase of the
    # reference collapses into ranking: strong corners outrank fallbacks)
    score = jnp.where(score >= cfg.fast_threshold_min, score, 0.0)
    # border mask
    m = cfg.edge_margin
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    inb = (yy >= m) & (yy < h - m) & (xx >= m) & (xx < w - m)
    score = jnp.where(inb, score, 0.0)

    # prefer strong (>= iniThFAST) corners over fallbacks regardless of raw
    # magnitude, mirroring the reference's two-pass per-cell detection
    rank = jnp.where(score >= cfg.fast_threshold, score + 1e4, score)

    # pad to multiple of cell size
    cs = cfg.cell_size
    ph = (cs - h % cs) % cs
    pw = (cs - w % cs) % cs
    rank_p = jnp.pad(rank, ((0, ph), (0, pw)))
    hp, wp = h + ph, w + pw
    ncy, ncx = hp // cs, wp // cs
    cells = rank_p.reshape(ncy, cs, ncx, cs).transpose(0, 2, 1, 3).reshape(
        ncy * ncx, cs * cs
    )
    k = min(cfg.cell_top_k, cs * cs)
    cell_vals, cell_idx = jax.lax.top_k(cells, k)  # [ncells, k]
    # convert to absolute coords
    cell_ids = jnp.arange(ncy * ncx)
    cy = (cell_ids // ncx)[:, None]
    cx = (cell_ids % ncx)[:, None]
    iy = cy * cs + cell_idx // cs
    ix = cx * cs + cell_idx % cs
    flat_vals = cell_vals.reshape(-1)
    flat_y = iy.reshape(-1)
    flat_x = ix.reshape(-1)
    # global top-N over candidates
    n_cand = flat_vals.shape[0]
    n_take = min(n_target, n_cand)
    top_vals, top_i = jax.lax.top_k(flat_vals, n_take)
    sel_y = flat_y[top_i].astype(jnp.float32)
    sel_x = flat_x[top_i].astype(jnp.float32)
    valid = top_vals > 0.0
    resp = jnp.where(top_vals >= 1e4, top_vals - 1e4, top_vals)
    xy = jnp.stack([sel_x, sel_y], axis=-1)
    if n_take < n_target:
        pad = n_target - n_take
        xy = jnp.concatenate([xy, jnp.zeros((pad, 2))], axis=0)
        resp = jnp.concatenate([resp, jnp.zeros(pad)], axis=0)
        valid = jnp.concatenate([valid, jnp.zeros(pad, bool)], axis=0)
    return xy, resp, valid


# ---------------------------------------------------------------------------
# Orientation (intensity centroid) + descriptors (steered BRIEF)
# ---------------------------------------------------------------------------

_PATCH_R = 15  # HALF_PATCH_SIZE in the reference (ORBextractor.cc:52)


def _gather_patches(img: jnp.ndarray, xy: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Gather (2r+1)^2 patches around integer keypoint coords, clipped."""
    h, w = img.shape
    d = jnp.arange(-radius, radius + 1)
    dy = d[:, None]
    dx = d[None, :]
    y = jnp.clip(xy[:, 1].astype(jnp.int32)[:, None, None] + dy[None], 0, h - 1)
    x = jnp.clip(xy[:, 0].astype(jnp.int32)[:, None, None] + dx[None], 0, w - 1)
    return img[y, x]  # [N, 2r+1, 2r+1]


def ic_angles(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation in radians (reference IC_Angle,
    ORBextractor.cc:77-104: circular patch of radius 15)."""
    r = _PATCH_R
    patches = _gather_patches(img, xy, r)  # [N, 31, 31]
    d = jnp.arange(-r, r + 1).astype(jnp.float32)
    yy = d[:, None]
    xx = d[None, :]
    circ = (yy * yy + xx * xx) <= r * r
    pc = patches * circ[None]
    m10 = jnp.sum(pc * xx[None], axis=(1, 2))
    m01 = jnp.sum(pc * yy[None], axis=(1, 2))
    return jnp.arctan2(m01, m10)


def gaussian_blur7(img: jnp.ndarray, sigma: float = 2.0) -> jnp.ndarray:
    """Separable 7x7 Gaussian (reference: GaussianBlur(..., Size(7,7), 2, 2)
    at ORBextractor.cc:1082)."""
    d = np.arange(-3, 4).astype(np.float32)
    k = np.exp(-d * d / (2 * sigma * sigma))
    k /= k.sum()
    k = jnp.asarray(k)
    # rows
    x = jnp.pad(img, ((3, 3), (0, 0)), mode="edge")
    out = jnp.zeros_like(img)
    for i in range(7):
        out = out + k[i] * jax.lax.dynamic_slice_in_dim(x, i, img.shape[0], axis=0)
    x = jnp.pad(out, ((0, 0), (3, 3)), mode="edge")
    out2 = jnp.zeros_like(img)
    for i in range(7):
        out2 = out2 + k[i] * jax.lax.dynamic_slice_in_dim(x, i, img.shape[1], axis=1)
    return out2


def brief_descriptors(
    img_blur: jnp.ndarray, xy: jnp.ndarray, angles: jnp.ndarray,
    pattern: jnp.ndarray = BRIEF_PATTERN,
) -> jnp.ndarray:
    """Steered BRIEF: rotate the pattern by the keypoint angle, compare pairs.

    Reference: computeOrbDescriptor (ORBextractor.cc:105-150) with nearest-
    pixel sampling of the blurred image.  Returns uint32 [N, 8] (256 bits).
    """
    h, w = img_blur.shape
    ca = jnp.cos(angles)[:, None]
    sa = jnp.sin(angles)[:, None]
    px1, py1, px2, py2 = pattern[:, 0], pattern[:, 1], pattern[:, 2], pattern[:, 3]

    def rot(px, py):
        rx = ca * px[None] - sa * py[None]
        ry = sa * px[None] + ca * py[None]
        return rx, ry

    # OpenCV steers with (x cos - y sin, x sin + y cos) against image axes.
    rx1, ry1 = rot(px1, py1)
    rx2, ry2 = rot(px2, py2)
    x0 = xy[:, 0:1]
    y0 = xy[:, 1:2]

    def sample(rx, ry):
        xi = jnp.clip(jnp.round(x0 + rx).astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(jnp.round(y0 + ry).astype(jnp.int32), 0, h - 1)
        return img_blur[yi, xi]  # [N, 256]

    v1 = sample(rx1, ry1)
    v2 = sample(rx2, ry2)
    bits = (v1 < v2).astype(jnp.uint32)  # [N, 256]
    bits = bits.reshape(bits.shape[0], 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(bits << shifts[None, None, :], axis=-1, dtype=jnp.uint32)
    return words  # [N, 8]


# ---------------------------------------------------------------------------
# Full extraction
# ---------------------------------------------------------------------------


class Features(NamedTuple):
    """Fixed-capacity feature set for one image (or [C, ...] for a rig).

    Replaces the per-Frame keypoint vectors of the reference
    (include/Frame.h:155-193: mvKeys*_total, mDescriptors_total, ...).
    """

    xy: jnp.ndarray        # [F, 2] level-0 pixel coords (distorted, as detected)
    xy_und: jnp.ndarray    # [F, 2] undistorted coords (filled by Frame build)
    level: jnp.ndarray     # [F] int32 pyramid level
    angle: jnp.ndarray     # [F] float32 radians
    response: jnp.ndarray  # [F] float32
    desc: jnp.ndarray      # [F, 8] uint32 packed 256-bit descriptors
    valid: jnp.ndarray     # [F] bool


@partial(jax.jit, static_argnums=(1,))
def extract_orb_reference(img: jnp.ndarray, cfg: ORBConfig = ORBConfig()) -> Features:
    """Per-level (unbatched) extraction — readable reference implementation.

    `extract_orb` below computes the same features with all pyramid levels
    batched onto one padded canvas (the path the tracker runs).
    """
    pyr = build_pyramid(img, cfg)
    counts = level_feature_counts(cfg)
    all_xy, all_lvl, all_resp, all_valid, all_angle, all_desc = [], [], [], [], [], []
    for lvl in range(cfg.n_levels):
        img_l = pyr[lvl]
        n_l = counts[lvl]
        if n_l == 0:
            continue
        xy, resp, valid = detect_level(img_l, n_l, cfg)
        ang = ic_angles(img_l, xy)
        blur = gaussian_blur7(img_l)
        desc = brief_descriptors(blur, xy, ang)
        scale = jnp.asarray(cfg.scale_factor ** lvl, jnp.float32)
        all_xy.append(xy * scale)
        all_lvl.append(jnp.full((n_l,), lvl, jnp.int32))
        all_resp.append(resp)
        all_valid.append(valid)
        all_angle.append(ang)
        all_desc.append(desc)
    xy = jnp.concatenate(all_xy, axis=0)
    return Features(
        xy=xy,
        xy_und=xy,  # caller overwrites after undistortion
        level=jnp.concatenate(all_lvl),
        angle=jnp.concatenate(all_angle),
        response=jnp.concatenate(all_resp),
        desc=jnp.concatenate(all_desc),
        valid=jnp.concatenate(all_valid),
    )


# ---------------------------------------------------------------------------
# Batched-level extraction
# ---------------------------------------------------------------------------


def gather_patches(canvas: jnp.ndarray, level: jnp.ndarray, yc: jnp.ndarray,
                   xc: jnp.ndarray, side: int) -> jnp.ndarray:
    """[F, side, side] windows of the [L, H, W] canvas centred on integer
    (yc, xc) of each feature's level; at the borders the window is shifted
    inside the canvas."""
    _, h, w = canvas.shape
    r = side // 2
    y0 = jnp.clip(yc - r, 0, h - side)
    x0 = jnp.clip(xc - r, 0, w - side)

    def slice_patch(l, y, x):
        return jax.lax.dynamic_slice(canvas, (l, y, x), (1, side, side))[0]

    return jax.vmap(slice_patch)(level, y0, x0)


def gaussian_blur7_batched(imgs: jnp.ndarray, sigma: float = 2.0) -> jnp.ndarray:
    """[B, H, W] separable 7x7 Gaussian via one conv pair."""
    d = np.arange(-3, 4).astype(np.float32)
    k = np.exp(-d * d / (2 * sigma * sigma))
    k /= k.sum()
    kx = jnp.asarray(k).reshape(1, 1, 1, 7)
    ky = jnp.asarray(k).reshape(1, 1, 7, 1)
    x = imgs[:, None]  # NCHW
    # DEFAULT precision (TF32 on the GPU): a 7-tap smoothing filter needs
    # no full-f32 products.  The bits this flips at the comparison threshold
    # are bounded against the CPU's descriptors by chip_smoke.py.
    x = jax.lax.conv_general_dilated(
        x, ky, (1, 1), [(3, 3), (0, 0)],
        precision=jax.lax.Precision.DEFAULT)
    x = jax.lax.conv_general_dilated(
        x, kx, (1, 1), [(0, 0), (3, 3)],
        precision=jax.lax.Precision.DEFAULT)
    return x[:, 0]


@partial(jax.jit, static_argnums=(1,))
def extract_orb(img: jnp.ndarray, cfg: ORBConfig = ORBConfig()) -> Features:
    """Batched-level ORB extraction.

    All pyramid levels are written into one zero-padded [L, H0, W0] canvas so
    FAST scoring, NMS, cell top-K, per-level top-N, blur, orientation, and
    descriptors each run as ONE batched op instead of a per-level chain.
    Padding is masked by static per-level border masks; padded cells rank 0.
    """
    H0, W0 = img.shape
    L = cfg.n_levels
    shapes = pyramid_shapes(H0, W0, cfg)
    counts = level_feature_counts(cfg)
    pyr = build_pyramid(img, cfg)
    canvas = jnp.zeros((L, H0, W0), img.dtype)
    for lvl in range(L):
        h, w = shapes[lvl]
        canvas = canvas.at[lvl, :h, :w].set(pyr[lvl])

    # FAST score per level at its TRUE shape: the canvas is ~2.6x padding
    # by area, so scoring each level's real extent and scattering into the
    # canvas skips that wasted compute; the border mask below hides the
    # roll's wrap-around at the image edges.
    score = jnp.zeros((L, H0, W0), img.dtype)
    for lvl in range(L):
        h, w = shapes[lvl]
        score = score.at[lvl, :h, :w].set(fast_score(pyr[lvl]))
    is_max = score >= jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (1, 3, 3), (1, 1, 1), "SAME")
    score = jnp.where(is_max, score, 0.0)
    score = jnp.where(score >= cfg.fast_threshold_min, score, 0.0)

    # static per-level border mask
    m = cfg.edge_margin
    border = np.zeros((L, H0, W0), bool)
    for lvl in range(L):
        h, w = shapes[lvl]
        border[lvl, m:h - m, m:w - m] = True
    score = jnp.where(jnp.asarray(border), score, 0.0)
    rank = jnp.where(score >= cfg.fast_threshold, score + 1e4, score)

    # cell top-K over all levels
    cs = cfg.cell_size
    ph = (cs - H0 % cs) % cs
    pw = (cs - W0 % cs) % cs
    rank_p = jnp.pad(rank, ((0, 0), (0, ph), (0, pw)))
    hp, wp = H0 + ph, W0 + pw
    ncy, ncx = hp // cs, wp // cs
    cells = rank_p.reshape(L, ncy, cs, ncx, cs).transpose(0, 1, 3, 2, 4)
    cells = cells.reshape(L, ncy * ncx, cs * cs)
    k = min(cfg.cell_top_k, cs * cs)
    cell_vals, cell_idx = jax.lax.top_k(cells, k)      # [L, ncells, k]
    cell_ids = jnp.arange(ncy * ncx)
    cy = (cell_ids // ncx)[None, :, None]
    cx = (cell_ids % ncx)[None, :, None]
    iy = cy * cs + cell_idx // cs
    ix = cx * cs + cell_idx % cs
    flat_vals = cell_vals.reshape(L, -1)
    flat_y = iy.reshape(L, -1)
    flat_x = ix.reshape(L, -1)

    # per-level top-cap selection (one batched top_k; cap = level-0 budget)
    cap = max(counts)
    top_vals, top_i = jax.lax.top_k(flat_vals, cap)     # [L, cap]
    sel_y = jnp.take_along_axis(flat_y, top_i, axis=1).astype(jnp.float32)
    sel_x = jnp.take_along_axis(flat_x, top_i, axis=1).astype(jnp.float32)
    resp_all = jnp.where(top_vals >= 1e4, top_vals - 1e4, top_vals)
    valid_all = top_vals > 0.0

    # slice each level's budget and concatenate -> [F]
    xs, ys, lvls, resps, valids = [], [], [], [], []
    for lvl in range(L):
        n_l = counts[lvl]
        xs.append(sel_x[lvl, :n_l])
        ys.append(sel_y[lvl, :n_l])
        lvls.append(jnp.full((n_l,), lvl, jnp.int32))
        resps.append(resp_all[lvl, :n_l])
        valids.append(valid_all[lvl, :n_l])
    x_lv = jnp.concatenate(xs)
    y_lv = jnp.concatenate(ys)
    level = jnp.concatenate(lvls)
    response = jnp.concatenate(resps)
    valid = jnp.concatenate(valids)
    F = x_lv.shape[0]

    # orientation + descriptors from ONE per-keypoint patch extraction:
    # one 45x45 slice covers the descriptor pattern (r=19) plus the 7x7
    # blur support, so the blur runs on the small patches instead of the
    # whole canvas.
    patches45 = gather_patches(canvas, level, y_lv.astype(jnp.int32),
                               x_lv.astype(jnp.int32),
                               2 * (DESC_PATCH_R + 3) + 1)   # [F, 45, 45]

    r = DESC_PATCH_R
    raw39 = patches45[:, 3:3 + 2 * r + 1, 3:3 + 2 * r + 1]
    dd = jnp.arange(-r, r + 1)
    df = dd.astype(jnp.float32)
    circ = ((df[:, None] ** 2 + df[None, :] ** 2) <= _PATCH_R * _PATCH_R)
    pc = raw39 * circ[None]
    m10 = jnp.sum(pc * df[None, None, :], axis=(1, 2))
    m01 = jnp.sum(pc * df[None, :, None], axis=(1, 2))
    angle = jnp.arctan2(m01, m10)

    # blur the patches, then descriptors via the rotation-bin matmul
    bpatches = gaussian_blur7_batched(patches45)[:, 3:3 + 2 * r + 1,
                                                 3:3 + 2 * r + 1]
    side = 2 * r + 1
    Pb = bpatches.reshape(F, side * side).astype(jnp.bfloat16)
    two_pi = 2.0 * jnp.pi
    ang_bin = jnp.mod(
        jnp.round(jnp.mod(angle, two_pi) / two_pi * N_ROT).astype(jnp.int32),
        N_ROT,
    )
    # one [F, 1521] @ [1521, N_ROT*256] matmul computes every rotation
    # bin; the per-feature bin is then selected with a one-hot contraction
    W_all = ROT_BRIEF_W.transpose(1, 0, 2).reshape(-1, N_ROT * 256)
    # DEFAULT precision on both contractions: the operands are bf16 patch
    # values and 0/+-1 weights, whose products are exact; only the sign of
    # each sum is kept, and a one-hot selection keeps that sign at TF32
    proj = jnp.dot(Pb, W_all, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.DEFAULT)
    proj = proj.reshape(F, N_ROT, 256)
    sel = jax.nn.one_hot(ang_bin, N_ROT, dtype=proj.dtype)
    diff = jnp.einsum("fbs,fb->fs", proj, sel,
                      precision=jax.lax.Precision.DEFAULT)
    bits = (diff > 0).astype(jnp.uint32)
    bits = bits.reshape(F, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    desc = jnp.sum(bits << shifts[None, None, :], axis=-1, dtype=jnp.uint32)

    scale = scale_factors(cfg)[level]
    xy = jnp.stack([x_lv, y_lv], axis=-1) * scale[:, None]
    return Features(
        xy=xy, xy_und=xy, level=level, angle=angle,
        response=response, desc=desc, valid=valid,
    )


def scale_factors(cfg: ORBConfig) -> jnp.ndarray:
    """Per-level scale factors sigma (reference mvScaleFactor)."""
    return jnp.asarray(
        [cfg.scale_factor ** l for l in range(cfg.n_levels)], jnp.float32
    )


def level_sigma2(cfg: ORBConfig) -> jnp.ndarray:
    """Per-level sigma^2 used in chi2 weighting (reference mvLevelSigma2)."""
    return scale_factors(cfg) ** 2
