"""Frame construction: multi-camera ORB extraction + depth association.

Replaces the reference's `Frame` dual-camera constructor
(src/Frame.cc:148-288): ORB extraction in both images, per-camera keypoint
undistortion (src/Frame.cc:673-740), RGB-D -> virtual-stereo right coordinate
(src/Frame.cc:959-1034), and the global feature indexing `keypoint_to_cam`
maps (src/Frame.cc:219-239).

Differences from the reference:
- cameras are a leading axis `[C, F, ...]`, so `keypoint_to_cam` becomes the
  index itself — no hash maps;
- both cameras are extracted inside one jitted program instead of the
  reference's sequential per-camera extraction (Frame.cc:182-185);
- the reference's 48x64 per-camera search grid (Frame.cc:348-395) is not
  materialized: windowed queries are dense masked comparisons over the fixed
  [F] feature axis, which vectorizes better than grid bucketing.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..ops import orb


class FrameData(NamedTuple):
    """One rig frame: all arrays are [C, F, ...] with validity masks."""

    xy: jnp.ndarray        # [C, F, 2] raw (distorted) pixel coords
    xy_und: jnp.ndarray    # [C, F, 2] undistorted pixel coords
    level: jnp.ndarray     # [C, F] int32
    angle: jnp.ndarray     # [C, F] float32
    response: jnp.ndarray  # [C, F]
    desc: jnp.ndarray      # [C, F, 8] uint32
    valid: jnp.ndarray     # [C, F] bool
    depth: jnp.ndarray     # [C, F] float32 (<=0 invalid)
    uright: jnp.ndarray    # [C, F] float32 virtual right u (-1 invalid)


def sample_depth(
    depth_img: jnp.ndarray, xy: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Nearest-pixel depth lookup at (raw) keypoint locations."""
    h, w = depth_img.shape
    x = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, h - 1)
    d = depth_img[y, x]
    return jnp.where(valid, d, 0.0)


@partial(jax.jit, static_argnums=(3,))
def build_frame_stereo(
    gray_left: jnp.ndarray,    # [H, W] float32
    gray_right: jnp.ndarray,   # [H, W]
    calib: "cam_mod.CameraParams",
    orb_cfg: orb.ORBConfig = orb.ORBConfig(),
) -> FrameData:
    """Stereo frame: depth from left<->right ORB matching (KITTI path).

    Reference: the stock stereo Frame constructor + ComputeStereoMatches
    (src/Frame.cc:76-146, 782-956).  Produces a single-camera FrameData whose
    depth/uright come from stereo disparity.
    """
    from ..ops import stereo as stereo_mod

    featsL = orb.extract_orb(gray_left, orb_cfg)
    featsR = orb.extract_orb(gray_right, orb_cfg)
    depth, uright = stereo_mod.stereo_match_depth(
        featsL, featsR, calib.bf, orb_cfg.scale_factor)
    # SAD subpixel refinement at level-0 resolution (Frame.cc:860-940)
    depth, uright = stereo_mod.subpixel_refine(
        gray_left, gray_right, featsL.xy[:, 0], featsL.xy[:, 1],
        uright, calib.bf)
    xy_und = cam_mod.undistort_pixels(calib.K[0], calib.dist[0], featsL.xy)
    return FrameData(
        xy=featsL.xy[None],
        xy_und=xy_und[None],
        level=featsL.level[None],
        angle=featsL.angle[None],
        response=featsL.response[None],
        desc=featsL.desc[None],
        valid=featsL.valid[None],
        depth=depth[None],
        uright=uright[None],
    )


@partial(jax.jit, static_argnums=(3,))
def build_frame(
    grays: jnp.ndarray,       # [C, H, W] float32
    depths: jnp.ndarray,      # [C, H, W] float32 (meters; <=0 = no depth)
    calib: "cam_mod.CameraParams",
    orb_cfg: orb.ORBConfig = orb.ORBConfig(),
) -> FrameData:
    # explicit per-camera extraction (C is tiny and static)
    per_cam = [orb.extract_orb(grays[c], orb_cfg)
               for c in range(grays.shape[0])]
    feats = jax.tree.map(lambda *xs: jnp.stack(xs), *per_cam)
    # undistort per camera
    xy_und = jax.vmap(
        lambda K, d, xy: cam_mod.undistort_pixels(K, d, xy)
    )(calib.K, calib.dist, feats.xy)
    depth = jax.vmap(sample_depth)(depths, feats.xy, feats.valid)
    bf = jnp.broadcast_to(jnp.asarray(calib.bf), (grays.shape[0],))
    uright = jax.vmap(cam_mod.virtual_right_u)(bf, xy_und[..., 0], depth)
    return FrameData(
        xy=feats.xy,
        xy_und=xy_und,
        level=feats.level,
        angle=feats.angle,
        response=feats.response,
        desc=feats.desc,
        valid=feats.valid,
        depth=depth,
        uright=uright,
    )
