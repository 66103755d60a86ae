#!/usr/bin/env python3
"""False-match rate of the triangulation epipolar search, +/- rotation hist.

The reference applies rotation-histogram
consistency in SearchForTriangulation (src/ORBmatcher.cc:1380-1388,
1540-1565); our triangulation matching gates with mutual-best + epipolar +
two-view chi2 instead.  This tool measures, on tracked keyframe pairs of
the benchmark sequence, the accepted-match count and the FALSE-match rate
(matched features whose ground-truth unprojections — rendered depth through
the ground-truth poses — land > 15 cm apart) with the histogram off
(default) and on (SlamConfig.tri_rotation_check).

Run: [JAX_PLATFORMS=cpu] python tools/measure_triangulation_matches.py
"""
import os
import sys
import json

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from multi_orb_slam.utils import compile_cache

from multi_orb_slam.config import SlamConfig
from multi_orb_slam.frontend import tracking
from multi_orb_slam.geometry import camera as cam_mod, se3
from multi_orb_slam.io import synthetic as syn
from multi_orb_slam.mapping import local_mapping
from multi_orb_slam.ops import hamming, orb

H, W, C = 480, 640, 2
N_FRAMES = 48


def gt_world(xy, depth_img, K, T_cw):
    """Unproject pixel xy through the RENDERED depth + ground-truth pose."""
    u = np.clip(np.round(xy[:, 0]).astype(int), 0, W - 1)
    v = np.clip(np.round(xy[:, 1]).astype(int), 0, H - 1)
    z = depth_img[v, u]
    fx, fy, cx, cy = K
    xc = (xy[:, 0] - cx) / fx * z
    yc = (xy[:, 1] - cy) / fy * z
    Twc = np.linalg.inv(T_cw)
    pc = np.stack([xc, yc, z], -1)
    return pc @ Twc[:3, :3].T + Twc[:3, 3], z > 0


def main():
    compile_cache.enable()
    K1 = np.asarray([520.9, 521.0, 320.0, 240.0], np.float32)
    Ry = se3.so3_exp(jnp.asarray([0.0, np.pi / 2, 0.0]))
    T_rc1 = (jnp.eye(4).at[:3, :3].set(Ry)
             .at[:3, 3].set(jnp.asarray([0.161, 0.004, -0.071])))
    T_rc = jnp.stack([jnp.eye(4), T_rc1])
    seq = syn.make_sequence(n_frames=N_FRAMES, K=K1, T_rc=np.asarray(T_rc),
                            height=H, width=W, n_points=4000)
    K = jnp.tile(jnp.asarray(K1)[None], (C, 1))
    calib = cam_mod.CameraParams(K=K, dist=jnp.zeros((C, 5)), T_rc=T_rc,
                                 bf=jnp.asarray(40.0), width=W, height=H)

    out = {}
    for rot_check in (False, True):
        cfg = SlamConfig(n_cams=C, width=W, height=H,
                         orb=orb.ORBConfig(n_features=1024),
                         tri_rotation_check=rot_check)
        tr = tracking.Tracker(calib, cfg)
        kf_frames = {}  # slot -> frame index

        def kf_cb(slot, tr=tr, kf_frames=kf_frames):
            kf_frames[int(slot)] = tr.frame_id
            return local_mapping.run_mapping_stage(
                tr.map, slot, tr.frame_id, calib, cfg)

        tr.kf_inserted_cb = kf_cb
        for i in range(N_FRAMES):
            tr.process(jnp.asarray(seq.grays[i]), jnp.asarray(seq.depths[i]))

        # replay the triangulation match for every covisible KF pair and
        # score each accepted pair against ground truth
        from multi_orb_slam.mapping import map_state as ms
        st = tr.map
        kvalid = np.asarray(st.kf_valid)
        slots = [s for s in sorted(kf_frames) if kvalid[s]]
        n_acc = n_false = 0
        for ia, sa in enumerate(slots):
            for sb in slots[ia + 1:]:
                fa, fb = kf_frames[sa], kf_frames[sb]
                if fa >= N_FRAMES or fb >= N_FRAMES:
                    continue
                for c in range(C):
                    acc, fal = _score_pair(st, sa, sb, c, cfg, calib,
                                           seq, fa, fb, K1)
                    n_acc += acc
                    n_false += fal
        rate = n_false / max(n_acc, 1)
        out["with_hist" if rot_check else "no_hist"] = {
            "accepted_matches": int(n_acc),
            "false_matches": int(n_false),
            "false_rate": round(float(rate), 4),
            "n_keyframes": len(slots),
        }
        print(f"rot_check={rot_check}: accepted={n_acc} false={n_false} "
              f"rate={rate:.4f}", flush=True)

    print(json.dumps({"metric": "triangulation_false_match_rate", **out}))


def _score_pair(st, sa, sb, c, cfg, calib, seq, fa, fb, K1):
    """Re-run the triangulation matching for one (pair, cam); score vs GT."""
    F = cfg.max_feat
    Ta = jnp.asarray(st.kf_Tcw[sa])
    Tb = jnp.asarray(st.kf_Tcw[sb])
    T1 = calib.T_rc[c] @ Ta
    T2 = calib.T_rc[c] @ Tb
    from multi_orb_slam.mapping.triangulation import _fundamental
    T_ab = T1 @ se3.inverse(T2)
    F12 = _fundamental(calib.K[c], calib.K[c], T_ab)
    free_a = st.kf_feat_valid[sa, c] & (st.kf_mp[sa, c] < 0)
    free_b = st.kf_feat_valid[sb, c] & (st.kf_mp[sb, c] < 0)
    xa = st.kf_xy_und[sa, c]
    xb = st.kf_xy_und[sb, c]
    xah = jnp.concatenate([xa, jnp.ones((F, 1))], -1)
    xbh = jnp.concatenate([xb, jnp.ones((F, 1))], -1)
    lines = xah @ F12.T
    num = jnp.abs(lines @ xbh.T)
    den = jnp.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2 + 1e-12)[:, None]
    sigma2_b = cfg.scale_factor ** (
        2.0 * st.kf_level[sb, c].astype(jnp.float32))
    epi_ok = (num / den) < 3.84 * jnp.sqrt(sigma2_b)[None, :]
    cand = free_a[:, None] & free_b[None, :] & epi_ok
    d = hamming.pairwise_hamming(st.kf_desc[sa, c], st.kf_desc[sb, c])
    bi, bd, b2 = hamming.masked_argmin2(d, cand)
    ok = (bd <= hamming.TH_LOW) & (
        bd.astype(jnp.float32) <= 0.9 * b2.astype(jnp.float32))
    d_masked = jnp.where(cand, d, hamming.BIG)
    best_back = jnp.argmin(d_masked, axis=0)
    ok = ok & (best_back[bi] == jnp.arange(F))
    if cfg.tri_rotation_check:
        delta = st.kf_angle[sa, c] - st.kf_angle[sb, c][bi]
        ok = hamming.rotation_histogram_filter(delta, ok)

    ok = np.asarray(ok)
    bi = np.asarray(bi)
    if not ok.any():
        return 0, 0
    # ground truth: unproject both features through rendered depth + GT pose
    T_gt_a = np.asarray(calib.T_rc[c]) @ seq.poses_gt[fa]
    T_gt_b = np.asarray(calib.T_rc[c]) @ seq.poses_gt[fb]
    wa, va = gt_world(np.asarray(xa)[ok], seq.depths[fa][c], K1, T_gt_a)
    wb, vb = gt_world(np.asarray(xb)[bi[ok]], seq.depths[fb][c], K1, T_gt_b)
    both = va & vb
    dist = np.linalg.norm(wa - wb, axis=-1)
    n_acc = int(both.sum())
    n_false = int((dist[both] > 0.15).sum())
    return n_acc, n_false


if __name__ == "__main__":
    main()
