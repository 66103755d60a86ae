"""Loop closing: detection, Sim3 computation, correction, pose graph, GBA.

Replaces the `LoopClosing` thread (src/LoopClosing.cc) as a deterministic
stage invoked after each keyframe's mapping pass:

1. DetectLoop (LoopClosing.cc:123-293): BoW gate (>= 10 KFs since last
   loop), minScore from camera-0 covisibility neighbors, database candidates
   with covisibility-group accumulation, temporal consistency over 3
   consecutive keyframes.
2. ComputeSim3 (LoopClosing.cc:320-565): brute-force camera-0 descriptor
   matching (>= 15), batched Sim3 RANSAC with camera-aware reprojection
   checks (>= 20 inliers), guided re-match, total-match gate (>= 40).
3. CorrectLoop (LoopClosing.cc:586-818): Sim3 correction propagated to the
   covisibility neighborhood, map-point correction, loop-point fusion,
   essential-graph optimization, then full global BA.

The vocabulary is trained online from early keyframe descriptors (the
reference ships a pre-trained 1M-word file, stripped from the mirror).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

# set MOS_LOOP_DEBUG=1 to trace why Sim3 verification accepts/rejects each
# loop candidate (gate-by-gate counts on stderr)
_LOOP_DEBUG = bool(os.environ.get("MOS_LOOP_DEBUG"))


def _dbg(msg: str):
    if _LOOP_DEBUG:
        import sys
        print(f"[loop] {msg}", file=sys.stderr, flush=True)

from ..config import SlamConfig
from ..geometry import camera as cam_mod, se3, sim3
from ..mapping import fusion, map_state as ms
from ..ops import hamming
from ..optim import global_ba, pose_graph
from ..placerec import database as db_mod, vocabulary as vocab_mod
from . import sim3_solver

@jax.jit
def _merge_gba(state: ms.MapState, Tcw_gba, pos_gba, old_kf, kf_fid_launch,
               old_mp, mp_ff_launch) -> ms.MapState:
    """Fold GBA output (computed from a past map snapshot) into the live map.

    Mirrors the propagation of src/LoopClosing.cc:927-989.  Slot-recycling
    guard: a slot only counts as "existed at launch" if it still holds the
    same keyframe (frame id) / map point (creation frame) — a culled slot
    reused during the solve is treated as new.
    """
    K = state.kf_Tcw.shape[0]
    old_kf_eff = (old_kf & state.kf_valid
                  & (state.kf_frame_id == kf_fid_launch))
    old_mp_eff = (old_mp & state.mp_valid
                  & (state.mp_first_frame == mp_ff_launch))
    is_new_kf = state.kf_valid & ~old_kf_eff
    # spanning-tree parent of a keyframe born during the solve: the old
    # keyframe sharing the most camera-0 observations (the reference
    # parents its spanning tree on cam1 covisibility, KeyFrame.cc:654-665)
    W = ms.covisibility(state, cam0_only=True)
    w_old = jnp.where(old_kf_eff[None, :], W, -1.0)
    parent = jnp.argmax(w_old, axis=1)
    has_parent = jnp.take_along_axis(w_old, parent[:, None], 1)[:, 0] > 0
    inv_Tp_cur = jax.vmap(se3.inverse)(state.kf_Tcw[parent])
    # Tcw_child' = (Tcw_child * Tcw_parent^-1) * Tcw_parent_GBA
    corr_child = jnp.einsum(
        "kij,kjl,klm->kim", state.kf_Tcw, inv_Tp_cur, Tcw_gba[parent])
    new_Tcw = jnp.where(
        old_kf_eff[:, None, None], Tcw_gba,
        jnp.where((is_new_kf & has_parent)[:, None, None],
                  corr_child, state.kf_Tcw))
    # map points born during the solve: re-anchor through their creating
    # keyframe's old->new transform (x' = T_ref_new^-1 * T_ref_old * x)
    ref = jnp.clip(state.mp_first_kf, 0, K - 1)
    corr = jnp.einsum(
        "mij,mjl->mil", jax.vmap(se3.inverse)(new_Tcw[ref]),
        state.kf_Tcw[ref])
    x_corr = (jnp.einsum("mij,mj->mi", corr[:, :3, :3], state.mp_pos)
              + corr[:, :3, 3])
    is_new_mp = state.mp_valid & ~old_mp_eff & (state.mp_first_kf >= 0)
    mp_pos = jnp.where(
        old_mp_eff[:, None], pos_gba,
        jnp.where(is_new_mp[:, None], x_corr, state.mp_pos))
    return state._replace(kf_Tcw=new_Tcw, mp_pos=mp_pos)


MIN_MATCHES_BOW = 15      # LoopClosing.cc:372 (SearchByBoW gate)
MIN_INLIERS_SIM3 = 20     # LoopClosing.cc:461
MIN_TOTAL_MATCHES = 40    # LoopClosing.cc:522
CONSISTENCY_TH = 3        # LoopClosing.cc:53 (mnCovisibilityConsistencyTh)
DETECT_GAP = 10           # LoopClosing.cc:137 (mnId < mLastLoopKFid+10)
MAX_RELAX_STREAK = 3      # consecutive relaxed-only chain extensions allowed
MIN_LOOP_AGE = 30         # frames: a loop candidate must be genuinely old.
                          # The reference relies on covisibility exclusion
                          # alone; after tracking losses fragment the map, a
                          # recent-but-disconnected KF can pass that gate and
                          # close a spurious "loop" onto itself.
VOCAB_MIN_DESCS = 6000


class LoopCloser:
    def __init__(self, calib: cam_mod.CameraParams, cfg: SlamConfig,
                 run_gba: bool = True, vocab_k: int = 10, vocab_depth: int = 4,
                 vocab_min_descs: int = VOCAB_MIN_DESCS,
                 vocab_path: str | None = None):
        # vocab depth 4 (~10^4 words) is the DEFAULT: an online 1000-word
        # depth-3 tree leaves loop detection no robust score margin (the
        # true candidate sits on a knife edge), and every tested
        # configuration (loop e2e, recall harness) uses depth 4
        self.calib = calib
        self.cfg = cfg
        self.run_gba = run_gba
        self.vocab_k = vocab_k
        self.vocab_depth = vocab_depth
        self.vocab_min_descs = vocab_min_descs
        self.voc: vocab_mod.Vocabulary | None = None
        self.db: db_mod.KeyFrameDB | None = None
        if vocab_path:
            # pre-trained DBoW2 text vocabulary (the reference's ORBvoc.txt
            # pathway, src/System.cc:79-87) — any size up to 10^6 words;
            # the sparse database scales independently of n_words
            self.voc = vocab_mod.load_dbow2_text(vocab_path)
            self.db = db_mod.make_empty_db(cfg.max_kf, self.voc.n_words)
        self._train_descs = []
        self.last_loop_kf = -DETECT_GAP
        self.consistent_groups = []  # [(set_of_kfs, count)]
        self._relax_streak = 0       # relaxed-only extensions in a row
        self.loop_pairs = []         # accumulated loop edges
        self.n_loops_closed = 0
        self._pending_bow = []
        # asynchronously dispatched global BA awaiting merge (the
        # reference's transient GBA thread, src/LoopClosing.cc:812):
        # (Tcw_gba, pos_gba, old_kf, kf_fid_launch, old_mp, mp_ff_launch)
        self._gba_pending = None
        self.n_gba_merged = 0

    def reset(self):
        """Clear all map-derived state (reference LoopClosing::RequestReset,
        src/LoopClosing.cc:1006-1030: empties the queue and resets
        mLastLoopKFid).  MUST run on a system reset: a pending GBA computed
        against the pre-reset map would otherwise merge into the fresh map
        — and since frame ids restart at 0, the slot-recycling guard can
        falsely match (slot 0 / frame 0) and overwrite fresh poses.  The
        keyframe database is re-created (its BoW rows index dead slots);
        the trained vocabulary itself is map-independent and kept."""
        self._gba_pending = None
        self._pending_bow = []
        self.consistent_groups = []
        self._relax_streak = 0
        self.loop_pairs = []
        self.last_loop_kf = -DETECT_GAP
        if self.voc is not None:
            self.db = db_mod.make_empty_db(self.cfg.max_kf, self.voc.n_words)

    # ------------------------------------------------------------------

    def _ensure_vocab(self, state: ms.MapState, kf_slot: int) -> bool:
        if self.voc is not None:
            return True
        desc = np.asarray(state.kf_desc[kf_slot][0])
        valid = np.asarray(state.kf_feat_valid[kf_slot][0])
        self._train_descs.append(desc[valid])
        total = sum(len(d) for d in self._train_descs)
        if total < self.vocab_min_descs:
            self._pending_bow.append(kf_slot)
            return False
        train = np.concatenate(self._train_descs)
        self.voc = vocab_mod.build_vocabulary(
            train, k=self.vocab_k, depth=self.vocab_depth)
        self.db = db_mod.make_empty_db(self.cfg.max_kf, self.voc.n_words)
        return True

    # ------------------------------------------------------------------

    def process_keyframe(self, state: ms.MapState, kf_slot: int) -> ms.MapState:
        # merge a finished asynchronous GBA before anything else (the
        # reference applies GBA results once the thread completes, pausing
        # mapping; our deterministic equivalent is the next KF boundary)
        state = self.merge_pending_gba(state)
        if not self._ensure_vocab(state, kf_slot):
            return state
        # index any keyframes that arrived before the vocabulary was ready
        for k in self._pending_bow:
            if bool(state.kf_valid[k]):
                self.db = db_mod.add_keyframe(self.db, self.voc, state, k)
        self._pending_bow = []

        fid = int(state.kf_frame_id[kf_slot])
        candidates = []
        if fid >= self.last_loop_kf + DETECT_GAP and int(state.n_kf) > 5:
            candidates = self._detect(state, kf_slot)
        self.db = db_mod.add_keyframe(self.db, self.voc, state, kf_slot)
        if not candidates:
            return state
        result = self._compute_sim3(state, kf_slot, candidates)
        if result is None:
            return state
        loop_kf, g_ab, matches = result
        state = self._correct_loop(state, kf_slot, loop_kf, g_ab)
        self.last_loop_kf = fid
        self.n_loops_closed += 1
        return state

    # ------------------------------------------------------------------

    def _detect(self, state: ms.MapState, kf_slot: int) -> list:
        """DetectLoop with temporal consistency groups."""
        # minScore = lowest BoW similarity to a covisibility neighbor
        W = np.asarray(ms.covisibility(state, cam0_only=True))
        neighbors = np.nonzero(W[kf_slot] >= 15.0)[0]
        q_desc = state.kf_desc[kf_slot][0]
        q_valid = state.kf_feat_valid[kf_slot][0]
        q_ids, q_vals = vocab_mod.bow_sparse(
            self.voc, q_desc, q_valid, budget=self.db.ids_cam0.shape[1])
        scores = np.asarray(db_mod.score_query_cam0(self.db, q_ids, q_vals))
        has = np.asarray(self.db.has_bow)
        nb = [n for n in neighbors if has[n]]
        min_score = float(scores[nb].min()) if nb else 0.3
        max_fid = int(state.kf_frame_id[kf_slot]) - MIN_LOOP_AGE
        cands = db_mod.detect_loop_candidates(
            self.db, state, kf_slot, max(min_score, 0.0),
            q_ids=q_ids, q_vals=q_vals, max_frame_id=max_fid)
        # consistency-earned score slack: a candidate whose covisibility
        # group is already part of an in-progress consistency chain may
        # pass at a relaxed minScore.  The reference's gate is fragile
        # exactly here — minScore tracks the covisibility neighborhood and
        # rises on well-tracked legs, so a revisit that scored above it for
        # CONSISTENCY_TH-1 consecutive keyframes can drop below it on the
        # final one and reset the chain (observed on the natural-drift
        # corridor).  Temporal consistency substitutes for score margin;
        # geometric acceptance still requires the full Sim3 chain (15 BoW
        # pairs, 20 RANSAC + 20 LM inliers, 40 total matches).
        strict = list(cands)
        if self.consistent_groups and self._relax_streak < MAX_RELAX_STREAK:
            chain = set()
            for g, cnt in self.consistent_groups:
                if cnt >= 1:
                    chain |= g
            if chain:
                relaxed = db_mod.detect_loop_candidates(
                    self.db, state, kf_slot, max(0.75 * min_score, 0.0),
                    q_ids=q_ids, q_vals=q_vals, max_frame_id=max_fid)
                for c in relaxed:
                    if c in cands:
                        continue
                    group = set(np.nonzero(W[c] > 0)[0].tolist()) | {c}
                    if group & chain:
                        cands.append(c)
        if not cands:
            self.consistent_groups = []
            self._relax_streak = 0
            return []
        # a chain may extend on relaxed-only hits for at most
        # MAX_RELAX_STREAK consecutive keyframes; after that it must earn a
        # full-minScore hit or die.  Bounds the Sim3 RANSAC/LM cost a
        # spurious self-sustaining chain can charge in repetitive scenes
        # (the geometric gates already protect correctness, not cost).
        self._relax_streak = 0 if strict else self._relax_streak + 1
        # temporal consistency: a candidate's covis group must reappear in
        # CONSISTENCY_TH consecutive keyframes (LoopClosing.cc:210-280)
        enough = []
        new_groups = []
        for c in cands:
            group = set(np.nonzero(W[c] > 0)[0].tolist()) | {c}
            count = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= CONSISTENCY_TH - 1:
                enough.append(c)
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------

    def _compute_sim3(self, state: ms.MapState, kf_a: int, candidates: list):
        """Match + batched Sim3 RANSAC against each candidate."""
        C, F = state.kf_desc.shape[1], state.kf_desc.shape[2]
        M = self.cfg.max_mp
        fid_a = int(state.kf_frame_id[kf_a])
        for kf_b in candidates:
            if int(state.kf_frame_id[kf_b]) > fid_a - MIN_LOOP_AGE:
                _dbg(f"a={kf_a} b={kf_b}: age-skip "
                     f"(fid_b={int(state.kf_frame_id[kf_b])}, "
                     f"fid_a={fid_a})")
                continue
            # word-gated matching between map-point features of ALL rig
            # cameras: candidate pairs share a vocabulary leaf, as in the
            # reference's SearchByBoW (ORBmatcher.cc:206-388 iterates the
            # shared FeatureVector nodes over the keyframe's full
            # multi-camera feature set).  A brute [F, F] search with the
            # 0.75 ratio test is NOT equivalent: on repetitive structure
            # the global second-best is nearly as good as the best and the
            # ratio kills almost every true match; within one word the
            # competition is only same-appearance features.
            C, F = state.kf_desc.shape[1], state.kf_desc.shape[2]
            da = state.kf_desc[kf_a].reshape(C * F, -1)
            db_ = state.kf_desc[kf_b].reshape(C * F, -1)
            mp_a_flat = state.kf_mp[kf_a].reshape(-1)
            mp_b_flat = state.kf_mp[kf_b].reshape(-1)
            has_a = ((mp_a_flat >= 0)
                     & state.kf_feat_valid[kf_a].reshape(-1))
            has_b = ((mp_b_flat >= 0)
                     & state.kf_feat_valid[kf_b].reshape(-1))
            wa = vocab_mod.transform_words(self.voc, da)
            wb = vocab_mod.transform_words(self.voc, db_)
            d = hamming.pairwise_hamming(da, db_)
            cand = (has_a[:, None] & has_b[None, :]
                    & (wa[:, None] == wb[None, :]))
            bi, bd, b2 = hamming.masked_argmin2(d, cand)
            ok = (bd <= hamming.TH_LOW) & (
                bd.astype(jnp.float32) <= 0.75 * b2.astype(jnp.float32))
            n_matches = int(jnp.sum(ok))
            if n_matches < MIN_MATCHES_BOW:
                _dbg(f"a={kf_a} b={kf_b}: bow-matches {n_matches} < "
                     f"{MIN_MATCHES_BOW}")
                continue
            # matched landmark pairs in each RIG frame, with the observing
            # camera of each side (the reference's Sim3Solver stores
            # per-point camera ids because loop matches can land in cam2,
            # src/Sim3Solver.cc:117-135)
            mp_a = np.asarray(mp_a_flat)
            mp_b = np.asarray(mp_b_flat)
            bi_np = np.asarray(bi)
            ok_np = np.asarray(ok)
            ia = np.nonzero(ok_np)[0]
            ib = bi_np[ia]
            pa_ids = mp_a[ia]
            pb_ids = mp_b[ib]
            pw = np.asarray(state.mp_pos)
            Ta = np.asarray(state.kf_Tcw[kf_a])
            Tb = np.asarray(state.kf_Tcw[kf_b])
            pts_a = pw[pa_ids] @ Ta[:3, :3].T + Ta[:3, 3]
            pts_b = pw[pb_ids] @ Tb[:3, :3].T + Tb[:3, 3]
            cam_a = (ia // F).astype(np.int32)
            cam_b = (ib // F).astype(np.int32)
            n = len(ia)
            cap = 256
            pad = cap - n if n < cap else 0
            if n > cap:
                pts_a, pts_b = pts_a[:cap], pts_b[:cap]
                cam_a, cam_b = cam_a[:cap], cam_b[:cap]
                n = cap
                pad = 0
            pts_a = np.concatenate([pts_a, np.zeros((pad, 3))]).astype(np.float32)
            pts_b = np.concatenate([pts_b, np.zeros((pad, 3))]).astype(np.float32)
            cam_a = np.concatenate([cam_a, np.zeros(pad, np.int32)])
            cam_b = np.concatenate([cam_b, np.zeros(pad, np.int32)])
            valid = np.zeros(cap, bool)
            valid[:n] = True
            g_ab, inl, n_inl = sim3_solver.solve_sim3_ransac(
                jax.random.PRNGKey(kf_a * 1000 + kf_b),
                jnp.asarray(pts_a), jnp.asarray(pts_b),
                jnp.asarray(cam_a), jnp.asarray(cam_b),
                jnp.asarray(valid),
                self.calib.T_rc, self.calib.K,
            )
            if int(n_inl) < MIN_INLIERS_SIM3:
                _dbg(f"a={kf_a} b={kf_b}: ransac inliers {int(n_inl)}/{n} "
                     f"< {MIN_INLIERS_SIM3}")
                continue
            # guided match-producing search (SearchBySim3,
            # ORBmatcher.cc:2814) + gated Sim3 LM (OptimizeSim3,
            # Optimizer.cc:1704): new correspondences feed the refinement,
            # acceptance needs >= 20 LM inliers (LoopClosing.cc:455-461)
            g_ref, n_lm = self._refine_sim3(
                state, kf_a, kf_b, g_ab,
                ia[:n], ib[:n], np.asarray(inl)[:n])
            if n_lm < MIN_INLIERS_SIM3:
                _dbg(f"a={kf_a} b={kf_b}: sim3-LM inliers {n_lm} < "
                     f"{MIN_INLIERS_SIM3}")
                continue
            g_ab = g_ref
            # total-match gate: project the loop-KF-neighborhood points
            # through g_ab into kf_a and count agreeing landmarks
            # (SearchByProjection over loop-connected points + the >= 40
            # gate, LoopClosing.cc:478-529)
            total = n_lm + self._guided_matches(state, kf_a, kf_b, g_ab)
            if total >= MIN_TOTAL_MATCHES:
                _dbg(f"a={kf_a} b={kf_b}: ACCEPT total={total}")
                return kf_b, g_ab, total
            _dbg(f"a={kf_a} b={kf_b}: total-matches {total} < "
                 f"{MIN_TOTAL_MATCHES}")
        return None

    def _refine_sim3(self, state, kf_a: int, kf_b: int, g_ab,
                     ia: np.ndarray, ib: np.ndarray, ransac_inl: np.ndarray):
        """SearchBySim3 guided matches + gated camera-aware Sim3-pair LM.

        `ia`/`ib` are the brute-match feature pairs (a-feature -> b-feature,
        FLAT [C*F] indices over all rig cameras) that seeded RANSAC;
        `ransac_inl` their inlier mask.  Returns (g_refined [8], n int).
        """
        from ..optim import sim3_opt

        cfg = self.cfg
        C, F = state.kf_desc.shape[1], state.kf_desc.shape[2]
        guided = np.asarray(sim3_solver.search_by_sim3(
            state, jnp.asarray(kf_a), jnp.asarray(kf_b), g_ab,
            self.calib.K[0], cfg.max_mp, cfg.scale_factor, cfg.n_levels))
        # union in the flat [C*F] index space: the guided search produces
        # cam0<->cam0 pairs (flat index == feature index); RANSAC-inlier
        # seed pairs — which may live in any camera — take precedence (the
        # reference leaves existing vpMatches12 entries untouched,
        # ORBmatcher.cc:2875)
        pair_of_a = np.full(C * F, -1, np.int64)
        pair_of_a[:F] = guided
        seed_a = ia[ransac_inl]
        seed_b = ib[ransac_inl]
        pair_of_a[seed_a] = seed_b
        ja = np.nonzero(pair_of_a >= 0)[0]
        jb = pair_of_a[ja]
        cam_ja = (ja // F).astype(np.int32)
        cam_jb = (jb // F).astype(np.int32)

        mp_a = np.asarray(state.kf_mp[kf_a]).reshape(-1)
        mp_b = np.asarray(state.kf_mp[kf_b]).reshape(-1)
        pw = np.asarray(state.mp_pos)
        Ta = np.asarray(state.kf_Tcw[kf_a])
        Tb = np.asarray(state.kf_Tcw[kf_b])
        X_a = pw[mp_a[ja]] @ Ta[:3, :3].T + Ta[:3, 3]
        X_b = pw[mp_b[jb]] @ Tb[:3, :3].T + Tb[:3, 3]
        uv_a = np.asarray(state.kf_xy_und[kf_a]).reshape(-1, 2)[ja]
        uv_b = np.asarray(state.kf_xy_und[kf_b]).reshape(-1, 2)[jb]
        sf2 = np.asarray(
            [cfg.scale_factor ** (2.0 * l) for l in range(cfg.n_levels)],
            np.float32)
        is2_a = 1.0 / sf2[np.asarray(state.kf_level[kf_a]).reshape(-1)[ja]]
        is2_b = 1.0 / sf2[np.asarray(state.kf_level[kf_b]).reshape(-1)[jb]]

        capn = 512
        n = min(len(ja), capn)
        pad = capn - n

        def padf(x, d):
            x = np.asarray(x[:n], np.float32)
            return np.concatenate([x, np.zeros((pad,) + x.shape[1:],
                                               np.float32)]) if pad else x

        def padi(x):
            x = np.asarray(x[:n], np.int32)
            return np.concatenate([x, np.zeros(pad, np.int32)]) if pad else x

        obs = sim3_opt.Sim3Obs(
            X_a=jnp.asarray(padf(X_a, 3)), X_b=jnp.asarray(padf(X_b, 3)),
            uv_a=jnp.asarray(padf(uv_a, 2)), uv_b=jnp.asarray(padf(uv_b, 2)),
            inv_sigma2_a=jnp.asarray(padf(is2_a, 1)),
            inv_sigma2_b=jnp.asarray(padf(is2_b, 1)),
            mask=jnp.asarray(np.arange(capn) < n),
            cam_a=jnp.asarray(padi(cam_ja)),
            cam_b=jnp.asarray(padi(cam_jb)),
        )
        g_ref, _, n_inl = sim3_opt.optimize_sim3(
            g_ab, obs, self.calib.K, T_rc=self.calib.T_rc, fix_scale=True)
        return g_ref, int(n_inl)

    def _guided_matches(self, state, kf_a, kf_b, g_ab) -> int:
        """SearchByProjection_cam1-style count of additional agreements."""
        M = self.cfg.max_mp
        mp_b = state.kf_mp[kf_b].reshape(-1)
        mask_b = jnp.zeros(M, bool).at[
            jnp.where(mp_b >= 0, mp_b, M - 1)].max(mp_b >= 0)
        mask_b = mask_b & state.mp_valid
        pw = state.mp_pos
        Tb = state.kf_Tcw[kf_b]
        pts_b_rig = se3.transform_points(Tb, pw)
        pts_a_rig = sim3.apply(g_ab, pts_b_rig)
        uv = cam_mod.project(self.calib.K[0], pts_a_rig)
        inb = cam_mod.in_image(uv, self.cfg.width, self.cfg.height)
        okz = pts_a_rig[:, 2] > 0.1
        proj_ok = mask_b & inb & okz
        # count projected points landing near a feature of kf_a (camera 0)
        fx = state.kf_xy_und[kf_a][0]
        fval = state.kf_feat_valid[kf_a][0]
        du = jnp.abs(uv[:, 0, None] - fx[None, :, 0])
        dv = jnp.abs(uv[:, 1, None] - fx[None, :, 1])
        near = (du < 8.0) & (dv < 8.0) & fval[None, :] & proj_ok[:, None]
        d = hamming.pairwise_hamming(state.mp_desc, state.kf_desc[kf_a][0])
        match = jnp.any(near & (d <= hamming.TH_LOW), axis=1)
        return int(jnp.sum(match))

    # ------------------------------------------------------------------

    def _correct_loop(self, state: ms.MapState, kf_a: int, kf_b: int,
                      g_ab: jnp.ndarray) -> ms.MapState:
        """Sim3 propagation + point correction + fusion + pose graph + GBA."""
        K = self.cfg.max_kf
        M = self.cfg.max_mp
        # corrected Sim3 of current KF: S_aw_corr = g_ab o S_bw ... the loop
        # says: landmarks seen in b map into a via g_ab, i.e. a's TRUE pose
        # satisfies S_aw = g_ab * S_bw ... current a pose has drift.
        g_old = jax.vmap(sim3.from_se3)(state.kf_Tcw)   # [K, 8] world->kf
        S_aw_corr = sim3.compose(g_ab, g_old[kf_b])

        # propagate to covisibility neighborhood of kf_a (CorrectedSim3)
        W = np.asarray(ms.covisibility(state, cam0_only=True))
        neigh = np.nonzero(W[kf_a] >= 15.0)[0].tolist()
        corrected_slots = [kf_a] + [n for n in neigh if n != kf_a]
        corr_mask = np.zeros(K, bool)
        g_corr = np.asarray(g_old).copy()
        S_aw_old_inv = sim3.inverse(g_old[kf_a])
        for k in corrected_slots:
            # S_kw_corr = S_k,a * S_aw_corr  with  S_k,a = S_kw * S_aw^-1
            S_ka = sim3.compose(g_old[k], S_aw_old_inv)
            g_corr[k] = np.asarray(sim3.compose(S_ka, S_aw_corr))
            corr_mask[k] = True

        # correct the map points of the corrected keyframes
        owned = np.zeros(M, bool)
        kf_mp_np = np.asarray(state.kf_mp)
        for k in corrected_slots:
            ids = kf_mp_np[k][kf_mp_np[k] >= 0]
            owned[ids] = True
        owned = jnp.asarray(owned) & state.mp_valid
        # x' = S_corr^-1 ( S_old (x) ) via the owning kf_a correction
        g_corr_j = jnp.asarray(g_corr)
        S_old_a = g_old[kf_a]
        S_new_a = jnp.asarray(g_corr[kf_a])
        x_in_a = sim3.apply(S_old_a, state.mp_pos)
        x_corr = sim3.apply(sim3.inverse(S_new_a), x_in_a)
        mp_pos = jnp.where(owned[:, None], x_corr, state.mp_pos)

        # write corrected SE3 poses
        kf_Tcw = state.kf_Tcw
        for k in corrected_slots:
            kf_Tcw = kf_Tcw.at[k].set(sim3.to_se3(jnp.asarray(g_corr[k])))
        state = state._replace(kf_Tcw=kf_Tcw, mp_pos=mp_pos)

        # fuse loop landmarks into the FULL corrected neighborhood in one
        # dispatch (reference SearchAndFuse, LoopClosing.cc:824-856)
        mp_b = state.kf_mp[kf_b].reshape(-1)
        loop_mask = jnp.zeros(M, bool).at[
            jnp.where(mp_b >= 0, mp_b, M - 1)].max(mp_b >= 0)
        fuse_cap = 32  # fixed batch: one compiled shape for any loop size
        slots = np.full(fuse_cap, K - 1, np.int32)
        slots[:min(len(corrected_slots), fuse_cap)] = \
            corrected_slots[:fuse_cap]
        state, _ = fusion.fuse_into_kfs(
            state, loop_mask, jnp.asarray(slots), self.cfg, self.calib)

        # essential-graph optimization
        self.loop_pairs.append((kf_a, kf_b))
        ei, ej, meas, ok = pose_graph.build_essential_edges(
            W, np.asarray(state.kf_valid), np.asarray(state.kf_frame_id),
            g_old, (g_corr, corr_mask), self.loop_pairs,
        )
        kf_free = state.kf_valid & (jnp.arange(K) != kf_b)
        g_in = jnp.asarray(g_corr)
        g_opt = pose_graph.optimize_essential_graph(
            g_in, kf_free, ei, ej, meas, ok)

        # apply: poses from Sim3 ([R | t/s]); points corrected through their
        # first (creating) keyframe's old->new transform
        new_Tcw = jax.vmap(sim3.to_se3)(g_opt)
        new_Tcw = jnp.where(state.kf_valid[:, None, None], new_Tcw,
                            state.kf_Tcw)
        ref_kf = jnp.clip(state.mp_first_kf, 0, K - 1)
        g_ref_old = g_in[ref_kf]
        g_ref_new = g_opt[ref_kf]
        x_mid = jax.vmap(sim3.apply)(g_ref_old, state.mp_pos)
        x_new = jax.vmap(lambda g, x: sim3.apply(sim3.inverse(g), x))(
            g_ref_new, x_mid)
        mp_pos = jnp.where(
            (state.mp_valid & (state.mp_first_kf >= 0))[:, None],
            x_new, state.mp_pos)
        state = state._replace(kf_Tcw=new_Tcw, mp_pos=mp_pos)

        # full-map BA, dispatched ASYNCHRONOUSLY: the reference spawns a
        # GBA thread so tracking/mapping continue during the solve
        # (src/LoopClosing.cc:812); here the solve is enqueued on the
        # device WITHOUT chaining it into the tracker's state — the host
        # returns immediately, tracking keeps dispatching against the
        # pose-graph-corrected map, and the result merges at the next
        # keyframe boundary (merge_pending_gba).  A newer loop closure
        # supersedes a pending GBA exactly as the reference's mnFullBAIdx
        # check aborts/ignores an outdated run (LoopClosing.cc:897-907).
        if self.run_gba:
            self._gba_pending = None  # superseded by this newer loop
            Tcw_gba, pos_gba = global_ba.dispatch_global_ba(
                state, self.calib, self.cfg, n_outer=9)
            self._gba_pending = (
                Tcw_gba, pos_gba,
                state.kf_valid, state.kf_frame_id,
                state.mp_valid, state.mp_first_frame,
            )
        return state

    # ------------------------------------------------------------------

    def merge_pending_gba(self, state: ms.MapState) -> ms.MapState:
        """Fold an asynchronously dispatched GBA result into the live map.

        Reference LoopClosing::RunGlobalBundleAdjustment
        (src/LoopClosing.cc:892-1001): keyframes that existed when GBA
        launched take their optimized poses; keyframes created DURING the
        solve are corrected through their spanning-tree parent
        (mTcwGBA = Tchild * Tparent^-1 * Tparent_GBA); map points that
        existed take optimized positions, newer ones are re-anchored
        through their creating keyframe's old->new transform.
        """
        if self._gba_pending is None:
            return state
        (Tcw_gba, pos_gba, old_kf, kf_fid_launch,
         old_mp, mp_ff_launch) = self._gba_pending
        self._gba_pending = None
        self.n_gba_merged += 1
        return _merge_gba(state, Tcw_gba, pos_gba, old_kf, kf_fid_launch,
                          old_mp, mp_ff_launch)
