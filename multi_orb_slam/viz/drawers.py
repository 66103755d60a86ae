"""Headless visualization: frame and map drawers.

Replaces the reference's Pangolin/OpenCV visualization stack
(src/FrameDrawer.cc, src/MapDrawer.cc, src/Viewer.cc) with headless
renderers producing numpy images / matplotlib figures — appropriate for a
server with no display:

- `draw_frame`: current image with keypoints/matches + the status bar text
  (state, #KFs, #MPs, #matches — reference FrameDrawer.cc:42-243)
- `draw_map`: map points (black=all, red=local), keyframe frusta,
  covisibility graph edges, trajectory (reference MapDrawer.cc:44-220)
- `Viewer`: periodic snapshot writer (the reference's interactive menu
  toggles map to System API calls, which exist on our System facade)
"""

from __future__ import annotations

import os

import numpy as np

from ..mapping import map_state as ms


def draw_frame(
    gray: np.ndarray,
    xy: np.ndarray,
    matched_mask: np.ndarray,
    state_text: str = "",
) -> np.ndarray:
    """Annotated BGR image: green squares on matched keypoints, blue on
    unmatched (reference FrameDrawer::DrawFrame)."""
    import cv2

    img = cv2.cvtColor(gray.astype(np.uint8), cv2.COLOR_GRAY2BGR)
    for (x, y), m in zip(xy, matched_mask):
        p = (int(round(x)), int(round(y)))
        color = (0, 255, 0) if m else (255, 0, 0)
        cv2.rectangle(img, (p[0] - 3, p[1] - 3), (p[0] + 3, p[1] + 3), color, 1)
        cv2.circle(img, p, 1, color, -1)
    if state_text:
        bar = np.zeros((22, img.shape[1], 3), np.uint8)
        cv2.putText(bar, state_text, (5, 15), cv2.FONT_HERSHEY_PLAIN, 1,
                    (255, 255, 255), 1)
        img = np.concatenate([img, bar], axis=0)
    return img


def frame_status_text(tracker) -> str:
    """Reference FrameDrawer status line (FrameDrawer.cc:168-204)."""
    state = tracker.state
    n_kf = int(tracker.map.n_kf)
    n_mp = int(tracker.map.n_mp)
    if state == 0:
        return "WAITING FOR IMAGES / NOT INITIALIZED"
    if state == 2:
        return "TRACK LOST. TRYING TO RELOCALIZE"
    mode = "LOCALIZATION | " if tracker.only_tracking else "SLAM MODE | "
    return (f"{mode}KFs: {n_kf}, MPs: {n_mp}, "
            f"Matches: {tracker.last_n_inliers}")


def draw_map(
    state: ms.MapState,
    current_Tcw: np.ndarray | None = None,
    local_mp_mask: np.ndarray | None = None,
    out_path: str | None = None,
    show_covisibility: bool = True,
):
    """Top-down (x-z) map rendering (MapDrawer::DrawMapPoints/DrawKeyFrames).

    Returns the matplotlib figure; saves to `out_path` if given.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    mp = np.asarray(state.mp_pos)
    mv = np.asarray(state.mp_valid)
    ax.scatter(mp[mv, 0], mp[mv, 2], s=1, c="k", alpha=0.4,
               label=f"map points ({mv.sum()})")
    if local_mp_mask is not None:
        lm = np.asarray(local_mp_mask) & mv
        ax.scatter(mp[lm, 0], mp[lm, 2], s=2, c="r", label="local points")

    kfv = np.asarray(state.kf_valid)
    centers = []
    for k in np.nonzero(kfv)[0]:
        T = np.asarray(state.kf_Tcw[k])
        c = -T[:3, :3].T @ T[:3, 3]
        centers.append((k, c))
        # frustum direction tick
        fwd = T[:3, :3].T @ np.array([0, 0, 0.2])
        ax.plot([c[0], c[0] + fwd[0]], [c[2], c[2] + fwd[2]], "b-", lw=0.8)
    if centers:
        cs = np.stack([c for _, c in centers])
        ax.scatter(cs[:, 0], cs[:, 2], s=14, c="b", marker="s",
                   label=f"keyframes ({len(centers)})")

    if show_covisibility and len(centers) > 1:
        import jax.numpy as jnp  # noqa: F401
        W = np.asarray(ms.covisibility(state))
        idx = {k: c for k, c in centers}
        for a in idx:
            for b in idx:
                if a < b and W[a, b] >= 15:
                    ca, cb = idx[a], idx[b]
                    ax.plot([ca[0], cb[0]], [ca[2], cb[2]], "g-",
                            lw=0.4, alpha=0.5)

    if current_Tcw is not None:
        c = -current_Tcw[:3, :3].T @ current_Tcw[:3, 3]
        ax.scatter([c[0]], [c[2]], s=60, c="lime", marker="^",
                   label="current camera")

    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    if out_path:
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig


class Viewer:
    """Periodic snapshot writer standing in for the Pangolin UI thread
    (reference src/Viewer.cc:54-140).  Call `update` once per frame; every
    `every` frames it writes frame/map snapshots to `out_dir`."""

    def __init__(self, out_dir: str, every: int = 30):
        self.out_dir = out_dir
        self.every = every
        self.count = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, tracker, gray: np.ndarray | None = None):
        self.count += 1
        if self.count % self.every:
            return
        tag = f"{self.count:06d}"
        if gray is not None and tracker.prev_mp is not None:
            xy = np.asarray(tracker.prev_frame.xy[0])
            ok = np.asarray(tracker.prev_mp[0]) >= 0
            img = draw_frame(gray, xy, ok, frame_status_text(tracker))
            import cv2
            cv2.imwrite(os.path.join(self.out_dir, f"frame_{tag}.png"), img)
        draw_map(
            tracker.map, np.asarray(tracker.Tcw),
            out_path=os.path.join(self.out_dir, f"map_{tag}.png"),
        )
