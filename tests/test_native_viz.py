import os

import numpy as np
import pytest

from multi_orb_slam.io import native_loader, synthetic
from multi_orb_slam.viz import drawers


class TestNativeLoader:
    def test_build_and_roundtrip(self, tmp_path):
        import cv2

        if not native_loader.native_available():
            pytest.skip("native toolchain unavailable")
        # write a small synthetic TUM-style pair set (PNG gray + 16-bit depth)
        world = synthetic.make_box_world(seed=0, n_points=500)
        K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
        items = []
        refs = []
        for i in range(4):
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = 0.05 * i
            g, d = synthetic.render_rgbd(world, K, T, 240, 320)
            rgb_p = str(tmp_path / f"rgb_{i}.png")
            dep_p = str(tmp_path / f"d_{i}.png")
            cv2.imwrite(rgb_p, g.astype(np.uint8))
            cv2.imwrite(dep_p, (d * 5000.0).astype(np.uint16))
            items.append((rgb_p, dep_p))
            refs.append((g, d))
        loader = native_loader.AsyncRGBDLoader(items, 240, 320,
                                               depth_factor=5000.0)
        for i, (gray, depth) in enumerate(loader):
            g_ref, d_ref = refs[i]
            np.testing.assert_allclose(gray, np.round(g_ref).astype(np.uint8),
                                       atol=1.0)
            np.testing.assert_allclose(depth, d_ref, atol=1e-3)
        loader.close()

    def test_jpeg_gray(self, tmp_path):
        import cv2

        if not native_loader.native_available():
            pytest.skip("native toolchain unavailable")
        img = (np.random.RandomState(0).rand(120, 160) * 255).astype(np.uint8)
        p = str(tmp_path / "x.jpg")
        cv2.imwrite(p, img)
        loader = native_loader.AsyncRGBDLoader([(p, None)], 120, 160)
        gray, depth = next(iter(loader))
        # JPEG is lossy; just require strong correlation
        assert np.corrcoef(gray.ravel(), img.ravel())[0, 1] > 0.95
        loader.close()


class TestViz:
    def test_draw_frame_and_map(self, tmp_path):
        import jax.numpy as jnp

        from multi_orb_slam.frontend import tracking
        from test_tracking import small_calib, small_cfg

        calib = small_calib()
        cfg = small_cfg()
        seq = synthetic.make_sequence(
            n_frames=4, K=np.asarray(calib.K[0]), height=240, width=320,
            n_points=2500)
        tr = tracking.Tracker(calib, cfg)
        viewer = drawers.Viewer(str(tmp_path / "viz"), every=2)
        for g, d in zip(seq.grays, seq.depths):
            tr.process(g, d)
            viewer.update(tr, g[0])
        outs = os.listdir(str(tmp_path / "viz"))
        assert any(f.startswith("map_") for f in outs)
        assert any(f.startswith("frame_") for f in outs)
        # status text renders
        txt = drawers.frame_status_text(tr)
        assert "KFs" in txt or "LOST" in txt
