"""Flythrough camera paths + animation scan (SURVEY.md C8, section 3.5)."""

import numpy as np
import jax
import jax.numpy as jnp

from hmrt.api.flythrough import (flythrough, frame_camera,
                                     orbit_flythrough)
from hmrt.bench.timing import _scan_frames
from hmrt.config import RenderConfig
from hmrt.core.renderer import render_frame


def test_flythrough_passes_through_keyframes():
    keys = [((0, 0, 10), (5, 5, 0)), ((10, 0, 10), (5, 5, 0)),
            ((10, 10, 12), (5, 5, 0))]
    cams = flythrough(keys, n_frames=8)
    assert cams.eye.shape == (8, 3)
    # first frame is at the first keyframe
    np.testing.assert_allclose(np.asarray(cams.eye[0]), [0, 0, 10], atol=1e-5)
    # positions are continuous (no jumps)
    d = np.diff(np.asarray(cams.eye), axis=0)
    assert np.linalg.norm(d, axis=1).max() < 6.0


def test_frame_camera_indexing():
    cams = orbit_flythrough(64, zmax=5.0, n_frames=5)
    c2 = frame_camera(cams, 2)
    assert c2.eye.shape == (3,)
    np.testing.assert_allclose(np.asarray(c2.eye), np.asarray(cams.eye[2]))


def test_animation_scan_runs(scene64):
    cams = orbit_flythrough(64, zmax=float(np.asarray(scene64.heights).max()),
                            n_frames=3)
    cfg = RenderConfig(width=32, height=16)
    acc = _scan_frames(scene64, cams, cfg, 3)
    assert np.isfinite(float(acc))
    # animated frames differ
    f0 = render_frame(scene64, frame_camera(cams, 0), cfg)
    f2 = render_frame(scene64, frame_camera(cams, 2), cfg)
    assert np.abs(np.asarray(f0.color) - np.asarray(f2.color)).max() > 0.01
