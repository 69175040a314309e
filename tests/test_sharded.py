"""Multi-device shard_map render == single-device render (SURVEY.md 4.4).

Runs on 8 virtual CPU devices (conftest sets
--xla_force_host_platform_device_count=8); mesh logic is device-count
generic so this proves the collective/gather plumbing without several
cards. The `multi_device` fixture skips where there is only one device.
"""

import numpy as np
import pytest

from hmrt.config import RenderConfig
from hmrt.core.renderer import render_frame
from hmrt.distrib.mesh import make_mesh, render_frame_sharded, replicate_scene


def test_sharded_render_pixel_identical(multi_device, scene64, camera64):
    mesh = make_mesh()
    sc = replicate_scene(scene64, mesh)
    cfg = RenderConfig(width=64, height=64, aux_buffers=True)
    fr_s = render_frame_sharded(sc, camera64, cfg, mesh)
    fr_1 = render_frame(scene64, camera64, cfg)
    np.testing.assert_array_equal(np.asarray(fr_s.hit), np.asarray(fr_1.hit))
    # colors agree to float ulp (XLA fuses the shaded band differently
    # across the shard_map boundary); hits are exact
    np.testing.assert_allclose(np.asarray(fr_s.color), np.asarray(fr_1.color),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(fr_s.depth), np.asarray(fr_1.depth),
                               rtol=1e-6)


def test_sharded_full_features(multi_device, scene64, camera64):
    mesh = make_mesh()
    sc = replicate_scene(scene64, mesh)
    cfg = RenderConfig(width=32, height=32, shading="phong", shadows=True,
                       fog=True)
    fr_s = render_frame_sharded(sc, camera64, cfg, mesh)
    fr_1 = render_frame(scene64, camera64, cfg)
    np.testing.assert_allclose(np.asarray(fr_s.color), np.asarray(fr_1.color),
                               atol=1e-6)


def test_uneven_height_raises(multi_device, scene64, camera64):
    mesh = make_mesh()
    with pytest.raises(ValueError):
        render_frame_sharded(scene64, camera64,
                             RenderConfig(width=16, height=17), mesh)


def test_flythrough_frame_sharded(multi_device, scene64):
    """Frame-axis DP (render_flythrough_sharded): the sharded animation
    stack equals per-frame single-device renders, frame for frame."""
    from hmrt.api.flythrough import frame_camera, orbit_flythrough
    from hmrt.distrib.mesh import render_flythrough_sharded
    ndev = len(multi_device)
    mesh = make_mesh(axis_name="frames")
    sc = replicate_scene(scene64, mesh)
    zmax = float(np.asarray(scene64.heights).max())
    F = 2 * ndev  # two scan steps per chip
    cams = orbit_flythrough(64, zmax, F)
    cfg = RenderConfig(width=32, height=24, shading="phong", shadows=True,
                       fog=True)
    stack = np.asarray(render_flythrough_sharded(sc, cams, cfg, mesh))
    assert stack.shape == (F, 24, 32, 3)
    for i in (0, 1, ndev, F - 1):  # first/second local frame, chip 1, last
        fr = render_frame(scene64, frame_camera(cams, i), cfg)
        # float-ulp wiggle: XLA fuses the shade differently under
        # scan+shard_map (the Phong rsqrt/pow chain amplifies to a few ulp
        # on grazing pixels)
        np.testing.assert_allclose(stack[i], np.asarray(fr.color), atol=1e-5)


def test_flythrough_uneven_frames_raises(multi_device, scene64):
    from hmrt.api.flythrough import orbit_flythrough
    from hmrt.distrib.mesh import render_flythrough_sharded
    mesh = make_mesh(axis_name="frames")
    cams = orbit_flythrough(64, 10.0, len(multi_device) + 1)
    with pytest.raises(ValueError):
        render_flythrough_sharded(scene64, cams,
                                  RenderConfig(width=16, height=16), mesh)
