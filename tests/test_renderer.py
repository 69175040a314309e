"""End-to-end oracle renderer tests + golden images (SURVEY.md 4.1, 4.3)."""

import numpy as np

from hmrt.api.scene import make_scene
from hmrt.bench.goldens import golden_diff, golden_render
from hmrt.config import RenderConfig
from hmrt.core.renderer import render_frame
from hmrt.types import Camera


def test_maxmip_render_equals_dda_render(scene64, camera64):
    cfg_m = RenderConfig(width=96, height=64, traversal="maxmip")
    cfg_d = RenderConfig(width=96, height=64, traversal="dda")
    fm = render_frame(scene64, camera64, cfg_m)
    fd = render_frame(scene64, camera64, cfg_d)
    np.testing.assert_array_equal(np.asarray(fm.hit), np.asarray(fd.hit))
    np.testing.assert_allclose(np.asarray(fm.color), np.asarray(fd.color),
                               atol=1e-5)


def test_full_feature_configs_run(scene64, camera64):
    for cfg in [
        RenderConfig(width=32, height=32, shading="phong", shadows=True,
                     fog=True, aux_buffers=True),
        RenderConfig(width=32, height=32, cell_intersect="bilinear"),
        RenderConfig(width=32, height=32, cell_intersect="flat"),
    ]:
        fr = render_frame(scene64, camera64, cfg)
        img = np.asarray(fr.color)
        assert np.isfinite(img).all()
        assert (img >= 0).all() and (img <= 1).all()
        assert np.asarray(fr.hit).any()


def test_textured_render(terrain64, camera64):
    n = terrain64.shape[0]
    rng = np.random.default_rng(0)
    albedo = rng.uniform(0.2, 0.9, (n, n, 3)).astype(np.float32)
    sc = make_scene(terrain64, albedo=albedo)
    cfg = RenderConfig(width=32, height=32, texture=True)
    fr = render_frame(sc, camera64, cfg)
    img = np.asarray(fr.color)
    assert np.isfinite(img).all()
    # textured image differs from untextured
    fr2 = render_frame(sc, camera64, RenderConfig(width=32, height=32))
    assert np.abs(img - np.asarray(fr2.color)).max() > 0.01


def _golden_check(name):
    # allow 1-bit quantization wiggle across backends/compilers
    diff = golden_diff(name, golden_render(name))
    assert (diff <= 1).all(), \
        f"golden mismatch: max diff {diff.max()}, {(diff > 1).sum()} px"


def test_golden_image_b1():
    """64x64 golden render of the B1-style scene, byte-stable (SURVEY.md 4.3)."""
    _golden_check("b1")


def test_golden_image_b2_style():
    """64x64 golden of the B2 feature set: max-mip + depth/normal aux
    buffers (BASELINE.json:8); depth golden checked alongside color."""
    _golden_check("b2")


def test_golden_image_b3_style():
    """64x64 golden of the B3 feature set: shadows + Phong + sky early-out
    (BASELINE.json:9)."""
    _golden_check("b3")


def test_camera_rays_unit_and_fov():
    cam = Camera.create(eye=(0, 0, 5), target=(0, 10, 5), fov_y_deg=90.0)
    eye, dirs = cam.rays(8, 8)
    d = np.asarray(dirs)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    # 90 deg vertical fov: top-center ray should have z component ~ tan(45)*~(7/8)
    assert d[0, 4, 2] > 0.5
    assert d[-1, 4, 2] < -0.5
    # all rays roughly forward (+y)
    assert (d[..., 1] > 0.2).all()
