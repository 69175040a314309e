"""Shading unit tests: normals, Lambert/Phong, fog, shadows (SURVEY.md 4.1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from hmrt.api.scene import make_scene
from hmrt.core.renderer import render_frame
from hmrt.config import RenderConfig
from hmrt.shading import shade as sh
from hmrt.types import Camera, Light


def _flat(v, n=1):
    return jnp.asarray(np.full(n, v, np.float32))


def test_gradient_normal_analytic_ramp():
    # plane z = a*x + b*y  =>  normal ∝ (-a, -b, 1)
    n = 16
    a, b = 0.3, -0.2
    xs = np.arange(n, dtype=np.float32)
    h = a * xs[None, :] + b * xs[:, None]
    hf = jnp.asarray(h.reshape(-1))
    nx, ny, nz = sh.gradient_normal(hf, n, _flat(7.3), _flat(5.8))
    expect = np.array([-a, -b, 1.0]) / np.linalg.norm([-a, -b, 1.0])
    np.testing.assert_allclose([float(nx[0]), float(ny[0]), float(nz[0])],
                               expect, atol=1e-5)


def test_lambert_closed_form():
    # normal straight up, light at 60 degrees elevation => N.L = sin(60)
    lz = np.sin(np.deg2rad(60))
    lx = np.cos(np.deg2rad(60))
    v = sh.lambert(_flat(0.0), _flat(0.0), _flat(1.0),
                   _flat(lx), _flat(0.0), _flat(lz))
    assert float(v[0]) == pytest.approx(lz, rel=1e-6)
    # backfacing clamps to zero
    v = sh.lambert(_flat(0.0), _flat(0.0), _flat(1.0),
                   _flat(0.0), _flat(0.0), _flat(-1.0))
    assert float(v[0]) == 0.0


def test_phong_mirror_peak():
    # light and view mirrored about the normal => specular = 1
    nx, ny, nz = _flat(0.0), _flat(0.0), _flat(1.0)
    l = np.array([1.0, 0.0, 1.0]) / np.sqrt(2)
    v = np.array([-1.0, 0.0, 1.0]) / np.sqrt(2)
    s = sh.phong_specular(nx, ny, nz, _flat(l[0]), _flat(l[1]), _flat(l[2]),
                          _flat(v[0]), _flat(v[1]), _flat(v[2]), 32.0)
    assert float(s[0]) == pytest.approx(1.0, rel=1e-5)


def test_fog_closed_form():
    r, g, b = sh.apply_fog(_flat(1.0), _flat(0.0), _flat(0.0),
                           _flat(100.0), 0.01, (0.5, 0.5, 0.5))
    f = np.exp(-1.0)
    assert float(r[0]) == pytest.approx(1.0 * f + 0.5 * (1 - f), rel=1e-5)
    assert float(g[0]) == pytest.approx(0.5 * (1 - f), rel=1e-5)


def test_bilinear_height_sample():
    n = 4
    h = np.arange(16, dtype=np.float32).reshape(4, 4)
    hf = jnp.asarray(h.reshape(-1))
    v = sh.sample_height(hf, n, _flat(1.5), _flat(2.5))
    # h[y,x]: bilinear at (1.5, 2.5): corners h[2,1]=9, h[2,2]=10, h[3,1]=13, h[3,2]=14 -> 11.5
    assert float(v[0]) == pytest.approx(11.5)


def test_shadow_wall_scene():
    """A tall wall between the sun and a flat plain casts a shadow there."""
    n = 64
    h = np.zeros((n, n), np.float32)
    h[:, 30:33] = 25.0  # wall along y at x~31
    light = Light.create(sun_dir=(1.0, 0.0, 0.35))  # sun low in +x
    sc = make_scene(h, light=light)
    cam = Camera.create(eye=(16.0, 32.0, 25.0), target=(28.0, 32.0, 0.0),
                        fov_y_deg=50.0)
    cfg = RenderConfig(width=64, height=64, shadows=True, shading="lambert",
                       aux_buffers=True)
    fr = render_frame(sc, cam, cfg)
    cfg_ns = RenderConfig(width=64, height=64, shadows=False,
                          shading="lambert", aux_buffers=True)
    fr_ns = render_frame(sc, cam, cfg_ns)
    img = np.asarray(fr.color)
    img_ns = np.asarray(fr_ns.color)
    hit = np.asarray(fr.hit)
    # the sun sits ~19 deg above the horizon behind a 25-unit wall: the
    # whole visible plain west of it is occluded -> many darkened pixels,
    # at exactly the ambient floor (diffuse fully removed)
    darker = (img.sum(-1) < img_ns.sum(-1) - 0.05) & hit
    assert darker.sum() > 200
    amb_floor = 0.55 * 0.15  # albedo * ambient
    np.testing.assert_allclose(img[darker], amb_floor, atol=1e-5)
    # sky pixels are untouched by the shadow pass
    np.testing.assert_allclose(img[~hit], img_ns[~hit], atol=1e-6)


def test_aux_buffers_depth_normal():
    n = 32
    h = np.zeros((n, n), np.float32)
    sc = make_scene(h)
    cam = Camera.create(eye=(16.0, 16.0, 10.0), target=(16.0, 16.01, 0.0))
    cfg = RenderConfig(width=16, height=16, aux_buffers=True)
    fr = render_frame(sc, cam, cfg)
    depth = np.asarray(fr.depth)
    nrm = np.asarray(fr.normal)
    hit = np.asarray(fr.hit)
    assert hit.all()
    # looking straight down at a flat plane from z=10: min depth ~= 10
    # (pixel centers are offset from the optical axis by half a pixel)
    assert depth.min() == pytest.approx(10.0, rel=2e-2)
    # normals straight up
    np.testing.assert_allclose(nrm[hit][:, 2], 1.0, atol=1e-5)
