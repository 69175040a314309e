"""Ray/cell intersection vs analytic cases (SURVEY.md section 4.1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from hmrt.traversal.intersect import (
    intersect_bilinear, intersect_flat, intersect_triangles, BIG_T)


def _shoot(fn, o, d, cell, corners, t_lo=0.0, t_hi=1e9):
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    d = d / np.linalg.norm(d)
    args = [jnp.asarray([v], jnp.float32) for v in (*o, *d)]
    cx = jnp.asarray([cell[0]], jnp.int32)
    cy = jnp.asarray([cell[1]], jnp.int32)
    zs = [jnp.asarray([z], jnp.float32) for z in corners]
    hit, t = fn(*args, cx, cy, *zs,
                jnp.asarray([t_lo], jnp.float32), jnp.asarray([t_hi], jnp.float32))
    return bool(hit[0]), float(t[0])


@pytest.mark.parametrize("fn", [intersect_triangles, intersect_bilinear])
def test_flat_plane_closed_form(fn):
    # flat cell at z=2: vertical ray from z=10 hits at t=8
    hit, t = _shoot(fn, (5.5, 7.25, 10.0), (0, 0, -1), (5, 7), (2, 2, 2, 2))
    assert hit and t == pytest.approx(8.0, rel=1e-5)


@pytest.mark.parametrize("fn", [intersect_triangles, intersect_bilinear])
def test_ramp_closed_form(fn):
    # planar ramp z = x - cx across cell (0,0): corners 0,1,0,1
    # oblique ray o=(0, .5, 1), d=(1,0,-1)/sqrt2: o+t*d has x = t/sq2, z = 1 - t/sq2
    # surface z = x => 1 - u = u with u = t/sq2 => u = .5, t = .5*sqrt(2)
    hit, t = _shoot(fn, (0.0, 0.5, 1.0), (1, 0, -1), (0, 0), (0, 1, 0, 1))
    assert hit and t == pytest.approx(0.5 * np.sqrt(2.0), rel=1e-5)


@pytest.mark.parametrize("fn", [intersect_triangles, intersect_bilinear, intersect_flat])
def test_miss_above(fn):
    hit, _ = _shoot(fn, (5.5, 7.5, 10.0), (1, 0, 0), (5, 7), (2, 2, 2, 2),
                    t_lo=0.0, t_hi=3.0)
    assert not hit


@pytest.mark.parametrize("fn", [intersect_triangles, intersect_bilinear])
def test_one_texel_spike_not_missed(fn):
    # spike at corner (0,0) of cell (0,0); steep descending ray into it
    hit, t = _shoot(fn, (0.05, 0.05, 5.0), (0, 0, -1), (0, 0), (4, 0, 0, 0))
    assert hit
    # surface at (0.05, 0.05): triangle T1 z = 4*(1-u-v)=4*0.9=3.6;
    # bilinear z = 4*(1-u)(1-v) = 4*0.9025=3.61
    assert t == pytest.approx(5.0 - 3.6, abs=0.05)


def test_flat_column_top():
    hit, t = _shoot(intersect_flat, (5.5, 7.5, 10.0), (0, 0, -1), (5, 7),
                    (1, 2, 1.5, 0.5))
    assert hit and t == pytest.approx(8.0, rel=1e-5)  # top at max corner z=2


@pytest.mark.parametrize("fn", [intersect_triangles, intersect_bilinear])
def test_t_range_respected(fn):
    hit, _ = _shoot(fn, (5.5, 7.25, 10.0), (0, 0, -1), (5, 7), (2, 2, 2, 2),
                    t_lo=0.0, t_hi=7.0)
    assert not hit
    hit, _ = _shoot(fn, (5.5, 7.25, 10.0), (0, 0, -1), (5, 7), (2, 2, 2, 2),
                    t_lo=8.5, t_hi=100.0)
    assert not hit


def test_triangle_vs_bilinear_agree_on_planes():
    # on planar corner sets the two surface models coincide
    rng = np.random.default_rng(0)
    for _ in range(50):
        gx, gy, z0 = rng.uniform(-1, 1, 3)
        corners = (z0, z0 + gx, z0 + gy, z0 + gx + gy)
        o = (0.3 + rng.uniform(0, 0.4), 0.3 + rng.uniform(0, 0.4), 5.0)
        d = (rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), -1.0)
        h1, t1 = _shoot(intersect_triangles, o, d, (0, 0), corners)
        h2, t2 = _shoot(intersect_bilinear, o, d, (0, 0), corners)
        assert h1 == h2
        if h1:
            assert t1 == pytest.approx(t2, abs=1e-4)


def test_bilinear_saddle_vs_sampling():
    # saddle corners: bilinear surface differs from triangles; verify the
    # bilinear hit against dense sampling of f(t) = ray_z - surface_z
    corners = (0.0, 1.0, 1.0, 0.0)
    o = np.array([0.0, 0.9, 1.2], np.float32)
    d = np.array([1.0, -0.8, -0.9], np.float32)
    d = d / np.linalg.norm(d)
    hit, t = _shoot(intersect_bilinear, o, d, (0, 0), corners)
    ts = np.linspace(0, 2, 200001)
    p = o[None, :] + ts[:, None] * d[None, :]
    inside = (p[:, 0] >= 0) & (p[:, 0] <= 1) & (p[:, 1] >= 0) & (p[:, 1] <= 1)
    z00, z10, z01, z11 = corners
    u, v = p[:, 0], p[:, 1]
    surf = z00 * (1 - u) * (1 - v) + z10 * u * (1 - v) + z01 * (1 - u) * v + z11 * u * v
    below = inside & (p[:, 2] <= surf)
    assert hit == below.any()
    if hit:
        t_ref = ts[np.argmax(below)]
        assert t == pytest.approx(t_ref, abs=1e-3)
