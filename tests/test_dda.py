"""Uniform-grid DDA property tests (SURVEY.md section 4.1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from hmrt.traversal.march import (
    entry_cell, ray_box_range, step_geometry)


def _trace_cells(o, d, n, max_steps=512):
    """Enumerate the fine cells the integer DDA visits, with entry ts."""
    ox, oy = jnp.float32(o[0]), jnp.float32(o[1])
    dx, dy = jnp.float32(d[0]), jnp.float32(d[1])
    t0, t1, valid = ray_box_range(ox, oy, dx, dy, float(n - 1))
    if not bool(valid):
        return [], []
    lvl = jnp.zeros((), jnp.int32)
    icx, icy = entry_cell(ox, oy, dx, dy, t0, lvl, n - 1)
    t = float(t0)
    cells, ts = [], []
    for _ in range(max_steps):
        cells.append((int(icx), int(icy)))
        ts.append(t)
        t_exit, nx, ny, _ = step_geometry(ox, oy, dx, dy, icx, icy, lvl)
        if float(t_exit) >= float(t1) - 1e-6:
            break
        if int(nx) < 0 or int(nx) >= n - 1 or int(ny) < 0 or int(ny) >= n - 1:
            break
        icx, icy = nx, ny
        t = max(t, float(t_exit))
    return cells, ts


def _oracle_cells(o, d, n, samples=40000):
    """Cells visited per dense sampling of the segment inside the box."""
    t0, t1, valid = ray_box_range(jnp.float32(o[0]), jnp.float32(o[1]),
                                  jnp.float32(d[0]), jnp.float32(d[1]),
                                  float(n - 1))
    if not bool(valid):
        return []
    ts = np.linspace(float(t0) + 1e-5, float(t1) - 1e-5, samples)
    px = o[0] + ts * d[0]
    py = o[1] + ts * d[1]
    cx = np.clip(np.floor(px).astype(int), 0, n - 2)
    cy = np.clip(np.floor(py).astype(int), 0, n - 2)
    seen, out = set(), []
    for c in zip(cx.tolist(), cy.tolist()):
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_dda_visits_oracle_cells(seed):
    rng = np.random.default_rng(seed)
    n = 16
    o = np.array([rng.uniform(-5, 20), rng.uniform(-5, 20), 3.0])
    ang = rng.uniform(0, 2 * np.pi)
    d = np.array([np.cos(ang), np.sin(ang), -0.1])
    d = d / np.linalg.norm(d)
    got, ts = _trace_cells(o, d, n)
    want = _oracle_cells(o, d, n)
    # allow corner-tie divergence: every oracle cell must appear, in order,
    # possibly with extra corner cells interleaved
    gi = 0
    missing = []
    for c in want:
        while gi < len(got) and got[gi] != c:
            gi += 1
        if gi == len(got):
            missing.append(c)
    assert not missing, f"missing cells {missing}; got {got}, want {want}"


@pytest.mark.parametrize("seed", range(6))
def test_dda_t_monotonic_nondecreasing(seed):
    rng = np.random.default_rng(100 + seed)
    o = np.array([rng.uniform(-5, 20), rng.uniform(-5, 20), 3.0])
    ang = rng.uniform(0, 2 * np.pi)
    d = np.array([np.cos(ang), np.sin(ang), -0.2])
    d = d / np.linalg.norm(d)
    got, ts = _trace_cells(o, d, 16)
    assert all(b >= a for a, b in zip(ts, ts[1:]))
    assert len(set(got)) == len(got), "no cell visited twice"


def test_dda_axis_aligned():
    got, _ = _trace_cells(np.array([-1.0, 4.5, 1.0]), np.array([1.0, 0.0, 0.0]), 9)
    assert got == [(x, 4) for x in range(8)]
    got, _ = _trace_cells(np.array([4.5, -1.0, 1.0]), np.array([0.0, 1.0, 0.0]), 9)
    assert got == [(4, y) for y in range(8)]


def test_dda_diagonal_45deg_terminates():
    # exact corner-crossing diagonal: must terminate, never revisit a cell
    d = np.array([1.0, 1.0, 0.0]) / np.sqrt(2)
    got, ts = _trace_cells(np.array([0.0, 0.0, 1.0]), d, 9)
    assert len(got) >= 8
    assert len(set(got)) == len(got)
    xs = [c[0] for c in got]
    assert xs == sorted(xs)


def test_negative_direction():
    got, _ = _trace_cells(np.array([9.0, 4.2, 1.0]), np.array([-1.0, 0.0, 0.0]), 9)
    assert got == [(x, 4) for x in range(7, -1, -1)]


def test_grazing_direction_no_stall():
    # tiny dx (the case that stalled a float-epsilon DDA): must cross the
    # grid in ~n steps, never repeating a cell
    o = np.array([49.531097, 80.3237, 32.19], np.float32)
    d = np.array([-0.01235653, -0.91633993, -0.40021056], np.float32)
    got, ts = _trace_cells(o, d, 64, max_steps=400)
    assert len(got) < 200
    assert len(set(got)) == len(got)
