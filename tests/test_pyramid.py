"""Max-mip pyramid invariants (SURVEY.md section 4.1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from hmrt.core import pyramid as pyr
from hmrt.io.heightmap import procedural_terrain


@pytest.mark.parametrize("n", [8, 33, 64, 100])
def test_levels_dominate_children(n):
    h = procedural_terrain(n, seed=1)
    levels = pyr.build_levels(jnp.asarray(h))
    m = pyr.next_pow2(n - 1)
    assert levels[0].shape == (m, m)
    assert levels[-1].shape == (1, 1)
    for k in range(1, len(levels)):
        parent = np.asarray(levels[k])
        child = np.asarray(levels[k - 1])
        expect = child.reshape(parent.shape[0], 2, parent.shape[1], 2).max(axis=(1, 3))
        np.testing.assert_array_equal(parent, expect)


def test_top_is_global_max():
    h = procedural_terrain(64, seed=2)
    levels = pyr.build_levels(jnp.asarray(h))
    # top of the pyramid == global max over CELL maxes == global height max
    assert float(levels[-1][0, 0]) == pytest.approx(float(h.max()), abs=1e-6)


def test_level0_bounds_surface():
    h = procedural_terrain(32, seed=3)
    lvl0 = np.asarray(pyr.build_levels(jnp.asarray(h))[0])
    cm = np.asarray(pyr.cell_maxes(jnp.asarray(h)))
    nc = cm.shape[0]
    np.testing.assert_array_equal(lvl0[:nc, :nc], cm)
    # padding is the sentinel
    if lvl0.shape[0] > nc:
        assert (lvl0[nc:, :] <= pyr.NEG_INF).all()
        assert (lvl0[:, nc:] <= pyr.NEG_INF).all()


@pytest.mark.parametrize("n_cells", [1, 2, 3, 7, 32, 63])
def test_flat_layout_and_offsets(n_cells):
    m = pyr.next_pow2(n_cells)
    total = 0
    for lvl in range(pyr.num_levels(m)):
        assert pyr.level_offset(m, lvl) == total
        total += (m >> lvl) ** 2
    assert pyr.flat_size(m) == total


def test_flat_index_matches_levels():
    h = procedural_terrain(33, seed=4)
    levels = pyr.build_levels(jnp.asarray(h))
    flat = np.asarray(pyr.flatten_levels(levels))
    m = levels[0].shape[0]
    rng = np.random.default_rng(0)
    for lvl, arr in enumerate(levels):
        side = arr.shape[0]
        for _ in range(10):
            cy = int(rng.integers(0, side))
            cx = int(rng.integers(0, side))
            idx = int(pyr.flat_index(m, lvl, cy, cx))
            assert flat[idx] == np.asarray(arr)[cy, cx]


def test_flat_index_vectorized_per_lane_levels():
    m = 16
    lvls = jnp.asarray([0, 1, 2, 3, 4], jnp.int32)
    cy = jnp.asarray([3, 1, 2, 1, 0], jnp.int32)
    cx = jnp.asarray([5, 7, 3, 0, 0], jnp.int32)
    got = np.asarray(pyr.flat_index(m, lvls, cy, cx))
    expect = [pyr.level_offset(m, int(l)) + int(y) * (m >> int(l)) + int(x)
              for l, y, x in zip(lvls, cy, cx)]
    np.testing.assert_array_equal(got, expect)
