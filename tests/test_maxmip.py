"""Max-mip march exactness vs brute-force DDA (SURVEY.md section 4.1).

"The single most important invariant — the accelerator must be exact, not
approximate": on randomized procedural terrains, the hierarchical march must
return the same hit mask, hit cell, and hit t as fine-level brute force.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from hmrt.api.scene import make_scene
from hmrt.io.heightmap import procedural_terrain
from hmrt.traversal.march import march_dda, march_maxmip

from conftest import random_rays


def _run_both(n, seed, n_rays=256, kind="mixed", intersect="triangle"):
    h = procedural_terrain(n, seed=seed)
    sc = make_scene(h)
    o, d = random_rays(n_rays, n, seed=seed, kind=kind)
    args = [jnp.asarray(o[:, i]) for i in range(3)] + [jnp.asarray(d[:, i]) for i in range(3)]
    hf = sc.heights.reshape(-1)
    acc = march_maxmip(*args, sc.pyr_flat, hf, n=n, m=sc.m, levels=sc.levels,
                       max_steps=16 * n, cell_intersect=intersect)
    ref = march_dda(*args, hf, n=n, max_steps=8 * n, cell_intersect=intersect)
    return acc, ref


@pytest.mark.parametrize("n,seed", [(64, 0), (64, 1), (256, 2)])
def test_maxmip_equals_bruteforce(n, seed):
    acc, ref = _run_both(n, seed)
    acc_hit = np.asarray(acc.hit)
    ref_hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(acc_hit, ref_hit)
    m = acc_hit
    np.testing.assert_array_equal(np.asarray(acc.cx)[m], np.asarray(ref.cx)[m])
    np.testing.assert_array_equal(np.asarray(acc.cy)[m], np.asarray(ref.cy)[m])
    np.testing.assert_allclose(np.asarray(acc.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-4)


def test_maxmip_axis_aligned_and_diagonal_rays():
    acc, ref = _run_both(64, 5, n_rays=64, kind="axis")
    np.testing.assert_array_equal(np.asarray(acc.hit), np.asarray(ref.hit))
    m = np.asarray(acc.hit)
    np.testing.assert_allclose(np.asarray(acc.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("intersect", ["bilinear", "flat"])
def test_maxmip_exact_other_surface_models(intersect):
    acc, ref = _run_both(64, 7, n_rays=128, intersect=intersect)
    np.testing.assert_array_equal(np.asarray(acc.hit), np.asarray(ref.hit))
    m = np.asarray(acc.hit)
    np.testing.assert_allclose(np.asarray(acc.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-4)


def test_maxmip_does_less_work():
    # the accelerator's reason to exist: far fewer total lane-steps than
    # brute force (work = sum of alive lanes over all loop iterations)
    acc, ref = _run_both(256, 3, n_rays=512)
    assert int(acc.work) < int(ref.work) / 3, (int(acc.work), int(ref.work))
    # note: LOOP ITERATIONS can exceed brute DDA's (descend/ascend overhead
    # on the slowest lane) — that is exactly why the production path runs
    # tile-granular with early exit rather than one global wavefront.


def test_camera_under_terrain_immediate_hits():
    n = 64
    h = procedural_terrain(n, seed=9)
    sc = make_scene(h)
    # eye buried below the surface looking up and sideways: must still terminate
    o = np.array([[20.0, 20.0, -5.0]] * 8, np.float32)
    d = np.array([[1, 0.3, 0.5], [0, 1, 0.2], [1, 1, 0.01], [-1, 0.5, 0.3],
                  [0.2, -1, 0.1], [1, 0, 0], [0, 1, 0], [0.5, 0.5, 1.0]], np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    args = [jnp.asarray(o[:, i]) for i in range(3)] + [jnp.asarray(d[:, i]) for i in range(3)]
    hf = sc.heights.reshape(-1)
    res = march_maxmip(*args, sc.pyr_flat, hf, n=n, m=sc.m, levels=sc.levels,
                       max_steps=16 * n)
    ref = march_dda(*args, hf, n=n, max_steps=8 * n)
    np.testing.assert_array_equal(np.asarray(res.hit), np.asarray(ref.hit))


def test_sky_early_out():
    n = 64
    h = procedural_terrain(n, seed=9)
    sc = make_scene(h)
    zmax = float(np.asarray(h).max())
    o = np.array([[10.0, 10.0, zmax + 5.0]] * 4, np.float32)
    d = np.array([[1, 0.2, 0.1], [0.3, 1, 0.0], [1, 1, 0.5], [0, 1, 0.9]], np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    args = [jnp.asarray(o[:, i]) for i in range(3)] + [jnp.asarray(d[:, i]) for i in range(3)]
    hf = sc.heights.reshape(-1)
    res = march_maxmip(*args, sc.pyr_flat, hf, n=n, m=sc.m, levels=sc.levels,
                       max_steps=16 * n)
    assert not np.asarray(res.hit).any()
    assert int(res.steps) == 0  # early-out: no march iterations at all
