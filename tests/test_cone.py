"""Cone-ratio field (core/cone.py): the conservative-bound invariant, and
bit-exactness of the cone-jump march vs brute-force DDA.

The cone jump is the round-3 answer to the measured grazing-tail wall
(BENCH_NOTES.md): it must cut step counts WITHOUT changing a single hit
decision — the same exactness bar as the max-mip itself (SURVEY.md 4.1).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from hmrt.api.scene import make_scene
from hmrt.core.cone import build_cone, cone_safe_cells
from hmrt.io.heightmap import procedural_terrain
from hmrt.traversal.march import march_dda, march_maxmip

from conftest import random_rays


@pytest.mark.parametrize("seed,radius", [(0, 8), (1, 16)])
def test_cone_bound_invariant(seed, radius):
    """Every sample within the radius sits at or below the cone surface."""
    rng = np.random.default_rng(seed)
    n = 48
    h = rng.uniform(0, 30, (n, n)).astype(np.float32)
    c = np.asarray(build_cone(jnp.asarray(h), radius))
    assert (c >= 0).all()
    for i, j in rng.integers(0, n, (40, 2)):
        y0, y1 = max(0, i - radius), min(n, i + radius + 1)
        x0, x1 = max(0, j - radius), min(n, j + radius + 1)
        for u in range(y0, y1):
            for v in range(x0, x1):
                d = max(abs(u - i), abs(v - j))
                if d == 0:
                    continue
                assert h[u, v] <= h[i, j] + c[i, j] * d + 1e-4 * d, \
                    (i, j, u, v, h[u, v], h[i, j], c[i, j])


def test_cone_flat_terrain_is_zero():
    c = np.asarray(build_cone(jnp.full((32, 32), 5.0), 8))
    np.testing.assert_allclose(c, 0.0, atol=1e-6)


def test_cone_single_spike():
    h = np.zeros((33, 33), np.float32)
    h[16, 16] = 10.0
    c = np.asarray(build_cone(jnp.asarray(h), 16))
    # neighbors at cheb distance d need ratio 10/d
    for d in (1, 2, 5):
        np.testing.assert_allclose(c[16, 16 - d], 10.0 / d, rtol=1e-5)
    # the spike itself dominates everything around it
    assert c[16, 16] == 0.0


def test_cone_safe_cells_monotone():
    z = jnp.asarray([10.0, 10.0, 10.0, 0.5])
    apex = jnp.asarray([0.0, 0.0, 0.0, 0.0])
    cone = jnp.asarray([0.5, 2.0, 0.0, 0.5])
    g = jnp.asarray([0.0, 0.0, 0.1, 0.0])
    k = np.asarray(cone_safe_cells(z, apex, cone, g, 64))
    assert k[0] >= 2                  # clear air over a mild cone
    assert k[1] < k[0]                # wider cone => shorter jump
    assert k[2] == 62                 # zero cone + climbing => radius cap
    assert k[3] <= 0 or k[3] < 2      # hugging: negative clearance


def _run_cone(n, seed, n_rays=512, kind="mixed", radius=32,
              intersect="triangle", grazing=False):
    h = procedural_terrain(n, seed=seed)
    sc = make_scene(h)
    if grazing:
        # near-horizontal rays from just above the terrain: the B3 tail
        rng = np.random.default_rng(seed)
        hmax = float(np.asarray(h).max())
        o = np.stack([rng.uniform(0, n - 1, n_rays),
                      np.full(n_rays, -0.5),
                      rng.uniform(0.3 * hmax, 1.1 * hmax, n_rays)],
                     -1).astype(np.float32)
        d = np.stack([rng.uniform(-0.3, 0.3, n_rays),
                      np.ones(n_rays),
                      rng.uniform(-0.05, 0.02, n_rays)], -1).astype(np.float32)
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
    else:
        o, d = random_rays(n_rays, n, seed=seed, kind=kind)
    args = [jnp.asarray(o[:, i]) for i in range(3)] \
        + [jnp.asarray(d[:, i]) for i in range(3)]
    hf = sc.heights.reshape(-1)
    cone = build_cone(sc.heights[:n, :n], radius).reshape(-1)
    kw = dict(n=n, m=sc.m, levels=sc.levels, max_steps=16 * n,
              cell_intersect=intersect)
    acc = march_maxmip(*args, sc.pyr_flat, hf, cone_flat=cone,
                       cone_radius=radius, **kw)
    ref = march_dda(*args, hf, n=n, max_steps=8 * n,
                    cell_intersect=intersect)
    plain = march_maxmip(*args, sc.pyr_flat, hf, **kw)
    return acc, ref, plain


@pytest.mark.parametrize("n,seed,kind,grazing", [
    (64, 0, "mixed", False), (64, 1, "mixed", False),
    (256, 2, "mixed", False), (64, 5, "axis", False),
    (128, 3, None, True), (128, 4, None, True)])
def test_cone_march_equals_bruteforce(n, seed, kind, grazing):
    acc, ref, _ = _run_cone(n, seed, kind=kind or "mixed", grazing=grazing)
    np.testing.assert_array_equal(np.asarray(acc.hit), np.asarray(ref.hit))
    m = np.asarray(acc.hit)
    np.testing.assert_array_equal(np.asarray(acc.cx)[m],
                                  np.asarray(ref.cx)[m])
    np.testing.assert_array_equal(np.asarray(acc.cy)[m],
                                  np.asarray(ref.cy)[m])
    np.testing.assert_allclose(np.asarray(acc.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("intersect", ["bilinear", "flat"])
def test_cone_march_other_surface_models(intersect):
    acc, ref, _ = _run_cone(64, 7, intersect=intersect)
    np.testing.assert_array_equal(np.asarray(acc.hit), np.asarray(ref.hit))
    m = np.asarray(acc.hit)
    np.testing.assert_allclose(np.asarray(acc.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-4)


def test_cone_never_increases_work():
    """MEASURED NEGATIVE RESULT (round 3, tools/diag_cone.py): on fBm
    terrain the cone jump fires on ~0% of fine steps — a lane at level 0
    either lacks clearance over its apex corner (the grazing band: the
    96% of work where the exact test misses below the cell max) or it had
    clearance and the max-mip never let it descend. The field is kept as
    the oracle-validated prototype + post-mortem evidence; the jump must
    at least never ADD work (it replaces a 1-cell step with a k>=2 jump
    only when the jump is safe)."""
    acc, _, plain = _run_cone(256, 3, n_rays=512, grazing=True, radius=64)
    assert int(acc.work) <= int(plain.work), \
        (int(acc.work), int(plain.work))
