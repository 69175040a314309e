"""The Pallas-Triton march kernel (traversal/march_pallas.py) against the
XLA march it replaces on the GPU, and the choice of path.

On the CPU the kernel runs in the Pallas interpreter and must match
`march_maxmip` exactly: same step function, same float order. The CUDA
lowering tests build the kernel's Triton program for the card without one,
which catches primitives the Triton route cannot lower. The compiled
kernel itself runs in the `gpu` tests.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hmrt.api.scene import make_scene
from hmrt.core import renderer
from hmrt.io.heightmap import procedural_terrain
from hmrt.traversal.march import march_maxmip
from hmrt.traversal.march_pallas import march_maxmip_pallas

from conftest import random_rays

N = 64


@pytest.fixture(scope="module")
def scene():
    return make_scene(procedural_terrain(N, seed=3))


def _rays(kind, any_hit, n_rays=160):
    o, d = random_rays(n_rays, N, seed=11, kind=kind)
    if any_hit:
        # shadow rays: toward a sun, starting just above the surface; a
        # third of the lanes enter dead, parked outside the map the way
        # shade_hits parks non-hit pixels
        rng = np.random.default_rng(5)
        o = np.stack([rng.uniform(0, N - 1, n_rays),
                      rng.uniform(0, N - 1, n_rays),
                      rng.uniform(0.0, 0.2 * N, n_rays)], -1)
        o[: n_rays // 3, :2] = -1e6
        d = np.broadcast_to(np.asarray([0.4, 0.3, 0.35]), o.shape)
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return ([jnp.asarray(o[:, i], jnp.float32) for i in range(3)]
            + [jnp.asarray(d[:, i], jnp.float32) for i in range(3)])


def _kw(scene, intersect, any_hit, clip):
    return dict(n=scene.n, m=scene.m, levels=scene.levels,
                max_steps=8 * scene.n_cells + 256, cell_intersect=intersect,
                any_hit=any_hit, clip=(8.0, 50.0) if clip else None)


@pytest.mark.parametrize("kind", ["mixed", "axis"])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("intersect", ["triangle", "bilinear", "flat"])
def test_kernel_interpret_matches_xla_march(scene, intersect, any_hit, clip,
                                            kind):
    args = _rays(kind, any_hit) + [scene.pyr_flat, scene.heights.reshape(-1)]
    kw = _kw(scene, intersect, any_hit, clip)
    ref = march_maxmip(*args, **kw)
    # 160 rays = one full and one padded block of 128
    got = march_maxmip_pallas(*args, **kw, interpret=True)
    hit = np.asarray(ref.hit)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(np.asarray(got.hit), hit)
    np.testing.assert_array_equal(np.asarray(got.cx)[hit],
                                  np.asarray(ref.cx)[hit])
    np.testing.assert_array_equal(np.asarray(got.cy)[hit],
                                  np.asarray(ref.cy)[hit])
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
    # block loops end when their own rays do: the longest block runs the
    # XLA loop's count, and the live lane-iterations are the same
    assert int(got.steps) == int(ref.steps)
    assert int(got.work) == int(ref.work)


@pytest.mark.parametrize("block", [32, 64, 256])
def test_kernel_block_sizes_and_padding(scene, block):
    args = _rays("mixed", False, n_rays=100) + [scene.pyr_flat,
                                                scene.heights.reshape(-1)]
    kw = _kw(scene, "triangle", False, False)
    ref = march_maxmip(*args, **kw)
    got = march_maxmip_pallas(*args, **kw, block=block, interpret=True)
    assert got.hit.shape == (100,) and got.t.shape == (100,)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))


def test_kernel_rejects_block_not_power_of_two(scene):
    args = _rays("mixed", False, n_rays=8) + [scene.pyr_flat,
                                              scene.heights.reshape(-1)]
    with pytest.raises(ValueError, match="power of two"):
        march_maxmip_pallas(*args, **_kw(scene, "triangle", False, False),
                            block=96, interpret=True)


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_lowers_for_cuda(scene, any_hit):
    """The compiled (not interpreted) kernel lowers to a Triton program for
    CUDA: every primitive of the step has a Triton lowering."""
    args = _rays("mixed", any_hit) + [scene.pyr_flat,
                                      scene.heights.reshape(-1)]
    kw = _kw(scene, "triangle", any_hit, False)
    fn = jax.jit(lambda *a: march_maxmip_pallas(*a, **kw))
    text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "div.rn.f32" in text or "march_maxmip" in text


@pytest.mark.parametrize("platform,path", [("cpu", "xla"),
                                           ("gpu", "pallas")])
def test_march_path_by_platform(platform, path):
    assert renderer.march_path(platform) == path
    assert renderer.maxmip_march(path) is {
        "pallas": march_maxmip_pallas, "xla": march_maxmip}[path]


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_march_path_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no renderer path"):
        renderer.march_path(platform)


def test_interpret_is_never_derived_from_the_backend():
    """Interpret mode is an explicit argument of tests: the renderer and
    the mesh path never pass it, and the kernel defaults to compiled."""
    from hmrt.distrib import mesh
    from hmrt.api import tiled
    for mod in (renderer, mesh, tiled):
        assert "interpret" not in inspect.getsource(mod)
    sig = inspect.signature(march_maxmip_pallas)
    assert sig.parameters["interpret"].default is False


@pytest.mark.gpu
@pytest.mark.parametrize("intersect", ["triangle", "bilinear", "flat"])
def test_kernel_compiled_matches_xla_march(gpu, scene, intersect):
    """On the card: the compiled kernel against the XLA march. FMA
    contraction flips a hit only on a ray that grazes the surface or hits
    on a cell edge, so the test allows one in a thousand."""
    args = _rays("mixed", False, n_rays=4096) + [scene.pyr_flat,
                                                 scene.heights.reshape(-1)]
    kw = _kw(scene, intersect, False, False)
    ref = march_maxmip(*args, **kw)
    got = march_maxmip_pallas(*args, **kw)
    flips = int((np.asarray(got.hit) != np.asarray(ref.hit)).sum())
    assert flips <= 4, flips
    both = np.asarray(got.hit) & np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(got.t)[both],
                               np.asarray(ref.t)[both], rtol=1e-4)
