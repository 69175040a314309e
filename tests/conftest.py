"""Test harness config (SURVEY.md section 4.4).

Tests run on the CPU backend (`JAX_PLATFORMS=cpu`) with 8
virtual devices, so the multi-device shard_map path is exercised without
several cards. Tests marked `gpu` take the `gpu` fixture and skip unless
JAX's default backend is a GPU; `python chip_smoke.py` runs them on the
card (`python -m pytest -m gpu tests/` does the same by hand).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# compiles in tests are many and small: keep them out of the persistent
# cache the CLIs point at the checkout (hmrt.utils.cache)
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_maps():
    """Keep the process under vm.max_map_count (default 65530).

    Every XLA:CPU compiled program holds ~5-6 JIT code mappings and the
    full suite compiles enough programs to exhaust the kernel limit:
    mmap then fails inside LLVM and the worker SEGVs in
    backend_compile_and_load (three full-suite crashes on 2026-08-18
    bisected to exactly this — /proc/self/maps hit 65426 of 65530 at
    the crash, always landing in the compile-heavy test_tiled module).
    jax.clear_caches() releases the executables' mappings (measured
    2559 -> 481 on a 400-program microbench); clear between modules,
    and only once the count is actually high so light modules keep
    their warm jit caches.
    """
    yield
    try:
        with open("/proc/self/maps") as f:
            n = sum(1 for _ in f)
    except OSError:
        return
    if n > 25000:
        jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")


@pytest.fixture
def multi_device():
    """The devices of a mesh with at least two of them, else skip."""
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs several devices")
    return devs


@pytest.fixture(scope="session")
def terrain64():
    from hmrt.io.heightmap import procedural_terrain
    return procedural_terrain(64, seed=3)


@pytest.fixture(scope="session")
def scene64(terrain64):
    from hmrt.api.scene import make_scene
    return make_scene(terrain64)


@pytest.fixture(scope="session")
def camera64(terrain64):
    from hmrt.types import Camera
    h = terrain64
    return Camera.create(eye=(32.0, -20.0, float(h.max()) + 12.0),
                         target=(32.0, 32.0, float(h.mean())))


def random_rays(n_rays, n, seed=0, kind="mixed"):
    """Random rays aimed at / across the terrain box [0, n-1]^2."""
    rng = np.random.default_rng(seed)
    if kind == "mixed":
        # origins around and above the box, targets inside it
        o = np.stack([
            rng.uniform(-0.5 * n, 1.5 * n, n_rays),
            rng.uniform(-0.5 * n, 1.5 * n, n_rays),
            rng.uniform(0.02 * n, 0.6 * n, n_rays),
        ], axis=-1).astype(np.float32)
        tgt = np.stack([
            rng.uniform(0, n - 1, n_rays),
            rng.uniform(0, n - 1, n_rays),
            rng.uniform(0.0, 0.2 * n, n_rays),
        ], axis=-1).astype(np.float32)
        d = tgt - o
    elif kind == "axis":
        # axis-aligned and 45-degree rays (tie-breaking cases)
        o = np.stack([
            np.full(n_rays, -1.0), rng.uniform(0, n - 1, n_rays),
            rng.uniform(0.05 * n, 0.3 * n, n_rays)], -1).astype(np.float32)
        d = np.zeros((n_rays, 3), np.float32)
        d[:, 0] = 1.0
        d[: n_rays // 2, 1] = 1.0  # 45 degrees in xy
        d[:, 2] = rng.uniform(-0.3, 0.1, n_rays)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d
