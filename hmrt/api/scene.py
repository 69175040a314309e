"""Scene construction: load heights, build pyramid, upload (SURVEY.md 3.1).

Reference startup: load heightmap -> upload to device -> build mip pyramid
on device -> camera init (SURVEY.md section 3.1). Here: one `device_put` of
the height grid (replicated across the mesh in the multi-card path —
hmrt.distrib) and a jitted pyramid build; everything stays resident in
device memory across frames.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from hmrt.core.pyramid import build_pyramid_flat, next_pow2, num_levels
from hmrt.types import Light, Scene


def make_scene(heights, albedo=None, light: Light | None = None,
               device=None) -> Scene:
    """Build a device-resident Scene from an (N, N) height grid.

    `albedo` is an optional (N, N, 3) float [0,1] texture (SURVEY.md C18),
    stored planar (3, N*N) for single-channel gathers.
    """
    heights = jnp.asarray(np.asarray(heights, np.float32))
    if heights.ndim != 2 or heights.shape[0] != heights.shape[1]:
        raise ValueError(f"heights must be square (N, N), got {heights.shape}")
    n = int(heights.shape[0])
    if n < 2:
        raise ValueError("heightmap must be at least 2x2")
    m = next_pow2(n - 1)
    levels = num_levels(m)
    if device is not None:
        heights = jax.device_put(heights, device)
    pyr = build_pyramid_flat(heights)
    alb = None
    if albedo is not None:
        a = np.asarray(albedo, np.float32)
        if a.shape != (n, n, 3):
            raise ValueError(f"albedo must be (N, N, 3), got {a.shape}")
        alb = jnp.asarray(a.reshape(n * n, 3).T.copy())  # (3, N*N) planar
        if device is not None:
            alb = jax.device_put(alb, device)
    return Scene(heights=heights, pyr_flat=pyr, albedo=alb,
                 light=light if light is not None else Light.create(),
                 n=n, m=m, levels=levels)
