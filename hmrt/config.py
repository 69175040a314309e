"""Render configuration.

The reference renderer (jeanfilho/GPU-Heightmap-Raytracer; capability
surface pinned by BASELINE.json:5-11) configures its pipeline through
command-line args and compile-time constants. Here the whole feature
surface is one frozen, hashable dataclass that is passed as a
*static* argument to jit — every flag combination compiles to its own
program with dead features compiled out, the equivalent of the reference's
template/#ifdef specialization.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (hashable; pass as static arg to jit).

    Mirrors the reference's capability surface (BASELINE.json:7-11):
      B1: uniform DDA + Lambert        -> traversal="dda",   shading="lambert"
      B2: max-mip + depth/normal bufs  -> traversal="maxmip", aux_buffers=True
      B3: shadows + Phong + sky test   -> shadows=True, shading="phong"
      B4: albedo texture + fog         -> texture=True, fog=True
      B5: multi-card row-band sharding -> see hmrt.distrib
    """

    # --- image ---
    width: int = 512
    height: int = 512

    # --- traversal ---
    traversal: Literal["dda", "maxmip"] = "maxmip"
    #: Exact surface model inside a cell. The reference's choice could not be
    #: verified (empty mount, SURVEY.md section 0); per SURVEY.md C12 both are
    #: implemented and flag-selectable, default triangle-pair.
    cell_intersect: Literal["triangle", "bilinear", "flat"] = "triangle"
    #: Hard cap on march iterations (static bound for lax.while_loop; the
    #: live-mask empties long before this in practice).
    max_steps: int = 0  # 0 = auto: 4*N for dda, 8*log2(N)+64 for maxmip
    #: World cell window [lo, hi] to march, or None for the full terrain.
    #: Used by the out-of-core tiled path (api/tiled.py) to restrict each
    #: sub-scene to its interior cells while gradient margins stay loaded.
    clip_box: tuple | None = None

    # --- shading ---
    shading: Literal["lambert", "phong"] = "lambert"
    shadows: bool = False
    fog: bool = False
    texture: bool = False
    #: Write depth + world-space-normal aux buffers (BASELINE.json:8).
    aux_buffers: bool = False

    # --- shading params (float params are baked as compile-time consts) ---
    ambient: float = 0.15
    specular: float = 0.5
    shininess: float = 32.0
    fog_density: float = 0.0015

    @property
    def resolution(self) -> tuple[int, int]:
        return (self.height, self.width)

    def steps_for(self, n_cells: int) -> int:
        if self.max_steps:
            return self.max_steps
        if self.traversal == "dda":
            return 4 * n_cells
        # max-mip: grazing terrain-hugging rays march O(N) fine cells with
        # descend/ascend overhead (measured ~1070 avg steps/ray on a 4096^2
        # horizon view) — the cap must scale with N, not log N, or long
        # rays are silently abandoned as misses. The wavefront loop exits
        # early via the live mask, so a generous bound costs nothing.
        return 8 * n_cells + 256
