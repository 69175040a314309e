"""The five benchmark configs, exactly as pinned by BASELINE.json:7-11.

These are the workloads the reference is judged on (SURVEY.md C24, section
6); each is a literal RenderConfig + scene recipe.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hmrt.config import RenderConfig


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    description: str
    map_n: int           # heightmap side (samples)
    render: RenderConfig
    animated: bool = False   # scripted flythrough (B4)
    sharded: bool = False    # multi-chip (B5)
    frames: int = 8          # timed frames per measurement


BENCH_CONFIGS: dict[str, BenchConfig] = {
    # BASELINE.json:7 — "256^2 procedural heightmap, 512x512 framebuffer,
    # uniform-grid DDA march, Lambert shading (CPU reference render)"
    "B1": BenchConfig(
        name="B1",
        description="256^2 procedural map, 512x512 FB, uniform DDA, Lambert "
                    "(reference-oracle correctness config)",
        map_n=256,
        render=RenderConfig(width=512, height=512, traversal="dda",
                            shading="lambert"),
    ),
    # BASELINE.json:8 — "1024^2 terrain tile, perspective camera,
    # maximum-mipmap (quadtree) accelerated stepping, depth + normal buffers"
    "B2": BenchConfig(
        name="B2",
        description="1024^2 tile, perspective camera, max-mip stepping, "
                    "depth+normal buffers",
        map_n=1024,
        render=RenderConfig(width=1024, height=768, traversal="maxmip",
                            shading="lambert", aux_buffers=True),
    ),
    # BASELINE.json:9 — "4096^2 DEM at 1920x1080 with shadow rays, Phong
    # shading, and early-out sky test" — THE north-star row (<16 ms)
    "B3": BenchConfig(
        name="B3",
        description="4096^2 DEM, 1920x1080, shadow rays, Phong, sky early-out "
                    "(north star: <16 ms/frame)",
        map_n=4096,
        render=RenderConfig(width=1920, height=1080, traversal="maxmip",
                            shading="phong", shadows=True),
    ),
    # BASELINE.json:10 — "8192^2 tiled heightmap with albedo texture lookup,
    # distance fog, and scripted camera flythrough (animation benchmark)"
    "B4": BenchConfig(
        name="B4",
        description="8192^2 tiled map, albedo texture, fog, scripted "
                    "flythrough (animation benchmark)",
        map_n=8192,
        render=RenderConfig(width=1280, height=720, traversal="maxmip",
                            shading="phong", fog=True, texture=True),
        animated=True,
    ),
    # BASELINE.json:11 — "3840x2160 render tile-sharded across 8 chips,
    # replicated height pyramid, gather of framebuffer"; here over the
    # devices present (4 H100s)
    "B5": BenchConfig(
        name="B5",
        description="3840x2160 row-band sharded across devices, "
                    "replicated pyramid, framebuffer all-gather",
        map_n=4096,
        render=RenderConfig(width=3840, height=2160, traversal="maxmip",
                            shading="phong", shadows=True),
        sharded=True,
    ),
}


def bench_scene(cfg: BenchConfig, seed: int = 3):
    """Deterministic scene + camera path for a bench config."""
    from hmrt.api.scene import make_scene
    from hmrt.io.heightmap import procedural_terrain
    from hmrt.types import Camera

    n = cfg.map_n
    terr = procedural_terrain(n, seed=seed)
    albedo = None
    if cfg.render.texture:
        # deterministic height+slope colored albedo (SURVEY.md C18)
        g = np.gradient(terr)
        slope = np.hypot(g[0], g[1])
        hnorm = (terr - terr.min()) / (np.ptp(terr) + 1e-9)
        grass = np.array([0.3, 0.5, 0.2], np.float32)
        rock = np.array([0.45, 0.4, 0.38], np.float32)
        snow = np.array([0.9, 0.9, 0.95], np.float32)
        w_rock = np.clip(slope / (slope.mean() * 2 + 1e-9), 0, 1)[..., None]
        w_snow = np.clip((hnorm - 0.75) * 4, 0, 1)[..., None]
        albedo = grass * (1 - w_rock) + rock * w_rock
        albedo = albedo * (1 - w_snow) + snow * w_snow
        albedo = albedo.astype(np.float32)
    scene = make_scene(terr, albedo=albedo)
    zmax = float(terr.max())
    cam = Camera.create(
        eye=(n * 0.5, -n * 0.25, zmax + n * 0.06),
        target=(n * 0.5, n * 0.5, float(terr.mean())),
        fov_y_deg=55.0,
    )
    return scene, cam, terr
