"""The renderer: raygen -> max-mip march -> shading -> Frame (SURVEY.md C20).

The reference ships a scalar CPU renderer whose images are the fidelity
oracle for its CUDA kernel (BASELINE.json:5 "identical intersection
fidelity versus CPU reference images"). Here the oracle is a fully
vectorized jnp pipeline that XLA compiles for any backend
(`render_frame_oracle`). `render_frame` runs the same pipeline with the
march chosen for the device by `march_path`: on a GPU the march is the
Pallas kernel of traversal/march_pallas.py, everything else stays the
oracle's jnp code.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from hmrt.config import RenderConfig
from hmrt.shading import shade as sh
from hmrt.traversal.march import march_dda, march_maxmip
from hmrt.traversal.march_pallas import march_maxmip_pallas
from hmrt.types import Camera, Frame, Scene

SHADOW_EPS = 1e-2


def march_path(platform: str) -> str:
    """The max-mip march a device platform runs: "pallas" or "xla".

    The one place the renderer's path is chosen; the single-device and the
    mesh renderers both call it. A GPU runs the Pallas kernel, which beats
    the XLA march end to end on the card (PERF.md, "Kernel decisions"). A
    platform without a path is an error, never a silent fallback."""
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no renderer path for platform {platform!r}")


def maxmip_march(path: str):
    """The march function of a path from `march_path` (same signature)."""
    return {"pallas": march_maxmip_pallas, "xla": march_maxmip}[path]


def render_frame(scene: Scene, camera: Camera, config: RenderConfig) -> Frame:
    """Render one frame on the default device (SURVEY.md section 3.2)."""
    return _render(scene, camera, config,
                   march=march_path(jax.default_backend()))


def render_frame_oracle(scene: Scene, camera: Camera,
                        config: RenderConfig) -> Frame:
    """The pure-XLA oracle pipeline (reference renderer, SURVEY.md C20)."""
    return _render(scene, camera, config, march="xla")


@partial(jax.jit, static_argnames=("config", "march"))
def _render(scene: Scene, camera: Camera, config: RenderConfig,
            march: str) -> Frame:
    H, W = config.height, config.width
    eye, dirs = camera.rays(H, W)
    color, depth, normal, hit = render_rays(scene, config, eye, dirs,
                                            march=march)
    return Frame(
        color=color.reshape(H, W, 3),
        depth=depth.reshape(H, W) if config.aux_buffers else None,
        normal=normal.reshape(H, W, 3) if config.aux_buffers else None,
        hit=hit.reshape(H, W),
    )


def render_rays(scene: Scene, config: RenderConfig, eye, dirs, *,
                march: str):
    """March and shade rays from `eye` along `dirs` (..., 3) -> flat
    (color[P,3], depth[P], normal[P,3], hit[P]). Shared by the
    single-device and the row-band mesh renderers."""
    d = dirs.reshape(-1, 3)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    P = dx.shape[0]
    ox = jnp.broadcast_to(eye[0], (P,))
    oy = jnp.broadcast_to(eye[1], (P,))
    oz = jnp.broadcast_to(eye[2], (P,))

    heights_flat = scene.heights.reshape(-1)
    n = scene.n
    max_steps = config.steps_for(scene.n_cells)

    if config.traversal == "dda":
        res = march_dda(ox, oy, oz, dx, dy, dz, heights_flat,
                        n=n, max_steps=max_steps,
                        cell_intersect=config.cell_intersect,
                        clip=config.clip_box)
    else:
        res = maxmip_march(march)(
            ox, oy, oz, dx, dy, dz, scene.pyr_flat, heights_flat, n=n,
            m=scene.m, levels=scene.levels, max_steps=max_steps,
            cell_intersect=config.cell_intersect, clip=config.clip_box)

    color, depth, normal = shade_hits(scene, config, ox, oy, oz, dx, dy, dz,
                                      res.hit, res.t, march=march)
    return color, depth, normal, res.hit


def shade_hits(scene: Scene, config: RenderConfig,
               ox, oy, oz, dx, dy, dz, hit, t, *, march: str = "xla"):
    """Shade a batch of march results -> (color[P,3], depth[P], normal[P,3]).

    `march` is the path (`march_path`) the shadow rays take."""
    heights_flat = scene.heights.reshape(-1)
    n = scene.n
    light = scene.light
    lx, ly, lz = light.sun_dir[0], light.sun_dir[1], light.sun_dir[2]

    ts = jnp.where(hit, t, 0.0)
    px = ox + ts * dx
    py = oy + ts * dy
    pz = oz + ts * dz

    nx, ny, nz = sh.gradient_normal(heights_flat, n, px, py)

    # --- direct lighting ---
    diff = sh.lambert(nx, ny, nz, lx, ly, lz)

    if config.shadows:
        # second masked march toward the sun, any-hit (SURVEY.md C17)
        sx = px + lx * SHADOW_EPS + nx * SHADOW_EPS
        sy = py + ly * SHADOW_EPS + ny * SHADOW_EPS
        sz = pz + lz * SHADOW_EPS + nz * SHADOW_EPS
        # the shadow march is always max-mip, so its step cap must use the
        # max-mip formula even when config.traversal == "dda" (whose 4*N cap
        # has no slack for descend/ascend overhead: grazing shadow rays
        # could hit the cap and be silently reported unoccluded)
        shadow_cap = config.max_steps or (8 * scene.n_cells + 256)
        occ = maxmip_march(march)(
            jnp.where(hit, sx, -1e6), jnp.where(hit, sy, -1e6), sz,
            jnp.broadcast_to(lx, px.shape), jnp.broadcast_to(ly, px.shape),
            jnp.broadcast_to(lz, px.shape),
            scene.pyr_flat, heights_flat,
            n=n, m=scene.m, levels=scene.levels,
            max_steps=shadow_cap,
            cell_intersect=config.cell_intersect, any_hit=True).hit
        diff = jnp.where(occ, 0.0, diff)

    if config.texture and scene.albedo is not None:
        alb = scene.albedo  # stored (3, N*N) planar
        ar, ag, ab = sh.sample_albedo(alb, n, px, py)
    else:
        ar = ag = ab = jnp.full_like(px, 0.55)

    amb = config.ambient
    sr, sg, sb = light.sun_color[0], light.sun_color[1], light.sun_color[2]
    r = ar * (amb + diff * sr)
    g = ag * (amb + diff * sg)
    b = ab * (amb + diff * sb)

    if config.shading == "phong":
        spec = sh.phong_specular(nx, ny, nz, lx, ly, lz,
                                 -dx, -dy, -dz, config.shininess)
        if config.shadows:
            spec = jnp.where(occ, 0.0, spec)
        ks = config.specular
        r = r + ks * spec * sr
        g = g + ks * spec * sg
        b = b + ks * spec * sb

    if config.fog:
        r, g, b = sh.apply_fog(r, g, b, ts, config.fog_density,
                               light.fog_color)

    skyr, skyg, skyb = sh.sky_color(dz, light.sky_top, light.sky_horizon)
    r = jnp.where(hit, r, skyr)
    g = jnp.where(hit, g, skyg)
    b = jnp.where(hit, b, skyb)

    color = jnp.stack([r, g, b], axis=-1)
    depth = jnp.where(hit, t, jnp.inf)
    normal = jnp.stack([jnp.where(hit, nx, 0.0),
                        jnp.where(hit, ny, 0.0),
                        jnp.where(hit, nz, 0.0)], axis=-1)
    return jnp.clip(color, 0.0, 1.0), depth, normal
