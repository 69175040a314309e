"""Multi-card rendering: framebuffer sharding over a device mesh (C27/C28).

The reference is single-GPU/single-process — it has no distributed layer at
all (SURVEY.md section 5 "Distributed communication backend: none"). This
adds the capability pinned by BASELINE.json:5,11: shard the framebuffer by
row band across the mesh with the height pyramid REPLICATED, render each
band locally, and all-gather the final image.

Design: a 1-D Mesh over all devices (every card reaches every other at the
same rate, so the mesh follows the algorithm alone), `shard_map` of the
single-device pipeline over row bands of the screen (rays are
embarrassingly parallel), and `jax.lax.all_gather` for final-image
assembly. Scene arrays use replicated specs so each device keeps one copy
with zero per-frame traffic. Each device runs the march that
`core.renderer.march_path` picks for its platform.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hmrt.config import RenderConfig
from hmrt.core.renderer import _render, march_path, render_rays
from hmrt.types import Camera, Frame, Scene


def make_mesh(devices=None, axis_name: str = "tiles") -> Mesh:
    """1D device mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    import numpy as np
    return Mesh(np.array(devices), (axis_name,))


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Pin scene arrays with a replicated sharding on the mesh (one copy
    per device, no per-frame transfer — BASELINE.json:5 'replicated height
    pyramid')."""
    rep = NamedSharding(mesh, P())
    put = lambda x: jax.device_put(x, rep) if x is not None else None
    return Scene(heights=put(scene.heights), pyr_flat=put(scene.pyr_flat),
                 albedo=put(scene.albedo),
                 light=jax.tree.map(put, scene.light),
                 n=scene.n, m=scene.m, levels=scene.levels)


def _mesh_march(mesh: Mesh) -> str:
    return march_path(mesh.devices.flat[0].platform)


def render_frame_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                         mesh: Mesh | None = None) -> Frame:
    """Multi-device render (SURVEY.md section 3.6): each device renders its
    row band of the screen; the full frame is all-gathered.

    Pixel-identical to the single-device render (tests/test_sharded.py):
    the per-ray pipeline is the same jitted math, only the raygen index
    range differs per shard.
    """
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.devices.size
    H = config.height
    if H % ndev != 0:
        raise ValueError(f"height {H} must divide evenly over {ndev} devices")
    return _render_sharded_jit(scene, camera, config, mesh,
                               march=_mesh_march(mesh))


def render_flythrough_sharded(scene: Scene, cams: Camera,
                              config: RenderConfig,
                              mesh: Mesh | None = None) -> jnp.ndarray:
    """Frame-parallel animation rendering (C8 x C27): shard the flythrough's
    FRAME axis over the mesh instead of the framebuffer.

    For a scripted animation (BASELINE.json:10) the frame axis is as
    embarrassingly parallel as the pixel domain, and sharding it is
    strictly cheaper than band-sharding every frame: each device renders
    whole frames against its replicated scene with ZERO per-frame
    cross-device traffic — the only movement is assembling the output
    stack, which `out_specs=P("frames")` leaves sharded in device memory
    until the host (or a downstream op) consumes it. Per-device rendering
    is the same pipeline as `core.renderer.render_frame`, scanned over the
    device's local frames in one device program.

    cams: batched Camera (leading frame axis, e.g. from
    `api.flythrough.flythrough`); the frame count must divide the mesh
    size. Returns the color stack, logically (F, H, W, 3), sharded over
    frames. Pixel-identical to rendering each frame on one device
    (tests/test_sharded.py).
    """
    if mesh is None:
        mesh = make_mesh(axis_name="frames")
    ndev = mesh.devices.size
    if cams.eye.ndim != 2:
        raise ValueError("cams must be a batched Camera (leading frame "
                         "axis, e.g. from api.flythrough.flythrough); "
                         f"got eye shape {cams.eye.shape}")
    F = int(cams.eye.shape[0])
    if F % ndev != 0:
        raise ValueError(f"frame count {F} must divide evenly over "
                         f"{ndev} devices")
    return _render_fly_jit(scene, cams, config, mesh,
                           march=_mesh_march(mesh))


@partial(jax.jit, static_argnames=("config", "mesh", "march"))
def _render_fly_jit(scene: Scene, cams: Camera, config: RenderConfig,
                    mesh: Mesh, march: str) -> jnp.ndarray:
    axis = mesh.axis_names[0]

    def device_frames(scene_rep, cams_local):
        # one device program per device: scan over its local frames
        def step(carry, cam):
            return carry, _render(scene_rep, cam, config, march=march).color
        _, colors = jax.lax.scan(step, jnp.float32(0.0), cams_local)
        return colors

    fn = shard_map(device_frames, mesh=mesh, in_specs=(P(), P(axis)),
                   out_specs=P(axis), check_vma=False)
    return fn(scene, cams)


@partial(jax.jit, static_argnames=("config", "mesh", "march"))
def _render_sharded_jit(scene: Scene, camera: Camera, config: RenderConfig,
                        mesh: Mesh, march: str) -> Frame:
    H, W = config.height, config.width
    ndev = mesh.devices.size
    band = H // ndev
    axis = mesh.axis_names[0]

    # one full-screen ray grid, sharded by row band; scene+camera replicated
    eye, dirs = camera.rays(H, W)

    def render_band(dirs_band, scene_rep):
        color, depth, normal, hit = render_rays(scene_rep, config, eye,
                                                dirs_band, march=march)
        out = (color.reshape(band, W, 3),
               depth.reshape(band, W),
               normal.reshape(band, W, 3),
               hit.reshape(band, W))
        # gather the full framebuffer (BASELINE.json:5)
        return jax.tree.map(
            lambda x: jax.lax.all_gather(x, axis, axis=0, tiled=True), out)

    fn = shard_map(
        render_band, mesh=mesh,
        in_specs=(P(axis, None, None), P()),
        out_specs=P(),
        # march loop carries start replicated (zeros) and become varying
        # per-shard; skip the varying-manual-axes check rather than pvary
        # every carry leaf inside the generic march code
        check_vma=False,
    )
    color, depth, normal, hit = fn(dirs, scene)
    return Frame(color=color,
                 depth=depth if config.aux_buffers else None,
                 normal=normal if config.aux_buffers else None,
                 hit=hit)
