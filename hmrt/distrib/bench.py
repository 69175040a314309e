"""Multi-device animation timing (B5, BASELINE.json:11)."""

from __future__ import annotations

from hmrt.api.flythrough import frame_camera
from hmrt.bench.timing import time_animation
from hmrt.config import RenderConfig
from hmrt.distrib.mesh import render_flythrough_sharded, render_frame_sharded
from hmrt.types import Camera, Scene


def time_animation_sharded(scene: Scene, cams: Camera, config: RenderConfig,
                           n_frames: int, mesh, reps: int = 3,
                           hit_frac: float | None = None) -> dict:
    """Band-sharded frames, one `render_frame_sharded` dispatch each."""
    def loop(scene, cams, config, n_frames):
        return [render_frame_sharded(scene, frame_camera(cams, i), config,
                                     mesh).color for i in range(n_frames)]

    return time_animation(scene, cams, config, n_frames, reps=reps,
                          render_scan=loop, hit_frac=hit_frac)


def time_flythrough_frames(scene: Scene, cams: Camera, config: RenderConfig,
                           n_frames: int, mesh, reps: int = 3,
                           hit_frac: float | None = None) -> dict:
    """Animation throughput with the FRAME axis sharded over the mesh
    (mesh.render_flythrough_sharded): all frames render as one device
    program, one frame per device at a time, with no per-frame traffic
    between devices — the natural multi-device strategy for the B4
    flythrough workload."""
    def scan(scene, cams, config, n_frames):
        return render_flythrough_sharded(scene, cams, config, mesh)

    return time_animation(scene, cams, config, n_frames, reps=reps,
                          render_scan=scan, hit_frac=hit_frac)
