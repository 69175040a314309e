"""Frame timing (SURVEY.md C23).

The reference brackets its CUDA kernel with event timers and reports
ms/frame + Mrays/s (metric schema per BASELINE.json:2). Here the host
clock brackets work that ends in `jax.block_until_ready`: JAX returns
before the device finishes, so a timing without it measures the enqueue.

Steady-state throughput is measured by scanning F frames inside ONE
device program (`lax.scan` over a batched camera path, like the
reference's frame loop) and dividing; this also amortizes host dispatch
out of the per-frame number.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp

from hmrt.api.flythrough import frame_camera
from hmrt.config import RenderConfig
from hmrt.core.renderer import render_frame
from hmrt.types import Camera, Scene


@partial(jax.jit, static_argnames=("config", "n_frames"))
def _scan_frames(scene: Scene, cams: Camera, config: RenderConfig,
                 n_frames: int):
    """Render n_frames sequentially on device; returns a scalar checksum."""

    def step(carry, i):
        fr = render_frame(scene, frame_camera(cams, i), config)
        return carry + jnp.sum(fr.color[::16, ::16]), None

    acc, _ = jax.lax.scan(step, jnp.float32(0.0),
                          jnp.arange(n_frames, dtype=jnp.int32))
    return acc


def time_animation(scene: Scene, cams: Camera, config: RenderConfig,
                   n_frames: int, reps: int = 3,
                   render_scan=None, hit_frac: float | None = None) -> dict:
    """ms/frame (median and largest over reps) for an n_frames animation.

    `render_scan(scene, cams, config, n_frames)` renders the frames and
    returns something `block_until_ready` waits on (default: one scanned
    device program). `hit_frac` (fraction of pixels that hit terrain,
    measured on a real frame by the caller) makes the shadow-ray count
    honest: shadow rays exist only for hit pixels, so total rays/frame =
    W*H*(1 + hit_frac) when shadows are on. Primary-only Mrays/s is always
    reported alongside.
    """
    scan = render_scan or _scan_frames
    jax.block_until_ready(scan(scene, cams, config, n_frames))  # compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(scan(scene, cams, config, n_frames))
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    ms = med / n_frames * 1e3
    primary = config.width * config.height
    shadow_mult = (1.0 + (hit_frac if hit_frac is not None else 1.0)
                   if config.shadows else 1.0)
    rays_per_frame = primary * shadow_mult
    out = {
        "ms_per_frame": ms,
        "ms_per_frame_max": times[-1] / n_frames * 1e3,
        "fps": 1e3 / ms if ms > 0 else float("inf"),
        "mrays_per_s": rays_per_frame / (ms / 1e3) / 1e6,
        "mrays_per_s_primary": primary / (ms / 1e3) / 1e6,
        "frames": n_frames,
        "reps": reps,
        "all_times_ms": [t / n_frames * 1e3 for t in times],
    }
    if config.shadows:
        out["shadow_rays_per_frame"] = int(primary * (shadow_mult - 1.0))
    return out
