"""Scripted camera flythrough (SURVEY.md C8).

The reference drives its animation benchmark with a scripted camera path
(BASELINE.json:10 "scripted camera flythrough"). Here keyframes
are interpolated into a BATCHED camera pytree (one leading frame axis) that
`lax.scan` consumes — the whole animation is one device program, no
per-frame host round-trips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hmrt.types import Camera


def catmull_rom(p0, p1, p2, p3, t):
    """Catmull-Rom spline segment, t in [0,1]; arrays broadcast."""
    t2 = t * t
    t3 = t2 * t
    return 0.5 * ((2.0 * p1)
                  + (-p0 + p2) * t
                  + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
                  + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3)


def flythrough(keyframes, n_frames: int, fov_y_deg: float = 55.0) -> Camera:
    """Batched Camera along a Catmull-Rom path through keyframes.

    keyframes: sequence of (eye_xyz, target_xyz) pairs (>= 2).
    Returns a Camera whose leaves have a leading (n_frames,) axis — index
    it with jax.tree.map or feed it to lax.scan.
    """
    eyes = np.asarray([k[0] for k in keyframes], np.float32)
    tgts = np.asarray([k[1] for k in keyframes], np.float32)
    if len(eyes) < 2:
        raise ValueError("need at least 2 keyframes")
    # pad endpoints for Catmull-Rom
    eyes_p = np.concatenate([eyes[:1], eyes, eyes[-1:]])
    tgts_p = np.concatenate([tgts[:1], tgts, tgts[-1:]])
    n_seg = len(eyes) - 1
    u = np.linspace(0.0, n_seg, n_frames, endpoint=False, dtype=np.float32)
    seg = np.minimum(u.astype(np.int32), n_seg - 1)
    t = (u - seg).astype(np.float32)[:, None]

    def interp(pts):
        p0 = pts[seg]
        p1 = pts[seg + 1]
        p2 = pts[seg + 2]
        p3 = pts[seg + 3]
        return catmull_rom(p0, p1, p2, p3, t)

    eye = jnp.asarray(interp(eyes_p))
    tgt = jnp.asarray(interp(tgts_p))
    up = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                          (n_frames, 3))
    fov = jnp.full((n_frames,), jnp.deg2rad(fov_y_deg), jnp.float32)
    return Camera(eye=eye, target=tgt, up=up, fov_y=fov)


def frame_camera(cams: Camera, i) -> Camera:
    """Select frame i from a batched Camera (works under scan/jit)."""
    return jax.tree.map(lambda x: x[i], cams)


def orbit_flythrough(n: int, zmax: float, n_frames: int,
                     height_frac: float = 0.10) -> Camera:
    """Default benchmark path: a descending orbit over an n x n map."""
    c = (n - 1) / 2.0
    keys = []
    for k in range(9):
        ang = 2.0 * np.pi * k / 8.0
        r = 0.42 * n * (1.0 - 0.05 * k / 8.0)
        h = zmax + height_frac * n * (1.0 - 0.5 * k / 8.0)
        keys.append(((c + r * np.cos(ang), c + r * np.sin(ang), h),
                     (c, c, zmax * 0.4)))
    return flythrough(keys, n_frames)
