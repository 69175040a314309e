"""Core pytree types: Camera, Light, Scene, Frame.

The reference keeps camera/light/scene state in C++ structs uploaded to CUDA
constant memory each frame (SURVEY.md C7, C21 — reference mount empty, layout
reconstructed). Here: frozen dataclasses registered as JAX
pytrees, so the whole scene state flows through jit/vmap/scan/shard_map as
ordinary traced leaves; shape-bearing metadata rides in static (meta) fields.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


def _pytree_dataclass(cls=None, *, meta_fields=()):
    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = [f.name for f in dataclasses.fields(c) if f.name not in meta_fields]
        jax.tree_util.register_dataclass(c, data_fields=data_fields, meta_fields=list(meta_fields))
        return c

    return wrap if cls is None else wrap(cls)


@_pytree_dataclass
class Camera:
    """Pinhole perspective camera (SURVEY.md C7).

    World convention: heightmap spans x,y in [0, N-1]; z is up.
    """

    eye: jax.Array        # (3,) f32 world position
    target: jax.Array     # (3,) f32 look-at point
    up: jax.Array         # (3,) f32 up hint
    fov_y: jax.Array      # () f32 vertical field of view, radians

    @staticmethod
    def create(eye, target, up=(0.0, 0.0, 1.0), fov_y_deg=60.0) -> "Camera":
        return Camera(
            eye=jnp.asarray(eye, jnp.float32),
            target=jnp.asarray(target, jnp.float32),
            up=jnp.asarray(up, jnp.float32),
            fov_y=jnp.asarray(jnp.deg2rad(fov_y_deg), jnp.float32),
        )

    def basis(self):
        """Orthonormal (right, up, forward) camera basis.

        Degenerate look directions (forward parallel to the up hint —
        e.g. a camera looking straight up) fall back to the y axis as the
        hint, so the basis is always finite (caught by the checkify
        sanitizer tests with a zenith camera: cross(f, up) was the zero
        vector and its normalization produced NaN rays)."""
        f = self.target - self.eye
        f = f / jnp.linalg.norm(f)
        r = jnp.cross(f, self.up)
        n2 = jnp.sum(r * r)
        alt = jnp.cross(f, jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
        r = jnp.where(n2 > 1e-12, r, alt)
        r = r / jnp.linalg.norm(r)
        u = jnp.cross(r, f)
        return r, u, f

    def rays(self, height: int, width: int, row0=None,
             full_height: int | None = None):
        """Primary rays for every pixel: origins (3,), dirs (H, W, 3).

        Reference: per-pixel ray gen inside the CUDA kernel (SURVEY.md C9).
        Here it is pure jnp so the same math is reused by the oracle renderer
        and (re-derived per-tile via broadcasted_iota) by the Pallas kernel.

        row0/full_height: generate only rows [row0, row0+height) of a
        full_height-row screen — the multi-chip row-band path (C27); row0
        may be a traced scalar (per-shard axis_index).
        """
        r, u, f = self.basis()
        tan_half = jnp.tan(self.fov_y * 0.5)
        fh = height if full_height is None else full_height
        aspect = width / fh
        jj = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
        rr = jnp.arange(height, dtype=jnp.float32)
        if row0 is not None:
            rr = rr + row0
        ii = 1.0 - (rr + 0.5) / fh * 2.0
        dx = jj * tan_half * aspect      # (W,)
        dy = ii * tan_half               # (H,)
        d = (f[None, None, :]
             + dx[None, :, None] * r[None, None, :]
             + dy[:, None, None] * u[None, None, :])
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return self.eye, d


@_pytree_dataclass
class Light:
    """Directional sun light + environment colors (SURVEY.md C15-C19)."""

    sun_dir: jax.Array     # (3,) f32, unit vector pointing TOWARD the sun
    sun_color: jax.Array   # (3,) f32
    sky_top: jax.Array     # (3,) f32 sky gradient at zenith
    sky_horizon: jax.Array  # (3,) f32 sky gradient at horizon
    fog_color: jax.Array   # (3,) f32

    @staticmethod
    def create(sun_dir=(0.4, 0.3, 0.85), sun_color=(1.0, 0.96, 0.9),
               sky_top=(0.35, 0.55, 0.95), sky_horizon=(0.75, 0.85, 0.98),
               fog_color=(0.7, 0.78, 0.88)) -> "Light":
        d = jnp.asarray(sun_dir, jnp.float32)
        d = d / jnp.linalg.norm(d)
        return Light(
            sun_dir=d,
            sun_color=jnp.asarray(sun_color, jnp.float32),
            sky_top=jnp.asarray(sky_top, jnp.float32),
            sky_horizon=jnp.asarray(sky_horizon, jnp.float32),
            fog_color=jnp.asarray(fog_color, jnp.float32),
        )


@_pytree_dataclass(meta_fields=("n", "m", "levels"))
class Scene:
    """Heightfield + max-mip pyramid + light, resident in device memory.

    Reference analog: device-side heightmap texture + mip pyramid buffers +
    per-frame constant state (SURVEY.md C3/C4/C6/C21; BASELINE.json:5
    "HBM-resident heightfield"). The pyramid is stored FLAT — one 1D f32
    array, level-major (finest first) — so a marching ray at any per-lane
    level can fetch its cell max with a single arithmetic index computation
    into one buffer (SURVEY.md section 7 "flatten the pyramid").

    meta (static): n = height-sample grid side N; m = padded power-of-two
    cell-grid side; levels = number of pyramid levels (level 0 is m x m,
    level levels-1 is 1 x 1).
    """

    heights: jax.Array     # (N, N) f32 height samples, world z units
    pyr_flat: jax.Array    # (T,) f32 flattened max pyramid over cells
    albedo: jax.Array | None  # (3, N*N) planar f32 texture (see make_scene), or None
    light: Light
    n: int
    m: int
    levels: int

    @property
    def n_cells(self) -> int:
        """Side length of the valid (unpadded) cell grid."""
        return self.n - 1

    @property
    def world_max(self) -> float:
        """x/y extent of the terrain: [0, n-1]."""
        return float(self.n - 1)


@_pytree_dataclass
class Frame:
    """Render output: color + optional aux buffers (SURVEY.md C3).

    Stays device-resident; BASELINE.json:5 "framebuffer writes stay entirely
    on device".
    """

    color: jax.Array        # (H, W, 3) f32 in [0,1]
    depth: jax.Array | None   # (H, W) f32 hit distance t (inf = sky)
    normal: jax.Array | None  # (H, W, 3) f32 world-space normals
    hit: jax.Array | None     # (H, W) bool


def normalize(v, axis=-1, eps=1e-20):
    return v / jnp.sqrt(jnp.sum(v * v, axis=axis, keepdims=True) + eps)
