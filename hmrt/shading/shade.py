"""Shading: gradient normals, Lambert/Phong, shadows, fog, sky, texture.

Reference: per-pixel device functions inside the CUDA kernel (SURVEY.md
C14-C19; mount empty, feature set pinned by BASELINE.json:5,7-10). All pure
jnp over ray batches; reused verbatim by the oracle renderer and the Pallas
kernel so colors match across backends.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hmrt.traversal.march import corner_heights


def gradient_normal(heights_flat, n, px, py):
    """World-space surface normal from central differences of the height
    grid, bilinearly interpolated at (px, py) (SURVEY.md C14).

    Heights sample a surface with unit x/y spacing: the gradient at corner
    (ix, iy) is ((h[ix+1]-h[ix-1])/2, (h[iy+1]-h[iy-1])/2); the normal is
    normalize(-gx, -gy, 1). Corners are clamped at the border.
    """
    ix = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, n - 2)
    iy = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, n - 2)
    fx = px - ix
    fy = py - iy

    def grad_at(cx, cy):
        xm = jnp.clip(cx - 1, 0, n - 1)
        xp = jnp.clip(cx + 1, 0, n - 1)
        ym = jnp.clip(cy - 1, 0, n - 1)
        yp = jnp.clip(cy + 1, 0, n - 1)
        h_xm = jnp.take(heights_flat, cy * n + xm, mode="clip")
        h_xp = jnp.take(heights_flat, cy * n + xp, mode="clip")
        h_ym = jnp.take(heights_flat, ym * n + cx, mode="clip")
        h_yp = jnp.take(heights_flat, yp * n + cx, mode="clip")
        gx = (h_xp - h_xm) * jnp.where((xp - xm) > 0, 1.0 / (xp - xm).astype(jnp.float32), 0.0)
        gy = (h_yp - h_ym) * jnp.where((yp - ym) > 0, 1.0 / (yp - ym).astype(jnp.float32), 0.0)
        return gx, gy

    g00x, g00y = grad_at(ix, iy)
    g10x, g10y = grad_at(ix + 1, iy)
    g01x, g01y = grad_at(ix, iy + 1)
    g11x, g11y = grad_at(ix + 1, iy + 1)

    def bilerp(v00, v10, v01, v11):
        return (v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy)
                + v01 * (1 - fx) * fy + v11 * fx * fy)

    gx = bilerp(g00x, g10x, g01x, g11x)
    gy = bilerp(g00y, g10y, g01y, g11y)
    inv = jax.lax.rsqrt(gx * gx + gy * gy + 1.0)
    return -gx * inv, -gy * inv, inv  # (nx, ny, nz)


def sample_height(heights_flat, n, px, py):
    """Bilinear height sample at (px, py)."""
    ix = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, n - 2)
    iy = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, n - 2)
    fx = px - ix
    fy = py - iy
    z00, z10, z01, z11 = corner_heights(heights_flat, n, ix, iy)
    return (z00 * (1 - fx) * (1 - fy) + z10 * fx * (1 - fy)
            + z01 * (1 - fx) * fy + z11 * fx * fy)


def sample_albedo(albedo_flat, n, px, py):
    """Bilinear RGB albedo sample (SURVEY.md C18); albedo_flat is (N*N, 3)
    stored planar as three (N*N,) channels stacked: shape (3, N*N)."""
    ix = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, n - 2)
    iy = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, n - 2)
    fx = px - ix
    fy = py - iy
    base = iy * n + ix
    out = []
    for c in range(3):
        ch = albedo_flat[c]
        v00 = jnp.take(ch, base, mode="clip")
        v10 = jnp.take(ch, base + 1, mode="clip")
        v01 = jnp.take(ch, base + n, mode="clip")
        v11 = jnp.take(ch, base + n + 1, mode="clip")
        out.append(v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy)
                   + v01 * (1 - fx) * fy + v11 * fx * fy)
    return out  # [r, g, b] each f32[P]


def lambert(nx, ny, nz, lx, ly, lz):
    """N.L diffuse factor, clamped (SURVEY.md C15)."""
    return jnp.maximum(nx * lx + ny * ly + nz * lz, 0.0)


def phong_specular(nx, ny, nz, lx, ly, lz, vx, vy, vz, shininess):
    """Phong specular via reflected light dir (SURVEY.md C16).

    R = 2(N.L)N - L; spec = max(R.V, 0)^shininess (V points FROM surface
    TOWARD the eye).
    """
    ndl = nx * lx + ny * ly + nz * lz
    rx = 2.0 * ndl * nx - lx
    ry = 2.0 * ndl * ny - ly
    rz = 2.0 * ndl * nz - lz
    rdv = jnp.maximum(rx * vx + ry * vy + rz * vz, 0.0)
    return jnp.where(ndl > 0.0, rdv ** shininess, 0.0)


def sky_color(dz, sky_top, sky_horizon):
    """Vertical-gradient sky (dz = ray dir z); returns (r, g, b) f32[P]."""
    u = jnp.clip(dz, 0.0, 1.0) ** 0.5
    return tuple(sky_horizon[c] * (1.0 - u) + sky_top[c] * u for c in range(3))


def apply_fog(r, g, b, t, fog_density, fog_color):
    """Exponential distance fog (SURVEY.md C19)."""
    f = jnp.exp(-t * fog_density)
    return (r * f + fog_color[0] * (1 - f),
            g * f + fog_color[1] * (1 - f),
            b * f + fog_color[2] * (1 - f))
