"""Exact ray/cell intersection at the finest level (SURVEY.md C12).

The reference tests the ray against the surface inside one heightfield cell
once the max-mip march reaches level 0 (implied by BASELINE.json:5
"identical intersection fidelity"; the bilinear-vs-triangle choice could not
be verified against the empty mount — SURVEY.md C12 — so all three standard
cell surface models are implemented, flag-selectable):

  - "triangle": two triangles per cell split along the (00)-(11)... note:
     split along the (10)-(01) diagonal (the common heightfield triangulation)
  - "bilinear": the bilinear patch z = a + b*u + c*v + d*u*v (quadratic in t)
  - "flat":     a flat "column top" at the cell's max corner height

All functions are pure jnp, fully vectorized over rays, and shared verbatim
by the XLA march and the Pallas kernel (same float order of operations,
per SURVEY.md section 7). `div(a, b)` is the float division: plain `/`
under XLA; the kernel passes a correctly rounded one, because Triton's
default f32 division is approximate.

Inputs use the world convention: cell (cx, cy) spans x in [cx, cx+1],
y in [cy, cy+1]; corner heights z00=h[cy,cx], z10=h[cy,cx+1] (x+),
z01=h[cy+1,cx] (y+), z11=h[cy+1,cx+1].
"""

from __future__ import annotations

import operator

import jax.numpy as jnp

BIG_T = 3.0e38


def intersect_triangles(ox, oy, oz, dx, dy, dz, cx, cy,
                        z00, z10, z01, z11, t_lo, t_hi, div=operator.truediv):
    """Ray vs the two cell triangles; returns (hit, t).

    Triangulation: T1 = (c00, c10, c01), T2 = (c11, c01, c10) — split along
    the (10)-(01) diagonal. Instead of Moller-Trumbore we solve each
    triangle's *plane* for t and test barycentric containment in (u, v)
    cell-local coordinates; this form is branch-free, uses only lane-local
    arithmetic, and is numerically identical across oracle and kernel.
    """
    fx = cx.astype(jnp.float32)
    fy = cy.astype(jnp.float32)
    # cell-local ray: u(t) = ox + t*dx - fx, v(t) = oy + t*dy - fy
    # T1 plane: z = z00 + (z10-z00)*u + (z01-z00)*v
    g1x = z10 - z00
    g1y = z01 - z00
    denom1 = dz - g1x * dx - g1y * dy
    num1 = z00 + g1x * (ox - fx) + g1y * (oy - fy) - oz
    t1 = div(num1, jnp.where(jnp.abs(denom1) < 1e-20, 1e-20, denom1))
    u1 = ox + t1 * dx - fx
    v1 = oy + t1 * dy - fy
    eps = 1e-6
    in1 = (u1 >= -eps) & (v1 >= -eps) & (u1 + v1 <= 1.0 + eps)
    ok1 = in1 & (t1 >= t_lo) & (t1 <= t_hi)

    # T2 plane through c11: z = z11 + (z01-z11)*(1-u... ) derive directly:
    # z(u,v) = z10 + (z11-z10)*v + (z01-z11)*(... ) — use plane via gradients:
    # On T2 (u+v>=1): z = z11 + (z10-z11)*(1-v) ... solve with plane normal form.
    # Plane through (1,0,z10),(0,1,z01),(1,1,z11):
    #   z = z10 + (z11 - z10)*v + (z01 - z11)*(1 - u)
    #     = (z10 - z11 + z01) + (z11 - z01)*u + (z11 - z10)*v
    a2 = z10 - z11 + z01
    g2x = z11 - z01
    g2y = z11 - z10
    denom2 = dz - g2x * dx - g2y * dy
    num2 = a2 + g2x * (ox - fx) + g2y * (oy - fy) - oz
    t2 = div(num2, jnp.where(jnp.abs(denom2) < 1e-20, 1e-20, denom2))
    u2 = ox + t2 * dx - fx
    v2 = oy + t2 * dy - fy
    in2 = (u2 <= 1.0 + eps) & (v2 <= 1.0 + eps) & (u2 + v2 >= 1.0 - eps)
    ok2 = in2 & (t2 >= t_lo) & (t2 <= t_hi)

    t1s = jnp.where(ok1, t1, BIG_T)
    t2s = jnp.where(ok2, t2, BIG_T)
    t = jnp.minimum(t1s, t2s)
    return ok1 | ok2, t


def intersect_bilinear(ox, oy, oz, dx, dy, dz, cx, cy,
                       z00, z10, z01, z11, t_lo, t_hi, div=operator.truediv):
    """Ray vs bilinear patch: solve the quadratic in t; returns (hit, t)."""
    fx = cx.astype(jnp.float32)
    fy = cy.astype(jnp.float32)
    # z(u,v) = z00 + b*u + c*v + e*u*v with u = (ox-fx) + t*dx, v likewise.
    b = z10 - z00
    c = z01 - z00
    e = z11 - z10 - z01 + z00
    u0 = ox - fx
    v0 = oy - fy
    # f(t) = oz + t*dz - [z00 + b(u0+t dx) + c(v0+t dy) + e(u0+t dx)(v0+t dy)]
    # Quadratic A t^2 + B t + C = 0 with:
    A = -e * dx * dy
    B = dz - b * dx - c * dy - e * (u0 * dy + v0 * dx)
    C = oz - z00 - b * u0 - c * v0 - e * u0 * v0
    # Solve robustly; when |A| ~ 0 fall back to linear.
    lin_t = div(-C, jnp.where(jnp.abs(B) < 1e-20, 1e-20, B))
    disc = B * B - 4.0 * A * C
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    # numerically stable pair
    q = -0.5 * (B + jnp.sign(B) * sq)
    Asafe = jnp.where(jnp.abs(A) < 1e-20, 1e-20, A)
    qsafe = jnp.where(jnp.abs(q) < 1e-20, 1e-20, q)
    r1 = div(q, Asafe)
    r2 = div(C, qsafe)
    tmin = jnp.minimum(r1, r2)
    tmax = jnp.maximum(r1, r2)
    is_lin = jnp.abs(A) < 1e-12

    eps = 1e-6

    def valid(t):
        u = u0 + t * dx
        v = v0 + t * dy
        inside = (u >= -eps) & (u <= 1.0 + eps) & (v >= -eps) & (v <= 1.0 + eps)
        return inside & (t >= t_lo) & (t <= t_hi) & (disc >= 0.0)

    def valid_lin(t):
        u = u0 + t * dx
        v = v0 + t * dy
        inside = (u >= -eps) & (u <= 1.0 + eps) & (v >= -eps) & (v <= 1.0 + eps)
        return inside & (t >= t_lo) & (t <= t_hi)

    c1 = (is_lin & valid_lin(lin_t)) | (~is_lin & valid(tmin))
    c2 = ~is_lin & valid(tmax)
    tq = jnp.where(valid(tmin), tmin, jnp.where(valid(tmax), tmax, BIG_T))
    t = jnp.where(is_lin, jnp.where(valid_lin(lin_t), lin_t, BIG_T), tq)
    return c1 | c2, t


def intersect_flat(ox, oy, oz, dx, dy, dz, cx, cy,
                   z00, z10, z01, z11, t_lo, t_hi, div=operator.truediv):
    """Ray vs flat column top at the cell max height; returns (hit, t).

    Classic "voxel column" heightfield model: the cell is a box whose top is
    at zmax = max(corners). The ray hits either the top face (descending
    onto it inside [t_lo, t_hi]) or the entry wall (already below zmax at
    entry).
    """
    zmax = jnp.maximum(jnp.maximum(z00, z10), jnp.maximum(z01, z11))
    z_at_lo = oz + t_lo * dz
    # wall hit: enter the cell below the top
    wall = z_at_lo <= zmax
    # top-face hit: crosses zmax within the interval, going down
    dz_safe = jnp.where(jnp.abs(dz) < 1e-20, 1e-20, dz)
    t_top = div(zmax - oz, dz_safe)
    top = (dz < 0.0) & (t_top >= t_lo) & (t_top <= t_hi)
    hit = wall | top
    t = jnp.where(wall, t_lo, t_top)
    return hit, t


INTERSECTORS = {
    "triangle": intersect_triangles,
    "bilinear": intersect_bilinear,
    "flat": intersect_flat,
}
