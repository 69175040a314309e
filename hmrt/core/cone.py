"""Conservative cone-ratio field for multi-cell steps on grazing rays.

The grazing tail is the measured wall of the B3 frame (BENCH_NOTES.md):
~25% of rays consume ~75% of all lane-steps crawling cell-by-cell at
level 0, because both the 2x2 block maxima and the single-cell maxima sit
ABOVE the grazing band — the maximum-mipmap gives zero skip there by
construction. The classic remedy from the heightfield-rendering
literature (cone step mapping, Dummer 2006; relaxed cones, Policarpo &
Oliveira, GPU Gems 3 ch. 18 — see PAPERS.md) is a second precomputed
field: per SAMPLE (i, j), the smallest cone opening ratio

    c(i, j) = max_{0 < chebdist((u,v),(i,j)) <= R} (H[u,v] - H[i,j]) / chebdist

such that no terrain sample within Chebyshev radius R pokes above the
cone  z = H[i,j] + c(i,j) * d.  A ray at height z over a cell whose low
corner (the apex sample) has height H0 and cone c can then advance

    u_max = (z - H0 - 2c) / (c - g)        [g = dz per chebyshev cell]

Chebyshev cells in one step without any possibility of an intersection:
every cell it overlaps at displacement u has its corner samples within
cheb distance u + 2 of the apex (+1 for the ray's in-cell offset, +1 for
the cell's far corners), and both intersectors' surfaces are bounded by
their cells' max corner, so the ray stays STRICTLY above the surface for
all displacements < u_max. The kernels jump floor(u_max) - 1 cells —
a full safety cell over the f32 rounding of the bound — so hit decisions
stay bit-identical to the oracle (tests/test_cone.py pins this against
brute-force DDA).

Unlike "relaxed" cone stepping (which over-opens the cone and binary-
searches afterwards, trading exactness for speed), this field is strictly
conservative: c is a MAX over true ratios, computed by R rounds of 3x3
Chebyshev max-dilation (radius-d Chebyshev dilation = d rounds of 3x3),
dividing by the round index. Dilation uses a -inf border, so edge cones
only see in-map terrain.

Cost: R reduce_window passes over the (n, n) grid at scene build time,
one extra (n, n) f32 field, one extra gather and ~25 extra ops per fine
iteration of the XLA march (the only march that takes the option).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

CONE_RADIUS = 64  # default Chebyshev validity radius of the cone field


@partial(jax.jit, static_argnames=("radius",))
def build_cone(heights: jax.Array, radius: int = CONE_RADIUS) -> jax.Array:
    """Conservative cone ratios c >= 0 per sample, valid within `radius`.

    heights: (n, n) f32 sample grid. Returns (n, n) f32 with
    H[u,v] <= H[i,j] + c[i,j] * chebdist for all samples within radius
    (tests/test_cone.py asserts the invariant on random grids).
    """
    h = heights.astype(jnp.float32)

    def body(d, carry):
        w, c = carry
        w = jax.lax.reduce_window(
            w, -jnp.inf, jax.lax.max,
            window_dimensions=(3, 3), window_strides=(1, 1), padding="SAME")
        c = jnp.maximum(c, (w - h) / d.astype(jnp.float32))
        return (w, c)

    _, cone = jax.lax.fori_loop(1, radius + 1, body,
                                (h, jnp.zeros_like(h)))
    return cone


def cone_safe_cells(z_exit, apex_h, cone, g_cheb, radius: int):
    """Safe whole-cell jump count for rays leaving a fine cell.

    z_exit: ray height at the current cell's exit; apex_h: the cell's low
    corner sample height (z00); cone: that sample's ratio; g_cheb: ray
    dz per Chebyshev cell (signed). Returns i32 >= 0; a jump of k cells
    is exact for k >= 2 (k < 2 callers take the normal single step).
    """
    num = z_exit - apex_h - 2.0 * cone
    den = cone - g_cheb
    u = jnp.where(den > 1e-12, num / den,
                  jnp.where(num > 0.0, 3.4e38, 0.0))
    k = jnp.floor(jnp.minimum(u, 3.0e38)).astype(jnp.int32) - 1
    return jnp.clip(k, 0, radius - 2)
