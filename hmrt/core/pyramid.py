"""Maximum-mipmap pyramid (SURVEY.md C6; Tevs, Ihrke, Seidel 2008, PAPERS.md).

The reference builds log2(N) reduction levels with a CUDA kernel, level k
holding the max of each 2x2 block of level k-1 (SURVEY.md section 3.3; mount
empty, algorithm pinned by BASELINE.json:5 "maximum-mipmap (quadtree)
hierarchical stepping"). Here: one jitted `lax.reduce_window` chain (the
2x2/stride-2 max reduce), and the levels are then FLATTENED into a single
level-major 1D device buffer so a marching ray at any per-lane level
reaches its cell max with pure integer arithmetic into one array (no
per-level dispatch).

Geometry convention: heights h[y, x] are CORNER samples of an (N-1)x(N-1)
cell grid. Level 0 of the pyramid stores, per cell, the max of its 4 corner
heights — an upper bound of both the bilinear patch and the triangle-pair
surface inside the cell. The cell grid is padded to the next power of two M
with -inf so every level halves exactly.

Flat layout (level-major, finest first):
    offset(l) = sum_{k<l} (M >> k)^2 = (M^2 - (M^2 >> 2l)) * 4 // 3
    index(l, cy, cx) = offset(l) + cy * (M >> l) + cx
Closed-form offsets mean the kernel never gathers an offset table.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -3.0e38  # sentinel for padded cells; avoids inf arithmetic traps


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def num_levels(m: int) -> int:
    """Levels down to 1x1 inclusive: log2(m) + 1."""
    return m.bit_length()  # m is a power of two


def flat_size(m: int) -> int:
    return (m * m * 4 - 1) // 3  # sum of 4^k for k=0..log2(m) = (4^{L}*4-1)/3? exact: (4m^2-1)/3


def level_offset(m: int, level: int) -> int:
    mm = m * m
    return ((mm - (mm >> (2 * level))) * 4) // 3


def cell_maxes(heights: jax.Array) -> jax.Array:
    """Level-0 pyramid: per-cell max of the 4 corner height samples.

    heights: (N, N) -> (N-1, N-1) cell maxes.
    """
    return jnp.maximum(
        jnp.maximum(heights[:-1, :-1], heights[:-1, 1:]),
        jnp.maximum(heights[1:, :-1], heights[1:, 1:]),
    )


def build_levels(heights: jax.Array) -> list[jax.Array]:
    """All pyramid levels as a list of (M>>k, M>>k) arrays, finest first."""
    c = cell_maxes(heights)
    n_cells = c.shape[0]
    m = next_pow2(n_cells)
    lvl0 = jnp.full((m, m), NEG_INF, c.dtype).at[:n_cells, :n_cells].set(c)
    levels = [lvl0]
    cur = lvl0
    while cur.shape[0] > 1:
        cur = jax.lax.reduce_window(
            cur, -jnp.inf, jax.lax.max,
            window_dimensions=(2, 2), window_strides=(2, 2), padding="VALID",
        )
        levels.append(cur)
    return levels


def flatten_levels(levels: list[jax.Array]) -> jax.Array:
    """Concatenate levels (finest first, each row-major) into one 1D buffer."""
    return jnp.concatenate([lvl.reshape(-1) for lvl in levels])


@jax.jit
def build_pyramid_flat(heights: jax.Array) -> jax.Array:
    """heights (N, N) -> flat level-major max pyramid, shape (flat_size(M),)."""
    return flatten_levels(build_levels(heights))


def flat_index(m: int, level, cy, cx):
    """Index into the flat pyramid. `level/cy/cx` may be traced arrays.

    Works with per-lane (vectorized) levels: offset is closed-form integer
    arithmetic, row length is a per-lane shift.
    """
    mm = m * m
    off = ((mm - (mm >> (2 * level))) * 4) // 3
    row = m >> level
    return off + cy * row + cx
