"""Max-mipmap / DDA heightfield ray march (SURVEY.md C10, C11, C13).

The reference marches each ray with per-thread Amanatides-Woo DDA accelerated
by the maximum-mipmap quadtree (BASELINE.json:5; algorithm per Tevs, Ihrke,
Seidel 2008 — PAPERS.md). A CUDA thread follows data-dependent control flow.
`march_maxmip` here is the XLA form and the oracle: ALL rays march in
lockstep as one batched `lax.while_loop` whose per-lane state is {t, level,
cell, alive, ...} and whose body is branch-free vector arithmetic plus
gathers — every "branch" is a `jnp.where` select. The GPU path runs the
same step per thread in a Pallas kernel (traversal/march_pallas.py).
Correctness invariant (tests/test_maxmip.py): the
accelerated march returns the same hit cell and t as brute-force fine-level
DDA, because the skip test is conservative at every level (a coarse cell's
stored max bounds the surface inside it).

Robustness design (shared verbatim with the Pallas kernel so hit decisions
match): cell coordinates are INTEGER per-lane state — stepping increments
them directly, so every iteration makes integer progress and no float
epsilon is ever added to t (an epsilon nudge is swamped by f32 rounding
when a direction component is tiny, which stalls the march). Level changes
are exact integer ops: ascend = cell >> 1, descend = 2*cell + (position vs
child midpoint). Boundary-crossing t values are always computed from the
ray ORIGIN (t = (boundary - o) / d), never accumulated. Exact corner
crossings take two steps (x then y) — a degenerate zero-length interval,
handled conservatively by the skip test.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hmrt.core.pyramid import flat_index
from hmrt.traversal.intersect import INTERSECTORS, BIG_T

EPS_EXIT = 1.0e-6
T_TOL = 1.0e-3   # slack on [t_lo, t_hi] for the exact intersection test


class MarchResult(NamedTuple):
    hit: jax.Array     # bool[P]
    t: jax.Array       # f32[P] hit distance (BIG_T if miss)
    cx: jax.Array      # i32[P] hit cell x (level 0)
    cy: jax.Array      # i32[P] hit cell y
    steps: jax.Array   # i32[] total loop iterations taken (diagnostics)
    work: jax.Array    # i32[] sum of alive lanes over all iterations


def ray_box_range(ox, oy, dx, dy, world_max, clip=None):
    """Clip rays to the terrain slab x,y in [0, world_max]; returns
    (t0, t1, valid). `clip=(lo, hi)` narrows the marched window to the
    cell coordinates [lo, hi] instead — the out-of-core tiled path uses it
    to march only a tile's interior cells (api/tiled.py)."""
    lo, hi = (0.0, world_max) if clip is None else clip
    inv_x = 1.0 / jnp.where(jnp.abs(dx) < 1e-20, 1e-20, dx)
    inv_y = 1.0 / jnp.where(jnp.abs(dy) < 1e-20, 1e-20, dy)
    tx0 = (lo - ox) * inv_x
    tx1 = (hi - ox) * inv_x
    ty0 = (lo - oy) * inv_y
    ty1 = (hi - oy) * inv_y
    t_lo = jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1))
    t_hi = jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1))
    t0 = jnp.maximum(t_lo, 0.0)
    t1 = t_hi
    return t0, t1, t1 > t0


def _cell_side(lvl):
    """2^lvl as f32 from an integer level: shift + convert (2 cheap VPU ops)
    instead of jnp.exp2 (transcendental lowering). Exact — powers of two
    are exactly representable, so downstream float math is bit-identical."""
    return (jnp.int32(1) << lvl).astype(jnp.float32)


def entry_cell(ox, oy, dx, dy, t0, lvl, side):
    """Integer cell containing the entry point at level `lvl` (clamped)."""
    s = _cell_side(lvl)
    px = ox + t0 * dx
    py = oy + t0 * dy
    icx = jnp.clip(jnp.floor(px / s).astype(jnp.int32), 0, side - 1)
    icy = jnp.clip(jnp.floor(py / s).astype(jnp.int32), 0, side - 1)
    return icx, icy


def ray_inverses(dx, dy):
    """Safe reciprocal direction components, hoisted out of the march loop
    (a VPU divide is an order of magnitude pricier than a multiply)."""
    inv_x = 1.0 / jnp.where(jnp.abs(dx) < 1e-20, 1e-20, dx)
    inv_y = 1.0 / jnp.where(jnp.abs(dy) < 1e-20, 1e-20, dy)
    return inv_x, inv_y


def step_geometry(ox, oy, dx, dy, icx, icy, lvl, inv_x=None, inv_y=None):
    """Exit t of integer cell (icx, icy) at level `lvl`, the stepped
    neighbor cell, and the crossed boundary index (ascent test input).

    Pure lane-local arithmetic; boundary t computed from the origin.
    """
    if inv_x is None:
        inv_x, inv_y = ray_inverses(dx, dy)
    s = _cell_side(lvl)
    pos_x = dx > 0.0
    pos_y = dy > 0.0
    bx = icx + pos_x.astype(jnp.int32)          # x boundary index to cross
    by = icy + pos_y.astype(jnp.int32)
    tx = (bx.astype(jnp.float32) * s - ox) * inv_x
    ty = (by.astype(jnp.float32) * s - oy) * inv_y
    tx = jnp.where(jnp.abs(dx) < 1e-20, BIG_T, tx)
    ty = jnp.where(jnp.abs(dy) < 1e-20, BIG_T, ty)
    axis_x = tx <= ty                            # tie -> step x first
    t_exit = jnp.minimum(tx, ty)
    step_x = jnp.where(pos_x, 1, -1)
    step_y = jnp.where(pos_y, 1, -1)
    nx = jnp.where(axis_x, icx + step_x, icx)
    ny = jnp.where(axis_x, icy, icy + step_y)
    # crossed boundary index on the stepped axis (at this level)
    b = jnp.where(axis_x, bx, by)
    return t_exit, nx, ny, b


def ascent_levels(b):
    """Levels to ascend after crossing boundary index b: the number of
    trailing zero bits of b, capped at 3 (ascending is always correct —
    the skip test is conservative at every level — so this is purely a
    perf policy; it is shared by the oracle and the Pallas kernel)."""
    a1 = ((b & 1) == 0).astype(jnp.int32)
    a2 = ((b & 3) == 0).astype(jnp.int32)
    a3 = ((b & 7) == 0).astype(jnp.int32)
    return a1 + a2 + a3


def descend_cell(ox, oy, dx, dy, t, icx, icy, lvl):
    """Child cell (at lvl-1) containing the position at parameter t.

    Callers mask out lvl == 0 lanes (descend is only taken above level 0);
    the clamp keeps the shift in _cell_side defined for those dead lanes
    (a negative shift is undefined, where exp2(-1) merely gave 0.5)."""
    s_child = _cell_side(jnp.maximum(lvl - 1, 0))
    px = ox + t * dx
    py = oy + t * dy
    cx2 = 2 * icx
    cy2 = 2 * icy
    right = px >= (cx2 + 1).astype(jnp.float32) * s_child
    up = py >= (cy2 + 1).astype(jnp.float32) * s_child
    return cx2 + right.astype(jnp.int32), cy2 + up.astype(jnp.int32)


def _take_clip(a, idx):
    return jnp.take(a, idx, mode="clip")


def corner_heights(heights_flat, n, cx, cy, take=_take_clip):
    """Gather the 4 corner heights of fine cell (cx, cy) from flat heights.

    cx/cy are clamped to the valid cell range [0, n-2] BEFORE forming flat
    indices: the march gathers unconditionally for masked-out lanes sitting
    in padded cells (cell grid is padded to a power of two > n-1), and the
    clamp keeps even those raw indices in bounds (checkify-clean) — their
    values are never used (padded cells' pyramid max is NEG_INF).
    `take(array, idx)` is the gather: `jnp.take` here, a ref load inside
    the Pallas kernel (traversal/march_pallas.py)."""
    cx = jnp.clip(cx, 0, n - 2)
    cy = jnp.clip(cy, 0, n - 2)
    base = cy * n + cx
    z00 = take(heights_flat, base)
    z10 = take(heights_flat, base + 1)
    z01 = take(heights_flat, base + n)
    z11 = take(heights_flat, base + n + 1)
    return z00, z10, z01, z11


class MaxmipRays(NamedTuple):
    """Per-ray constants of the max-mip march."""
    ox: jax.Array
    oy: jax.Array
    oz: jax.Array
    dx: jax.Array
    dy: jax.Array
    dz: jax.Array
    inv_x: jax.Array
    inv_y: jax.Array
    t1: jax.Array      # exit t of the marched window


def maxmip_start(ox, oy, oz, dx, dy, dz, global_max, *, n: int, m: int,
                 levels: int, start_level: int | None = None,
                 clip: tuple | None = None):
    """Ray constants and the initial march state {t, lvl, icx, icy, alive}.

    Rays that miss the marched window, or start above `global_max` and
    climb (the early-out sky test, SURVEY.md C13), start dead."""
    world_max = float(n - 1)
    top = levels - 1 if start_level is None else min(start_level, levels - 1)
    t0, t1, valid = ray_box_range(ox, oy, dx, dy, world_max, clip)
    inv_x, inv_y = ray_inverses(dx, dy)
    z_at_entry = oz + t0 * dz
    sky = (z_at_entry > global_max) & (dz >= 0.0)
    valid = valid & ~sky
    top_arr = jnp.full(ox.shape, top, jnp.int32)
    icx0, icy0 = entry_cell(ox, oy, dx, dy, t0, top_arr, m >> top)
    rays = MaxmipRays(ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1)
    state = dict(t=jnp.where(valid, t0, BIG_T), lvl=top_arr, icx=icx0,
                 icy=icy0, alive=valid)
    return rays, state


def maxmip_step(st, r: MaxmipRays, pyr_flat, heights_flat, global_max, *,
                n: int, m: int, levels: int, intersector,
                take=_take_clip, cone=None):
    """One max-mip iteration for a batch of lanes: skip, descend, or run the
    exact cell test, then step. Shared by the XLA march below and the
    Pallas kernel (traversal/march_pallas.py), so both make the same float
    operations in the same order. `st` holds t, lvl, icx, icy, alive, hit,
    t_hit, hx, hy; the updated dict is returned."""
    t, lvl, alive = st["t"], st["lvl"], st["alive"]
    icx, icy = st["icx"], st["icy"]
    ox, oy, oz, dx, dy, dz, t1 = r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.t1

    t_exit, nx, ny, bnd = step_geometry(ox, oy, dx, dy, icx, icy, lvl,
                                        r.inv_x, r.inv_y)
    t_exit_c = jnp.minimum(t_exit, t1)

    # min ray height over [t, t_exit_c] (z is linear in t); degenerate
    # corner intervals give a point test — conservative either way
    zmin = oz + jnp.minimum(t * dz, t_exit_c * dz)

    side = m >> lvl
    idx = flat_index(m, lvl,
                     jnp.clip(icy, 0, side - 1),
                     jnp.clip(icx, 0, side - 1))
    cmax = take(pyr_flat, idx)

    skip = zmin > cmax
    at_fine = lvl == 0
    descend = ~skip & ~at_fine
    test = ~skip & at_fine & alive

    # exact intersection at the finest level
    z00, z10, z01, z11 = corner_heights(heights_flat, n, icx, icy, take)
    hit_now, t_c = intersector(ox, oy, oz, dx, dy, dz, icx, icy,
                               z00, z10, z01, z11,
                               t - T_TOL, t_exit_c + T_TOL)
    hit_now = hit_now & test

    advance = alive & ~descend & ~hit_now

    # descend: exact integer child selection at the current position
    dcx, dcy = descend_cell(ox, oy, dx, dy, t, icx, icy, lvl)

    # multi-level ascent on skip-advance by boundary alignment; a failed
    # exact test does NOT ascend (terrain-hugging rays would ping-pong
    # descend/ascend around the surface)
    asc = jnp.where(alive & skip & advance, ascent_levels(bnd), 0)
    asc = jnp.minimum(asc, (levels - 1) - lvl)
    new_lvl = jnp.where(descend, lvl - 1, lvl + asc)
    adv_x = nx >> asc
    adv_y = ny >> asc
    new_icx = jnp.where(descend, dcx, jnp.where(advance, adv_x, icx))
    new_icy = jnp.where(descend, dcy, jnp.where(advance, adv_y, icy))
    new_t = jnp.where(advance, jnp.maximum(t, t_exit_c), t)

    if cone is not None:
        # cone jump (core/cone.py): a level-0 lane whose exact test
        # missed (and whose cell-max skip also failed — the grazing
        # regime) may advance several cells at once when the cone
        # over its apex corner sample clears the ray's descent.
        from hmrt.core.cone import cone_safe_cells
        cone_flat, cone_radius, inv_vmax, g_cheb = cone
        capex = take(cone_flat,
                     jnp.clip(icy, 0, n - 2) * n + jnp.clip(icx, 0, n - 2))
        z_e = oz + t_exit_c * dz
        kj = cone_safe_cells(z_e, z00, capex, g_cheb, cone_radius)
        jump = advance & at_fine & ~skip & (kj >= 2)
        t_j = t_exit_c + kj.astype(jnp.float32) * inv_vmax
        jx = jnp.clip(jnp.floor(ox + t_j * dx).astype(jnp.int32), 0, m - 1)
        jy = jnp.clip(jnp.floor(oy + t_j * dy).astype(jnp.int32), 0, m - 1)
        new_t = jnp.where(jump, t_j, new_t)
        new_icx = jnp.where(jump, jx, new_icx)
        new_icy = jnp.where(jump, jy, new_icy)
        new_lvl = jnp.where(jump, 0, new_lvl)
        out_jump = jump & (t_j >= t1 - EPS_EXIT)
        advance_step = advance & ~jump
    else:
        out_jump = False
        advance_step = advance

    new_side = m >> new_lvl
    # escape test (exact, not heuristic): once the ray's position is
    # above the global max height and it is climbing, no hit is
    # possible — the in-march generalization of the entry sky test
    escaped = advance & (oz + new_t * dz > global_max) & (dz > 0.0)
    out = (advance_step & ((t_exit >= t1 - EPS_EXIT)
                           | (new_icx < 0) | (new_icx >= new_side)
                           | (new_icy < 0) | (new_icy >= new_side))
           | out_jump | escaped)
    new_alive = alive & ~hit_now & ~out

    return dict(
        t=new_t,
        lvl=jnp.where(alive, new_lvl, lvl),
        icx=jnp.where(alive, new_icx, icx),
        icy=jnp.where(alive, new_icy, icy),
        alive=new_alive,
        hit=st["hit"] | hit_now,
        t_hit=jnp.where(hit_now, t_c, st["t_hit"]),
        hx=jnp.where(hit_now, icx, st["hx"]),
        hy=jnp.where(hit_now, icy, st["hy"]),
    )


def init_results(state):
    """Add the hit outputs {hit, t_hit, hx, hy} to a fresh march state."""
    shape = state["t"].shape
    return dict(state, hit=jnp.zeros(shape, bool),
                t_hit=jnp.full(shape, BIG_T, jnp.float32),
                hx=jnp.zeros(shape, jnp.int32),
                hy=jnp.zeros(shape, jnp.int32))


@partial(jax.jit, static_argnames=("n", "m", "levels", "max_steps",
                                   "cell_intersect", "start_level", "any_hit",
                                   "clip", "cone_radius"))
def march_maxmip(ox, oy, oz, dx, dy, dz, pyr_flat, heights_flat, *,
                 n: int, m: int, levels: int, max_steps: int,
                 cell_intersect: str = "triangle",
                 start_level: int | None = None,
                 any_hit: bool = False,
                 clip: tuple | None = None,
                 cone_flat=None, cone_radius: int = 0) -> MarchResult:
    """Masked-wavefront maximum-mipmap march over a batch of rays.

    All ray components are f32[P]; pyr_flat/heights_flat live in device
    memory. `any_hit=True` is the shadow-ray variant (SURVEY.md C17):
    identical traversal, the caller consumes only the hit mask.

    `cone_flat`/`cone_radius`: optional conservative cone field
    (core/cone.py) — level-0 lanes whose exact test misses advance by a
    multi-cell safe jump instead of one DDA step; hit decisions are
    bit-identical (tests/test_cone.py). The renderer leaves it off.
    """
    del any_hit  # same traversal; the caller reads only the hit mask
    intersector = INTERSECTORS[cell_intersect]
    global_max = pyr_flat[-1]
    rays, state = maxmip_start(ox, oy, oz, dx, dy, dz, global_max, n=n, m=m,
                               levels=levels, start_level=start_level,
                               clip=clip)
    cone = None
    if cone_flat is not None:
        # per-lane constants of the cone jump: Chebyshev speed (cells per
        # unit t along the dominant axis) and dz per Chebyshev cell
        inv_vmax = 1.0 / jnp.maximum(jnp.maximum(jnp.abs(dx), jnp.abs(dy)),
                                     1e-20)
        cone = (cone_flat, cone_radius, inv_vmax, dz * inv_vmax)
    state = dict(init_results(state), i=jnp.int32(0), work=jnp.int32(0))

    def cond(st):
        return (st["i"] < max_steps) & jnp.any(st["alive"])

    def body(st):
        new = maxmip_step(st, rays, pyr_flat, heights_flat, global_max,
                          n=n, m=m, levels=levels, intersector=intersector,
                          cone=cone)
        return dict(new, i=st["i"] + 1,
                    work=st["work"] + jnp.sum(st["alive"].astype(jnp.int32)))

    final = jax.lax.while_loop(cond, body, state)
    return MarchResult(final["hit"], final["t_hit"], final["hx"], final["hy"],
                       final["i"], final["work"])


@partial(jax.jit, static_argnames=("n", "max_steps", "cell_intersect",
                                   "clip"))
def march_dda(ox, oy, oz, dx, dy, dz, heights_flat, *,
              n: int, max_steps: int,
              cell_intersect: str = "triangle",
              clip: tuple | None = None) -> MarchResult:
    """Brute-force uniform-grid DDA at the finest level (SURVEY.md C10).

    Independent of the pyramid — tests every crossed cell with the exact
    intersector. This is BASELINE.json:7's B1 traversal mode AND the oracle
    that pins the max-mip march's exactness (tests/test_maxmip.py).
    """
    intersector = INTERSECTORS[cell_intersect]
    world_max = float(n - 1)
    n_cells = n - 1
    t0, t1, valid = ray_box_range(ox, oy, dx, dy, world_max, clip)

    P = ox.shape
    inv_x, inv_y = ray_inverses(dx, dy)
    lvl0 = jnp.zeros(P, jnp.int32)
    icx0, icy0 = entry_cell(ox, oy, dx, dy, t0, lvl0, n_cells)
    state = dict(
        t=jnp.where(valid, t0, BIG_T),
        icx=icx0,
        icy=icy0,
        alive=valid,
        hit=jnp.zeros(P, bool),
        t_hit=jnp.full(P, BIG_T, jnp.float32),
        hx=jnp.zeros(P, jnp.int32),
        hy=jnp.zeros(P, jnp.int32),
        i=jnp.int32(0),
        work=jnp.int32(0),
    )

    def cond(st):
        return (st["i"] < max_steps) & jnp.any(st["alive"])

    def body(st):
        t, alive = st["t"], st["alive"]
        icx, icy = st["icx"], st["icy"]
        t_exit, nx, ny, _ = step_geometry(ox, oy, dx, dy, icx, icy, lvl0,
                                          inv_x, inv_y)
        t_exit_c = jnp.minimum(t_exit, t1)
        z00, z10, z01, z11 = corner_heights(heights_flat, n, icx, icy)
        hit_now, t_c = intersector(ox, oy, oz, dx, dy, dz, icx, icy,
                                   z00, z10, z01, z11,
                                   t - T_TOL, t_exit_c + T_TOL)
        hit_now = hit_now & alive
        out = (t_exit >= t1 - EPS_EXIT) | (nx < 0) | (nx >= n_cells) \
            | (ny < 0) | (ny >= n_cells)
        return dict(
            t=jnp.where(alive, jnp.maximum(t, t_exit_c), t),
            icx=jnp.where(alive, nx, icx),
            icy=jnp.where(alive, ny, icy),
            alive=alive & ~hit_now & ~out,
            hit=st["hit"] | hit_now,
            t_hit=jnp.where(hit_now, t_c, st["t_hit"]),
            hx=jnp.where(hit_now, icx, st["hx"]),
            hy=jnp.where(hit_now, icy, st["hy"]),
            i=st["i"] + 1,
            work=st["work"] + jnp.sum(alive.astype(jnp.int32)),
        )

    final = jax.lax.while_loop(cond, body, state)
    return MarchResult(final["hit"], final["t_hit"], final["hx"], final["hy"],
                       final["i"], final["work"])
