"""Out-of-core tiled rendering for maps larger than device memory (C5).

The reference handles 8192^2-class maps as tiles (BASELINE.json:10 "8192^2
tiled heightmap"). When the whole map fits in device memory the
resident path is fastest and is what the B4 benchmark measures; this module
is the capability for maps that do NOT fit: the map is streamed tile by
tile (from a RawTileMap mmap or an in-memory array), each tile becomes a
temporary sub-scene, the FULL frame is rendered against each sub-scene with
the camera translated into tile-local coordinates, and the per-tile frames
are composited by nearest hit depth.

Exactness: every heightfield cell belongs to exactly one tile (tiles carry
a one-sample overlap so each cell's 4 corner samples are tile-local), the
per-cell intersection math is identical, and min-depth compositing selects
the globally nearest hit — so the composite is pixel-identical to a
monolithic render of the same map (tests/test_tiled.py).

Shadows: a shadow ray's occluder may live in a different tile than the
hit, so shadowed colors cannot be composited per tile. Instead the
shadowed path runs in three stages: (1) the per-tile GEOMETRY composite
above (hit, t, normal) with shading deferred; (2) a second tile sweep
marching every shadow ray clipped to that tile's cell window (any-hit,
same SHADOW_EPS origin offset as the resident path) and OR-ing the
occlusion — cells partition across tiles with bit-identical corners, so
the union equals the monolithic shadow march hit-for-hit; (3) one global
XLA shading pass replicating core.renderer.shade_hits (Lambert/Phong,
fog, sky) from the composited geometry, with albedo sampled from the
caller's full albedo array. B4 — the tiled benchmark config — remains
texture+fog without shadows (BASELINE.json:10); shadowed out-of-core
frames pay a second streaming sweep.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import jax.numpy as jnp

from hmrt.api.scene import make_scene
from hmrt.config import RenderConfig
from hmrt.core.renderer import render_frame
from hmrt.types import Camera, Frame, Light


class TileSceneCache:
    """LRU cache of tile sub-scenes, keyed by (y0, x0, kind).

    A shadowed out-of-core frame builds every visible tile's scene TWICE
    (primary composite, then the shadow sweep), and an animation rebuilds
    them every frame. Caching is pixel-neutral — same heights in, same
    scene out — and bounded: at most `max_tiles` sub-scenes stay resident
    (one 2048-cell tile is ~40 MB of device memory; 16 covers a whole
    8192^2 map if memory allows, 2-4 is enough to serve the
    primary->shadow reuse within a frame). The cache is valid for ONE
    (source, albedo) pair — pass a fresh cache when either changes.
    """

    def __init__(self, max_tiles: int):
        self.max_tiles = int(max_tiles)
        self._d: OrderedDict = OrderedDict()
        self.built = 0  # build-count telemetry (tests/_stats)

    def get(self, key, build):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        scene = build()
        self.built += 1
        if self.max_tiles > 0:
            self._d[key] = scene
            while len(self._d) > self.max_tiles:
                self._d.popitem(last=False)
        return scene

    def peek(self, key):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return None


def _tile_axis(side: int, tile: int):
    """Tile origins along one axis. Every tile spans exactly `tile` cells
    (tile+1 samples): a non-aligned final tile is SHIFTED back to overlap
    its neighbor rather than shrunk — overlapped cells are bit-identical
    duplicates, so min-depth compositing stays exact, and no tile ever
    contains fabricated cells beyond the map edge."""
    n_cells = side - 1
    if n_cells <= tile:
        return [0]
    xs = list(range(0, n_cells - tile, tile))
    xs.append(n_cells - tile)
    return xs


def _tile_origins(side: int, tile: int):
    for y0 in _tile_axis(side, tile):
        for x0 in _tile_axis(side, tile):
            yield y0, x0


def _ray_box_tmin(ox, oy, oz, dx, dy, dz, box):
    """Conservative per-ray AABB slab test in the frame's ray
    parameterization (p = o + t*d, same t as Frame.depth).

    Returns (tmin, intersects) with tmin clamped to >= 0. Near-parallel
    components are clamped to +/-1e-12 instead of special-cased, which
    errs toward "intersects" — the caller CULLS on the result, so
    uncertainty must never cull a tile that could contain a hit."""
    x0, x1, y0, y1, z0, z1 = box

    def axis(o, d, lo, hi):
        d = jnp.where(jnp.abs(d) < 1e-12,
                      jnp.where(d < 0.0, -1e-12, 1e-12), d)
        inv = 1.0 / d
        ta = (lo - o) * inv
        tb = (hi - o) * inv
        return jnp.minimum(ta, tb), jnp.maximum(ta, tb)

    t0x, t1x = axis(ox, dx, x0, x1)
    t0y, t1y = axis(oy, dy, y0, y1)
    t0z, t1z = axis(oz, dz, z0, z1)
    tmin = jnp.maximum(jnp.maximum(t0x, t0y), jnp.maximum(t0z, 0.0))
    tmax = jnp.minimum(jnp.minimum(t1x, t1y), t1z)
    return tmin, tmin <= tmax


def _tile_boxes(origins, fetch, t_cells):
    """Probe pass: stream each tile's interior samples once for its
    conservative AABB. The marched window is global cells
    [x0, x0+t_cells] x [y0, y0+t_cells], whose surface (triangle or
    bilinear — both stay within the corner-sample hull) lies inside
    [tile zmin, tile zmax] of exactly the (t_cells+1)^2 interior samples,
    so the AABB never undercounts. For an mmap'd RawTileMap this is one
    extra streaming read of the map; it buys skipping whole-tile RENDERS
    (pyramid build + full-frame march), the expensive part."""
    boxes = []
    for y0, x0 in origins:
        hts = np.asarray(fetch(y0, x0, t_cells + 1, t_cells + 1))
        boxes.append((float(x0), float(x0 + t_cells),
                      float(y0), float(y0 + t_cells),
                      float(hts.min()), float(hts.max())))
    return boxes


def _front_to_back(origins, boxes, eye):
    """Order tiles by eye-to-AABB Euclidean distance (a monotone proxy
    for entry t). Ordering is an efficiency lever only — compositing is
    min-depth, so any order gives identical pixels — but front-to-back
    makes best_t tight early, so the per-tile can-improve test culls the
    back tiles."""
    ex, ey, ez = (float(v) for v in np.asarray(eye))
    keyed = []
    for og, bx in zip(origins, boxes):
        ddx = max(bx[0] - ex, 0.0, ex - bx[1])
        ddy = max(bx[2] - ey, 0.0, ey - bx[3])
        ddz = max(bx[4] - ez, 0.0, ez - bx[5])
        keyed.append((ddx * ddx + ddy * ddy + ddz * ddz, og, bx))
    keyed.sort(key=lambda k: k[0])
    return [(og, bx) for _, og, bx in keyed]


def render_frame_tiled(source, camera: Camera, config: RenderConfig, *,
                       tile: int = 2048, light: Light | None = None,
                       albedo: np.ndarray | None = None, cull: bool = True,
                       cache: TileSceneCache | int = 0,
                       _stats: dict | None = None) -> Frame:
    """Render one frame against a tiled heightmap source.

    source: an (N, N) float32 array in world z units, or any object with
    `.side` and `.tile(y0, x0, th, tw) -> np.ndarray` (e.g.
    hmrt.io.native.RawTileMap for an mmap'd raw-f32 file).
    `tile` is the cell count per tile edge (a tile loads tile+1 samples).

    cull: probe each tile's AABB once, order tiles front-to-back, and
    render a tile only if some ray could still hit it strictly closer
    than its current composite depth. Pixel-identical to cull=False (a
    skipped tile's hits satisfy t >= AABB entry t >= best_t, and the
    composite keeps strictly-closer hits only); the win is skipping
    whole-tile renders behind the camera / outside the frustum / fully
    occluded. _stats (a dict, test hook) records tiles_total,
    tiles_rendered, shadow_tiles_marched and tiles_built.

    cache: a TileSceneCache (or an int max-tile count) keeping built
    sub-scenes resident across the shadow sweep and across frames —
    pixel-neutral, bounded HBM (see TileSceneCache). 0 = no caching.
    """
    if not isinstance(cache, TileSceneCache):
        cache = TileSceneCache(int(cache))
    built0 = cache.built  # per-call build count for _stats
    if isinstance(source, np.ndarray):
        side = source.shape[0]

        def fetch(y0, x0, th, tw):
            ys = np.clip(np.arange(y0, y0 + th), 0, side - 1)
            xs = np.clip(np.arange(x0, x0 + tw), 0, side - 1)
            return np.asarray(source[np.ix_(ys, xs)], np.float32)
    else:
        side = source.side
        fetch = source.tile

    H, W = config.height, config.width
    n_cells = side - 1
    t_cells = min(tile, n_cells)
    # Sub-scenes carry a one-sample margin on every edge so gradient
    # normals at tile seams read the true neighbor samples (fetch clamps
    # at the map border — exactly the monolithic border clamping). The
    # march is clipped to the interior cell window [1, 1 + t_cells] so the
    # margin's duplicate/virtual cells are never tested.
    # Shadowed frames defer ALL shading to the global stage-3 pass, so the
    # per-tile renders drop shadows (occlusion is stage 2's job).
    sub_cfg = dataclasses.replace(config, aux_buffers=True, shadows=False,
                                  clip_box=(1.0, 1.0 + t_cells))

    def load_tile(y0, x0, with_albedo):
        n_sub = t_cells + 3  # tile samples + 1 margin sample per edge
        heights = np.array(fetch(y0 - 1, x0 - 1, n_sub, n_sub))
        # Off-map margin lines (clamped duplicates) are linearly
        # extrapolated so border-cell gradients match the monolithic
        # render: its clamped central difference (h[1]-h[0])/1 equals the
        # local (h[1]-h[-1])/2 exactly when h[-1] = 2*h[0]-h[1]. Margin
        # cells are outside clip_box, so the values are never marched.
        if y0 - 1 < 0:
            heights[0, :] = 2.0 * heights[1, :] - heights[2, :]
        if x0 - 1 < 0:
            heights[:, 0] = 2.0 * heights[:, 1] - heights[:, 2]
        if y0 - 1 + n_sub > side:
            heights[-1, :] = 2.0 * heights[-2, :] - heights[-3, :]
        if x0 - 1 + n_sub > side:
            heights[:, -1] = 2.0 * heights[:, -2] - heights[:, -3]
        alb = None
        if with_albedo:
            ys = np.clip(np.arange(y0 - 1, y0 - 1 + n_sub), 0, side - 1)
            xs = np.clip(np.arange(x0 - 1, x0 - 1 + n_sub), 0, side - 1)
            alb = np.asarray(albedo[np.ix_(ys, xs)], np.float32)
        return heights, alb

    if n_cells < 1:
        raise ValueError("heightmap smaller than one cell")

    # sky image computed once (identical expression to the monolithic
    # renderer's miss pixels) so an all-culled frame still has a color
    from hmrt.shading import shade as sh
    lgt = light if light is not None else Light.create()
    eye_v, dirs = camera.rays(H, W)
    skyr, skyg, skyb = sh.sky_color(dirs[..., 2], lgt.sky_top,
                                    lgt.sky_horizon)
    sky_col = jnp.clip(jnp.stack([skyr, skyg, skyb], axis=-1), 0.0, 1.0)

    origins = list(_tile_origins(side, tile))
    if cull:
        boxes = _tile_boxes(origins, fetch, t_cells)
        ordered = _front_to_back(origins, boxes, camera.eye)
    else:
        ordered = [(og, None) for og in origins]
    dflat = dirs.reshape(-1, 3)

    best_t = jnp.full((H, W), jnp.inf, jnp.float32)
    best_color = sky_col
    best_normal = jnp.zeros((H, W, 3), jnp.float32)
    any_hit = jnp.zeros((H, W), bool)
    rendered = 0

    for (y0, x0), box in ordered:
        if box is not None:
            tmin, ib = _ray_box_tmin(eye_v[0], eye_v[1], eye_v[2],
                                     dflat[:, 0], dflat[:, 1], dflat[:, 2],
                                     box)
            if not bool(jnp.any(ib & (tmin < best_t.reshape(-1)))):
                continue
        rendered += 1

        def build_full(y0=y0, x0=x0):
            heights, alb = load_tile(y0, x0, albedo is not None)
            return make_scene(heights, albedo=alb, light=light)

        scene = cache.get((y0, x0, "full"), build_full)
        # translate the camera into tile-local world coordinates (the
        # margin shifts the tile origin by one more sample)
        off = jnp.asarray([x0 - 1, y0 - 1, 0.0], jnp.float32)
        cam_local = Camera(eye=camera.eye - off, target=camera.target - off,
                           up=camera.up, fov_y=camera.fov_y)
        fr = render_frame(scene, cam_local, sub_cfg)
        hit = fr.hit
        t = jnp.where(hit, fr.depth, jnp.inf)
        closer = t < best_t
        best_color = jnp.where(closer[..., None], fr.color, best_color)
        best_normal = jnp.where(closer[..., None], fr.normal, best_normal)
        best_t = jnp.minimum(best_t, t)
        any_hit = any_hit | hit
        # free the sub-scene before the next tile streams in (the cache,
        # if enabled, holds its bounded working set)
        del scene

    if _stats is not None:
        _stats.update(tiles_total=len(ordered), tiles_rendered=rendered)

    if config.shadows:
        frame = _shade_shadowed(camera, config, light, albedo, load_tile,
                                [og for og, _ in ordered],
                                [bx for _, bx in ordered],
                                side, t_cells,
                                best_t, best_normal, any_hit, cache, _stats)
        if _stats is not None:
            _stats["tiles_built"] = cache.built - built0
        return frame

    if _stats is not None:
        _stats["tiles_built"] = cache.built - built0

    color = jnp.where(any_hit[..., None], best_color, sky_col)
    return Frame(color=color,
                 depth=best_t if config.aux_buffers else None,
                 normal=(jnp.where(any_hit[..., None], best_normal, 0.0)
                         if config.aux_buffers else None),
                 hit=any_hit)


def _shade_shadowed(camera, config, light, albedo, load_tile, origins,
                    boxes, side, t_cells, best_t, best_normal, any_hit,
                    cache, _stats=None):
    """Stages 2+3 of the shadowed out-of-core frame (module docstring):
    union the per-tile clipped any-hit shadow marches, then shade the
    composited geometry globally — the same expressions as
    core.renderer.shade_hits, so the result matches a monolithic shadowed
    render (tests/test_tiled.py).

    With AABB boxes available (cull=True), a tile's shadow march is
    skipped when no LIVE shadow ray (primary hit, not yet occluded)
    intersects its AABB — the union over the remaining tiles is
    unchanged because skipped tiles can contribute no occlusion hit."""
    import jax
    from hmrt.core.renderer import SHADOW_EPS, march_path, maxmip_march
    from hmrt.shading import shade as sh

    march_maxmip = maxmip_march(march_path(jax.default_backend()))

    H, W = config.height, config.width
    lgt = light if light is not None else Light.create()
    eye, dirs = camera.rays(H, W)
    d = dirs.reshape(-1, 3)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    P = dx.shape[0]
    hit = any_hit.reshape(-1)
    tb = best_t.reshape(-1)
    ts = jnp.where(hit, tb, 0.0)
    px = eye[0] + ts * dx
    py = eye[1] + ts * dy
    pz = eye[2] + ts * dz
    nrm = best_normal.reshape(-1, 3)
    nx, ny, nz = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    lx, ly, lz = lgt.sun_dir[0], lgt.sun_dir[1], lgt.sun_dir[2]

    # stage 2: occlusion — shadow origins offset exactly as shade_hits
    sx = px + lx * SHADOW_EPS + nx * SHADOW_EPS
    sy = py + ly * SHADOW_EPS + ny * SHADOW_EPS
    sz = pz + lz * SHADOW_EPS + nz * SHADOW_EPS
    occ = jnp.zeros(P, bool)
    marched = 0
    for (y0, x0), box in zip(origins, boxes):
        live = hit & ~occ
        if not bool(jnp.any(live)):
            break
        if box is not None:
            tmin, ib = _ray_box_tmin(
                sx, sy, sz,
                jnp.broadcast_to(lx, (P,)), jnp.broadcast_to(ly, (P,)),
                jnp.broadcast_to(lz, (P,)), box)
            if not bool(jnp.any(live & ib)):
                continue
        marched += 1
        # the shadow march needs only pyr_flat + heights: a cached "full"
        # scene from the primary pass serves directly; otherwise build
        # (and cache) one
        sub = cache.peek((y0, x0, "full"))
        if sub is None:

            def build_shadow(y0=y0, x0=x0):
                heights, _ = load_tile(y0, x0, False)
                return make_scene(heights, light=lgt)

            sub = cache.get((y0, x0, "shadow"), build_shadow)
        shadow_cap = config.max_steps or (8 * sub.n_cells + 256)
        res = march_maxmip(
            jnp.where(live, sx - (x0 - 1), -1e6),
            jnp.where(live, sy - (y0 - 1), -1e6), sz,
            jnp.broadcast_to(lx, (P,)), jnp.broadcast_to(ly, (P,)),
            jnp.broadcast_to(lz, (P,)),
            sub.pyr_flat, sub.heights.reshape(-1),
            n=sub.n, m=sub.m, levels=sub.levels, max_steps=shadow_cap,
            cell_intersect=config.cell_intersect, any_hit=True,
            clip=(1.0, 1.0 + t_cells))
        occ = occ | res.hit
        del sub
    if _stats is not None:
        _stats["shadow_tiles_marched"] = marched

    # stage 3: global shading from composited geometry (mirrors shade_hits)
    diff = sh.lambert(nx, ny, nz, lx, ly, lz)
    diff = jnp.where(occ, 0.0, diff)
    if config.texture and albedo is not None:
        alb_planar = jnp.asarray(
            np.asarray(albedo, np.float32).reshape(side * side, 3).T.copy())
        ar, ag, ab = sh.sample_albedo(alb_planar, side, px, py)
    else:
        ar = ag = ab = jnp.full_like(px, 0.55)
    amb = config.ambient
    sr, sg, sb = lgt.sun_color[0], lgt.sun_color[1], lgt.sun_color[2]
    r = ar * (amb + diff * sr)
    g = ag * (amb + diff * sg)
    b = ab * (amb + diff * sb)
    if config.shading == "phong":
        spec = sh.phong_specular(nx, ny, nz, lx, ly, lz,
                                 -dx, -dy, -dz, config.shininess)
        spec = jnp.where(occ, 0.0, spec)
        ks = config.specular
        r = r + ks * spec * sr
        g = g + ks * spec * sg
        b = b + ks * spec * sb
    if config.fog:
        r, g, b = sh.apply_fog(r, g, b, ts, config.fog_density,
                               lgt.fog_color)
    skyr, skyg, skyb = sh.sky_color(dz, lgt.sky_top, lgt.sky_horizon)
    r = jnp.where(hit, r, skyr)
    g = jnp.where(hit, g, skyg)
    b = jnp.where(hit, b, skyb)
    color = jnp.clip(jnp.stack([r, g, b], axis=-1), 0.0, 1.0)
    return Frame(color=color.reshape(H, W, 3),
                 depth=best_t if config.aux_buffers else None,
                 normal=(jnp.where(any_hit[..., None], best_normal, 0.0)
                         if config.aux_buffers else None),
                 hit=any_hit)
