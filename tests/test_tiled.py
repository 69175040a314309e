"""Out-of-core tiled render == monolithic render (SURVEY.md C5).

Every cell lives in exactly one tile (overlap duplicates are
bit-identical), so nearest-depth compositing must reproduce the
monolithic image. Camera translation into tile-local coordinates shifts
ray origins by exact small integers, so intersection t's match to f32 ulp.
"""

import numpy as np
import pytest

from hmrt.api.tiled import _tile_axis, render_frame_tiled
from hmrt.api.scene import make_scene
from hmrt.config import RenderConfig
from hmrt.core.renderer import render_frame
from hmrt.io.heightmap import procedural_terrain
from hmrt.types import Camera


def _cam(h):
    n = h.shape[0]
    return Camera.create(eye=(n * 0.5, -n * 0.3, float(h.max()) + n * 0.15),
                         target=(n * 0.5, n * 0.5, float(h.mean())))


def test_tile_axis_covers_all_cells():
    for side, tile in [(129, 64), (120, 64), (65, 64), (40, 64), (8193, 2048)]:
        xs = _tile_axis(side, tile)
        covered = set()
        for x0 in xs:
            assert x0 + min(tile, side - 1) <= side - 1 or x0 == 0
            covered.update(range(x0, min(x0 + tile, side - 1)))
        assert covered == set(range(side - 1)), (side, tile)


@pytest.mark.parametrize("side,tile", [(129, 64), (120, 64)])
def test_tiled_matches_monolithic(side, tile):
    h = procedural_terrain(side, seed=7)
    rng = np.random.default_rng(1)
    albedo = rng.uniform(0.2, 0.9, (side, side, 3)).astype(np.float32)
    cam = _cam(h)
    cfg = RenderConfig(width=48, height=32, shading="phong", fog=True,
                       texture=True, aux_buffers=True)
    mono = render_frame(make_scene(h, albedo=albedo), cam, cfg)
    tiled = render_frame_tiled(h, cam, cfg, tile=tile, albedo=albedo)
    np.testing.assert_array_equal(np.asarray(tiled.hit), np.asarray(mono.hit))
    np.testing.assert_allclose(np.asarray(tiled.depth),
                               np.asarray(mono.depth), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(tiled.color),
                               np.asarray(mono.color), atol=2e-4)


def test_tiled_from_rawmap(tmp_path):
    h = procedural_terrain(100, seed=9)
    path = str(tmp_path / "m.raw")
    h.astype(np.float32).tofile(path)
    from hmrt.io.native import RawTileMap
    cam = _cam(h)
    cfg = RenderConfig(width=32, height=24)
    mono = render_frame(make_scene(h), cam, cfg)
    with RawTileMap(path) as rm:
        assert rm.side == 100
        tiled = render_frame_tiled(rm, cam, cfg, tile=48)
    np.testing.assert_array_equal(np.asarray(tiled.hit), np.asarray(mono.hit))
    np.testing.assert_allclose(np.asarray(tiled.color),
                               np.asarray(mono.color), atol=2e-4)


def test_tiled_shadows_match_monolithic():
    """Shadowed out-of-core: the union of per-tile clipped shadow marches
    + global reshade equals the resident shadowed render (occlusion is
    compared via the color planes: any occlusion flip shows up at full
    sun-term magnitude, far above the 2e-4 float tolerance)."""
    side, tile = 129, 64
    h = procedural_terrain(side, seed=7)
    cam = _cam(h)
    cfg = RenderConfig(width=48, height=32, shading="phong", shadows=True,
                       fog=True, aux_buffers=True)
    mono = render_frame(make_scene(h), cam, cfg)
    tiled = render_frame_tiled(h, cam, cfg, tile=tile)
    np.testing.assert_array_equal(np.asarray(tiled.hit), np.asarray(mono.hit))
    np.testing.assert_allclose(np.asarray(tiled.depth),
                               np.asarray(mono.depth), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(tiled.color),
                               np.asarray(mono.color), atol=2e-4)


def test_tiled_culling_skips_tiles_pixel_identical():
    """Front-to-back AABB culling: an oblique close-up view must render
    strictly fewer than all tiles, with output pixel-identical to the
    uncull path (and to the monolithic render)."""
    side, tile = 129, 32
    h = procedural_terrain(side, seed=7)
    cam = Camera.create(eye=(20.0, 8.0, float(h.max()) + 6.0),
                        target=(30.0, 30.0, float(h.mean())),
                        fov_y_deg=50.0)
    cfg = RenderConfig(width=48, height=32, shading="phong", fog=True,
                       aux_buffers=True)
    stats = {}
    culled = render_frame_tiled(h, cam, cfg, tile=tile, _stats=stats)
    full = render_frame_tiled(h, cam, cfg, tile=tile, cull=False)
    assert stats["tiles_total"] == 16
    assert 0 < stats["tiles_rendered"] < stats["tiles_total"], stats
    np.testing.assert_array_equal(np.asarray(culled.hit),
                                  np.asarray(full.hit))
    np.testing.assert_array_equal(np.asarray(culled.color),
                                  np.asarray(full.color))
    np.testing.assert_array_equal(np.asarray(culled.depth),
                                  np.asarray(full.depth))
    mono = render_frame(make_scene(h), cam, cfg)
    np.testing.assert_allclose(np.asarray(culled.color),
                               np.asarray(mono.color), atol=2e-4)


def test_tiled_culling_all_sky():
    """A camera looking straight up renders ZERO tiles and still produces
    the exact monolithic sky."""
    side = 65
    h = procedural_terrain(side, seed=3)
    cam = Camera.create(eye=(32.0, 32.0, float(h.max()) + 10.0),
                        target=(33.0, 32.0, float(h.max()) + 400.0))
    cfg = RenderConfig(width=32, height=24)
    stats = {}
    tiled = render_frame_tiled(h, cam, cfg, tile=32, _stats=stats)
    assert stats["tiles_rendered"] == 0, stats
    mono = render_frame(make_scene(h), cam, cfg)
    assert not bool(np.asarray(tiled.hit).any())
    # sky gradient only; computed by two separately-compiled programs,
    # whose rounding may differ by ~1 ulp
    np.testing.assert_allclose(np.asarray(tiled.color),
                               np.asarray(mono.color), atol=5e-6)


def test_tiled_shadow_culling_skips_tiles():
    """Shadowed out-of-core with culling: fewer-than-all tiles marched in
    the shadow sweep, colors identical to the uncull path."""
    side, tile = 129, 32
    h = procedural_terrain(side, seed=7)
    cam = Camera.create(eye=(20.0, 8.0, float(h.max()) + 6.0),
                        target=(30.0, 30.0, float(h.mean())),
                        fov_y_deg=50.0)
    cfg = RenderConfig(width=40, height=28, shadows=True)
    stats = {}
    culled = render_frame_tiled(h, cam, cfg, tile=tile, _stats=stats)
    full = render_frame_tiled(h, cam, cfg, tile=tile, cull=False)
    assert stats["shadow_tiles_marched"] < stats["tiles_total"], stats
    np.testing.assert_array_equal(np.asarray(culled.color),
                                  np.asarray(full.color))


def test_tiled_shadows_low_sun_crosses_tiles():
    """A low sun throws occlusion across tile boundaries — the case a
    naive per-tile shadow march would get wrong."""
    from hmrt.types import Light

    side, tile = 129, 64
    h = procedural_terrain(side, seed=11)
    light = Light.create(sun_dir=(0.9, 0.1, 0.25))
    cam = _cam(h)
    cfg = RenderConfig(width=40, height=28, shadows=True)
    mono = render_frame(make_scene(h, light=light), cam, cfg)
    tiled = render_frame_tiled(h, cam, cfg, tile=tile, light=light)
    np.testing.assert_allclose(np.asarray(tiled.color),
                               np.asarray(mono.color), atol=2e-4)


def test_tile_scene_cache_pixel_neutral_and_reuses():
    """TileSceneCache: a shadowed frame with caching is pixel-identical
    to the uncached render, reuses primary scenes for the shadow sweep
    (fewer builds than marches+renders), and a repeated frame through a
    persistent cache builds zero new scenes."""
    from hmrt.api.tiled import TileSceneCache

    side, tile = 129, 64
    h = procedural_terrain(side, seed=7)
    cam = _cam(h)
    cfg = RenderConfig(width=48, height=32, shading="phong", shadows=True,
                       fog=True, aux_buffers=True)
    s0, s1 = {}, {}
    plain = render_frame_tiled(h, cam, cfg, tile=tile, _stats=s0)
    cache = TileSceneCache(16)
    cached = render_frame_tiled(h, cam, cfg, tile=tile, cache=cache,
                                _stats=s1)
    np.testing.assert_array_equal(np.asarray(cached.color),
                                  np.asarray(plain.color))
    np.testing.assert_array_equal(np.asarray(cached.hit),
                                  np.asarray(plain.hit))
    # uncached: every render + every shadow march builds a scene
    assert s0["tiles_built"] == s0["tiles_rendered"] + s0["shadow_tiles_marched"]
    # cached: the shadow sweep reuses the primary pass's scenes
    assert s1["tiles_built"] == s1["tiles_rendered"], s1
    # second identical frame: fully served from the cache
    s2 = {}
    again = render_frame_tiled(h, cam, cfg, tile=tile, cache=cache,
                               _stats=s2)
    assert s2["tiles_built"] == 0, s2
    np.testing.assert_array_equal(np.asarray(again.color),
                                  np.asarray(plain.color))


def test_tile_scene_cache_bounded():
    """An LRU bound below the tile count still renders correctly and
    never holds more than max_tiles scenes."""
    from hmrt.api.tiled import TileSceneCache

    side, tile = 129, 32  # 16 tiles
    h = procedural_terrain(side, seed=7)
    cam = _cam(h)
    cfg = RenderConfig(width=40, height=28)
    cache = TileSceneCache(3)
    plain = render_frame_tiled(h, cam, cfg, tile=tile)
    cached = render_frame_tiled(h, cam, cfg, tile=tile, cache=cache)
    assert len(cache._d) <= 3
    np.testing.assert_array_equal(np.asarray(cached.color),
                                  np.asarray(plain.color))
