"""Native I/O runtime vs pure-Python fallbacks (SURVEY.md C4/C5/C6)."""

import numpy as np
import pytest

from hmrt.io import image as im
from hmrt.io import native
from hmrt.core import pyramid as pyr
from hmrt.io.heightmap import procedural_terrain

needs_native = pytest.mark.skipif(native.get_lib() is None,
                                  reason="native toolchain unavailable")


@needs_native
def test_native_png_matches_python(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (57, 91, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    im.write_png(p, img)
    back = im.read_png(p)          # native path
    np.testing.assert_array_equal(back, img)


@needs_native
def test_native_unfilter_all_filter_types():
    # synthesize filtered scanlines of every type and compare to python
    rng = np.random.default_rng(1)
    h, stride, bpp = 16, 24, 3
    orig = rng.integers(0, 256, (h, stride), dtype=np.uint8)
    # build filtered stream with a rotating filter type
    raw = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = y % 5
        cur = orig[y].astype(np.int32)
        line = np.zeros(stride, np.int32)
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ft == 0:
                line[i] = cur[i]
            elif ft == 1:
                line[i] = cur[i] - a
            elif ft == 2:
                line[i] = cur[i] - b
            elif ft == 3:
                line[i] = cur[i] - ((a + b) >> 1)
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = cur[i] - pr
        raw.append(ft)
        raw.extend((line & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    out = native.png_unfilter(np.frombuffer(bytes(raw), np.uint8),
                              h, stride, bpp)
    np.testing.assert_array_equal(out, orig)


@needs_native
def test_rawmap_tiles(tmp_path):
    n = 64
    h = procedural_terrain(n, seed=2)
    p = str(tmp_path / "h.r32")
    h.tofile(p)
    with native.RawTileMap(p) as tm:
        assert tm.side == n
        t = tm.tile(8, 16, 32, 32)
        np.testing.assert_array_equal(t, h[8:40, 16:48])
        # edge clamping matches clipped-index extraction
        t2 = tm.tile(-4, 60, 8, 8)
        ys = np.clip(np.arange(-4, 4), 0, n - 1)
        xs = np.clip(np.arange(60, 68), 0, n - 1)
        np.testing.assert_array_equal(t2, h[np.ix_(ys, xs)])


@needs_native
def test_host_pyramid_matches_device():
    import jax.numpy as jnp
    h = procedural_terrain(100, seed=3)
    host = native.build_pyramid_host(h, pyr.NEG_INF)
    dev = np.asarray(pyr.build_pyramid_flat(jnp.asarray(h)))
    np.testing.assert_allclose(host, dev)


def test_python_fallback_rawmap(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    n = 32
    h = procedural_terrain(n, seed=4)
    p = str(tmp_path / "h.r32")
    h.tofile(p)
    tm = native.RawTileMap(p)
    np.testing.assert_array_equal(tm.tile(0, 0, 16, 16), h[:16, :16])
