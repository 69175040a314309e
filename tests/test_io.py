"""Heightmap / image I/O round-trips (SURVEY.md C4, C2-replacement)."""

import numpy as np
import pytest

from hmrt.io import image as im
from hmrt.io.heightmap import load_heightmap, procedural_terrain


def test_png_roundtrip_rgb(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    im.write_png(p, img)
    back = im.read_png(p)
    np.testing.assert_array_equal(back, img)


def test_png_roundtrip_gray(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (16, 21), dtype=np.uint8)
    p = str(tmp_path / "g.png")
    im.write_png(p, img)
    back = im.read_png(p)
    np.testing.assert_array_equal(back[:, :, 0], img)


def test_png_float_clipping(tmp_path):
    img = np.array([[[1.5, -0.2, 0.5]]], np.float32)
    p = str(tmp_path / "c.png")
    im.write_png(p, img)
    back = im.read_png(p)
    np.testing.assert_array_equal(back[0, 0], [255, 0, 128])


def _write_palette_png(path, idx, pal, depth, trns=None):
    """Minimal PLTE PNG writer (test fixture; filter 0 rows)."""
    import struct
    import zlib

    h, w = idx.shape

    def chunk(tag, body):
        c = struct.pack(">I", len(body)) + tag + body
        return c + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    if depth == 8:
        rows = idx.astype(np.uint8)
    else:
        per = 8 // depth
        pad = (-w) % per
        p = np.pad(idx, ((0, 0), (0, pad))).astype(np.uint8)
        bits = ((p[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
        rows = np.packbits(bits.reshape(h, -1), axis=1)
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 3, 0, 0, 0))
    out += chunk(b"PLTE", pal.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", bytes(trns))
    out += chunk(b"IDAT", zlib.compress(raw))
    out += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_png_palette(tmp_path, depth):
    rng = np.random.default_rng(depth)
    ncol = 1 << depth
    pal = rng.integers(0, 256, (ncol, 3), dtype=np.uint8)
    idx = rng.integers(0, ncol, (5, 7), dtype=np.uint8)
    p = str(tmp_path / "pal.png")
    _write_palette_png(p, idx, pal, depth)
    back = im.read_png(p)
    assert back.shape == (5, 7, 3)
    np.testing.assert_array_equal(back, pal[idx])


def test_png_palette_trns(tmp_path):
    pal = np.array([[255, 0, 0], [0, 255, 0]], np.uint8)
    idx = np.array([[0, 1], [1, 0]], np.uint8)
    p = str(tmp_path / "pal_a.png")
    _write_palette_png(p, idx, pal, 8, trns=[128])
    back = im.read_png(p)
    assert back.shape == (2, 2, 4)
    np.testing.assert_array_equal(back[..., 3],
                                  np.where(idx == 0, 128, 255))


def test_apng_roundtrip(tmp_path):
    """APNG structure + per-frame pixel fidelity: walk the chunk stream,
    reassemble each frame as a standalone PNG, and decode it back."""
    import struct
    import zlib

    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (3, 6, 9, 3), dtype=np.uint8)
    p = str(tmp_path / "anim.apng")
    im.write_apng(p, frames, fps=10)
    data = open(p, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunks.append((tag, data[pos + 8:pos + 8 + ln]))
        pos += 12 + ln
    tags = [t for t, _ in chunks]
    assert tags.count(b"fcTL") == 3 and tags.count(b"fdAT") == 2
    actl = dict(chunks)[b"acTL"]
    assert struct.unpack(">II", actl) == (3, 0)
    ihdr = dict(chunks)[b"IHDR"]

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    datas = [b for t, b in chunks if t == b"IDAT"] \
        + [b[4:] for t, b in chunks if t == b"fdAT"]
    for fi, d in enumerate(datas):
        single = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                  + chunk(b"IDAT", d) + chunk(b"IEND", b""))
        sp = str(tmp_path / f"f{fi}.png")
        open(sp, "wb").write(single)
        np.testing.assert_array_equal(im.read_png(sp), frames[fi])


def test_load_npy(tmp_path):
    h = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)
    p = str(tmp_path / "h.npy")
    np.save(p, h)
    out = load_heightmap(p, z_scale=2.0)
    assert out.shape == (8, 8)
    assert out.min() == 0.0 and out.max() == pytest.approx(2.0)


def test_load_raw(tmp_path):
    h = np.arange(16, dtype=np.float32)
    p = str(tmp_path / "h.r32")
    h.tofile(p)
    out = load_heightmap(p, z_scale=1.0)
    assert out.shape == (4, 4)


def test_load_png_heightmap(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    p = str(tmp_path / "h.png")
    im.write_png(p, img)
    out = load_heightmap(p, z_scale=3.0)
    assert out.shape == (16, 16)
    assert out.max() == pytest.approx(3.0)


def test_load_pgm_ascii_and_binary(tmp_path):
    p = str(tmp_path / "a.pgm")
    with open(p, "w") as f:
        f.write("P2\n# comment\n3 2\n255\n0 128 255\n64 32 16\n")
    out = load_heightmap(p, z_scale=1.0)
    assert out.shape == (2, 3)
    assert out[0, 2] == pytest.approx(1.0)

    p2 = str(tmp_path / "b.pgm")
    data = np.arange(6, dtype=np.uint8).reshape(2, 3)
    with open(p2, "wb") as f:
        f.write(b"P5\n3 2\n255\n")
        f.write(data.tobytes())
    out2 = load_heightmap(p2, z_scale=5.0)
    assert out2.shape == (2, 3)
    assert out2.max() == pytest.approx(5.0)


def test_load_esri_ascii(tmp_path):
    p = str(tmp_path / "d.asc")
    with open(p, "w") as f:
        f.write("ncols 3\nnrows 2\nxllcorner 0\nyllcorner 0\ncellsize 30\n"
                "NODATA_value -9999\n1 2 3\n4 -9999 6\n")
    out = load_heightmap(p, z_scale=1.0)
    assert out.shape == (2, 3)
    assert np.isfinite(out).all()


def test_procedural_deterministic():
    a = procedural_terrain(32, seed=5)
    b = procedural_terrain(32, seed=5)
    c = procedural_terrain(32, seed=6)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3
    assert a.shape == (32, 32) and a.dtype == np.float32


def test_procedural_native_matches_numpy(monkeypatch):
    """The native fBm evaluator (io/native terrain_fbm) is BIT-identical
    to the numpy spec — same f64 interpolation, one f32 rounding per
    octave (odd size exercises the non-exact linspace step)."""
    import hmrt.io.heightmap as hm
    import hmrt.io.native as nat
    if nat.get_lib() is None:
        pytest.skip("native lib unavailable")
    a = hm.procedural_terrain(257, seed=5)
    monkeypatch.setattr(nat, "terrain_fbm", lambda *a_, **k: None)
    b = hm.procedural_terrain(257, seed=5)
    np.testing.assert_array_equal(a, b)


def test_png_truncation_fuzz(tmp_path):
    """Every truncation of a valid PNG must either raise a clean
    ValueError or decode fully (cuts inside a trailing CRC / IEND once
    all pixel data is present) — never an opaque struct/zlib/TypeError
    and never silent garbage (untrusted-input path)."""
    p = tmp_path / "t.png"
    img = (np.random.default_rng(0).random((17, 23, 3)) * 255) / 255.0
    im.write_png(str(p), img)
    data = p.read_bytes()
    ref = im.read_png(str(p))
    q = tmp_path / "cut.png"
    for cut in list(range(0, len(data), 7)) + [len(data) - 1]:
        q.write_bytes(data[:cut])
        try:
            got = im.read_png(str(q))
        except ValueError:
            continue
        np.testing.assert_array_equal(got, ref)  # complete-data cuts only


def test_asc_truncation_fuzz(tmp_path):
    """A truncated ESRI ASCII grid must raise a clean ValueError — it
    used to come back as a silently SMALLER heightmap (header-only cut
    loaded as a (1, 2) array) or an IndexError on a cut header line."""
    h = (np.random.default_rng(0).random((19, 19)) * 1000).astype(np.float32)
    p = tmp_path / "t.asc"
    with open(p, "w") as f:
        f.write("ncols 19\nnrows 19\nxllcorner 0\nyllcorner 0\n"
                "cellsize 1\nNODATA_value -9999\n")
        for row in h:
            f.write(" ".join(f"{v:.2f}" for v in row) + "\n")
    data = p.read_bytes()
    q = tmp_path / "cut.asc"
    full = load_heightmap(str(p))
    assert full.shape == (19, 19)
    # cuts inside the LAST number are undetectable in a text format (a
    # truncated "841.11" still parses as a float and the grid shape is
    # complete) — exclude the final token; every structural truncation
    # must raise
    for cut in list(range(0, len(data) - 8, 11)):
        q.write_bytes(data[:cut])
        with pytest.raises(ValueError):
            load_heightmap(str(q))
