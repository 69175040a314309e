"""GeoTIFF DEM reader (io/geotiff.py): synthetic TIFFs covering the DEM
profile — strips/tiles, none/deflate/LZW/PackBits, predictor 2, BigTIFF.
"""

import struct
import zlib

import numpy as np
import pytest

from hmrt.io.geotiff import read_tiff_gray
from hmrt.io.heightmap import load_heightmap


def _write_tiff(path, img, *, comp=1, tiled=False, predictor=1,
                big=False, bo="<"):
    """Minimal single-band TIFF writer for test fixtures."""
    h, w = img.shape
    dt = img.dtype
    bits = dt.itemsize * 8
    sfmt = {"u": 1, "i": 2, "f": 3}[dt.kind]

    def prep(block):
        if predictor == 3:
            # float predictor: big-endian byte planes (MSB first), then
            # byte-wise horizontal differencing — inverse of _unpredict
            be = np.ascontiguousarray(block.astype(f">f{dt.itemsize}"))
            b = be.view(np.uint8).reshape(block.shape[0], block.shape[1],
                                          dt.itemsize)
            b = b.transpose(0, 2, 1).reshape(block.shape[0], -1)
            d = b.astype(np.int16)
            d[:, 1:] = d[:, 1:] - d[:, :-1]
            raw = (d & 0xFF).astype(np.uint8).tobytes()
            if comp in (8, 32946):
                return zlib.compress(raw)
            return raw
        if predictor == 2:
            u = block.view(np.dtype(f"u{dt.itemsize}")).astype(np.int64)
            d = np.empty_like(u)
            d[:, 0] = u[:, 0]
            d[:, 1:] = u[:, 1:] - u[:, :-1]
            block = (d & ((1 << bits) - 1)).astype(
                np.dtype(f"u{dt.itemsize}")).view(dt)
        raw = block.astype(dt.newbyteorder(bo)).tobytes()
        if comp in (8, 32946):
            return zlib.compress(raw)
        return raw

    blocks, extra_tags = [], []
    if tiled:
        tw = th = 16
        per_row = (w + tw - 1) // tw
        per_col = (h + th - 1) // th
        for ty in range(per_col):
            for tx in range(per_row):
                tile = np.zeros((th, tw), dt)
                ys = min(th, h - ty * th)
                xs = min(tw, w - tx * tw)
                tile[:ys, :xs] = img[ty * th:ty * th + ys,
                                     tx * tw:tx * tw + xs]
                blocks.append(prep(tile))
        extra_tags = [(322, 3, [tw]), (323, 3, [th])]
        off_tag, cnt_tag = 324, 325
    else:
        rows = 7
        for y in range(0, h, rows):
            blocks.append(prep(img[y:y + rows]))
        extra_tags = [(278, 3, [rows])]
        off_tag, cnt_tag = 273, 279

    tags = [(256, 3, [w]), (257, 3, [h]), (258, 3, [bits]),
            (259, 3, [comp]), (277, 3, [1]), (339, 3, [sfmt]),
            (317, 3, [predictor])] + extra_tags
    # layout: header | IFD | out-of-line values | block data
    n = len(tags) + 2
    hdr = 16 if big else 8
    esz, cfmt = (20, "Q") if big else (12, "I")
    ifd_size = (8 + n * esz + 8) if big else (2 + n * esz + 4)
    voff = hdr + ifd_size
    aux = bytearray()

    def enc_entry(tag, typ, vals):
        nonlocal aux
        fmt = {3: "H", 4: "I", 16: "Q"}[typ]
        size = struct.calcsize(fmt) * len(vals)
        inline = 8 if big else 4
        body = struct.pack(bo + fmt * len(vals), *vals)
        if size <= inline:
            val = body + b"\x00" * (inline - size)
        else:
            val = struct.pack(bo + cfmt, voff + len(aux))
            aux += body
        return (struct.pack(bo + "HH", tag, typ)
                + struct.pack(bo + cfmt, len(vals)) + val)

    # encode entries with dummy offsets first, then patch them in
    otyp = 16 if big else 4
    entries = [enc_entry(t, ty, v) for t, ty, v in tags]
    off_pos = len(aux)
    entries.append(enc_entry(off_tag, otyp, [0] * len(blocks)))
    entries.append(enc_entry(cnt_tag, otyp, [len(b) for b in blocks]))
    data0 = voff + len(aux)
    offs = []
    pos = data0
    for b in blocks:
        offs.append(pos)
        pos += len(b)
    # patch offsets into aux (or inline if they fit)
    fmt = "Q" if big else "I"
    packed = struct.pack(bo + fmt * len(blocks), *offs)
    inline = 8 if big else 4
    if len(packed) <= inline:
        entries[-2] = (struct.pack(bo + "HH", off_tag, otyp)
                       + struct.pack(bo + cfmt, len(blocks))
                       + packed + b"\x00" * (inline - len(packed)))
    else:
        aux[off_pos:off_pos + len(packed)] = packed

    out = bytearray()
    out += (b"II" if bo == "<" else b"MM")
    if big:
        out += struct.pack(bo + "HHHQ", 43, 8, 0, 16)
        out += struct.pack(bo + "Q", n)
    else:
        out += struct.pack(bo + "HI", 42, 8)
        out += struct.pack(bo + "H", n)
    for e in sorted(entries, key=lambda e: struct.unpack(bo + "H", e[:2])[0]):
        out += e
    out += struct.pack(bo + ("Q" if big else "I"), 0)  # next IFD
    out += aux
    for b in blocks:
        out += b
    with open(path, "wb") as f:
        f.write(out)


@pytest.fixture
def dem():
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 1000, (37, 53))).astype(np.float32)


@pytest.mark.parametrize("comp", [1, 8])
def test_strips_f32(tmp_path, dem, comp):
    p = str(tmp_path / "d.tif")
    _write_tiff(p, dem, comp=comp)
    np.testing.assert_array_equal(read_tiff_gray(p), dem)


@pytest.mark.parametrize("compression",
                         ["tiff_lzw", "tiff_deflate", "packbits", None])
def test_against_pillow(tmp_path, compression):
    """Cross-validate against real Pillow-written TIFFs (u8/u16/f32,
    whatever strip layout + predictor Pillow chooses)."""
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 255, (37, 53), dtype=np.uint8),
            rng.integers(0, 60000, (23, 31), dtype=np.uint16),
            rng.uniform(0, 1000, (19, 29)).astype(np.float32)]
    for i, img in enumerate(imgs):
        p = str(tmp_path / f"pil{i}.tif")
        kw = {"compression": compression} if compression else {}
        PIL.fromarray(img).save(p, **kw)
        np.testing.assert_array_equal(read_tiff_gray(p), img)


def test_tiles_deflate(tmp_path, dem):
    p = str(tmp_path / "t.tif")
    _write_tiff(p, dem, comp=8, tiled=True)
    np.testing.assert_array_equal(read_tiff_gray(p), dem)


def test_i16_predictor2_deflate(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(-500, 4000, (23, 31), dtype=np.int16)
    p = str(tmp_path / "p.tif")
    _write_tiff(p, img, comp=8, predictor=2)
    np.testing.assert_array_equal(read_tiff_gray(p), img)


def test_f32_predictor3_deflate(tmp_path, dem):
    """GDAL's recommended profile for float DEMs: deflate + PREDICTOR=3."""
    p = str(tmp_path / "p3.tif")
    _write_tiff(p, dem, comp=8, predictor=3)
    np.testing.assert_array_equal(read_tiff_gray(p), dem)


def test_f32_predictor3_tiled(tmp_path, dem):
    p = str(tmp_path / "p3t.tif")
    _write_tiff(p, dem, comp=8, predictor=3, tiled=True)
    np.testing.assert_array_equal(read_tiff_gray(p), dem)


def test_unknown_predictor_raises(tmp_path, dem):
    p = str(tmp_path / "px.tif")
    _write_tiff(p, dem, predictor=4)
    with pytest.raises(ValueError, match="predictor"):
        read_tiff_gray(p)


def test_truncated_tiff_raises(tmp_path, dem):
    p = str(tmp_path / "tr.tif")
    _write_tiff(p, dem)
    with open(p, "rb") as f:
        data = f.read()
    with open(p, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(ValueError, match="[Tt]runcated|exceeds"):
        read_tiff_gray(p)


def test_u16_bigendian(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 65535, (11, 17), dtype=np.uint16)
    p = str(tmp_path / "be.tif")
    _write_tiff(p, img, bo=">")
    np.testing.assert_array_equal(read_tiff_gray(p), img)


def test_bigtiff(tmp_path, dem):
    p = str(tmp_path / "big.tif")
    _write_tiff(p, dem, big=True)
    np.testing.assert_array_equal(read_tiff_gray(p), dem)


def test_packbits_decoder():
    from hmrt.io.geotiff import _packbits_decode

    # literal run of 3, replicate 'x' 4 times, literal 1
    enc = bytes([2]) + b"abc" + bytes([253]) + b"x" + bytes([0]) + b"z"
    assert _packbits_decode(enc) == b"abcxxxxz"


def test_load_heightmap_tif(tmp_path, dem):
    p = str(tmp_path / "dem.tif")
    _write_tiff(p, dem, comp=8)
    h = load_heightmap(p)
    assert h.shape == dem.shape and h.dtype == np.float32


def test_tiff_truncation_fuzz(tmp_path, dem):
    """Every truncation of a valid TIFF must raise a clean ValueError —
    the header/IFD region included (it used to leak opaque struct.error
    messages) — never decode silent garbage (untrusted-input path)."""
    p = str(tmp_path / "t.tif")
    _write_tiff(p, dem)
    data = open(p, "rb").read()
    q = str(tmp_path / "cut.tif")
    for cut in list(range(0, len(data), 7)) + [len(data) - 1]:
        with open(q, "wb") as f:
            f.write(data[:cut])
        with pytest.raises(ValueError):
            read_tiff_gray(q)
