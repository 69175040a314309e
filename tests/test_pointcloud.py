"""Point-cloud gridding + 16-bit PNG export (SURVEY.md io converters)."""

import numpy as np
import pytest

from hmrt.io import image as im
from hmrt.io.pointcloud import grid_points, load_points


def test_grid_points_max_and_mean():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 100, (5000, 3)).astype(np.float32)
    h = grid_points(pts, 32, agg="max")
    assert h.shape == (32, 32) and np.isfinite(h).all()
    hm = grid_points(pts, 32, agg="mean")
    assert (h >= hm - 1e-3).all()   # per-cell max >= mean


def test_grid_points_holes_filled():
    # sparse cloud: only corners populated; grid must still be finite
    pts = np.array([[0, 0, 1], [99, 0, 2], [0, 99, 3], [99, 99, 4]],
                   np.float32)
    h = grid_points(pts, 16)
    assert np.isfinite(h).all()
    assert h.min() >= 1.0 - 1e-5 and h.max() <= 4.0 + 1e-5


def test_load_points_text_and_npy(tmp_path):
    pts = np.array([[1, 2, 3], [4, 5, 6]], np.float32)
    p1 = str(tmp_path / "p.xyz")
    with open(p1, "w") as f:
        f.write("1 2 3\n4,5,6\n")
    np.testing.assert_allclose(load_points(p1), pts)
    p2 = str(tmp_path / "p.npy")
    np.save(p2, pts)
    np.testing.assert_allclose(load_points(p2), pts)


def test_pointcloud_through_loader(tmp_path):
    from hmrt.io.heightmap import load_heightmap
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 50, (2000, 3)).astype(np.float32)
    p = str(tmp_path / "cloud.xyz")
    np.savetxt(p, pts)
    h = load_heightmap(p, z_scale=10.0)
    assert h.shape == (1024, 1024)
    assert h.max() == pytest.approx(10.0)


def test_png16_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 65536, (24, 31), dtype=np.uint16)
    p = str(tmp_path / "h16.png")
    im.write_png16(p, img)
    back = im.read_png(p)
    np.testing.assert_array_equal(back[:, :, 0], img)
