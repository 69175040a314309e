"""CLI entry points end-to-end (SURVEY.md C1/L6): render, flythrough,
view (HTML + APNG), tiled render — tiny scenes on the oracle/CPU path.
"""

import numpy as np
import pytest

from hmrt.cli.render import main as render_main
from hmrt.cli.view import main as view_main
from hmrt.io.image import read_png


def test_render_cli_png(tmp_path):
    out = str(tmp_path / "r.png")
    rc = render_main(["--size", "64", "--width", "48", "--height", "32",
                      "--shadows", "--fog", "-o", out])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (32, 48, 3)
    assert img.max() > 0


def test_render_cli_aux(tmp_path):
    out = str(tmp_path / "r.png")
    rc = render_main(["--size", "64", "--width", "32", "--height", "24",
                      "--aux", "-o", out])
    assert rc == 0
    depth = np.load(str(tmp_path / "r_depth.npy"))
    assert depth.shape == (24, 32)
    assert read_png(str(tmp_path / "r_normal.png")).shape == (24, 32, 3)


def test_render_cli_tiled(tmp_path):
    out = str(tmp_path / "t.png")
    rc = render_main(["--size", "80", "--width", "32", "--height", "24",
                      "--tile", "48", "-o", out])
    assert rc == 0
    assert read_png(out).shape == (24, 32, 3)


def test_render_cli_tiled_flythrough(tmp_path):
    """Out-of-core animation: --tile + --flythrough renders each frame
    through render_frame_tiled with a persistent tile-scene cache."""
    out = str(tmp_path / "fly.npy")
    rc = render_main(["--size", "80", "--width", "32", "--height", "24",
                      "--tile", "48", "--flythrough", "2",
                      "--tile-cache", "4", "-o", out])
    assert rc == 0
    stack = np.load(out)
    assert stack.shape == (2, 24, 32, 3)
    assert np.isfinite(stack).all()


def test_render_cli_albedo(tmp_path):
    from hmrt.io.image import write_png

    rng = np.random.default_rng(4)
    tex = rng.uniform(0.0, 1.0, (40, 40, 3)).astype(np.float32)
    texp = str(tmp_path / "tex.png")
    write_png(texp, tex)
    out = str(tmp_path / "a.png")
    rc = render_main(["--size", "64", "--width", "32", "--height", "24",
                      "--albedo", texp, "-o", out])
    assert rc == 0
    assert read_png(out).shape == (24, 32, 3)


def test_load_texture_resample(tmp_path):
    from hmrt.io.heightmap import load_texture
    from hmrt.io.image import write_png

    tex = np.zeros((16, 16, 3), np.float32)
    tex[:, :, 0] = 1.0  # constant red resamples exactly
    p = str(tmp_path / "t.png")
    write_png(p, tex)
    out = load_texture(p, 33)
    assert out.shape == (33, 33, 3)
    np.testing.assert_allclose(out[..., 0], 1.0, atol=1e-2)
    np.testing.assert_allclose(out[..., 1], 0.0, atol=1e-2)


def test_load_texture_gray_alpha(tmp_path):
    """A gray+alpha PNG must expand to RGB (alpha dropped), not pass
    through as an (N, N, 2) array that breaks albedo packing later."""
    from hmrt.io.heightmap import load_texture
    from hmrt.io.image import write_png

    ga = np.zeros((8, 8, 2), np.float32)
    ga[:, :, 0] = 0.5
    ga[:, :, 1] = 1.0
    p = str(tmp_path / "ga.png")
    write_png(p, ga)
    out = load_texture(p)
    assert out.shape == (8, 8, 3)
    np.testing.assert_allclose(out, 0.5, atol=1e-2)


def test_load_texture_via_pillow(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    from hmrt.io.heightmap import load_heightmap, load_texture

    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)
    p = str(tmp_path / "t.jpg")
    PIL.fromarray(img).save(p, quality=95)
    tex = load_texture(p, 20)
    assert tex.shape == (20, 20, 3) and 0.0 <= tex.min() <= tex.max() <= 1.0
    # JPEG heightmap via the generic fallback
    h = load_heightmap(p)
    assert h.shape == (20, 20) and h.dtype == np.float32


def test_flythrough_and_view_cli(tmp_path):
    stack = str(tmp_path / "fly.npy")
    rc = render_main(["--size", "64", "--width", "32", "--height", "24",
                      "--flythrough", "3", "-o", stack])
    assert rc == 0
    frames = np.load(stack)
    assert frames.shape == (3, 24, 32, 3)

    html = str(tmp_path / "fly.html")
    assert view_main([stack, "-o", html]) == 0
    text = open(html).read()
    assert "data:image/png;base64," in text

    apng = str(tmp_path / "fly.apng")
    assert view_main([stack, "-o", apng]) == 0
    data = open(apng, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"acTL" in data
