"""The three 64x64 golden renders (tests/golden/b{1,2,3}_64.npy).

One recipe each for the B1-, B2- and B3-style feature sets on a 64^2
procedural map, quantized to uint8 the way the goldens were saved. The
tests compare them on the CPU and `chip_smoke.py` on the card, both to at
most 1 LSB.
"""

from __future__ import annotations

import os

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden")


def _u8(x):
    return (np.clip(np.asarray(x), 0, 1) * 255 + 0.5).astype(np.uint8)


def golden_render(name: str) -> np.ndarray:
    """Render golden `name` ("b1", "b2" or "b3") with `render_frame`."""
    from hmrt.api.scene import make_scene
    from hmrt.config import RenderConfig
    from hmrt.core.renderer import render_frame
    from hmrt.io.heightmap import procedural_terrain
    from hmrt.types import Camera

    h = procedural_terrain(64, seed=3)
    sc = make_scene(h)
    cam = Camera.create(eye=(32.0, -20.0, float(h.max()) + 12.0),
                        target=(32.0, 32.0, float(h.mean())))
    if name == "b1":
        cfg = RenderConfig(width=64, height=64, traversal="maxmip",
                           shading="lambert")
    elif name == "b2":
        # max-mip + depth/normal aux buffers; depth checked beside color
        cfg = RenderConfig(width=64, height=64, traversal="maxmip",
                           shading="lambert", aux_buffers=True)
    elif name == "b3":
        cfg = RenderConfig(width=64, height=64, traversal="maxmip",
                           shading="phong", shadows=True)
    else:
        raise ValueError(f"no golden {name!r}")
    fr = render_frame(sc, cam, cfg)
    img = _u8(fr.color)
    if name == "b2":
        depth = np.asarray(fr.depth)
        dn = _u8(np.where(np.isfinite(depth), depth, 0.0) / 128.0)
        img = np.concatenate([img, dn[:, :, None]], axis=-1)
    return img


def golden_diff(name: str, img: np.ndarray) -> np.ndarray:
    """|img - stored golden| per channel, as int."""
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}_64.npy"))
    return np.abs(img.astype(int) - golden.astype(int))
