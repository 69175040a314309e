"""Sanitizer layer (SURVEY.md section 5): checkify guards on the oracle.

The renderer is pure/functional so data races cannot occur by construction;
the remaining sanitizer surface is out-of-bounds gathers and NaN leaks.
This wraps the oracle in jax.experimental.checkify with index + NaN checks
and drives it with hostile cameras (under the terrain, far outside the
box, grazing) — the checks must come back clean, proving the clip-mode
gathers and NEG_INF sentinels keep every lane in range even for rays that
never touch the terrain.
"""

import jax
import numpy as np
import pytest
from jax.experimental import checkify

from hmrt.config import RenderConfig
from hmrt.core.renderer import render_frame_oracle
from hmrt.types import Camera

HOSTILE_CAMERAS = [
    # under the terrain, looking up
    Camera.create(eye=(32.0, 32.0, -50.0), target=(32.0, 32.0, 100.0)),
    # far outside the box, looking across it
    Camera.create(eye=(-500.0, -500.0, 5.0), target=(32.0, 32.0, 0.0)),
    # inside the terrain volume, grazing downward
    Camera.create(eye=(31.5, 31.5, 1.0), target=(200.0, 200.0, -60.0)),
    # outside, looking AWAY from the box (all sky / all invalid)
    Camera.create(eye=(-100.0, -100.0, 50.0), target=(-200.0, -200.0, 80.0)),
]


@pytest.mark.parametrize("ci", range(len(HOSTILE_CAMERAS)))
def test_oracle_checkify_clean(scene64, ci):
    cam = HOSTILE_CAMERAS[ci]
    cfg = RenderConfig(width=16, height=16, shading="phong", shadows=True,
                       aux_buffers=True)
    errs = checkify.index_checks | checkify.nan_checks
    f = checkify.checkify(
        lambda s, c: render_frame_oracle(s, c, cfg).color, errors=errs)
    err, color = f(scene64, cam)
    err.throw()  # raises if any gather went OOB or a NaN was produced
    assert np.isfinite(np.asarray(color)).all()
    assert (np.asarray(color) >= 0.0).all()


def test_debug_nans_render(scene64, camera64):
    """jax_debug_nans over a full-feature oracle render (SURVEY.md sec. 5)."""
    cfg = RenderConfig(width=16, height=16, shading="phong", shadows=True,
                       fog=True)
    jax.config.update("jax_debug_nans", True)
    try:
        fr = render_frame_oracle(scene64, camera64, cfg)
        assert np.isfinite(np.asarray(fr.color)).all()
    finally:
        jax.config.update("jax_debug_nans", False)
