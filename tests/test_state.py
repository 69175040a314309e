"""Scene/camera persistence round-trips (SURVEY.md section 5)."""

import numpy as np

from hmrt.api.scene import make_scene
from hmrt.config import RenderConfig
from hmrt.io.state import load_state, save_state
from hmrt.io.heightmap import procedural_terrain
from hmrt.types import Camera, Light


def test_state_roundtrip(tmp_path):
    terr = procedural_terrain(64, seed=7)
    rng = np.random.default_rng(0)
    albedo = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    scene = make_scene(terr, albedo=albedo, light=Light.create(sun_dir=(1, 2, 3)))
    cam = Camera.create(eye=(1, 2, 3), target=(4, 5, 6), fov_y_deg=42.0)
    cfg = RenderConfig(width=320, height=200, shadows=True, fog=True)
    base = str(tmp_path / "state")
    save_state(base, scene=scene, camera=cam, light=scene.light,
               config=cfg, frame_index=17)
    st = load_state(base)
    assert st["frame_index"] == 17
    assert st["config"] == cfg
    np.testing.assert_allclose(np.asarray(st["camera"].eye), [1, 2, 3])
    assert float(np.asarray(st["camera"].fov_y)) == np.float32(np.deg2rad(42.0))
    np.testing.assert_allclose(np.asarray(st["scene"].heights), terr, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(st["light"].sun_dir),
                               np.asarray(scene.light.sun_dir), rtol=1e-6)
    # albedo round-trips through the planar storage
    n = scene.n
    back = np.asarray(st["scene"].albedo).T.reshape(n, n, 3)
    np.testing.assert_allclose(back, albedo, rtol=1e-6)
