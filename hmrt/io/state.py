"""Scene/camera persistence (SURVEY.md section 5, checkpoint/resume).

The reference has no training state; its nearest analogs are scene/camera
persistence and saved renders. Here: Camera/Light/RenderConfig serialize to
JSON, the heightmap (+ albedo) to npz, so flythrough benchmarks can resume
mid-script and scenes round-trip between sessions.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from hmrt.config import RenderConfig
from hmrt.types import Camera, Light


def save_state(path: str, *, scene=None, camera: Camera | None = None,
               light: Light | None = None, config: RenderConfig | None = None,
               frame_index: int | None = None) -> None:
    """Write <path>.json (+ <path>.npz when scene arrays are given)."""
    doc = {}
    if camera is not None:
        doc["camera"] = {
            "eye": np.asarray(camera.eye).tolist(),
            "target": np.asarray(camera.target).tolist(),
            "up": np.asarray(camera.up).tolist(),
            "fov_y": float(np.asarray(camera.fov_y)),
        }
    if light is not None:
        doc["light"] = {k: np.asarray(getattr(light, k)).tolist()
                        for k in ("sun_dir", "sun_color", "sky_top",
                                  "sky_horizon", "fog_color")}
    if config is not None:
        doc["config"] = dataclasses.asdict(config)
    if frame_index is not None:
        doc["frame_index"] = frame_index
    arrays = {}
    if scene is not None:
        arrays["heights"] = np.asarray(scene.heights)
        if scene.albedo is not None:
            n = scene.n
            arrays["albedo"] = (np.asarray(scene.albedo).T
                                .reshape(n, n, 3))
        doc["scene_npz"] = os.path.basename(path) + ".npz"
    with open(path + ".json", "w") as f:
        json.dump(doc, f, indent=1)
    if arrays:
        np.savez_compressed(path + ".npz", **arrays)


def load_state(path: str):
    """Read state written by save_state; returns a dict with any of
    'scene', 'camera', 'light', 'config', 'frame_index'."""
    with open(path + ".json") as f:
        doc = json.load(f)
    out = {}
    if "camera" in doc:
        c = doc["camera"]
        cam = Camera.create(eye=c["eye"], target=c["target"], up=c["up"])
        import jax.numpy as jnp
        cam = Camera(eye=cam.eye, target=cam.target, up=cam.up,
                     fov_y=jnp.asarray(c["fov_y"], jnp.float32))
        out["camera"] = cam
    if "light" in doc:
        li = doc["light"]
        out["light"] = Light.create(sun_dir=li["sun_dir"],
                                    sun_color=li["sun_color"],
                                    sky_top=li["sky_top"],
                                    sky_horizon=li["sky_horizon"],
                                    fog_color=li["fog_color"])
    if "config" in doc:
        out["config"] = RenderConfig(**doc["config"])
    if "frame_index" in doc:
        out["frame_index"] = doc["frame_index"]
    if "scene_npz" in doc:
        from hmrt.api.scene import make_scene
        npz_path = os.path.join(os.path.dirname(path) or ".",
                                doc["scene_npz"])
        with np.load(npz_path) as z:
            heights = z["heights"]
            albedo = z["albedo"] if "albedo" in z.files else None
        out["scene"] = make_scene(heights, albedo=albedo,
                                  light=out.get("light"))
    return out
