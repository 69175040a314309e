"""hmrt — heightmap raytracer in JAX.

A rebuild of the capability surface of jeanfilho/GPU-Heightmap-Raytracer
(single-GPU CUDA heightfield renderer; see SURVEY.md for the layer map and
BASELINE.json for the pinned feature set): camera -> 2D DDA /
maximum-mipmap march -> shading, as XLA programs with a Pallas-Triton march
kernel on NVIDIA GPUs, scaling over a device mesh by framebuffer sharding
with the pyramid replicated.
"""

from hmrt.api.scene import make_scene
from hmrt.config import RenderConfig
from hmrt.core.pyramid import build_pyramid_flat
from hmrt.core.renderer import render_frame
from hmrt.io.heightmap import load_heightmap, procedural_terrain
from hmrt.types import Camera, Frame, Light, Scene

__version__ = "0.1.0"

__all__ = [
    "Camera", "Frame", "Light", "RenderConfig", "Scene",
    "build_pyramid_flat", "load_heightmap", "make_scene",
    "procedural_terrain", "render_frame",
]
