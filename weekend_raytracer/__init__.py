"""weekend_raytracer — a progressive path-tracing framework for GPUs.

A brand-new JAX/XLA/Pallas rebuild of the capabilities of the Rust+wgpu
reference ``linuxing3/weekend-raytracer-wgpu`` (see SURVEY.md): progressive
Monte-Carlo path tracing of sphere scenes with lambertian / metal /
dielectric / checkerboard materials, image + solid textures, a thin-lens
fly camera with defocus blur, an analytic daylight sky in the reference's
Hosek-Wilkie 9-parameter form, per-frame sample accumulation with
parameter-change reset, and Uncharted2 tonemapping — re-architected as a
batched wavefront tracer with SoA device state, counter-based RNG, a fused
Pallas (Triton) GPU kernel, and mesh-sharded multi-device rendering.
"""

from .models.angle import Angle
from .models.camera import Camera, CameraBasis
from .models.materials import Material, MaterialTable
from .models.params import RenderParams, RenderParamsValidationError, SamplingParams
from .models.scenes import SCENES, SceneDesc
from .models.sky import SkyParams, SkyState, to_sky_state
from .models.spheres import Sphere, SphereSoA
from .models.textures import Texture, TexturePool
from .ops.tracer import Scene, render_image, render_pixels, trace_paths
from .renderer import (
    CheckpointMismatchError,
    Renderer,
    RenderProgress,
    RenderStats,
)

__version__ = "0.1.0"

__all__ = [
    "CheckpointMismatchError",
    "Angle",
    "Camera",
    "CameraBasis",
    "Material",
    "MaterialTable",
    "RenderParams",
    "RenderParamsValidationError",
    "Renderer",
    "RenderProgress",
    "RenderStats",
    "SamplingParams",
    "SCENES",
    "Scene",
    "SceneDesc",
    "SkyParams",
    "SkyState",
    "Sphere",
    "SphereSoA",
    "Texture",
    "TexturePool",
    "render_image",
    "render_pixels",
    "to_sky_state",
    "trace_paths",
]
