"""weekend_raytracer_tpu_torch — the PyTorch/CUDA port of weekend_raytracer_tpu.

Progressive Monte-Carlo path tracing of sphere scenes, with the JAX
package's scene and parameter model, its progressive ``Renderer``, and its
kernel backends rewritten as hand-written CUDA kernels for NVIDIA Hopper:
the fused megakernel (csrc/megakernel.cu), the lane-regrouped wavefront
(csrc/regroup.cu, ops/cuda/regroup.py) and the row-compacted wavefront
(csrc/wavefront.cu, ops/cuda/wavefront.py), which share one per-ray body
(csrc/bounce.cuh), and the JAX package's XLA tracer in plain PyTorch
(ops/tracer.py, the ``"xla"`` backend). It imports torch, numpy and scipy,
never jax. The public names are the JAX package's, for the parts that exist
so far.
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
    GpuSamplingParams,
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
    "GpuSamplingParams",
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
