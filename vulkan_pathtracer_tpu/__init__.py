"""vulkan_pathtracer_tpu — a JAX wavefront path tracer.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``antlilja/vulkan-pathtracer`` reference (Zig + Vulkan KHR ray tracing +
GLSL).  Everything the Vulkan *driver* did implicitly for the reference
(BVH build, traversal, ray-triangle intersection, texture sampling) is
first-class code here; everything the reference did explicitly (glTF
contract, material math, BRDF sampling, RNG, camera, CLI semantics) is
reproduced with the same numeric semantics.

Layer map (mirrors SURVEY.md §1):

- ``ops``      — device math kernels: RNG, BRDF, intersection, BVH,
                 texture sampling, the GPU traversal kernel (JAX +
                 Pallas).
- ``models``   — scene/asset model: glTF loader, materials, textures,
                 camera, flattened device scene (SoA arrays).
- ``render``   — the compiled render pipeline: wavefront bounce loop,
                 progressive accumulation, unorm8 output.
- ``parallel`` — device mesh + shard_map framebuffer tiling, collectives.
- ``utils``    — CLI, timer, stats/metrics, PNG IO, config.
- ``app``      — headless driver loop and camera-path playback.
"""

__version__ = "0.1.0"

from vulkan_pathtracer_tpu.utils.config import RenderConfig  # noqa: F401

# Lazy top-level API (PEP 562): the primary objects a framework user
# needs, without importing jax at package-import time.
_LAZY = {
    "Camera": ("vulkan_pathtracer_tpu.models.camera", "Camera"),
    "load_scene": ("vulkan_pathtracer_tpu.models.gltf", "load"),
    "build_device_scene": (
        "vulkan_pathtracer_tpu.models.device_scene", "build_device_scene"),
    "build_instanced_scene": (
        "vulkan_pathtracer_tpu.models.instanced_scene",
        "build_instanced_scene"),
    "RenderPipeline": (
        "vulkan_pathtracer_tpu.render.pipeline", "RenderPipeline"),
    "Accumulator": ("vulkan_pathtracer_tpu.render.output", "Accumulator"),
    "make_render_mesh": (
        "vulkan_pathtracer_tpu.parallel.mesh", "make_render_mesh"),
}

__all__ = ["RenderConfig", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
