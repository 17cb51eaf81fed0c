"""webgpu_raytracing_tpu — a progressive Monte Carlo path tracer in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the WebGPU
reference renderer (gidra5/webgpu-raytracing). The reference is a browser
WGSL megakernel; this framework is built as array programs instead:

* Scene geometry lives in SoA ``jnp`` arrays (faces as ``p0, e1, e2`` edge
  vectors, mirroring reference ``scene.ts:144-163``).
* BVH traversal is *stackless*: the per-model preorder median-split trees
  (reference ``bv.ts``) are threaded with skip ("miss") links at build time
  so device traversal is one uniform ``while`` loop over a vector of rays —
  no divergent per-thread stacks (reference ``render.ts:433-640``).
* The integrator is a wavefront: a fixed unroll of
  trace → shade → bounce steps over large ray batches, with masked lanes
  instead of data-dependent control flow (reference ``render.ts:1120-1225``).
* Progressive accumulation state is an explicit, donated pytree
  (reference ``render.ts:1454-1507`` clear/accumulate semantics).
* Multi-device scaling shards the pixel dimension over a ``jax.sharding.Mesh``
  with the scene replicated (embarrassingly parallel; collectives only to
  assemble the final frame).
"""

__version__ = "0.1.0"

from .config import (
    BlitView,
    FovOrientation,
    LensShape,
    ProjectionType,
    RenderSettings,
    ShadingType,
    Tonemapping,
)

_LAZY = {
    "Camera": ("webgpu_raytracing_tpu.camera", "Camera"),
    "Controls": ("webgpu_raytracing_tpu.camera", "Controls"),
    "orbit_path": ("webgpu_raytracing_tpu.camera", "orbit_path"),
    "Scene": ("webgpu_raytracing_tpu.models.scene", "Scene"),
    "load_scene": ("webgpu_raytracing_tpu.models.scene", "load_scene"),
    "scene_from_facesets": (
        "webgpu_raytracing_tpu.models.scene", "scene_from_facesets"
    ),
    "FrameBuffers": ("webgpu_raytracing_tpu.renderer", "FrameBuffers"),
    "FrameInputs": ("webgpu_raytracing_tpu.renderer", "FrameInputs"),
    "Renderer": ("webgpu_raytracing_tpu.renderer", "Renderer"),
    "render_frame": ("webgpu_raytracing_tpu.renderer", "render_frame"),
}


def __getattr__(name):  # PEP 562 — keep `import webgpu_raytracing_tpu`
    # (and CLI --help / compare) free of the multi-second jax startup
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)


__all__ = [
    "Renderer",
    "render_frame",
    "FrameBuffers",
    "FrameInputs",
    "Scene",
    "load_scene",
    "scene_from_facesets",
    "Camera",
    "Controls",
    "orbit_path",
    "RenderSettings",
    "ShadingType",
    "ProjectionType",
    "FovOrientation",
    "LensShape",
    "Tonemapping",
    "BlitView",
]
