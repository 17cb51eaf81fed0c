"""Render configuration.

The reference keeps all of this in a SolidJS reactive store
(``store.ts:46-102``) and delivers values to the GPU through two channels:

* baked into WGSL source as compile-time constants — changing one recompiles
  the pipeline (``gpu.ts:512-525``), and
* uniform buffers for cheap per-frame values (view matrices, seed, counter,
  jitter — ``render.ts:57-85``).

The JAX equivalent of that split is *static vs traced* ``jit``
arguments: :class:`RenderSettings` is a frozen, hashable dataclass passed as
a static argument (a change triggers an XLA retrace — the analog of a WGSL
pipeline recompile), while per-frame state (view matrix, RNG seed, counter,
jitter, accumulation buffers) flows through as traced arrays
(:mod:`webgpu_raytracing_tpu.renderer`).
"""

from __future__ import annotations

import dataclasses
import enum
import math


class ShadingType(enum.IntEnum):
    """store.ts:7-10."""

    FLAT = 0
    PHONG = 1


class ProjectionType(enum.IntEnum):
    """store.ts:12-17."""

    FISHEYE = 0
    PANINI = 1
    PERSPECTIVE = 2
    ORTHOGRAPHIC = 3


class FovOrientation(enum.IntEnum):
    """store.ts:19-23."""

    HORIZONTAL = 0
    VERTICAL = 1
    DIAGONAL = 2


class LensShape(enum.IntEnum):
    """store.ts:25-28."""

    CIRCLE = 0
    SQUARE = 1


class Tonemapping(enum.IntEnum):
    """store.ts:30-36."""

    REINHARD = 0
    FILMIC = 1
    ACES = 2
    LOTTES = 3
    NONE = 4


class BlitView(enum.Enum):
    """store.ts:38-44."""

    IMAGE = "image"
    PREV_IMAGE = "prevImage"
    DEPTH = "depth"
    PREV_DEPTH = "prevDepth"
    DEPTH_DELTA = "depthDelta"
    NORMALS = "normals"


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static (retrace-on-change) render settings.

    Field defaults mirror the reference store defaults (store.ts:46-102).
    Anything here is baked into the compiled kernel, exactly like the
    reference bakes these into WGSL source (e.g. ``maxBounces``
    render.ts:1166, projection switch render.ts:705-722).
    """

    # image
    width: int = 640
    height: int = 480
    # Render-resolution scale (store.ts:76, UI.tsx:184): the reference
    # scales the canvas backing store (render.ts:109-113) so the whole
    # pipeline renders at width*scale x height*scale and the fullscreen
    # blit stretches to the display size; here the accumulation/G-buffers
    # are allocated at the scaled size and blit() bilinear-upscales.
    resolution_scale: float = 1.0
    # G-buffer allocation multiplier (store.ts:77, render.ts:141-144).
    # In the reference this scales only the geometry BUFFER SIZE while
    # the kernel indexes it with the full-resolution imageIdx: > 1 pads
    # the allocation with rows that are never read; < 1 under-allocates,
    # and WebGPU robust buffer access turns the out-of-range accesses
    # into dropped writes / zero reads. Mirrored here: the G-buffer gets
    # round(scale x render_height) rows; rows beyond it behave as
    # "no data" (face -1 / position 0) for the predictor and
    # reprojection, exactly the robust-access result.
    geometry_buffer_scale: float = 1.0
    # BVH build knobs (store.ts:82-85, defaults 16/2). STORE PARITY
    # ONLY: the reference code consuming them is commented out
    # (bv.ts:121-129) — its build always splits to <= 2-face leaves
    # regardless, and so does models/bvh.py. Carried so a store.ts user
    # finds every field; changing them changes nothing, exactly like
    # the reference.
    bvh_max_depth: int = 16
    bvh_leaf_soft_max_size: int = 2

    @property
    def render_width(self) -> int:
        return max(1, round(self.width * self.resolution_scale))

    @property
    def render_height(self) -> int:
        return max(1, round(self.height * self.resolution_scale))

    @property
    def geo_height(self) -> int:
        """Allocated G-buffer rows (render.ts:144; capped at the render
        height — extra allocation is never read, matching the
        reference's unused padding)."""
        return max(
            1,
            min(
                round(self.render_height * self.geometry_buffer_scale),
                self.render_height,
            ),
        )

    # sampling (store.ts:54-58). Each frame traces 1 + sample_count camera
    # samples per pixel (render.ts:1464-1495).
    sample_count: int = 1
    bounces_depth: int = 4
    samples_per_point: int = 1
    # store.ts:57 ships this but no WGSL ever reads it — kept for store
    # parity, unused here too
    samples_per_bounce: int = 1

    # camera model (store.ts:59-71). Baked constants in the reference
    # megakernel (render.ts:642-651).
    fov: float = math.pi * 2 / 3
    fov_orientation: FovOrientation = FovOrientation.HORIZONTAL
    focus_distance: float = 4.0
    circle_of_confusion: float = 0.0
    panini_distance: float = 1.0
    vertical_compression: float = 0.0
    projection_type: ProjectionType = ProjectionType.PANINI
    lens_shape: LensShape = LensShape.CIRCLE

    # shading / display
    shading_type: ShadingType = ShadingType.PHONG
    tonemapping: Tonemapping = Tonemapping.NONE
    exposure: float = 2.0
    gamma: float = 1.0
    ambience: float = 0.1
    blit_view: BlitView = BlitView.IMAGE

    # temporal reprojection (store.ts:73-77)
    reprojection_rate: int = 0
    jitter_strength: float = 0.0
    bilateral_filter: bool = False

    # debug (store.ts:87-90)
    debug_bvh: bool = False
    debug_reprojection: bool = False

    # --- extensions beyond the reference ---
    # Quad hit-distance predictor (pixelHitDist, render.ts:1121-1141).
    # Always on in the reference (a SIMT optimization: quad-shared prev
    # hits bound the primary ray's t_max); image-neutral by construction
    # (it only prunes beyond the known closest hit). Off by default: it
    # adds a prev-quad re-test pass per frame; the feature stays for
    # reference-semantics runs.
    use_hit_predictor: bool = False
    # Traversal backend: "auto" = the Triton tile kernel on a GPU
    # (ops/cluster_triton.py) and XLA clustered tracing elsewhere;
    # "triton" = the kernel (GPU only — an error elsewhere); "clustered"
    # = XLA dense cluster tracing (ops/cluster_trace.py); "threaded" =
    # stackless skip-link walk (ops/traverse.py, the reference oracle).
    traversal: str = "auto"
    # Rays per traversal tile (coherent pixel groups; a power of two for
    # the kernel): one kernel program, or one row of the XLA round loop.
    trace_tile: int = 64
    # Big-frame slab decomposition (renderer.render_frame_slabs): render
    # the frame as this many horizontal slabs, one jitted render_tile
    # call each, so wavefront temporaries scale with the slab rather than
    # the frame. Bit-identical to the single-tile frame (global row0
    # pixel indexing — the multi-chip slab contract). Requires
    # geometry_buffer_scale == 1 when > 1. The 1M-triangle 4K frame needs
    # none on an 80 GB card (peak 25.5 GB in one slab, PERF.md).
    frame_slabs: int = 1
    # Dead-lane slicing of sorted bounce legs (ops/ray_sort.sorted_trace
    # live_slice): rays with no entered cluster — RR kills, prior
    # misses, lines that exit the scene — key to the back of the ray
    # sort and their answer is already known (t_max, miss). The trace
    # runs on a static live prefix (3/4 of the rays at bounce segment 1,
    # 1/2 after; 3/8 and 1/4 for shadow legs), with a lax.cond
    # full-width fallback on overflow — exact either way.
    live_slice: bool = True
    # Env-NEE depth limit (config #3, ops/integrator.py): 0 = every path
    # vertex next-event-samples the environment (the full-MIS default);
    # K > 0 = only the first K vertices do, deeper vertices keep BSDF
    # sampling with MIS weight 1 (unbiased — each vertex's strategy mix
    # is independent). Each env-NEE vertex costs one UNBOUNDED any-hit
    # leg (the environment has no shadow distance); the variance
    # reduction it buys concentrates at the first vertices, where
    # throughput is largest.
    env_nee_depth: int = 0
    # Sort bounce/shadow rays by nearest hit cluster before tracing
    # (ops/ray_sort.py): shrinks each tile's cluster set on incoherent
    # segments and compacts dead lanes to the back (the wavefront-
    # compaction analog, BASELINE config #5). Camera rays are never
    # sorted (already coherent).
    sort_bounce_rays: bool = True
    # Chain the sort across the whole path segment (ops/integrator.py):
    # instead of sort -> trace -> unsort around each traversal, the FULL
    # per-lane wavefront state (ray, RNG, throughput, color, env carry)
    # is permuted once per segment and every downstream op runs in
    # sorted order; original order is restored by ONE final scatter.
    # Bit-identical results (per-ray math is lane-order-independent;
    # tests/test_chained_sort.py). Off by default; its cost on the GPU
    # is not measured yet.
    chained_sort: bool = False
    # Next-event estimation. The reference ships the NEE chain
    # (``pointColor``/``sampleLights`` render.ts:1143-1157, 849-869) but
    # never calls it from the megakernel main; default off for parity.
    next_event_estimation: bool = False
    # Environment source: "equirect" (reference scene.ts:348-368),
    # "cubemap" (new capability, BASELINE config #2), or "procedural"
    # (fallback when no environment asset is present).
    environment: str = "procedural"
    # Luminance importance sampling of the equirect environment with MIS
    # (new capability, BASELINE config #3). Requires environment="equirect"
    # and env_data passed as an EnvDistribution.
    env_importance_sampling: bool = False

    @property
    def reproject(self) -> bool:
        """const _reproject (render.ts:1406)."""
        return self.reprojection_rate > 0

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


# WGSL shader constants (shaders/constants.ts:1-15).
PHI = 1.61803398874989484820459
SRT = 1.41421356237309504880169
PI = 3.14159265358979323846264
E = 2.71828182845904523536028
TWO_PI = 6.28318530717958647692528
INV_PI = 0.31830988618379067153776
EPSILON = 0.001
F32_MIN = 2.0**-126
F32_MAX = 3.4028234663852886e38
MIN_DIST = 0.0
MAX_DIST = F32_MAX
