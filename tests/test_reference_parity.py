"""Cross-implementation parity: the framework vs the WGSL-semantics
simulator (validation/wgsl_sim.py — a scalar transliteration of the
reference megakernel, render.ts:1434-1509).

Two layers of evidence:

* a LIVE 12x12 run of the simulator against the framework's renderer on
  the bundled scene (same seeds, equal spp) — RMSE must beat the
  north-star bar of 1e-2 (BASELINE.md);
* the checked-in 48x48 golden (tools/make_reference_golden.py) against
  the renderer, same bar, more pixels.
"""

import os

import numpy as np
import pytest

from webgpu_raytracing_tpu.camera import Camera
from webgpu_raytracing_tpu.config import RenderSettings
from webgpu_raytracing_tpu.models.scene import load_scene
from webgpu_raytracing_tpu.renderer import Renderer
from webgpu_raytracing_tpu.utils.paths import ASSETS_DIR
from webgpu_raytracing_tpu.validation.envs import synthetic_equirect


OBJ = os.path.join(ASSETS_DIR, "raytraced-scene.obj")
MTL = os.path.join(ASSETS_DIR, "raytraced-scene.mtl")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "wgsl_reference_48x48.npz")


needs_assets = pytest.mark.skipif(
    not os.path.exists(OBJ), reason="bundled scene assets not in the checkout"
)
GOLDEN_ANALYTIC = os.path.join(
    os.path.dirname(__file__), "golden", "wgsl_analytic_48x48.npz"
)


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


# Bit-identity claims vs the scalar WGSL simulator pin chained_sort=False:
# chained segment sorting is PROVEN a pure per-lane reordering at the
# integrator level (tests/test_chained_sort.py, exact equality), but a
# different compiled frame graph lets XLA make different fusion/FMA
# choices in the unprotected parts of the color chain — ~1-ulp noise on a
# few % of pixels. These tests establish SEMANTIC equivalence with the
# reference, so they run the fusion-stable configuration; the production
# path's closeness is separately bounded by the RMSE assertions (which
# 1-ulp noise cannot move) and by chip_smoke.py's wgsl_parity phase on
# the GPU.
_PIN = {"chained_sort": False}


def _render_repo(size, seeds, env):
    settings = RenderSettings(
        width=size, height=size, environment="equirect",
        sample_count=1, bounces_depth=4, **_PIN,
    )
    scene = load_scene(OBJ, MTL)
    r = Renderer(scene, settings, env_data=env)
    for seed in seeds:
        r.step(seed=seed)
    return np.asarray(r.buffers.image)


def _normalized(img):
    return img[..., :3] / np.maximum(img[..., 3:4], 1e-20)


@pytest.fixture(scope="module")
def env():
    return synthetic_equirect()


@needs_assets
def test_live_sim_vs_renderer_rmse(env):
    from webgpu_raytracing_tpu.validation.wgsl_sim import WGSLReference

    size, seeds = 12, [777]
    settings = RenderSettings(
        width=size, height=size, environment="equirect",
        sample_count=1, bounces_depth=4, **_PIN,
    )
    scene = load_scene(OBJ, MTL)
    sim = WGSLReference(scene, settings, env)
    sim.step(seeds[0], Camera().view_matrix())

    ours = _render_repo(size, seeds, env)
    # equal spp per pixel by construction
    np.testing.assert_array_equal(ours[..., 3], sim.image[..., 3])
    rmse = _rmse(_normalized(ours), _normalized(sim.image))
    assert rmse <= 1e-2, f"cross-implementation RMSE {rmse}"


@needs_assets
@pytest.mark.parametrize(
    "mode",
    [
        {"projection_type": "PERSPECTIVE"},
        {"projection_type": "FISHEYE"},
        {"projection_type": "ORTHOGRAPHIC"},
        {"circle_of_confusion": 0.15, "focus_distance": 3.0},
        {"shading_type": "FLAT"},
        {"fov_orientation": "VERTICAL"},
    ],
    ids=["pinhole", "fisheye", "ortho", "thin-lens", "flat", "fov-vert"],
)
def test_live_sim_vs_renderer_rmse_modes(env, mode):
    """Cross-implementation parity beyond the default camera: each
    projection (render.ts:653-729) and the thin-lens DoF path
    (render.ts:695-702, 740-747) against the WGSL-semantics simulator."""
    from webgpu_raytracing_tpu.config import ProjectionType
    from webgpu_raytracing_tpu.validation.wgsl_sim import WGSLReference

    from webgpu_raytracing_tpu.config import FovOrientation, ShadingType

    kw = dict(mode)
    if "projection_type" in kw:
        kw["projection_type"] = ProjectionType[kw["projection_type"]]
    if "shading_type" in kw:
        kw["shading_type"] = ShadingType[kw["shading_type"]]
    if "fov_orientation" in kw:
        kw["fov_orientation"] = FovOrientation[kw["fov_orientation"]]
    size, seeds = 12, [4242 + 17 * k for k in range(4)]
    settings = RenderSettings(
        width=size, height=size, environment="equirect",
        sample_count=1, bounces_depth=4, **_PIN, **kw,
    )
    scene = load_scene(OBJ, MTL)
    sim = WGSLReference(scene, settings, env)
    r = Renderer(scene, settings, env_data=env)
    for seed in seeds:
        sim.step(seed, Camera().view_matrix())
        r.step(seed=seed)
    ours = np.asarray(r.buffers.image)
    np.testing.assert_array_equal(ours[..., 3], sim.image[..., 3])
    # Primary rays go through unjittered pixel centers in BOTH
    # implementations (render.ts:1464), so a silhouette-edge center whose
    # f32 intersection decision flips between the two repeats its flip
    # every frame and never averages out — on a 144-pixel crop one such
    # pixel alone breaks a global-RMSE bar that the 48x48 golden meets.
    # The honest per-mode assertion is the isolation claim itself:
    # decision flips hit at most ~1% of pixels, and everywhere else the
    # two implementations accumulate bit-identically.
    diff = (
        np.abs(_normalized(ours) - _normalized(sim.image)).max(axis=-1)
        > 1e-5
    )
    assert diff.mean() <= 0.02, f"{mode}: {diff.sum()} differing pixels"
    np.testing.assert_array_equal(
        np.asarray(ours)[~diff], sim.image[~diff],
        err_msg=f"{mode}: non-edge pixels must accumulate bit-identically",
    )


@needs_assets
def test_golden_vs_renderer_rmse(env):
    if not os.path.exists(GOLDEN):
        pytest.skip("golden not generated")
    z = np.load(GOLDEN)
    size = int(z["size"][0])
    ours = _render_repo(size, [int(s) for s in z["seeds"]], env)
    np.testing.assert_array_equal(ours[..., 3], z["image"][..., 3])
    rmse = _rmse(_normalized(ours), _normalized(z["image"]))
    assert rmse <= 1e-2, f"cross-implementation RMSE vs golden {rmse}"


@needs_assets
def test_golden_vs_real_kernel(env, interpreted_kernel):
    """The GPU traversal path (the Triton kernel, here under the Pallas
    interpreter) against the WGSL-semantics golden. The kernel decides
    intersections with exact f32 Möller–Trumbore in the reference's
    order, so the frame must match everywhere except isolated knife-edge
    flips."""
    if not os.path.exists(GOLDEN):
        pytest.skip("golden not generated")
    z = np.load(GOLDEN)
    size = int(z["size"][0])
    settings = RenderSettings(
        width=size, height=size, environment="equirect",
        sample_count=1, bounces_depth=4, traversal="triton",
        **_PIN,
    )
    scene = load_scene(OBJ, MTL)
    r = Renderer(scene, settings, env_data=env)
    for seed in z["seeds"]:
        r.step(seed=int(seed))
    ours = np.asarray(r.buffers.image)
    a, b = _normalized(ours), _normalized(z["image"])
    flipped = np.abs(a - b).max(axis=-1) > 1e-6
    mismatched = int(flipped.sum())
    rmse = _rmse(a, b)
    rmse_rest = _rmse(np.where(flipped[..., None], b, a), b)
    assert rmse_rest <= 1e-7 and mismatched <= 5 and rmse <= 1e-2, (
        f"kernel parity regression: rmse {rmse} (rest {rmse_rest}), "
        f"{mismatched}/{a.shape[0] * a.shape[1]} mismatched"
    )


@pytest.mark.parametrize("traversal", ["clustered", "threaded", "triton"])
def test_analytic_golden_vs_renderer(env, interpreted_kernel, traversal):
    """The seeded analytic scene (no asset files) at 48² against the WGSL
    simulator's golden (tools/make_reference_golden.py analytic), every
    traversal backend (the kernel under the interpreter): RMSE within
    the correctness clause, and on the CPU every pixel bit-identical."""
    from webgpu_raytracing_tpu.models.analytic import analytic_scene

    z = np.load(GOLDEN_ANALYTIC)
    size = int(z["size"][0])
    settings = RenderSettings(
        width=size, height=size, environment="equirect",
        sample_count=1, bounces_depth=4, traversal=traversal, **_PIN,
    )
    r = Renderer(analytic_scene(), settings, env_data=env)
    for seed in z["seeds"]:
        r.step(seed=int(seed))
    ours = np.asarray(r.buffers.image)
    np.testing.assert_array_equal(ours[..., 3], z["image"][..., 3])
    a, b = _normalized(ours), _normalized(z["image"])
    assert _rmse(a, b) <= 1e-2
    np.testing.assert_array_equal(a, b)
