"""Shadow-terminator any-hit check.

A shadow ray toward a light at distance t_max must see every occluder
strictly inside (0, t_max), however close to the light it sits
(reference semantics: rayIntersectBVHAnyHit with interval (0, t_max),
render.ts:468-480). The Triton kernel tests triangles with exact f32
Möller–Trumbore and compares ``t < t_max`` on the f32 value itself, so
its decisions at the light's distance must equal the threaded oracle's
bit for bit — no acceptance window is lost to key packing.
"""

import numpy as np
import jax.numpy as jnp

from webgpu_raytracing_tpu.models.scene import scene_from_facesets
from webgpu_raytracing_tpu.models.test_models import ground_plane, make_model
from webgpu_raytracing_tpu.ops.cluster_triton import trace_any_triton
from webgpu_raytracing_tpu.ops.traverse import trace_any


def _occluder_quad(z: float, half: float = 4.0):
    """Two-triangle quad in the z=const plane, facing +z (single-sided:
    rays travelling -z hit the front face)."""
    v = np.array(
        [
            [-half, -half, z],
            [half, -half, z],
            [half, half, z],
            [-half, half, z],
        ],
        np.float32,
    )
    # winding chosen so Möller–Trumbore backface culling keeps -z rays
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return make_model(v, idx)


def _shadow_scene(z_occluder: float):
    return scene_from_facesets(
        [
            ("occluder", _occluder_quad(z_occluder)),
            ("floor", ground_plane(-6.0, 8.0)),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )


def _shadow_rays(rng_np, n=256, t_light=2.0):
    """Rays from a z=0 grid straight down -z toward a light at z=-t_light."""
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng_np.uniform(-2, 2, n)
    o[:, 1] = rng_np.uniform(-2, 2, n)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    tmax = np.full((n,), t_light, np.float32)
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)


def _kernel_occluded(o, d, tmax, tables, tile):
    return np.asarray(
        trace_any_triton(o, d, tmax, tables, tile=tile, interpret=True)
    )


def test_occluder_inside_light_distance_always_occludes(rng_np):
    """Occluders at 0.5x, 0.999x and 1-1e-4 of the light distance must
    occlude every shadow ray on the kernel, at two tile sizes."""
    t_light = 2.0
    for frac in (0.5, 0.999, 1.0 - 1e-4):
        scene = _shadow_scene(-frac * t_light)
        tables = scene.tables()
        o, d, tmax = _shadow_rays(rng_np, t_light=t_light)
        ref = np.asarray(trace_any(o, d, tmax, tables))
        assert ref.all(), "oracle sanity: every ray passes the occluder"
        for tile in (64, 128):
            got = _kernel_occluded(o, d, tmax, tables, tile)
            np.testing.assert_array_equal(got, ref), (frac, tile)


def test_knife_edge_leak_confined_to_truncation_bucket(rng_np):
    """An occluder 2^-18 relative inside the light distance — the knife
    edge a packed-key kernel could lose — and one exactly at it: the
    kernel's blocked set must equal the oracle's in both cases (the
    leak window is empty)."""
    t_light = 2.0
    for frac in (1.0 - 2.0**-18, 1.0):
        scene = _shadow_scene(-frac * t_light)
        tables = scene.tables()
        o, d, tmax = _shadow_rays(rng_np, t_light=t_light)
        ref = np.asarray(trace_any(o, d, tmax, tables))
        got = _kernel_occluded(o, d, tmax, tables, 64)
        np.testing.assert_array_equal(got, ref)
