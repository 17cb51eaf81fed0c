"""Chained segment sorting (RenderSettings.chained_sort).

Two claims, tested at the level where each is exact:

1. At the integrator level the chain is a PURE per-lane reordering:
   permuting the whole wavefront state per segment and scattering
   color/state back once gives BIT-IDENTICAL results to the per-trace
   sort/unsort path (per-lane math is lane-order-independent, per-ray
   trace results are grouping-independent).

2. At the compiled-frame level the two settings build different XLA
   graphs, so fusion/FMA choices in the unprotected parts of the color
   chain may differ by ~1 ulp on a few % of pixels — bounded here.
   Intersection decisions (G-buffer faces, sample counts) must still
   match exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webgpu_raytracing_tpu.config import F32_MAX, RenderSettings
from webgpu_raytracing_tpu.models.analytic import analytic_scene
from webgpu_raytracing_tpu.renderer import Renderer


@pytest.fixture(scope="module")
def scene():
    return analytic_scene()


def _path_trace_pair(scene, backend, **kw):
    from webgpu_raytracing_tpu.ops import rng
    from webgpu_raytracing_tpu.ops.integrator import path_trace
    from webgpu_raytracing_tpu.ops.raygen import camera_rays

    tables = scene.tables()
    w = h = 48
    r = w * h
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.int32),
        jnp.arange(w, dtype=jnp.int32),
        indexing="ij",
    )
    idx = (xs + ys * w).reshape(r)
    pos = jnp.stack([xs, ys], -1).reshape(r, 2).astype(jnp.float32)
    env = jnp.zeros((1, 1, 3), jnp.float32)
    base = RenderSettings(
        width=w, height=h, environment="procedural", traversal=backend,
        sample_count=1, bounces_depth=4, **kw,
    )

    @functools.partial(jax.jit, static_argnums=(4,))
    def run(o, d, tmax, st, settings):
        return path_trace(o, d, tmax, st, tables, env, settings)

    st = rng.seed_state(jnp.broadcast_to(jnp.uint32(11), (r,)), idx)
    o, d, st2 = camera_rays(pos, jnp.eye(4, dtype=jnp.float32), st, base)
    tmax = jnp.full((r,), F32_MAX, jnp.float32)
    out = []
    for chained in (False, True):
        res = run(o, d, tmax, st2, base.replace(chained_sort=chained))
        out.append(res)
    return out


def test_chained_is_pure_reordering_clustered(scene):
    a, b = _path_trace_pair(scene, "clustered")
    np.testing.assert_array_equal(np.asarray(a.color), np.asarray(b.color))
    np.testing.assert_array_equal(np.asarray(a.state), np.asarray(b.state))
    np.testing.assert_array_equal(
        np.asarray(a.first_hit.face), np.asarray(b.first_hit.face)
    )


def test_chained_is_pure_reordering_with_nee(scene):
    """NEE shadow rays ride the segment permutation with no sort leg of
    their own — still bit-identical at the integrator level."""
    a, b = _path_trace_pair(
        scene, "clustered", next_event_estimation=True
    )
    np.testing.assert_array_equal(np.asarray(a.color), np.asarray(b.color))
    np.testing.assert_array_equal(np.asarray(a.state), np.asarray(b.state))


def test_chained_is_pure_reordering_pallas(scene, interpreted_kernel):
    """The GPU path: the Triton kernel under the Pallas interpreter."""
    a, b = _path_trace_pair(scene, "triton")
    np.testing.assert_array_equal(np.asarray(a.color), np.asarray(b.color))
    np.testing.assert_array_equal(np.asarray(a.state), np.asarray(b.state))


def test_chained_frame_deviation_is_ulp_bounded(scene):
    """Full-frame (renderer-level) A/B: different compiled graphs, so XLA
    fusion noise up to ~1 ulp is allowed on the color — but intersection
    decisions and sample counts must match exactly, and the relative
    deviation must stay at float32-epsilon scale (NOT at decision-flip
    scale, which would be O(1))."""

    def frame(chained):
        s = RenderSettings(
            width=48, height=48, environment="procedural",
            sample_count=1, bounces_depth=4, traversal="clustered",
            chained_sort=chained,
        )
        r = Renderer(scene, s, base_seed=11)
        for _ in range(2):
            r.step()
        return np.asarray(r.buffers.image), np.asarray(r.buffers.geo_face)

    (a, gfa), (b, gfb) = frame(False), frame(True)
    np.testing.assert_array_equal(gfa, gfb)
    np.testing.assert_array_equal(a[..., 3], b[..., 3])
    rel = np.abs(a[..., :3] - b[..., :3]) / np.maximum(
        np.abs(a[..., :3]), 1e-3
    )
    assert rel.max() < 1e-6, f"max rel deviation {rel.max()} exceeds ulp scale"
