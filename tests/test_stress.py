"""Scalability tests (BASELINE config #5 machinery) — a few hundred
thousand triangles in CI; the full 1M run is scripts-level."""

import time

import numpy as np
import pytest
import jax.numpy as jnp

from webgpu_raytracing_tpu.config import F32_MAX, RenderSettings
from webgpu_raytracing_tpu.models.stress import stress_scene
from webgpu_raytracing_tpu.ops.cluster_trace import trace_closest_clustered
from webgpu_raytracing_tpu.ops.traverse import trace_closest


@pytest.mark.slow
def test_stress_scene_builds_and_traces():
    t0 = time.time()
    scene = stress_scene(200_000)
    total = sum(len(m.faces) for m in scene.models)
    assert total > 150_000
    tables = scene.tables()
    build_s = time.time() - t0
    assert build_s < 120, build_s

    rng = np.random.default_rng(0)
    n = 256
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(3, 8, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])  # look down at the sphere field
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = jnp.full((n,), F32_MAX, jnp.float32)

    ref = trace_closest(jnp.asarray(o), jnp.asarray(d), tmax, tables)
    cl = trace_closest_clustered(
        jnp.asarray(o), jnp.asarray(d), tmax, tables, tile=128
    )
    hits = np.asarray(ref.face) >= 0
    assert hits.sum() > 100
    np.testing.assert_array_equal(np.asarray(cl.face) >= 0, hits)
    np.testing.assert_allclose(
        np.asarray(cl.t)[hits], np.asarray(ref.t)[hits], rtol=5e-4,
        atol=1e-4,
    )


@pytest.mark.slow
def test_pallas_hbm_path_for_large_scenes(rng_np):
    """A cluster table of tens of MB (the size class that once needed a
    streaming kernel): the Triton kernel reads it from device memory like
    any other and must agree with the threaded oracle."""
    from webgpu_raytracing_tpu.ops.cluster_triton import (
        trace_clustered_triton,
    )

    scene = stress_scene(60_000)
    tables = scene.tables()
    assert tables.clusters.mat_b.nbytes > 12 * 1024 * 1024

    n = 256
    o = rng_np.uniform(-10, 10, (n, 3)).astype(np.float32)
    o[:, 1] = rng_np.uniform(3, 8, n)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = jnp.full((n,), F32_MAX, jnp.float32)
    ref = trace_closest(jnp.asarray(o), jnp.asarray(d), tmax, tables)
    pk = trace_clustered_triton(
        jnp.asarray(o), jnp.asarray(d), tmax, tables, tile=64,
        interpret=True,
    )
    hits = np.asarray(ref.face) >= 0
    assert hits.sum() > 50
    np.testing.assert_array_equal(np.asarray(pk.face), np.asarray(ref.face))
    np.testing.assert_array_equal(np.asarray(pk.t), np.asarray(ref.t))


@pytest.mark.slow
def test_pallas_hbm_any_hit(rng_np):
    """Any-hit on the same large table: the shadow-ray termination rule
    must agree with the threaded oracle."""
    from webgpu_raytracing_tpu.ops.cluster_triton import trace_any_triton
    from webgpu_raytracing_tpu.ops.traverse import trace_any

    scene = stress_scene(60_000)
    tables = scene.tables()
    n = 256
    o = rng_np.uniform(-10, 10, (n, 3)).astype(np.float32)
    o[:, 1] = rng_np.uniform(3, 8, n)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for tmax_val in (F32_MAX, 6.0):
        tmax = jnp.full((n,), tmax_val, jnp.float32)
        ref = trace_any(jnp.asarray(o), jnp.asarray(d), tmax, tables)
        pk = trace_any_triton(
            jnp.asarray(o), jnp.asarray(d), tmax, tables, tile=64,
            interpret=True,
        )
        np.testing.assert_array_equal(np.asarray(pk), np.asarray(ref))
