"""Two-level (supercluster) tables: builder invariants + interpret-mode
kernel equivalence with the threaded oracle (the large-scene path,
BASELINE config #5; no reference counterpart — render.ts has no TLAS)."""

import numpy as np
import pytest
import jax.numpy as jnp

from webgpu_raytracing_tpu.config import F32_MAX
from webgpu_raytracing_tpu.models.cluster import build_clusters
from webgpu_raytracing_tpu.models.scene import scene_from_facesets
from webgpu_raytracing_tpu.models.test_models import (
    ground_plane,
    unit_cube_model,
    uv_sphere,
)
from webgpu_raytracing_tpu.ops.cluster_triton import trace_clustered_triton
from webgpu_raytracing_tpu.ops.traverse import trace_any, trace_closest


def _scene():
    return scene_from_facesets(
        [
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", ground_plane(-1.5, 8.0)),
            ("cube", unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )


@pytest.fixture
def rng_np():
    return np.random.default_rng(7)


def test_grouped_builder_invariants():
    scene = _scene()
    g = 4
    cl = build_clusters(scene.models, cluster_size=16, group_size=g)
    assert cl.group == g
    assert cl.n_clusters % g == 0
    c2 = cl.n_clusters // g
    assert cl.super_box.shape == (c2, 6)
    # every face appears exactly once (pads carry -1)
    fid = cl.face_id[cl.face_id >= 0]
    assert len(np.unique(fid)) == sum(len(m.faces) for m in scene.models)
    grp = cl.box.reshape(c2, g, 6)
    real = cl.face_id.reshape(c2, g, -1).max(axis=2) >= 0  # (C2, g)
    for s in range(c2):
        for j in range(g):
            if real[s, j]:
                assert np.all(cl.super_box[s, 0:3] <= grp[s, j, 0:3])
                assert np.all(cl.super_box[s, 3:6] >= grp[s, j, 3:6])
            else:
                # pad clusters: inverted-empty boxes, zero matrices
                assert np.all(grp[s, j, 0:3] > grp[s, j, 3:6])


def test_two_level_interpret_matches_threaded(rng_np):
    scene = _scene()
    t1 = scene.tables()
    t2 = scene.tables(cluster_size=16, group_size=4)
    assert t2.clusters.super_box is not None
    assert t1.clusters.super_box is None

    n = 384
    o = rng_np.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 2] = rng_np.uniform(0, 2, n)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = jnp.full((n,), F32_MAX, jnp.float32)
    ref = trace_closest(jnp.asarray(o), jnp.asarray(d), tmax, t1)
    pk = trace_clustered_triton(
        jnp.asarray(o), jnp.asarray(d), tmax, t2, tile=64, interpret=True
    )
    # exact arithmetic in both: same faces, bit-equal t
    np.testing.assert_array_equal(np.asarray(pk.face), np.asarray(ref.face))
    np.testing.assert_array_equal(np.asarray(pk.t), np.asarray(ref.t))


def test_two_level_any_hit_interpret(rng_np):
    scene = _scene()
    t1 = scene.tables()
    t2 = scene.tables(cluster_size=16, group_size=4)
    n = 256
    o = rng_np.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = jnp.full((n,), F32_MAX, jnp.float32)
    ref = trace_any(jnp.asarray(o), jnp.asarray(d), tmax, t1)
    pk = trace_clustered_triton(
        jnp.asarray(o), jnp.asarray(d), tmax, t2, tile=64,
        interpret=True, any_hit=True,
    )
    np.testing.assert_array_equal(np.asarray(pk.face) >= 0, np.asarray(ref))
