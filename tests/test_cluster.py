"""Clustered traversal (XLA path and Triton kernel): equivalence with the
threaded-BVH oracle and brute force; cluster table invariants."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from webgpu_raytracing_tpu.config import F32_MAX
from webgpu_raytracing_tpu.models.cluster import build_clusters
from webgpu_raytracing_tpu.models.scene import scene_from_facesets
from webgpu_raytracing_tpu.models.test_models import (
    ground_plane,
    unit_cube_model,
    uv_sphere,
)
from webgpu_raytracing_tpu.ops.cluster_trace import (
    intersect_cluster_block,
    pack_cluster_tables,
    ray_matrix,
    trace_closest_clustered,
)
from webgpu_raytracing_tpu.ops.intersect import ray_triangle
from webgpu_raytracing_tpu.ops.traverse import trace_closest


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


def test_cluster_tables_cover_all_faces():
    scene = _scene()
    clusters = build_clusters(scene.models)
    total_faces = sum(len(m.faces) for m in scene.models)
    fid = clusters.face_id[clusters.face_id >= 0]
    assert len(np.unique(fid)) == total_faces
    # padding normals are zero → det == 0 → always culled
    pad_mask = clusters.face_id < 0
    assert np.all(clusters.n[pad_mask] == 0)


def test_cluster_boxes_contain_their_faces():
    scene = _scene()
    clusters = build_clusters(scene.models)
    from webgpu_raytracing_tpu.models.face import FaceSet

    fs = FaceSet.concat([m.faces for m in scene.models])
    for c in range(clusters.n_clusters):
        fids = clusters.face_id[c][clusters.face_id[c] >= 0]
        v0 = fs.p0[fids]
        v1 = v0 + fs.e1[fids]
        v2 = v0 + fs.e2[fids]
        pts = np.concatenate([v0, v1, v2])
        assert (pts >= clusters.box[c, 0:3] - 1e-4).all()
        assert (pts <= clusters.box[c, 3:6] + 1e-4).all()


def test_bilinear_mt_matches_reference_mt(rng_np):
    """The matmul decomposition must reproduce classic Möller–Trumbore."""
    scene = _scene()
    tables = scene.tables()
    ct = tables.clusters
    n = 64
    o = rng_np.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a = ray_matrix(jnp.asarray(o), jnp.asarray(d))
    best = jnp.full((n,), F32_MAX, jnp.float32)

    cid = 0
    t_cl, u_cl, v_cl, slot = intersect_cluster_block(
        a, ct.mat_b[cid], best
    )
    # oracle: classic per-triangle MT over the same cluster's faces
    s = ct.face_id.shape[1]
    t_ref = np.full((n,), F32_MAX, np.float32)
    u_ref = np.zeros((n,), np.float32)
    for k in range(s):
        fid = int(ct.face_id[cid, k])
        if fid < 0:
            continue
        tri = np.asarray(tables.tri[fid])
        th = ray_triangle(
            jnp.asarray(o), jnp.asarray(d),
            jnp.broadcast_to(jnp.asarray(tri[0:3]), (n, 3)),
            jnp.broadcast_to(jnp.asarray(tri[3:6]), (n, 3)),
            jnp.broadcast_to(jnp.asarray(tri[6:9]), (n, 3)),
            0.0, jnp.asarray(t_ref),
        )
        hit = np.asarray(th.hit)
        t_ref = np.where(hit, np.asarray(th.t), t_ref)
        u_ref = np.where(hit, np.asarray(th.u), u_ref)
    hits_ref = t_ref < F32_MAX
    hits_cl = np.asarray(slot) >= 0
    np.testing.assert_array_equal(hits_cl, hits_ref)
    np.testing.assert_allclose(
        np.asarray(t_cl)[hits_ref], t_ref[hits_ref], rtol=2e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(u_cl)[hits_ref], u_ref[hits_ref], rtol=1e-3, atol=2e-4
    )


def test_clustered_matches_threaded(rng_np):
    scene = _scene()
    tables = scene.tables()
    n = 512
    o = rng_np.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 2] = rng_np.uniform(0, 2, n)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = jnp.full((n,), F32_MAX, jnp.float32)

    ref = trace_closest(jnp.asarray(o), jnp.asarray(d), tmax, tables)
    cl = trace_closest_clustered(
        jnp.asarray(o), jnp.asarray(d), tmax, tables, tile=128
    )
    hits_ref = np.asarray(ref.face) >= 0
    hits_cl = np.asarray(cl.face) >= 0
    np.testing.assert_array_equal(hits_cl, hits_ref)
    assert hits_ref.sum() > 50
    np.testing.assert_allclose(
        np.asarray(cl.t)[hits_ref],
        np.asarray(ref.t)[hits_ref],
        rtol=2e-4,
        atol=1e-5,
    )
    # face agreement except float-tie cases
    agree = (np.asarray(cl.face) == np.asarray(ref.face))[hits_ref]
    assert agree.mean() > 0.995, agree.mean()


def test_clustered_respects_tmax_and_active():
    scene = _scene()
    tables = scene.tables()
    o = jnp.asarray(np.array([[0, 0, 0], [0, 0, 0]], np.float32))
    d = jnp.asarray(np.array([[0, 0, -1], [0, 0, -1]], np.float32))
    tmax = jnp.full((2,), F32_MAX, jnp.float32)
    both = trace_closest_clustered(o, d, tmax, tables, tile=128)
    assert int(both.face[0]) >= 0 and int(both.face[1]) >= 0
    t = float(both.t[0])
    near = trace_closest_clustered(
        o, d, jnp.asarray([t * 0.5, F32_MAX], jnp.float32), tables, tile=128
    )
    assert int(near.face[0]) == -1 and int(near.face[1]) >= 0
    inact = trace_closest_clustered(
        o, d, tmax, tables,
        active=jnp.asarray([False, True]), tile=128,
    )
    assert int(inact.face[0]) == -1 and int(inact.face[1]) >= 0


def test_pallas_kernel_interpret_matches_threaded(rng_np):
    """The Triton tile kernel (interpret mode on CPU) must agree with the
    threaded-BVH oracle."""
    from webgpu_raytracing_tpu.ops.cluster_triton import (
        trace_clustered_triton,
    )

    scene = _scene()
    tables = scene.tables()
    n = 384
    o = rng_np.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 2] = rng_np.uniform(0, 2, n)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = jnp.full((n,), F32_MAX, jnp.float32)
    ref = trace_closest(jnp.asarray(o), jnp.asarray(d), tmax, tables)
    pk = trace_clustered_triton(
        jnp.asarray(o), jnp.asarray(d), tmax, tables, tile=128,
        interpret=True,
    )
    hits = np.asarray(ref.face) >= 0
    np.testing.assert_array_equal(np.asarray(pk.face) >= 0, hits)
    np.testing.assert_allclose(
        np.asarray(pk.t)[hits], np.asarray(ref.t)[hits], rtol=2e-4,
        atol=1e-5,
    )
    np.testing.assert_array_equal(np.asarray(pk.face), np.asarray(ref.face))


def test_sorted_trace_matches_plain(rng_np):
    """ops/ray_sort.sorted_trace is a pure reordering — results must be
    identical to the plain clustered trace."""
    from webgpu_raytracing_tpu.ops.ray_sort import sorted_trace

    scene = _scene()
    tables = scene.tables()
    n = 256
    o = rng_np.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = jnp.full((n,), F32_MAX, jnp.float32)

    trace = lambda a, b, c, t, act: trace_closest_clustered(
        a, b, c, t, act, tile=64
    )
    plain = trace(jnp.asarray(o), jnp.asarray(d), tmax, tables, None)
    srt = sorted_trace(trace, jnp.asarray(o), jnp.asarray(d), tmax, tables)
    np.testing.assert_array_equal(np.asarray(plain.face), np.asarray(srt.face))
    np.testing.assert_allclose(
        np.asarray(plain.t), np.asarray(srt.t), rtol=1e-6
    )


def test_sorted_trace_bool_result_matches_plain(rng_np):
    """A single bool result leaf (the shadow-ray path) takes the
    non-packed unsort fallback — must still be a pure reordering."""
    from webgpu_raytracing_tpu.ops.cluster_trace import trace_any_clustered
    from webgpu_raytracing_tpu.ops.ray_sort import sorted_trace

    scene = _scene()
    tables = scene.tables()
    n = 256
    o = rng_np.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = jnp.full((n,), 2.5, jnp.float32)

    trace = lambda a, b, c, t, act: trace_any_clustered(
        a, b, c, t, act, tile=64
    )
    plain = trace(jnp.asarray(o), jnp.asarray(d), tmax, tables, None)
    srt = sorted_trace(trace, jnp.asarray(o), jnp.asarray(d), tmax, tables)
    np.testing.assert_array_equal(np.asarray(plain), np.asarray(srt))


def test_clustered_any_hit_matches_threaded(rng_np):
    """The XLA clustered any-hit early-exit (rounds stop once every live
    ray has some hit) must agree with the threaded any-hit oracle."""
    from webgpu_raytracing_tpu.ops.cluster_trace import trace_any_clustered
    from webgpu_raytracing_tpu.ops.traverse import trace_any

    scene = _scene()
    tables = scene.tables()
    n = 384
    o = rng_np.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for tmax_val in (F32_MAX, 2.5):
        tmax = jnp.full((n,), tmax_val, jnp.float32)
        ref = trace_any(jnp.asarray(o), jnp.asarray(d), tmax, tables)
        got = trace_any_clustered(
            jnp.asarray(o), jnp.asarray(d), tmax, tables, tile=128
        )
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_pallas_any_hit_interpret_matches_threaded(rng_np):
    """The any-hit early-exit kernel path (shadow rays) must agree with
    the threaded any-hit oracle, bounded and unbounded."""
    from webgpu_raytracing_tpu.ops.cluster_triton import trace_any_triton
    from webgpu_raytracing_tpu.ops.traverse import trace_any

    scene = _scene()
    tables = scene.tables()
    n = 384
    o = rng_np.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for tmax_val in (F32_MAX, 2.5):
        tmax = jnp.full((n,), tmax_val, jnp.float32)
        ref = trace_any(jnp.asarray(o), jnp.asarray(d), tmax, tables)
        pk = trace_any_triton(
            jnp.asarray(o), jnp.asarray(d), tmax, tables, tile=128,
            interpret=True,
        )
        np.testing.assert_array_equal(np.asarray(pk), np.asarray(ref))


@pytest.mark.parametrize(
    "dead_frac,frac", [(0.7, 0.5), (0.0, 0.25)], ids=["sliced", "overflow"]
)
@pytest.mark.parametrize("mode", ["closest", "any"])
def test_live_slice_bit_identical(mode, dead_frac, frac):
    """sorted_trace(live_slice=...) at r >= 1024 must equal the full-width
    sorted trace bit for bit: with most lanes dead the trace runs on the
    live prefix and the keyless tail takes the miss answer ("sliced");
    with too many live rays the full-width fallback runs ("overflow").
    Driven through the Triton kernel (interpreter), as on the GPU."""
    from webgpu_raytracing_tpu.ops.cluster_triton import (
        trace_clustered_triton,
    )
    from webgpu_raytracing_tpu.ops.ray_sort import (
        nearest_cluster_key,
        sorted_trace,
    )
    from webgpu_raytracing_tpu.ops.traverse import Hit

    tables = _scene().tables(cluster_size=16, group_size=4)
    n = 2048
    rng = np.random.default_rng(21)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    active = jnp.asarray(rng.random(n) >= dead_frac)
    tm = jnp.full((n,), F32_MAX if mode == "closest" else 3.0, jnp.float32)

    def fn(o_, d_, tm_, tb_, act_):
        h = trace_clustered_triton(
            o_, d_, tm_, tb_, act_, tile=64, interpret=True,
            any_hit=mode == "any",
        )
        return h if mode == "closest" else h.face >= 0

    def tail(tm_tail):
        if mode == "any":
            return jnp.zeros(tm_tail.shape, jnp.bool_)
        z = jnp.zeros(tm_tail.shape, jnp.float32)
        return Hit(t=tm_tail, u=z, v=z,
                   face=jnp.full(tm_tail.shape, -1, jnp.int32))

    keys = nearest_cluster_key(
        o, d, jnp.where(active, tm, 0.0), tables.clusters.sort_box
    )
    c = tables.clusters.sort_box.shape[0]
    n_live = int((np.asarray(keys) < c * (c + 1)).sum())
    assert (n_live <= n * frac) == (dead_frac == 0.7), n_live

    full = sorted_trace(fn, o, d, tm, tables, active)
    sliced = sorted_trace(
        fn, o, d, tm, tables, active, live_slice=frac, tail=tail
    )
    for a, b in zip(jax.tree.leaves(full), jax.tree.leaves(sliced)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if mode == "closest":
        assert (np.asarray(full.face) >= 0).sum() > 100
