"""The Triton tile kernel (ops/cluster_triton.py) under the Pallas
interpreter: exact agreement with the threaded-BVH oracle over tile sizes,
table layouts and query kinds; padding and inactive lanes; agreement with
the XLA clustered path; the traversal-backend choice; and the compiled
kernel on a GPU (marked ``gpu``)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from webgpu_raytracing_tpu.config import F32_MAX, RenderSettings
from webgpu_raytracing_tpu.models.scene import scene_from_facesets
from webgpu_raytracing_tpu.models.test_models import (
    ground_plane,
    unit_cube_model,
    uv_sphere,
)
from webgpu_raytracing_tpu.ops import integrator
from webgpu_raytracing_tpu.ops.cluster_trace import trace_closest_clustered
from webgpu_raytracing_tpu.ops.cluster_triton import (
    cluster_tri_soa,
    trace_any_triton,
    trace_clustered_triton,
)
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


@pytest.fixture(scope="module")
def layouts():
    scene = _scene()
    return {
        "single": scene.tables(),
        "two_level": scene.tables(cluster_size=16, group_size=4),
    }


def _rays(n, seed=5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(0, 2, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("layout", ["single", "two_level"])
@pytest.mark.parametrize("tile", [32, 64, 128])
def test_kernel_matches_oracle(layouts, tile, layout, mode):
    """Exact f32 Möller–Trumbore in the reference's order on both sides:
    faces and t bit-equal (closest), blocked sets equal (any, bounded
    and unbounded)."""
    tables = layouts[layout]
    assert (tables.clusters.super_box is not None) == (layout == "two_level")
    o, d = _rays(320)
    if mode == "closest":
        tm = jnp.full((320,), F32_MAX, jnp.float32)
        ref = trace_closest(o, d, tm, tables)
        got = trace_clustered_triton(
            o, d, tm, tables, tile=tile, interpret=True
        )
        assert (np.asarray(ref.face) >= 0).sum() > 50
        np.testing.assert_array_equal(np.asarray(got.face), np.asarray(ref.face))
        np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
        hit = np.asarray(ref.face) >= 0
        np.testing.assert_allclose(
            np.asarray(got.u)[hit], np.asarray(ref.u)[hit], atol=1e-6
        )
    else:
        for bound in (F32_MAX, 2.5):
            tm = jnp.full((320,), bound, jnp.float32)
            ref = trace_any(o, d, tm, tables)
            got = trace_any_triton(o, d, tm, tables, tile=tile, interpret=True)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_kernel_padding_and_inactive(layouts, mode):
    """A ray count that is no multiple of the tile (padded with inactive
    lanes), a random inactive mask and NaN bounds: inactive and NaN-bound
    rays miss, the rest match the oracle — a NaN bound must not stop the
    rest of its tile."""
    tables = layouts["single"]
    n = 200
    o, d = _rays(n, seed=9)
    rng = np.random.default_rng(3)
    active = jnp.asarray(rng.random(n) < 0.7)
    tm = np.full((n,), F32_MAX, np.float32)
    tm[::17] = np.nan
    tm = jnp.asarray(tm)
    live = np.asarray(active) & ~np.isnan(np.asarray(tm))
    if mode == "closest":
        ref = trace_closest(o, d, tm, tables, jnp.asarray(live))
        got = trace_clustered_triton(
            o, d, tm, tables, active, tile=64, interpret=True
        )
        assert got.face.shape == (n,)
        np.testing.assert_array_equal(np.asarray(got.face), np.asarray(ref.face))
        assert (np.asarray(got.face)[~live] == -1).all()
    else:
        ref = trace_any(o, d, tm, tables, jnp.asarray(live))
        got = trace_any_triton(o, d, tm, tables, active, tile=64,
                               interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        assert not np.asarray(got)[~live].any()


@pytest.mark.parametrize("tile", [0, 48, 96])
def test_kernel_rejects_tile_not_power_of_two(layouts, tile):
    """trace_tile is user-settable (--opt); a tile the kernel cannot
    block is an error, not a silent mis-shape."""
    o, d = _rays(64)
    with pytest.raises(ValueError, match="power of two"):
        trace_clustered_triton(
            o, d, jnp.full((64,), F32_MAX), layouts["single"], tile=tile,
            interpret=True,
        )


def test_kernel_matches_xla_clustered(layouts):
    """Same schedule, same exact arithmetic: the kernel and the XLA
    clustered path return identical hit records."""
    tables = layouts["single"]
    o, d = _rays(256, seed=2)
    tm = jnp.full((256,), F32_MAX, jnp.float32)
    a = trace_closest_clustered(o, d, tm, tables, tile=64)
    b = trace_clustered_triton(o, d, tm, tables, tile=64, interpret=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_cluster_tri_soa_pads_are_degenerate(layouts):
    """Pad slots carry all-zero triangles (det = 0, always culled); real
    slots carry their face's [p0 | e1 | e2]."""
    tables = layouts["two_level"]
    soa = np.asarray(cluster_tri_soa(tables))
    fid = np.asarray(tables.clusters.face_id).reshape(-1)
    assert soa.shape == (9, fid.size)
    assert (soa[:, fid < 0] == 0).all()
    np.testing.assert_array_equal(
        soa[:, fid >= 0], np.asarray(tables.tri)[fid[fid >= 0]].T
    )


@pytest.mark.parametrize(
    "platform,traversal,expected",
    [
        ("cpu", "auto", "clustered"),
        ("gpu", "auto", "triton"),
        ("gpu", "clustered", "clustered"),
        ("cpu", "threaded", "threaded"),
        ("cpu", "triton", ValueError),
        ("gpu", "pallas", ValueError),
    ],
)
def test_resolve_backend(monkeypatch, platform, traversal, expected):
    """"auto" follows the platform; the kernel on a non-GPU platform, or
    an unknown name, is an error rather than a silent fallback."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    s = RenderSettings(traversal=traversal)
    if expected is ValueError:
        with pytest.raises(ValueError):
            integrator._resolve_backend(s)
    else:
        assert integrator._resolve_backend(s) == expected


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["single", "two_level"])
def test_compiled_kernel_matches_oracle(gpu_device, layouts, layout):
    """The kernel as compiled for the card against the oracle. FMA
    contraction on the card may flip knife-edge decisions: faces agree
    on >= 99.99% of rays, t within 1e-5 relative where they agree."""
    tables = jax.device_put(layouts[layout], gpu_device)
    o, d = _rays(65536, seed=11)
    tm = jnp.full((65536,), F32_MAX, jnp.float32)
    ref = trace_closest(o, d, tm, tables)
    got = trace_clustered_triton(o, d, tm, tables, tile=64)
    rf, gf = np.asarray(ref.face), np.asarray(got.face)
    assert (rf == gf).mean() >= 0.9999
    both = (rf == gf) & (rf >= 0)
    rt, gt = np.asarray(ref.t)[both], np.asarray(got.t)[both]
    assert (np.abs(gt - rt) <= 1e-5 * np.maximum(1.0, np.abs(rt))).all()
    blocked = trace_any_triton(o, d, jnp.full((65536,), 2.5), tables)
    ref_b = trace_any(o, d, jnp.full((65536,), 2.5), tables)
    assert (np.asarray(blocked) == np.asarray(ref_b)).mean() >= 0.9999
