"""Renderer-level tests: accumulation semantics, determinism, the furnace
(energy-conservation) test, predictor invariance, and sharded-vs-single
equality — the integration layer of the test pyramid (SURVEY.md §4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from webgpu_raytracing_tpu.config import RenderSettings
from webgpu_raytracing_tpu.models.scene import scene_from_facesets
from webgpu_raytracing_tpu.models.test_models import (
    ground_plane,
    uv_sphere,
)
from webgpu_raytracing_tpu.renderer import Renderer


def _mini_scene():
    return scene_from_facesets(
        [
            ("light", uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4, lon=6)),
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


SMALL = RenderSettings(
    width=16, height=16, bounces_depth=3, sample_count=0,
    environment="procedural",
)


def test_accumulation_counts():
    r = Renderer(_mini_scene(), SMALL, base_seed=1)
    r.step()
    img = np.asarray(r.buffers.image)
    assert (img[..., 3] == 1.0).all()
    r.step()
    img = np.asarray(r.buffers.image)
    assert (img[..., 3] == 2.0).all()
    # reset → clear on next frame
    r.reset()
    r.step()
    img = np.asarray(r.buffers.image)
    assert (img[..., 3] == 1.0).all()


def test_determinism():
    a = Renderer(_mini_scene(), SMALL, base_seed=42)
    b = Renderer(_mini_scene(), SMALL, base_seed=42)
    a.step()
    b.step()
    np.testing.assert_array_equal(
        np.asarray(a.buffers.image), np.asarray(b.buffers.image)
    )


def test_image_finite_and_oriented():
    r = Renderer(_mini_scene(), SMALL, base_seed=1)
    r.step()
    img = r.image()
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    assert img.max() <= 1.0 and img.min() >= 0.0
    # light is at world +y → must be in the TOP half of the display image
    gf = np.asarray(r.buffers.geo_face)[::-1]  # display orientation
    light_rows = np.nonzero((gf >= 0) & (gf < 48))[0]
    if len(light_rows):
        assert light_rows.mean() < 8


def test_odd_dimensions():
    """Odd width/height must render: the 2×2 quad predictor pads ragged
    edges with no-candidate lanes (the GPU analog: inactive quad lanes)."""
    st = SMALL.replace(width=15, height=17, use_hit_predictor=True)
    r = Renderer(_mini_scene(), st, base_seed=3)
    r.step()
    r.step()
    img = np.asarray(r.buffers.image)
    assert img.shape == (17, 15, 4)
    assert np.isfinite(img).all()
    assert (img[..., 3] == 2.0).all()


def test_predictor_invariance():
    """The quad hit-distance predictor is a pure traversal bound: frame
    images with and without it must be identical (render.ts:1121-1141 is
    a speedup, not a semantic change)."""
    a = Renderer(_mini_scene(), SMALL.replace(use_hit_predictor=True), base_seed=9)
    b = Renderer(_mini_scene(), SMALL.replace(use_hit_predictor=False), base_seed=9)
    for _ in range(2):  # second frame exercises a populated prev G-buffer
        a.step()
        b.step()
    np.testing.assert_array_equal(
        np.asarray(a.buffers.image), np.asarray(b.buffers.image)
    )


@pytest.mark.slow
def test_furnace():
    """Furnace test: a Lambertian sphere of albedo a under a uniform
    unit-radiance environment must converge to pixel value a (energy
    conservation of the cosine-sampled bounce + Russian roulette)."""
    albedo = 0.5
    scene = scene_from_facesets(
        [("sphere", uv_sphere((0, 0, -4), 1.0, lat=24, lon=48))],
        np.array([[albedo] * 3], np.float32),
        np.zeros((1, 3), np.float32),
    )
    from webgpu_raytracing_tpu.config import ProjectionType

    st = RenderSettings(
        width=24,
        height=24,
        bounces_depth=8,
        sample_count=3,
        environment="white",
        use_hit_predictor=False,
        projection_type=ProjectionType.PERSPECTIVE,
        fov=0.6,
    )
    r = Renderer(scene, st, base_seed=11)
    for _ in range(24):
        r.step()
    img = np.asarray(r.buffers.image)
    raw = img[..., :3] / np.maximum(img[..., 3:], 1)
    gf = np.asarray(r.buffers.geo_face)
    on_sphere = gf >= 0
    # only use pixels whose primary ray hit the sphere
    mean = raw[on_sphere].mean()
    assert on_sphere.sum() > 30
    assert abs(mean - albedo) < 0.03, mean


def test_checkpoint_roundtrip(tmp_path):
    r = Renderer(_mini_scene(), SMALL, base_seed=5)
    r.step()
    r.step()
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)
    r2 = Renderer(_mini_scene(), SMALL, base_seed=5)
    r2.load_checkpoint(path)
    assert r2.counter == 2
    np.testing.assert_array_equal(
        np.asarray(r.buffers.image), np.asarray(r2.buffers.image)
    )


def test_sharded_matches_single_chip():
    """Row-sharded multi-device render must be bit-identical to the
    single-chip image (global pixel RNG indexing)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    from webgpu_raytracing_tpu.parallel.shard import make_mesh, render_sharded
    from webgpu_raytracing_tpu.renderer import (
        FrameBuffers,
        FrameInputs,
        render_frame,
    )

    scene = _mini_scene()
    tables = scene.tables()
    st = SMALL.replace(width=16, height=16, use_hit_predictor=False)
    env = jnp.zeros((1, 1, 3), jnp.float32)

    single, _ = render_frame(
        FrameBuffers.create(16, 16),
        tables,
        env,
        FrameInputs.simple(jnp.eye(4, dtype=jnp.float32), 1, 0),
        st,
    )
    mesh = make_mesh(4)
    sharded, rays = render_sharded(tables, env, st, n_frames=1, mesh=mesh)
    np.testing.assert_array_equal(
        np.asarray(single.image), np.asarray(sharded.image)
    )
    assert rays > 0


def test_sharded_reprojection_matches_single_chip():
    """The full temporal path under sharding — reprojection, jitter, and
    the quad predictor all read the REPLICATED prev buffers with global
    pixel coordinates, so a row-sharded run must stay bit-identical to
    single-chip across updatePrev rotations."""
    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    from webgpu_raytracing_tpu.ops.reproject import reprojection_frustum
    from webgpu_raytracing_tpu.parallel.shard import make_mesh, render_sharded
    from webgpu_raytracing_tpu.renderer import (
        FrameBuffers,
        FrameInputs,
        render_frame,
    )

    st = SMALL.replace(
        width=16,
        height=16,
        sample_count=1,
        reprojection_rate=2,
        jitter_strength=0.5,
        use_hit_predictor=True,
    )
    scene = _mini_scene()
    tables = scene.tables()
    env = jnp.zeros((1, 1, 3), jnp.float32)
    eye = np.eye(4, dtype=np.float32)
    frustum = reprojection_frustum(eye, st.width, st.height, st.fov)

    def mk_inputs(k):
        return FrameInputs(
            view=jnp.asarray(eye),
            seed=jnp.uint32((7 + k * 2654435761) % (2**32)),
            counter=jnp.int32(k),
            jitter=jnp.asarray([0.21, -0.34], jnp.float32),
            frustum=jnp.asarray(frustum),
            prev_origin=jnp.zeros((3,), jnp.float32),
        )

    # single chip, Renderer.step's updatePrev schedule
    bufs = FrameBuffers.create(st.width, st.height)
    frame_counter = 0
    for k in range(3):
        update_prev = frame_counter % st.reprojection_rate == 0
        frame_counter = (frame_counter + 1) % st.reprojection_rate
        bufs, _ = render_frame(bufs, tables, env, mk_inputs(k), st)
        if update_prev:
            bufs = bufs.rotated()

    mesh = make_mesh(4)
    sharded, rays = render_sharded(
        tables, env, st, n_frames=3, mesh=mesh, inputs_fn=mk_inputs
    )
    np.testing.assert_array_equal(
        np.asarray(bufs.image), np.asarray(sharded.image)
    )
    np.testing.assert_array_equal(
        np.asarray(bufs.prev_image), np.asarray(sharded.prev_image)
    )
    assert rays > 0


@pytest.mark.parametrize("nee", [False, True], ids=["paths", "nee"])
def test_pallas_interpret_full_frame_matches_clustered(
    interpreted_kernel, nee
):
    """Drive the Triton kernel (under the interpreter) through the whole
    frame path — raygen, primary trace, sorted bounce legs with live
    slicing, NEE shadow legs, accumulation — against the XLA clustered
    backend. Both decide intersections with exact f32 Möller–Trumbore,
    so the frames may differ only where the XLA path's top-2 candidate
    preselection drops a winner (isolated pixels at most)."""
    scene = _mini_scene()
    imgs = {}
    for backend in ("clustered", "triton"):
        s = RenderSettings(
            width=16, height=16, bounces_depth=3, sample_count=1,
            environment="procedural", traversal=backend, trace_tile=64,
            next_event_estimation=nee,
        )
        r = Renderer(scene, s, base_seed=11)
        r.step()
        imgs[backend] = np.asarray(r.buffers.image)
    a, b = imgs["clustered"], imgs["triton"]
    np.testing.assert_array_equal(a[..., 3], b[..., 3])  # equal spp
    close = np.all(np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(a), axis=-1)
    assert close.mean() >= 0.98, f"{(~close).sum()} pixels differ"


def test_frame_slabs_bit_identical():
    """render_frame_slabs (big-frame slab decomposition) must be
    bit-identical to the single-tile frame — same slab contract as the
    multi-chip shard (global row0 pixel/RNG indexing, prev snapshots
    whole), exercised WITH temporal reprojection so the prev-read paths
    cross slab boundaries."""
    scene = _mini_scene()
    imgs = {}
    for label, kw in (("one", {}), ("slabs", dict(frame_slabs=4))):
        r = Renderer(
            scene,
            RenderSettings(
                width=32, height=32, environment="procedural",
                reprojection_rate=3, **kw,
            ),
            base_seed=7,
        )
        for _ in range(3):
            r.step()
        imgs[label] = np.asarray(r.buffers.image)
    np.testing.assert_array_equal(imgs["one"], imgs["slabs"])
