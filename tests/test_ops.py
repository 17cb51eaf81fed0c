"""Unit tests for tonemapping, env sampling, raygen, derivatives,
reprojection math, and the bilinear samplers."""

import numpy as np
import jax.numpy as jnp

from webgpu_raytracing_tpu.config import (
    FovOrientation,
    ProjectionType,
    RenderSettings,
    Tonemapping,
)
from webgpu_raytracing_tpu.ops import tonemap
from webgpu_raytracing_tpu.ops.derivatives import dfdx, dfdy
from webgpu_raytracing_tpu.ops.envmap import (
    equirect_uv,
    sample_cubemap,
    sample_equirect,
)
from webgpu_raytracing_tpu.ops.raygen import camera_rays
from webgpu_raytracing_tpu.ops.reproject import (
    reproject_point,
    reprojection_frustum,
)
from webgpu_raytracing_tpu.ops.sampling import sample_bilinear


# --- tonemapping (shaders/tonemapping.ts) ---


def test_srgb_roundtrip():
    x = jnp.linspace(0.0, 1.0, 64)
    y = tonemap.srgb_to_linear(tonemap.linear_to_srgb(x))
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-5)


def test_tonemap_ranges():
    x = jnp.asarray(np.linspace(0.0, 20.0, 128, dtype=np.float32))
    for mode in (
        Tonemapping.REINHARD,
        Tonemapping.ACES,
        Tonemapping.FILMIC,
        Tonemapping.LOTTES,
    ):
        y = np.asarray(tonemap.apply(x, mode))
        assert np.isfinite(y).all(), mode
        assert (y >= -1e-6).all() and (y <= 1.2).all(), mode
        # monotone non-decreasing
        assert (np.diff(y) >= -1e-4).all(), mode


def test_tonemap_none_identity():
    x = jnp.asarray(np.array([0.5, 2.0], np.float32))
    np.testing.assert_array_equal(
        np.asarray(tonemap.apply(x, Tonemapping.NONE)), np.asarray(x)
    )


# --- environment sampling (render.ts:932-940) ---


def test_equirect_uv_mapping():
    # +y (up) → v = 1 (top of texture domain)
    uv = np.asarray(equirect_uv(jnp.asarray([[0.0, 1.0, 0.0]])))
    assert abs(uv[0, 1] - 1.0) < 1e-6
    # -y → v = 0
    uv = np.asarray(equirect_uv(jnp.asarray([[0.0, -1.0, 0.0]])))
    assert abs(uv[0, 1]) < 1e-6
    # +x → u = 0.5
    uv = np.asarray(equirect_uv(jnp.asarray([[1.0, 0.0, 0.0]])))
    assert abs(uv[0, 0] - 0.5) < 1e-6


def test_equirect_nearest_fetch():
    img = jnp.asarray(np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3))
    d = jnp.asarray([[1.0, 0.0, 0.0]])  # u=0.5, v=0.5 → texel (4, 2)
    out = np.asarray(sample_equirect(img, d))
    expected = np.asarray(img)[2, 4]
    np.testing.assert_array_equal(out[0], expected)


def test_cubemap_face_selection():
    faces = np.zeros((6, 4, 4, 3), np.float32)
    for f in range(6):
        faces[f] = f + 1
    fj = jnp.asarray(faces)
    dirs = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float32,
    )
    out = np.asarray(sample_cubemap(fj, jnp.asarray(dirs)))
    np.testing.assert_array_equal(out[:, 0], np.arange(1, 7, dtype=np.float32))


# --- raygen (render.ts:642-766) ---


def _center_ray(settings):
    pos = jnp.asarray(
        [[settings.width / 2.0, settings.height / 2.0]], dtype=jnp.float32
    )
    state = jnp.asarray(np.array([7], np.uint32))
    o, d, _ = camera_rays(pos, jnp.eye(4, dtype=jnp.float32), state, settings)
    return np.asarray(o)[0], np.asarray(d)[0]


def test_center_ray_looks_down_minus_z():
    for proj in (ProjectionType.PERSPECTIVE, ProjectionType.PANINI):
        st = RenderSettings(width=64, height=64, projection_type=proj)
        o, d = _center_ray(st)
        np.testing.assert_allclose(o, 0.0, atol=1e-6)
        np.testing.assert_allclose(d, [0, 0, -1], atol=1e-5)


def test_fisheye_center_looks_plus_z():
    """Reference quirk: fisheye is +z-forward (render.ts:680-689)."""
    st = RenderSettings(width=64, height=64, projection_type=ProjectionType.FISHEYE)
    o, d = _center_ray(st)
    # thin lens flips through the focus point at -z... fisheye dir (0,0,1)
    # → focusPoint = -d*fd/d.z = (0,0,-4); ray toward it
    np.testing.assert_allclose(d, [0, 0, -1], atol=1e-5)


def test_fov_orientation_scaling():
    st = RenderSettings(
        width=128,
        height=64,
        projection_type=ProjectionType.PERSPECTIVE,
        fov_orientation=FovOrientation.HORIZONTAL,
    )
    # right edge center pixel: uv.x = 1 → half the fov angle off-axis
    pos = jnp.asarray([[128.0, 32.0]], dtype=jnp.float32)
    state = jnp.asarray(np.array([7], np.uint32))
    _, d, _ = camera_rays(pos, jnp.eye(4, dtype=jnp.float32), state, st)
    d = np.asarray(d)[0]
    angle = np.arctan2(d[0], -d[2])
    np.testing.assert_allclose(angle, st.fov / 2.0, rtol=1e-4)


def test_view_matrix_transforms_ray():
    st = RenderSettings(width=64, height=64, projection_type=ProjectionType.PERSPECTIVE)
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [1.0, 2.0, 3.0]
    pos = jnp.asarray([[32.0, 32.0]], dtype=jnp.float32)
    state = jnp.asarray(np.array([7], np.uint32))
    o, d, _ = camera_rays(pos, jnp.asarray(view), state, st)
    np.testing.assert_allclose(np.asarray(o)[0], [1, 2, 3], atol=1e-5)
    np.testing.assert_allclose(np.asarray(d)[0], [0, 0, -1], atol=1e-5)


# --- derivatives (render.ts:943-1007) ---


def test_quad_derivatives():
    h, w = 4, 4
    v = jnp.asarray(np.arange(h * w, dtype=np.float32).reshape(h, w))
    dx = np.asarray(dfdx(v))
    dy = np.asarray(dfdy(v))
    # gradient of x+4y: dx = 1 everywhere, dy = 4 everywhere (within quads)
    np.testing.assert_allclose(dx, 1.0)
    np.testing.assert_allclose(dy, 4.0)


# --- reprojection math (store.ts:129-179, render.ts:1022-1025) ---


def test_reproject_point_roundtrip():
    """A point along a pinhole camera ray through pixel (px, py) must
    reproject back to (px, py) under the same view."""
    st = RenderSettings(
        width=96,
        height=64,
        projection_type=ProjectionType.PERSPECTIVE,
        fov_orientation=FovOrientation.HORIZONTAL,
        circle_of_confusion=0.0,
    )
    view = np.eye(4, dtype=np.float32)
    frustum = jnp.asarray(
        reprojection_frustum(view, st.width, st.height, st.fov)
    )
    pix = np.array(
        [[10.0, 20.0], [48.0, 32.0], [90.0, 5.0], [3.0, 60.0]], np.float32
    )
    state = jnp.asarray(np.arange(4, dtype=np.uint32))
    o, d, _ = camera_rays(jnp.asarray(pix), jnp.eye(4), state, st)
    p = np.asarray(o) + np.asarray(d) * np.array([[2.0], [3.0], [5.0], [1.5]])
    uv = np.asarray(
        reproject_point(
            jnp.asarray(p), frustum, jnp.zeros((3,), jnp.float32)
        )
    )
    np.testing.assert_allclose(uv, pix, atol=0.05)


# --- bilinear samplers (render.ts:1227-1334) ---


def test_sample_bilinear_exact_at_integers():
    img = jnp.asarray(np.random.default_rng(0).random((6, 7, 4)).astype(np.float32))
    uv = jnp.asarray([[3.0, 2.0]])
    out = np.asarray(sample_bilinear(img, uv))
    np.testing.assert_allclose(out[0], np.asarray(img)[2, 3], atol=1e-6)


def test_sample_bilinear_midpoint():
    img = np.zeros((2, 2, 1), np.float32)
    img[0, 0] = 0.0
    img[0, 1] = 1.0
    img[1, 0] = 2.0
    img[1, 1] = 3.0
    out = np.asarray(sample_bilinear(jnp.asarray(img), jnp.asarray([[0.5, 0.5]])))
    np.testing.assert_allclose(out[0, 0], 1.5, atol=1e-6)


def test_controls_move_and_rotate():
    """controls.ts semantics: WASD assembles a normalized move vector
    scaled by speed*dt; Shift runs; pointer rotates by dt*sensitivity."""
    from webgpu_raytracing_tpu.camera import Camera, Controls

    cam = Camera()
    c = Controls(cam, sensitivity=0.03, speed=2.0, run_speed=5.0)
    c.press("w")
    assert c.update(0.5)
    # identity orientation: front basis is (0,0,1) ground-projected
    np.testing.assert_allclose(cam.position, [0, 0, 1.0], atol=1e-6)
    c.press("Shift")
    c.update(0.5)
    np.testing.assert_allclose(cam.position, [0, 0, 3.5], atol=1e-6)
    c.release_all()
    assert not c.update(0.5)
    assert c.pointer(1.0, 0.0, 0.1)  # yaw changed
    assert not np.array_equal(cam.orientation, np.array([0, 0, 0, 1]))


def test_orbit_path_faces_center():
    """Orbit cameras must sit on the circle and look at the center,
    accounting for the view matrix's -position translation."""
    from webgpu_raytracing_tpu.camera import orbit_path
    from webgpu_raytracing_tpu.utils import mathx as mx

    center = np.array([0.0, 1.0, -6.0], np.float32)
    for cam in orbit_path(center, 6.0, 1.0, 4):
        view = cam.view_matrix()
        origin = view[:3, 3]  # world-space camera origin
        np.testing.assert_allclose(
            np.linalg.norm((origin - center)[[0, 2]]), 6.0, rtol=1e-4
        )
        # camera forward = R @ (0,0,-1) must point at the center
        fwd = view[:3, :3] @ np.array([0, 0, -1.0], np.float32)
        want = (center - origin) / np.linalg.norm(center - origin)
        np.testing.assert_allclose(fwd, want, atol=1e-4)


def test_det_trig_correctly_rounded():
    """det_sincos/det_tan (ops/detmath.py): double-f32 trig must match the
    correctly rounded f32 result (f64-evaluated, rounded once) on all but
    a ~1e-6 sliver of rounding-boundary ties, across the ranges the
    renderer draws from (sampler phases [0, 2π), raygen angles, and
    adversarial near-k·π/2 arguments where Cody-Waite reduction cancels).
    This is the cross-backend determinism primitive: its bits are a pure
    function of f32 mul/add, identical on every backend."""
    import jax

    from webgpu_raytracing_tpu.ops.detmath import det_sincos, det_tan

    rng = np.random.default_rng(3)
    n = 1 << 18
    pools = {
        "sampler": rng.uniform(0, 2 * np.pi, n).astype(np.float32),
        "raygen": rng.uniform(-1.2, 1.2, n).astype(np.float32),
        "near_kpio2": (
            rng.integers(0, 5, n) * (np.pi / 2)
            + rng.normal(0, 1e-6, n)
        ).astype(np.float32),
    }
    f_sc = jax.jit(det_sincos)
    f_t = jax.jit(det_tan)
    for label, xs in pools.items():
        s, c = f_sc(jnp.asarray(xs))
        t = f_t(jnp.asarray(xs))
        x64 = xs.astype(np.float64)
        for name, got, ref in (
            ("sin", np.asarray(s), np.sin(x64).astype(np.float32)),
            ("cos", np.asarray(c), np.cos(x64).astype(np.float32)),
            ("tan", np.asarray(t), np.tan(x64).astype(np.float32)),
        ):
            neq = got != ref
            frac = neq.mean()
            assert frac <= 1e-5, f"{label}/{name}: {frac} mis-rounded"
            if neq.any():
                ulp = np.abs(
                    got.view(np.int32) - ref.view(np.int32)
                )[neq].max()
                assert ulp <= 2, f"{label}/{name}: {ulp} ulp off"
