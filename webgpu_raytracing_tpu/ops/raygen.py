"""Camera ray generation — all four reference projections + thin lens.

Parity with the WGSL raygen module (render.ts:642-766): pinhole, Panini,
fisheye, orthographic; FoV-orientation normalization
(horizontal/vertical/diagonal, render.ts:749-758); thin-lens depth of field
with circle/square bokeh (render.ts:695-702, 740-747); and the exact
``ray_transform`` into world space (render.ts:731-738), including its
``dir.z * ray_pos.w`` quirk (a no-op for affine view matrices, kept for
fidelity). Quirks replicated on purpose: Panini multiplies the half-FoV
scaled coordinate by the half-Panini-FoV again (render.ts:659-661), and the
fisheye looks down +z while the others look down -z (render.ts:680-689).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..config import FovOrientation, LensShape, ProjectionType, RenderSettings
from . import rng
from .detmath import det_div as _det_div  # bit-identical CPU↔TPU
from .detmath import det_sincos as _det_sincos
from .detmath import det_tan as _det_tan
from .detmath import normalize as _normalize


def pinhole_dir(uv: jnp.ndarray, fov: float) -> jnp.ndarray:
    z = -1.0 / jnp.tan(fov / 2.0)
    return _normalize(
        jnp.stack(
            [uv[..., 0], uv[..., 1], jnp.full_like(uv[..., 0], z)], axis=-1
        )
    )


def panini_dir(
    uv: jnp.ndarray, fov: float, panini_distance: float, vertical_compression: float
) -> jnp.ndarray:
    half_fov = fov / 2.0
    hv = uv * half_fov
    half_panini_fov = jnp.arctan2(
        jnp.sin(half_fov), jnp.cos(half_fov) + panini_distance
    )
    hv_pan = hv * half_panini_fov
    # det_sincos/det_tan: each backend's polynomial trig may differ by
    # an ulp or two, and every camera direction feeds chaotic path
    # divergence. The double-f32 versions are bit-identical across
    # backends and ≈ correctly rounded (ops/detmath.py).
    sx, cx = _det_sincos(hv_pan[..., 0])
    # strict products: a backend may fuse these mul/add chains into
    # FMAs (1 ulp off the strict WGSL/scalar evaluation); smul rounds
    # each product first (ops/strictf.py)
    from .strictf import smul as _smul

    from .detmath import det_sqrt as _det_sqrt

    w = sx * panini_distance
    m = (
        _det_sqrt(jnp.maximum(1.0 - _smul(w, w), 0.0))
        + _smul(panini_distance, cx)
    )
    x = sx * m
    z = _smul(cx, m) - panini_distance
    y = _det_tan(hv_pan[..., 1]) * (
        z + _smul(panini_distance, 1.0 - vertical_compression)
    )
    return _normalize(jnp.stack([x, y, -z], axis=-1))


def fisheye_dir(uv: jnp.ndarray, fov: float) -> jnp.ndarray:
    angle = uv * (fov / 2.0)
    sax, cax = _det_sincos(angle[..., 0])  # see panini_dir's trig note
    say, cay = _det_sincos(angle[..., 1])
    return _normalize(
        jnp.stack([-sax, -say * cax, cay * cax], axis=-1)
    )


def camera_rays(
    pos: jnp.ndarray,  # (R, 2) pixel coordinates (jittered)
    view: jnp.ndarray,  # (4, 4) view matrix (camera → world)
    state: jnp.ndarray,  # (R,) uint32 RNG state
    settings: RenderSettings,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """cameraRay (render.ts:749-765). Returns (origin, direction, state)."""
    viewport = jnp.array(
        [settings.render_width, settings.render_height], dtype=jnp.float32
    )
    uv = 2.0 * pos - viewport
    if settings.fov_orientation == FovOrientation.VERTICAL:
        uv = uv / viewport[1]
    elif settings.fov_orientation == FovOrientation.HORIZONTAL:
        uv = uv / viewport[0]
    else:
        uv = uv / jnp.sqrt(jnp.sum(viewport * viewport))

    proj = settings.projection_type
    if proj == ProjectionType.PANINI:
        d = panini_dir(
            uv, settings.fov, settings.panini_distance, settings.vertical_compression
        )
    elif proj == ProjectionType.PERSPECTIVE:
        d = pinhole_dir(uv, settings.fov)
    elif proj == ProjectionType.FISHEYE:
        d = fisheye_dir(uv, settings.fov)
    else:  # orthographic
        d = jnp.broadcast_to(
            jnp.array([0.0, 0.0, -1.0], jnp.float32), uv.shape[:-1] + (3,)
        )

    # sampleLens (render.ts:740-747): always draws random_2.
    t2, state = rng.random_2(state)
    if settings.lens_shape == LensShape.CIRCLE:
        lens = rng.sample_incircle(t2)
    else:
        lens = rng.sample_insquare(t2)

    # thinLensRay (render.ts:695-702). Strict products (ops/strictf.py):
    # the lens/focus muls feed subtractions a backend may contract to
    # FMAs, diverging 1 ulp from the scalar evaluation.
    from .strictf import smul as _smul2

    o = jnp.concatenate(
        [
            _smul2(lens, settings.circle_of_confusion),
            jnp.zeros_like(lens[..., :1]),
        ],
        axis=-1,
    )
    focus = _smul2(-d, _det_div(settings.focus_distance, d[..., 2:3]))
    d = _normalize(focus - o)

    if proj == ProjectionType.ORTHOGRAPHIC:
        # cameraRayPosition (render.ts:724-729)
        fov_distance = settings.fov / jnp.pi * 4.0
        o = o + _smul2(
            jnp.concatenate([uv, jnp.zeros_like(uv[..., :1])], axis=-1),
            fov_distance,
        )

    # ray_transform (render.ts:731-738), expanded to strict elementwise
    # mul/adds: a small matmul may run at reduced precision (TF32 on a
    # GPU at DEFAULT precision) with another accumulation order than the
    # CPU — unacceptable for the transform every ray goes through.
    def _mat_vec(mat, v3, w):  # rows of (4,4) or (3,3) mat · [v3, w]
        cols = []
        for j in range(mat.shape[0]):
            acc = _smul2(v3[..., 0], mat[j, 0])
            acc = acc + _smul2(v3[..., 1], mat[j, 1])
            acc = acc + _smul2(v3[..., 2], mat[j, 2])
            if w is not None:
                acc = acc + w * mat[j, 3]
            cols.append(acc)
        return jnp.stack(cols, axis=-1)

    oh = _mat_vec(view, o, jnp.ones_like(o[..., 0]))  # (R, 4)
    o_w = oh[..., :3]
    d = _normalize(
        jnp.concatenate(
            [d[..., :2], _smul2(d[..., 2:3], oh[..., 3:4])], axis=-1
        )
    )
    d_w = _mat_vec(view[:3, :3], d, None)
    return o_w, d_w, state
