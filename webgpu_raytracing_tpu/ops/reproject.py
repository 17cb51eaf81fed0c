"""Temporal reprojection (reference K10: render.ts:1009-1118 + the
frustum-plane matrix store.ts:129-179, after Jacco Bikker's method).

``reprojection_frustum`` builds a 4×3 matrix of scaled frustum-plane
normals from the previous frame's view matrix; ``reproject_point``
projects a world-space hit point into previous-frame pixel coordinates as
two plane-distance ratios. Validation compares the candidate's
previous-frame G-buffer position to the point; on mismatch a *stochastic
local search* (bounded 128 probes with shrinking step) hunts for the true
source pixel — here a masked ``lax.fori_loop``, the array-program shape of the
reference's data-dependent loop (render.ts:1079-1094). An optional 5×5
bilateral filter blends neighbors by position+color distance
(render.ts:1027-1059)."""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderSettings
from . import rng
from .sampling import sample_bilinear

REPROJECT_THRESHOLD = 1e-8  # render.ts:1062
_BILATERAL_RADIUS = 2
_BILATERAL_SIGMA_POS = 0.01
_BILATERAL_SIGMA_COLOR = 0.01
_BILATERAL_STEP = 0.1


def reprojection_frustum(
    prev_view: np.ndarray, width: int, height: int, fov: float
) -> np.ndarray:
    """store.ts:129-179 → (4, 3) matrix of scaled frustum-plane normals
    for the previous view (host math, float32). Rows: [n_left·W,
    n_bottom·H, n_left+n_right, n_bottom+n_top]; row k dotted with
    (p - prev_view_translation) gives plane distances whose ratios
    d1/(d1+d2) are the previous-frame pixel coordinates (Jacco Bikker's
    reprojection, cited at store.ts:176).

    NOTE: the reference scales its sum vectors as ``forward·(-2·cos(fov))``
    (store.ts:167-168), which only equals ``n1 + n2`` when the plane
    normals happen to satisfy it — at the default 120° horizontal FoV it's
    off by tan(60°), so the reference's reprojection lands off-target and
    leans on its stochastic search to recover. Here the plane sums are
    computed exactly from the corner rays."""
    view = np.asarray(prev_view, dtype=np.float64)
    aspect = height / width
    hfov = fov / 2.0
    tan_hfov = np.tan(hfov)
    w = view[3, 3]
    ray_z = -w / tan_hfov

    def corner_ray(x: float, y: float) -> np.ndarray:
        d = np.array([x, y * aspect, ray_z])
        d = d / np.linalg.norm(d)
        return view[:3, :3] @ d

    # the four frustum side planes through the camera origin; normals
    # point into the frustum
    c_mm, c_pm = corner_ray(-1, -1), corner_ray(1, -1)
    c_mp, c_pp = corner_ray(-1, 1), corner_ray(1, 1)
    def plane(a, b):
        n = np.cross(a, b)
        return n / np.linalg.norm(n)

    n_left = plane(c_mm, c_mp)  # x = -1 edge (pixel x = 0)
    n_right = plane(c_pp, c_pm)  # x = +1 edge
    n_bottom = plane(c_pm, c_mm)  # y = -1 edge (pixel y = 0)
    n_top = plane(c_mp, c_pp)  # y = +1 edge

    return np.stack(
        [
            n_left * width,
            n_bottom * height,
            n_left + n_right,
            n_bottom + n_top,
        ]
    ).astype(np.float32)


def reproject_point(
    p: jnp.ndarray,  # (R, 3) world point
    frustum: jnp.ndarray,  # (4, 3)
    prev_origin: jnp.ndarray,  # (3,) prev view matrix translation column
) -> jnp.ndarray:
    """reprojectPoint (render.ts:1022-1025): duv = M (p - o);
    uv = duv.xy / duv.zw."""
    rel = p - prev_origin[None, :]
    # HIGHEST: a default-precision f32 product may run in TF32 on a GPU
    duv = jnp.matmul(
        rel, frustum.T, precision=jax.lax.Precision.HIGHEST
    )  # (R, 4): left, top, c, d distances
    return duv[..., 0:2] / duv[..., 2:4]


class ReprojectionResult(NamedTuple):
    color: jnp.ndarray  # (R, 4): color sum + sample count (0 = rejected)


def bilateral_filter(
    uv: jnp.ndarray,  # (R, 2)
    p: jnp.ndarray,  # (R, 3)
    c: jnp.ndarray,  # (R, 3)
    prev_image: jnp.ndarray,  # (H, W, 4)
    prev_geo_position: jnp.ndarray,  # (H, W, 3)
) -> jnp.ndarray:
    """render.ts:1031-1059 — 5×5 taps at 0.1-pixel pitch, weights from
    squared position and color distance."""
    color = jnp.zeros(uv.shape[:-1] + (4,), jnp.float32)
    weight = jnp.zeros(uv.shape[:-1] + (1,), jnp.float32)
    for i in range(-_BILATERAL_RADIUS, _BILATERAL_RADIUS + 1):
        for j in range(-_BILATERAL_RADIUS, _BILATERAL_RADIUS + 1):
            tap = uv + jnp.array([i, j], jnp.float32) * _BILATERAL_STEP
            tap_color = sample_bilinear(prev_image, tap)
            valid = tap_color[..., 3:4] > 0.0
            tap_pos = sample_bilinear(prev_geo_position, tap)
            dp = p - tap_pos
            dc = c - tap_color[..., :3] / jnp.maximum(
                tap_color[..., 3:4], 1e-20
            )
            w = jnp.exp(
                -jnp.sum(dp * dp, -1, keepdims=True) / _BILATERAL_SIGMA_POS
                - jnp.sum(dc * dc, -1, keepdims=True) / _BILATERAL_SIGMA_COLOR
            )
            w = jnp.where(valid, w, 0.0)
            color = color + tap_color * w
            weight = weight + w
    return jnp.where(weight > 0.0, color / jnp.maximum(weight, 1e-20), 0.0)


def reproject(
    p: jnp.ndarray,  # (R, 3) current hit points
    c: jnp.ndarray,  # (R, 3) current color (bilateral reference)
    state: jnp.ndarray,  # (R,) uint32 RNG
    frustum: jnp.ndarray,  # (4, 3)
    prev_origin: jnp.ndarray,  # (3,)
    prev_image: jnp.ndarray,  # (H, W, 4)
    prev_geo_position: jnp.ndarray,  # (H, W, 3)
    settings: RenderSettings,
):
    """reproject (render.ts:1064-1117). Returns ((R, 4) color+count with
    0-count meaning rejected, new rng state). Debug tints
    (debug_reprojection) follow the reference's false-coloring."""
    width = jnp.float32(settings.render_width)
    height = jnp.float32(settings.render_height)
    uv = reproject_point(p, frustum, prev_origin)
    inside = (
        (uv[..., 0] >= 0.0)
        & (uv[..., 1] >= 0.0)
        & (uv[..., 0] <= width)
        & (uv[..., 1] <= height)
    )

    def dist2(cand_uv):
        dp = sample_bilinear(prev_geo_position, cand_uv) - p
        return jnp.sum(dp * dp, axis=-1)

    d0 = dist2(uv)

    # stochastic local search (render.ts:1079-1094): 128 probes, step 0.1
    # shrinking by 0.005 every 16 — masked fixed-trip loop.
    def search_body(i, carry):
        min_uv, d, st = carry
        # render.ts:1085-1087 decrements ON i%16==0 including i=0, so
        # probes 0-15 already use 0.095
        step = 0.1 - 0.005 * (i // 16 + 1).astype(jnp.float32)
        t2, st2 = rng.random_2(st)
        # the reference returns before the search for out-of-viewport
        # pixels (render.ts:1067-1073) — no RNG draws there
        active = inside & (d >= REPROJECT_THRESHOLD)
        st = rng.masked_advance(st, st2, active)
        cand = min_uv - rng.sample_insquare(t2) * step
        cd = dist2(cand)
        better = active & (cd < d)
        min_uv = jnp.where(better[..., None], cand, min_uv)
        d = jnp.where(better, cd, d)
        return min_uv, d, st

    min_uv, d, state = jax.lax.fori_loop(
        0, 128, search_body, (uv, d0, state)
    )

    converged = d < REPROJECT_THRESHOLD

    if settings.debug_reprojection:
        # outside → green; unconverged → red(d); converged → uv tint
        out_col = jnp.where(
            inside[..., None],
            jnp.where(
                converged[..., None],
                jnp.concatenate(
                    [
                        jnp.modf(min_uv / 4.0)[0],
                        jnp.ones_like(min_uv[..., :1]),
                        jnp.ones_like(min_uv[..., :1]),
                    ],
                    axis=-1,
                ),
                jnp.stack(
                    [d, jnp.zeros_like(d), jnp.zeros_like(d), jnp.ones_like(d)],
                    axis=-1,
                ),
            ),
            jnp.broadcast_to(
                jnp.array([0, 1, 0, 1], jnp.float32), p.shape[:-1] + (4,)
            ),
        )
        return ReprojectionResult(out_col), state

    if settings.bilateral_filter:
        filtered = bilateral_filter(
            min_uv, p, c, prev_image, prev_geo_position
        )
        fallback = sample_bilinear(prev_image, min_uv)
        color = jnp.where(filtered[..., 3:4] > 0.0, filtered, fallback)
    else:
        color = sample_bilinear(prev_image, min_uv)

    ok = (inside & converged)[..., None]
    return ReprojectionResult(jnp.where(ok, color, 0.0)), state
