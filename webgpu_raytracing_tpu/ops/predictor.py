"""Hit-distance prediction from the previous frame's G-buffer.

The reference's ``pixelHitDist`` (render.ts:1121-1141) uses subgroup quads:
each pixel re-tests the 4 previous-frame hit faces of its 2×2 quad
(``objectFaceHit``) and uses the nearest re-hit (+EPSILON) to bound the
primary ray's BVH traversal. Array shape: the "quad" is an explicit 2×2
pixel block; the 4 candidate faces per pixel come from one reshape, and
each gets a direct Möller–Trumbore re-test (no BVH traversal — any hit is
already a valid upper bound on the closest hit, which is all the bound
needs to be)."""

from __future__ import annotations

import jax.numpy as jnp

from ..config import EPSILON, F32_MAX
from ..models.scene import SceneTables
from .intersect import ray_triangle


def quad_faces(prev_geo_face: jnp.ndarray) -> jnp.ndarray:
    """(H, W) int32 face ids → (H, W, 4): the 2×2-block faces of each
    pixel (the reference's quadBroadcast of all four lanes,
    render.ts:1440-1446). Odd dimensions are padded with -1 (no candidate)
    — matching the GPU, where out-of-image quad lanes are inactive."""
    h, w = prev_geo_face.shape
    hp, wp = h + (h % 2), w + (w % 2)
    padded = jnp.pad(
        prev_geo_face, ((0, hp - h), (0, wp - w)), constant_values=-1
    )
    blocks = padded.reshape(hp // 2, 2, wp // 2, 2)
    quad = blocks.transpose(0, 2, 1, 3).reshape(hp // 2, wp // 2, 4)
    quad = jnp.repeat(jnp.repeat(quad, 2, axis=0), 2, axis=1)
    return quad[:h, :w]


def predict_hit_dist(
    o: jnp.ndarray,  # (R, 3)
    d: jnp.ndarray,  # (R, 3)
    prev_quad_faces: jnp.ndarray,  # (R, 4) int32 candidate faces (-1 none)
    tables: SceneTables,
) -> jnp.ndarray:
    """pixelHitDist (render.ts:1121-1141): min over quad candidates of the
    re-tested hit distance, + EPSILON; F32_MAX when nothing re-hits."""
    best = jnp.full(o.shape[:-1], F32_MAX, jnp.float32)
    prev_face = jnp.full(o.shape[:-1], -1, jnp.int32)
    for k in range(4):
        fi = prev_quad_faces[..., k]
        # skip duplicate consecutive candidates (render.ts:1130-1132)
        fresh = (fi >= 0) & (fi != prev_face)
        fic = jnp.maximum(fi, 0)
        tri = jnp.take(tables.tri, fic, axis=0)
        th = ray_triangle(
            o, d, tri[..., 0:3], tri[..., 3:6], tri[..., 6:9], 0.0,
            best + EPSILON,
        )
        ok = fresh & th.hit
        best = jnp.where(ok, th.t, best)
        prev_face = fi
    return jnp.where(best < F32_MAX, best + EPSILON, best)
