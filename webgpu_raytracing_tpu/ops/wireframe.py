"""Debug BVH wireframe (reference K17, render.ts:1517-1630).

The reference instanced-draws 12 line-list edges per BVH AABB with an
additive-ish blend (each fragment adds 0.01). The equivalent here is a
vectorized line rasterizer: project all 8 corners of every node AABB with
the view-projection matrix, clip, and accumulate the 12 edges of every box
into an (H, W) intensity buffer with a fixed number of samples per edge —
a scatter-add, the natural XLA shape for additive blending."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# edge list over the 8 corner indices (bit k of the corner index selects
# min/max on axis k) — the same 12 cube edges as render.ts:1568-1592
_EDGES = np.array(
    [
        (0, 1), (1, 5), (5, 4), (0, 4),  # bottom ring
        (2, 3), (3, 7), (7, 6), (2, 6),  # top ring
        (0, 2), (1, 3), (5, 7), (4, 6),  # verticals
    ],
    dtype=np.int32,
)

LINE_INTENSITY = 0.01  # fragment output (render.ts:1599)
_SAMPLES_PER_EDGE = 64


def rasterize_bvh_wireframe(
    node_min: jnp.ndarray,  # (N, 3)
    node_max: jnp.ndarray,  # (N, 3)
    view_proj: jnp.ndarray,  # (4, 4) perspectiveZO * inverse(view)
    width: int,
    height: int,
) -> jnp.ndarray:
    """Returns an (H, W) additive intensity image of all node AABB edges."""
    n = node_min.shape[0]
    # corners: (N, 8, 3)
    sel = jnp.asarray(
        np.array(
            [[(c >> k) & 1 for k in range(3)] for c in range(8)], np.float32
        )
    )  # (8, 3) 0→min, 1→max
    corners = (
        node_min[:, None, :] * (1.0 - sel)[None] + node_max[:, None, :] * sel[None]
    )

    hom = jnp.concatenate(
        [corners, jnp.ones((n, 8, 1), jnp.float32)], axis=-1
    )
    # HIGHEST: a default-precision f32 product may run in TF32 on a GPU
    clip = jnp.matmul(
        hom, view_proj.T, precision=jax.lax.Precision.HIGHEST
    )  # (N, 8, 4)

    e = jnp.asarray(_EDGES)
    a = clip[:, e[:, 0], :]  # (N, 12, 4)
    b = clip[:, e[:, 1], :]

    ts = jnp.linspace(0.0, 1.0, _SAMPLES_PER_EDGE, dtype=jnp.float32)
    pts = a[:, :, None, :] * (1 - ts[None, None, :, None]) + b[
        :, :, None, :
    ] * ts[None, None, :, None]  # (N, 12, S, 4)
    pts = pts.reshape(-1, 4)

    w_c = pts[:, 3]
    valid = w_c > 1e-6
    ndc = pts[:, :3] / jnp.maximum(w_c, 1e-6)[:, None]
    # z in [0, 1] (perspectiveZO), x/y in [-1, 1]; y up in clip space →
    # screen row = (1 - y)/2 * H when displayed top-down
    xs = ((ndc[:, 0] + 1.0) * 0.5 * width).astype(jnp.int32)
    ys = ((1.0 - ndc[:, 1]) * 0.5 * height).astype(jnp.int32)
    valid = (
        valid
        & (ndc[:, 2] >= 0.0)
        & (ndc[:, 2] <= 1.0)
        & (xs >= 0)
        & (xs < width)
        & (ys >= 0)
        & (ys < height)
    )
    flat_idx = jnp.where(valid, ys * width + xs, 0)
    contrib = jnp.where(valid, LINE_INTENSITY, 0.0)
    img = jnp.zeros((height * width,), jnp.float32)
    img = img.at[flat_idx].add(contrib)
    return img.reshape(height, width)


def overlay_wireframe(display: jnp.ndarray, wire: jnp.ndarray) -> jnp.ndarray:
    """Blend the wireframe over a display image like the reference's
    one / one-minus-src-alpha pass with per-fragment alpha 0.01
    (render.ts:1604-1615)."""
    alpha = jnp.clip(wire, 0.0, 1.0)[..., None]
    return display * (1.0 - alpha) + jnp.clip(wire, 0.0, 1.0)[..., None]
