"""Screen-space quad derivatives (reference K12, render.ts:943-1007).

The WGSL uses subgroup ``quadSwapX``/``quadSwapY`` to difference values
across 2×2 quads; the array-program equivalent is an axis roll within even/odd pixel
pairs of an (H, W, ...) array — one vectorized shuffle, no subgroups
needed. Sign convention matches the reference: the derivative is oriented
so both lanes of a pair get the same forward difference."""

from __future__ import annotations

import jax.numpy as jnp


def quad_swap_x(v: jnp.ndarray) -> jnp.ndarray:
    """Swap each pixel with its horizontal quad partner; v is (H, W, ...)."""
    h, w = v.shape[0], v.shape[1]
    pairs = v.reshape(h, w // 2, 2, *v.shape[2:])
    return pairs[:, :, ::-1].reshape(v.shape)


def quad_swap_y(v: jnp.ndarray) -> jnp.ndarray:
    """Swap each pixel with its vertical quad partner."""
    h, w = v.shape[0], v.shape[1]
    pairs = v.reshape(h // 2, 2, w, *v.shape[2:])
    return pairs[:, ::-1].reshape(v.shape)


def dfdx(v: jnp.ndarray) -> jnp.ndarray:
    """dFdx1..4 (render.ts:944-998): p - quadSwapX(p), negated on the even
    lane so both lanes carry right-minus-left."""
    d = v - quad_swap_x(v)
    w = v.shape[1]
    col = jnp.arange(w) % 2  # 0 = even lane (quadIdx 0/2)
    sign = jnp.where(col == 0, -1.0, 1.0)
    sign = sign.reshape((1, w) + (1,) * (v.ndim - 2))
    return d * sign


def dfdy(v: jnp.ndarray) -> jnp.ndarray:
    """dFdy1..4: p - quadSwapY(p), negated on the top lane."""
    d = v - quad_swap_y(v)
    h = v.shape[0]
    row = jnp.arange(h) % 2
    sign = jnp.where(row == 0, -1.0, 1.0)
    sign = sign.reshape((h, 1) + (1,) * (v.ndim - 2))
    return d * sign
