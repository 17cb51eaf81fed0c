"""Stackless BVH traversal over ray batches (pure JAX, jit friendly).

This is the array-program replacement for the reference's per-thread stack
walk (render.ts:433-640). The build threads every preorder tree with skip
links (:mod:`..models.bvh`), so traversal is one uniform loop per ray:

    idx = (node AABB hit and not leaf) ? idx + 1 : skip[idx]

vectorized over a whole ray batch with per-lane ``jnp.take`` gathers — no
stacks, no divergence, fixed-shape state, a single ``lax.while_loop`` whose
trip count is the *maximum* active path length in the batch. Because the
per-model trees are concatenated and chained by their skip links, falling
off one model's subtree lands on the next root, which subsumes the
reference's outer all-models loop (render.ts:456-462).

Semantics preserved from the WGSL: closest-hit tightens the search interval
to the current best t as it goes (render.ts:581-583, 597), leaves test at
most two faces sequentially (render.ts:589-606), and Möller–Trumbore culls
backfaces. Ordered near-child-first descent (render.ts:615-635) is replaced
by t-pruning against the skip-ordered walk — an intentional trade: ordered
descent needs a stack, and uniform control flow is worth more on a vector
machine than the ~25% extra node visits.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import F32_MAX
from ..models.scene import SceneTables
from .intersect import ray_aabb, ray_triangle, safe_inv_dir


class Hit(NamedTuple):
    t: jnp.ndarray  # (R,) f32; best hit distance (== initial t_max if miss)
    u: jnp.ndarray  # (R,) f32 barycentric
    v: jnp.ndarray  # (R,) f32 barycentric
    face: jnp.ndarray  # (R,) i32 global face index, -1 on miss

    @property
    def hit(self):
        return self.face >= 0


def trace_closest(
    o: jnp.ndarray,  # (R, 3)
    d: jnp.ndarray,  # (R, 3)
    t_max: jnp.ndarray,  # (R,) search upper bound (hit-distance predictor)
    tables: SceneTables,
    active: jnp.ndarray | None = None,  # (R,) bool; inactive lanes skip work
) -> Hit:
    """Closest-hit query (reference rayIntersectBVH render.ts:447-465)."""
    r = o.shape[0]
    n = tables.n_nodes
    inv_d = safe_inv_dir(d)

    if active is None:
        active = jnp.ones((r,), dtype=bool)
    idx0 = jnp.where(active, 0, n).astype(jnp.int32)

    def cond(s):
        return jnp.any(s[0] < n)

    def body(s):
        idx, t, u, v, face = s
        idxc = jnp.minimum(idx, n - 1)
        box = jnp.take(tables.node_box, idxc, axis=0)  # (R, 8)
        meta = jnp.take(tables.node_meta, idxc, axis=0)  # (R, 4)
        in_tree = idx < n

        box_hit, _near = ray_aabb(o, inv_d, box[:, 0:3], box[:, 3:6], t)
        box_hit = box_hit & in_tree
        skip = meta[:, 0]
        f0 = meta[:, 1]
        f1 = meta[:, 2]
        is_leaf = f0 >= 0
        at_leaf = box_hit & is_leaf

        def leaf_tests(args):
            t, u, v, face = args
            for fi in (f0, f1):
                fic = jnp.maximum(fi, 0)
                tri = jnp.take(tables.tri, fic, axis=0)  # (R, 9)
                th = ray_triangle(
                    o, d, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], 0.0, t
                )
                ok = at_leaf & (fi >= 0) & th.hit
                t = jnp.where(ok, th.t, t)
                u = jnp.where(ok, th.u, u)
                v = jnp.where(ok, th.v, v)
                face = jnp.where(ok, fi, face)
            return t, u, v, face

        # Skip the two triangle gathers entirely on steps where no lane
        # sits at a hit leaf (common near the tree top).
        t, u, v, face = jax.lax.cond(
            jnp.any(at_leaf), leaf_tests, lambda a: a, (t, u, v, face)
        )

        nxt = jnp.where(box_hit & ~is_leaf, idx + 1, skip)
        idx = jnp.where(in_tree, nxt, idx).astype(jnp.int32)
        return idx, t, u, v, face

    init = (
        idx0,
        t_max.astype(jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.full((r,), -1, jnp.int32),
    )
    _, t, u, v, face = jax.lax.while_loop(cond, body, init)
    return Hit(t=t, u=u, v=v, face=face)


def trace_any(
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_max: jnp.ndarray,
    tables: SceneTables,
    active: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Any-hit query (reference rayIntersectBVHAnyHit render.ts:468-480).
    Returns (R,) bool. Lanes stop traversing as soon as they find a hit."""
    r = o.shape[0]
    n = tables.n_nodes
    inv_d = safe_inv_dir(d)
    if active is None:
        active = jnp.ones((r,), dtype=bool)
    idx0 = jnp.where(active, 0, n).astype(jnp.int32)

    def cond(s):
        idx, hit = s
        return jnp.any((idx < n) & ~hit)

    def body(s):
        idx, hit = s
        idxc = jnp.minimum(idx, n - 1)
        box = jnp.take(tables.node_box, idxc, axis=0)
        meta = jnp.take(tables.node_meta, idxc, axis=0)
        in_tree = (idx < n) & ~hit

        box_hit, _ = ray_aabb(o, inv_d, box[:, 0:3], box[:, 3:6], t_max)
        box_hit = box_hit & in_tree
        f0 = meta[:, 1]
        f1 = meta[:, 2]
        is_leaf = f0 >= 0
        at_leaf = box_hit & is_leaf

        def leaf_tests(hit):
            for fi in (f0, f1):
                fic = jnp.maximum(fi, 0)
                tri = jnp.take(tables.tri, fic, axis=0)
                th = ray_triangle(
                    o, d, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], 0.0, t_max
                )
                hit = hit | (at_leaf & (fi >= 0) & th.hit)
            return hit

        hit = jax.lax.cond(jnp.any(at_leaf), leaf_tests, lambda h: h, hit)
        nxt = jnp.where(box_hit & ~is_leaf, idx + 1, meta[:, 0])
        idx = jnp.where(in_tree, nxt, idx).astype(jnp.int32)
        return idx, hit

    _, hit = jax.lax.while_loop(
        cond, body, (idx0, jnp.zeros((r,), dtype=bool))
    )
    return hit
