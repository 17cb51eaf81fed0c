"""Clustered ray tracing — the XLA traversal path.

The scene is cut into clusters of ≤S triangles (models/cluster.py), and
rays are grouped into coherent *tiles*. Each round, every tile picks its
nearest unprocessed cluster (dense box tests, no per-ray tree walk) and
tests all its rays against that cluster's triangles densely; rounds
repeat until every tile has exhausted the clusters that could still beat
its rays' best hits. ``ops/cluster_triton.py`` runs the same schedule as
one GPU kernel with a loop per tile; this module's round loop is global
(one ``while_loop`` over all tiles) and is the path off the GPU.

Candidates are selected with a bilinear form of Möller–Trumbore (one
``(T, 10) @ (10, 4·S)`` product per tile and round), and the two nearest
are re-tested with exact sequential arithmetic, so the decisions follow
the reference's arithmetic rather than the product's.

The Möller–Trumbore algebra (s = o − p0, h = d × e2, w = o × d,
n = e1 × e2, q1 = p0 × e1, q2 = p0 × e2, k0 = p0·n):

    det   = e1 · h       = −(d · n)
    u·1   = s · h        =  w · e2 + d · q2
    v·1   = d · (s × e1) = −(w · e1 + d · q1)
    t·det = e2 · (s × e1) =  o · n − k0

so with the ray matrix A = [o | w | d | 1] (T, 10) and per-cluster
B = (10, 4·64) holding [n-cols | (e2,q2)-cols | −(e1,q1)-cols | (n,−k0)],
``A @ B`` yields det / u_num / v_num / t_num for all 64 triangles at once.
Culling/interval semantics match the reference exactly
(render.ts:359-409): det < ε² rejects (backface + parallel), barycentrics
tested against det before the division, strict positive t interval.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EPSILON, F32_MAX, MIN_DIST
from .intersect import safe_inv_dir
from .traverse import Hit

CLUSTER_SIZE = 64
_EPS2 = EPSILON * EPSILON
_INF = float(F32_MAX)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClusterTables:
    """Device-resident cluster tables (a jit-able pytree).

    Two-level layout (large scenes, models/cluster.py ``group_size``):
    ``super_box`` present, and supercluster ``s`` owns the
    cluster rows ``[s*group, (s+1)*group)`` (pad rows: empty boxes, zero
    matrices). Single-level: None."""

    box: jax.Array  # (C, 6) AABB min/max
    mat_b: jax.Array  # (C, 10, 4*S) the Möller–Trumbore bilinear matrix
    face_id: jax.Array  # (C, S) int32 global face ids (-1 pad)
    super_box: jax.Array | None = None  # (C2, 6)

    @property
    def n_clusters(self) -> int:
        return self.box.shape[0]

    @property
    def sort_box(self) -> jax.Array:
        """Boxes for the ray-coherence sort key (ops/ray_sort.py): the
        supers when present (a dense test over all C child boxes is
        exactly the per-ray cost the two-level layout exists to avoid)."""
        return self.box if self.super_box is None else self.super_box


def pack_cluster_tables(clusters) -> ClusterTables:
    """models.cluster.ClusterSet → ClusterTables (host → device).

    B layout (rows = ray-matrix components [o(0:3) | w(3:6) | d(6:9) | 1]):
      cols [0,S):   det   — rows d ← −n
      cols [S,2S):  t_num — rows o ← n, bias ← −k0
      cols [2S,3S): u_num — rows w ← e2, rows d ← q2
      cols [3S,4S): v_num — rows w ← −e1, rows d ← −q1
    """
    c, s, _ = clusters.n.shape
    b = np.zeros((c, 10, 4 * s), dtype=np.float32)
    nt = np.transpose(clusters.n, (0, 2, 1))
    b[:, 6:9, 0 * s : 1 * s] = -nt
    b[:, 0:3, 1 * s : 2 * s] = nt
    b[:, 9, 1 * s : 2 * s] = -clusters.k0
    b[:, 3:6, 2 * s : 3 * s] = np.transpose(clusters.e2, (0, 2, 1))
    b[:, 6:9, 2 * s : 3 * s] = np.transpose(clusters.q2, (0, 2, 1))
    b[:, 3:6, 3 * s : 4 * s] = -np.transpose(clusters.e1, (0, 2, 1))
    b[:, 6:9, 3 * s : 4 * s] = -np.transpose(clusters.q1, (0, 2, 1))
    import jax.numpy as _jnp

    super_box = (
        None
        if clusters.super_box is None
        else _jnp.asarray(clusters.super_box)
    )

    return ClusterTables(
        box=_jnp.asarray(clusters.box),
        mat_b=_jnp.asarray(b),
        face_id=_jnp.asarray(clusters.face_id),
        super_box=super_box,
    )


def ray_matrix(o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """A = [o | o×d | d | 1] — (R, 10)."""
    w = jnp.cross(o, d)
    ones = jnp.ones(o.shape[:-1] + (1,), o.dtype)
    return jnp.concatenate([o, w, d, ones], axis=-1)


def intersect_cluster_block(
    a: jnp.ndarray,  # (T, 10) ray matrix
    b: jnp.ndarray,  # (10, 4*S) cluster matrix
    best_t: jnp.ndarray,  # (T,)
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Dense ray-block × cluster Möller–Trumbore. Returns
    (t, u, v, slot) of the best triangle per ray (slot == -1 if none
    beats best_t)."""
    s = b.shape[-1] // 4
    out = jnp.dot(a, b, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    det = out[..., 0 * s : 1 * s]
    t_num = out[..., 1 * s : 2 * s]
    u_num = out[..., 2 * s : 3 * s]
    v_num = out[..., 3 * s : 4 * s]

    valid = (
        (det >= _EPS2)
        & (u_num >= 0.0)
        & (u_num <= det)
        & (v_num >= 0.0)
        & (u_num + v_num <= det)
    )
    # true division — WGSL rounding (render.ts:406-408, see intersect.py)
    det_safe = jnp.where(valid, det, 1.0)
    t = t_num / det_safe
    valid = valid & (t > MIN_DIST) & (t < best_t[..., None])

    t_masked = jnp.where(valid, t, _INF)
    slot = jnp.argmin(t_masked, axis=-1)
    t_best = jnp.take_along_axis(t_masked, slot[..., None], axis=-1)[..., 0]
    u_best = jnp.take_along_axis(
        u_num / det_safe, slot[..., None], axis=-1
    )[..., 0]
    v_best = jnp.take_along_axis(
        v_num / det_safe, slot[..., None], axis=-1
    )[..., 0]
    hit = t_best < best_t
    return (
        jnp.where(hit, t_best, best_t),
        u_best,
        v_best,
        jnp.where(hit, slot, -1),
    )


def intersect_cluster_block_top2(
    a: jnp.ndarray,  # (T, 10) ray matrix
    b: jnp.ndarray,  # (10, 4*S) cluster matrix
    best_t: jnp.ndarray,  # (T,)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bilinear-form candidate SELECTION only: the slots of the two
    nearest bilinear-valid triangles per ray (-1 when absent). The exact
    sequential Möller–Trumbore re-test (same arithmetic order as the
    WGSL, render.ts:359-409) adjudicates them outside, so the XLA
    path's knife-edge decisions match the exact-arithmetic reference
    semantics."""
    s = b.shape[-1] // 4
    out = jnp.dot(a, b, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    det = out[..., 0 * s : 1 * s]
    t_num = out[..., 1 * s : 2 * s]
    u_num = out[..., 2 * s : 3 * s]
    v_num = out[..., 3 * s : 4 * s]

    valid = (
        (det >= _EPS2)
        & (u_num >= 0.0)
        & (u_num <= det)
        & (v_num >= 0.0)
        & (u_num + v_num <= det)
    )
    t = t_num / jnp.where(valid, det, 1.0)
    valid = valid & (t > MIN_DIST) & (t < best_t[..., None])
    t_masked = jnp.where(valid, t, _INF)
    slot1 = jnp.argmin(t_masked, axis=-1)
    t1 = jnp.take_along_axis(t_masked, slot1[..., None], axis=-1)[..., 0]
    iota = jax.lax.broadcasted_iota(jnp.int32, t_masked.shape, 1)
    t_masked2 = jnp.where(iota == slot1[..., None], _INF, t_masked)
    slot2 = jnp.argmin(t_masked2, axis=-1)
    t2 = jnp.take_along_axis(t_masked2, slot2[..., None], axis=-1)[..., 0]
    return (
        jnp.where(t1 < _INF, slot1, -1),
        jnp.where(t2 < _INF, slot2, -1),
    )


def _exact_face_eval(o, d, tri, present, t_bound):
    """Exact sequential Möller–Trumbore under the reference's semantics
    (render.ts:359-409): cull, barycentric gates against det, true
    division (vec3(t,u,v)/det), strict t interval vs the running best.
    Contraction-proof arithmetic (ops/strictf.py) so decisions match
    the scalar reference bit-for-bit under jit."""
    from .strictf import scross, sdot3

    p0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    h = scross(d, e2)
    det = sdot3(e1, h)
    sv = o - p0
    u_num = sdot3(sv, h)
    q = scross(sv, e1)
    v_num = sdot3(d, q)
    t_num = sdot3(e2, q)
    culled = det < _EPS2
    bary_ok = (
        (u_num >= 0.0)
        & (u_num <= det)
        & (v_num >= 0.0)
        & (u_num + v_num <= det)
    )
    det_safe = jnp.where(culled, 1.0, det)
    t = t_num / det_safe
    valid = (
        present
        & ~culled
        & bary_ok
        & (t > MIN_DIST)
        & (t < t_bound)
    )
    return valid, t, u_num / det_safe, v_num / det_safe


def tile_nears_fused(
    o: jnp.ndarray,  # (R, 3) — R divisible by tile
    inv_d: jnp.ndarray,  # (R, 3)
    t_max: jnp.ndarray,  # (R,)
    boxes: jnp.ndarray,  # (C, 6)
    tile: int,
    pad_to: int | None = None,
) -> jnp.ndarray:
    """Per-tile per-cluster min entry distance → (R // tile, C), +F32_MAX
    where no ray of the tile enters the box. Per-axis accumulation (no
    ``(…, C, 3)`` stacked temporaries) and a single consumer chain into
    one min-reduce over the ray axis, so XLA fuses the (tile, C) slab
    results into the reduction instead of materializing (R, C) arrays.
    ``pad_to`` pads the cluster axis with +F32_MAX."""
    r = o.shape[0]
    n_tiles = r // tile
    c = boxes.shape[0]

    def chunk_nears(args):
        # one tile; lax.map(batch_size=…) vmaps this over tile batches
        ot, it, tt = args  # (tile, 3), (tile, 3), (tile,)
        near = jnp.full((tile, c), -_INF, jnp.float32)
        far = jnp.full((tile, c), _INF, jnp.float32)
        for ax in range(3):
            t0 = (
                boxes[None, :, ax] - ot[:, ax : ax + 1]
            ) * it[:, ax : ax + 1]
            t1 = (
                boxes[None, :, 3 + ax] - ot[:, ax : ax + 1]
            ) * it[:, ax : ax + 1]
            near = jnp.maximum(near, jnp.minimum(t0, t1))
            far = jnp.minimum(far, jnp.maximum(t0, t1))
        hit = (near < far) & (near < tt[:, None]) & (far > MIN_DIST)
        nears = jnp.where(hit, jnp.maximum(near, 0.0), _INF)
        return jnp.min(nears, axis=0)  # (C,)

    args = (
        o.reshape(n_tiles, tile, 3),
        inv_d.reshape(n_tiles, tile, 3),
        t_max.reshape(n_tiles, tile),
    )
    near_tc = jax.lax.map(
        chunk_nears,
        args,
        batch_size=max(1, min(n_tiles, 16_777_216 // (tile * c))),
    )
    if pad_to is not None and pad_to > c:
        near_tc = jnp.pad(
            near_tc, ((0, 0), (0, pad_to - c)), constant_values=_INF
        )
    return near_tc


def trace_closest_clustered(
    o: jnp.ndarray,  # (R, 3)
    d: jnp.ndarray,  # (R, 3)
    t_max: jnp.ndarray,  # (R,)
    tables,  # SceneTables (needs .clusters: ClusterTables)
    active: jnp.ndarray | None = None,
    tile: int = 1024,
    any_hit: bool = False,
) -> Hit:
    """Closest-hit over coherent ray tiles (drop-in for
    ops.traverse.trace_closest). With ``any_hit`` the rounds stop as soon
    as every ray in a tile has found *some* valid hit — shadow-ray
    semantics (rayIntersectBVHAnyHit, render.ts:468-480); the returned t
    is then any valid hit, not necessarily the closest."""
    ct: ClusterTables = tables.clusters
    r0 = o.shape[0]
    if active is None:
        active = jnp.ones((r0,), bool)
    if r0 % tile:  # pad with inactive rays to a whole number of tiles
        pad = tile - r0 % tile
        o = jnp.concatenate([o, jnp.ones((pad, 3), o.dtype)], axis=0)
        d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)], axis=0)
        t_max = jnp.concatenate([t_max, jnp.zeros((pad,), t_max.dtype)])
        active = jnp.concatenate([active, jnp.zeros((pad,), bool)])
    r = o.shape[0]
    n_tiles = r // tile
    c = ct.n_clusters
    s = ct.face_id.shape[1]

    # NaN bounds (NaN shading points, integrator.offset_ray) hit nothing
    # per ray; zeroing them keeps them out of the tile's max bound
    t_max = jnp.where(active & (t_max > 0.0), t_max, 0.0)

    a_mat = ray_matrix(o, d).reshape(n_tiles, tile, 10)
    inv_d = safe_inv_dir(d)

    # per-tile per-cluster min entry distance (the shortlist source);
    # fused per-axis accumulation — see tile_nears_fused
    near_tc = tile_nears_fused(o, inv_d, t_max, ct.box, tile)  # (n_tiles, C)

    def _tile_bound(best_t, best_slot):
        """Per-tile upper bound on useful cluster entry distances. Closest
        hit: a closer hit may still exist below any ray's best t. Any hit:
        a ray is DONE at its first valid hit — only not-yet-hit rays keep
        their search interval open."""
        if any_hit:
            pending = jnp.where(best_slot >= 0, 0.0, t_max)
            return jnp.max(pending.reshape(n_tiles, tile), axis=1)
        return jnp.max(best_t.reshape(n_tiles, tile), axis=1)

    def cond(state):
        near_tc, best_t, _u, _v, best_slot, _c = state
        # a tile still works while its nearest unprocessed cluster could
        # beat some ray's current best (closest) / first hit (any)
        return jnp.any(jnp.min(near_tc, axis=1) < _tile_bound(best_t, best_slot))

    fid_flat = ct.face_id.reshape(-1)

    def body(state):
        near_tc, best_t, best_u, best_v, best_slot, best_cid = state
        cid = jnp.argmin(near_tc, axis=1)  # (n_tiles,)
        cnear = jnp.take_along_axis(near_tc, cid[:, None], axis=1)[:, 0]
        tile_act = cnear < _tile_bound(best_t, best_slot)  # (n_tiles,)

        b = jnp.take(ct.mat_b, cid, axis=0)  # (n_tiles, 10, 4S)
        # bilinear-form candidate selection, exact sequential
        # re-adjudication of the top-2 — knife-edge decisions then match
        # the reference's arithmetic, not the product decomposition's
        slot1, slot2 = jax.vmap(intersect_cluster_block_top2)(
            a_mat, b, best_t.reshape(n_tiles, tile)
        )
        cid_r = jnp.broadcast_to(cid[:, None], (n_tiles, tile)).reshape(r)
        slot1 = slot1.reshape(r)
        slot2 = slot2.reshape(r)

        def tri_of(slot):
            f = jnp.where(slot >= 0, cid_r * s + jnp.maximum(slot, 0), 0)
            return jnp.take(
                tables.tri,
                jnp.take(fid_flat, f),
                axis=0,
            )

        v1, t1, u1, w1 = _exact_face_eval(
            o, d, tri_of(slot1), slot1 >= 0, best_t
        )
        v2, t2, u2, w2 = _exact_face_eval(
            o, d, tri_of(slot2), slot2 >= 0, best_t
        )
        pick2 = v2 & (~v1 | (t2 < t1))
        improved = (
            (v1 | v2)
            & jnp.broadcast_to(tile_act[:, None], (n_tiles, tile)).reshape(r)
        )
        best_t = jnp.where(improved, jnp.where(pick2, t2, t1), best_t)
        best_u = jnp.where(improved, jnp.where(pick2, u2, u1), best_u)
        best_v = jnp.where(improved, jnp.where(pick2, w2, w1), best_v)
        best_slot = jnp.where(
            improved, jnp.where(pick2, slot2, slot1), best_slot
        )
        best_cid = jnp.where(improved, cid_r, best_cid)
        # mark processed (also for inactive tiles: their nearest cluster
        # can never matter again, since max_best only decreases)
        near_tc = near_tc.at[jnp.arange(n_tiles), cid].set(_INF)
        return near_tc, best_t, best_u, best_v, best_slot, best_cid

    init = (
        near_tc,
        t_max.astype(jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.int32),
    )
    _, best_t, best_u, best_v, best_slot, best_cid = jax.lax.while_loop(
        cond, body, init
    )

    face = jnp.where(
        best_slot >= 0,
        jnp.take(
            ct.face_id.reshape(-1),
            best_cid * s + jnp.maximum(best_slot, 0),
        ),
        -1,
    ).astype(jnp.int32)
    return Hit(
        t=best_t[:r0], u=best_u[:r0], v=best_v[:r0], face=face[:r0]
    )


def trace_any_clustered(
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_max: jnp.ndarray,
    tables,
    active: jnp.ndarray | None = None,
    tile: int = 1024,
) -> jnp.ndarray:
    """Any-hit query (shadow rays, rayIntersectBVHAnyHit
    render.ts:468-480). Same machinery with early-exit rounds: a tile
    stops as soon as every live ray has *some* valid hit."""
    hit = trace_closest_clustered(
        o, d, t_max, tables, active, tile, any_hit=True
    )
    return hit.face >= 0
