"""Clustered closest-hit / any-hit traversal as one Pallas kernel (Triton
route, ``backend="triton"``), one program per ray tile.

The XLA path (``cluster_trace.trace_closest_clustered``) runs ONE global
round loop: its ``cond`` is a ``jnp.any`` over all tiles, so every
iteration repeats every tile's work at full width until the slowest tile
is done, and each round's per-tile products round-trip through device
memory. Here each program owns one tile of ``tile`` rays and runs its
own loop, so a tile that finishes after one cluster costs one cluster:

* the program loads its rays and walks the clusters in ascending order
  of the tile's entry distance (the dense per-tile near row from
  ``cluster_trace.tile_nears_fused``; each round scans the row for the
  next ``(near, cid)`` after the last one processed, in chunks);
* it stops on its own tile bound, as ``cluster_trace`` does: closest hit
  while the next entry distance is below the largest best ``t`` of the
  tile, any hit while it is below the largest ``t_max`` of a ray that
  has not hit yet;
* each round tests every ray against the cluster's triangles with exact
  f32 Möller–Trumbore in the reference's order of operations
  (render.ts:359-409, ``cluster_trace._exact_face_eval``) — no matrix
  product. Every product is formed as ``x*y + z`` with ``z`` a zero the
  compiler cannot see, so contraction can only give ``fma(x, y, 0)``,
  the correctly rounded product (the ``ops/strictf.py`` idiom).

Two-level tables (``ClusterTables.super_box``) are traced through their
child boxes, like the XLA path: ``ct.box`` always carries every cluster
box (pads are inverted-empty), so the dense near row covers both
layouts.

``interpret=True`` runs the same kernel under the Pallas interpreter on
any backend; it is an argument for tests, not a render setting.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import EPSILON, F32_MAX, MIN_DIST
from .intersect import safe_inv_dir
from .traverse import Hit

_EPS2 = EPSILON * EPSILON
_INF = float(F32_MAX)  # the near row's miss sentinel
_BIG = 2**30  # "no cluster" id
# Triangles tested per step of a cluster, and warps per program: with
# 64-ray tiles, the fastest of a sweep over tile {32, 64, 128} x
# triangles {16, 32, 64} x warps {4, 8} on the 2.07M primary rays of a
# 1080p stress1m frame (H100, PERF.md).
_BLK_S = 16
_NUM_WARPS = 8


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _kernel(
    ray_ref, near_ref, tri_ref, t_ref, u_ref, v_ref, code_ref,
    *, n_s: int, blk_s: int, blk_c: int, n_chunks: int, any_hit: bool,
):
    ox, oy, oz = ray_ref[0, :], ray_ref[1, :], ray_ref[2, :]
    dx, dy, dz = ray_ref[3, :], ray_ref[4, :], ray_ref[5, :]
    t_max = ray_ref[6, :]
    z = ray_ref[7, :][:, None]  # runtime zeros: strict products
    tile = t_max.shape[0]
    iota_c = jax.lax.broadcasted_iota(jnp.int32, (blk_c,), 0)
    iota_s = jax.lax.broadcasted_iota(jnp.int32, (tile, blk_s), 1)

    def bound(best_t, best_code):
        if any_hit:
            return jnp.max(jnp.where(best_code >= 0, 0.0, t_max))
        return jnp.max(best_t)

    def next_cluster(last_near, last_cid):
        """Smallest (near, cid) strictly after (last_near, last_cid)."""

        def chunk(k, carry):
            bn, bc = carry
            nv = near_ref[pl.ds(k * blk_c, blk_c)]
            cid = k * blk_c + iota_c
            after = (nv > last_near) | ((nv == last_near) & (cid > last_cid))
            cand = jnp.where(after, nv, jnp.inf)
            m = jnp.min(cand)
            c = jnp.min(jnp.where(after & (cand == m), cid, _BIG))
            # chunks ascend in cid: on a tie the earlier chunk's id wins
            better = m < bn
            return jnp.where(better, m, bn), jnp.where(better, c, bc)

        return jax.lax.fori_loop(
            0, n_chunks, chunk, (jnp.float32(jnp.inf), jnp.int32(_BIG))
        )

    def test_cluster(cid, best):
        best_t, best_u, best_v, best_code = best
        for j in range(n_s // blk_s):
            base = cid * n_s + j * blk_s

            def row(k):
                return tri_ref[k, pl.ds(base, blk_s)][None, :]

            p0x, p0y, p0z = row(0), row(1), row(2)
            e1x, e1y, e1z = row(3), row(4), row(5)
            e2x, e2y, e2z = row(6), row(7), row(8)
            rdx, rdy, rdz = dx[:, None], dy[:, None], dz[:, None]
            # h = d × e2; det = e1·h
            hx = (rdy * e2z + z) - (rdz * e2y + z)
            hy = (rdz * e2x + z) - (rdx * e2z + z)
            hz = (rdx * e2y + z) - (rdy * e2x + z)
            det = ((e1x * hx + z) + (e1y * hy + z)) + (e1z * hz + z)
            # s = o - p0; u = s·h; q = s × e1; v = d·q; t = e2·q
            sx, sy, sz = ox[:, None] - p0x, oy[:, None] - p0y, oz[:, None] - p0z
            u_num = ((sx * hx + z) + (sy * hy + z)) + (sz * hz + z)
            qx = (sy * e1z + z) - (sz * e1y + z)
            qy = (sz * e1x + z) - (sx * e1z + z)
            qz = (sx * e1y + z) - (sy * e1x + z)
            v_num = ((rdx * qx + z) + (rdy * qy + z)) + (rdz * qz + z)
            t_num = ((e2x * qx + z) + (e2y * qy + z)) + (e2z * qz + z)
            culled = det < _EPS2
            det_safe = jnp.where(culled, 1.0, det)
            t = t_num / det_safe
            valid = (
                ~culled
                & (u_num >= 0.0)
                & (u_num <= det)
                & (v_num >= 0.0)
                & (u_num + v_num <= det)
                & (t > MIN_DIST)
                & (t < best_t[:, None])
            )
            t_v = jnp.where(valid, t, jnp.inf)
            t_min = jnp.min(t_v, axis=1)
            slot = jnp.min(
                jnp.where(valid & (t_v == t_min[:, None]), iota_s, _BIG),
                axis=1,
            )
            pick = iota_s == slot[:, None]
            # one-hot sums are exact: every other term is +0
            u_w = jnp.sum(jnp.where(pick, u_num, 0.0), axis=1)
            v_w = jnp.sum(jnp.where(pick, v_num, 0.0), axis=1)
            d_w = jnp.sum(jnp.where(pick, det_safe, 0.0), axis=1)
            hit = t_min < best_t
            d_w = jnp.where(hit, d_w, 1.0)
            best_t = jnp.where(hit, t_min, best_t)
            best_u = jnp.where(hit, u_w / d_w, best_u)
            best_v = jnp.where(hit, v_w / d_w, best_v)
            best_code = jnp.where(hit, cid * n_s + j * blk_s + slot, best_code)
        return best_t, best_u, best_v, best_code

    def cond(state):
        nxt_near, _, best = state
        return nxt_near < bound(best[0], best[3])

    def body(state):
        nxt_near, nxt_cid, best = state
        best = test_cluster(nxt_cid, best)
        nn, nc = next_cluster(nxt_near, nxt_cid)
        return nn, nc, best

    zeros = jnp.zeros((tile,), jnp.float32)
    best0 = (t_max, zeros, zeros, jnp.full((tile,), -1, jnp.int32))
    n0, c0 = next_cluster(jnp.float32(-jnp.inf), jnp.int32(-1))
    _, _, (best_t, best_u, best_v, best_code) = jax.lax.while_loop(
        cond, body, (n0, c0, best0)
    )
    t_ref[...] = best_t
    u_ref[...] = best_u
    v_ref[...] = best_v
    code_ref[...] = best_code


def cluster_tri_soa(tables) -> jnp.ndarray:
    """(9, C*S) triangle rows [p0 | e1 | e2] in cluster-slot order; pad
    slots are all-zero triangles (det = 0 < ε², always culled)."""
    fid = tables.clusters.face_id.reshape(-1)
    tri = jnp.take(tables.tri, jnp.maximum(fid, 0), axis=0)
    return jnp.where(fid[:, None] >= 0, tri, 0.0).T


@functools.partial(
    jax.jit, static_argnames=("tile", "any_hit", "interpret")
)
def trace_clustered_triton(
    o: jnp.ndarray,  # (R, 3)
    d: jnp.ndarray,  # (R, 3)
    t_max: jnp.ndarray,  # (R,)
    tables,  # SceneTables (needs .clusters: ClusterTables)
    active: jnp.ndarray | None = None,
    tile: int = 64,
    any_hit: bool = False,
    interpret: bool = False,
) -> Hit:
    """Drop-in for ``cluster_trace.trace_closest_clustered``. With
    ``any_hit`` a tile stops as soon as every ray has *some* valid hit
    (shadow-ray semantics, rayIntersectBVHAnyHit render.ts:468-480); the
    returned t is then any valid hit, not necessarily the closest.

    ``tile`` is the rays per program (a power of two); rays are padded
    with inactive lanes to a whole number of tiles."""
    if tile <= 0 or tile & (tile - 1):
        raise ValueError(f"trace tile must be a power of two, got {tile}")
    ct = tables.clusters
    r0 = o.shape[0]
    if active is None:
        active = jnp.ones((r0,), bool)
    # NaN bounds (NaN shading points, integrator.offset_ray) hit nothing
    # per ray; zeroing them keeps them out of the tile's max bound
    t_max = jnp.where(active & (t_max > 0.0), t_max, 0.0).astype(jnp.float32)
    pad = (-r0) % tile
    if pad:
        o = jnp.concatenate([o, jnp.ones((pad, 3), o.dtype)])
        d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])
        t_max = jnp.concatenate([t_max, jnp.zeros((pad,), jnp.float32)])
    r = r0 + pad
    n_tiles = r // tile

    n_s = ct.face_id.shape[1]
    blk_s = min(_BLK_S, _pow2_at_least(n_s))
    assert n_s % blk_s == 0, (n_s, blk_s)
    c = ct.n_clusters
    blk_c = min(1024, _pow2_at_least(c))
    cp = -(-c // blk_c) * blk_c

    from .cluster_trace import tile_nears_fused
    from .strictf import szero

    near = tile_nears_fused(
        o, safe_inv_dir(d), t_max, ct.box, tile, pad_to=cp
    )  # (n_tiles, cp), +F32_MAX = miss / pad
    zero = jnp.broadcast_to(szero(), (r,))
    rays = jnp.concatenate(
        [o.T, d.T, t_max[None], zero[None]], axis=0
    ).astype(jnp.float32)  # (8, r)
    tri = cluster_tri_soa(tables)

    kernel = functools.partial(
        _kernel, n_s=n_s, blk_s=blk_s, blk_c=blk_c, n_chunks=cp // blk_c,
        any_hit=any_hit,
    )
    row = pl.BlockSpec((tile,), lambda i: (i,))
    t, u, v, code = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((8, tile), lambda i: (0, i)),
            pl.BlockSpec((None, cp), lambda i: (i, 0)),
            pl.BlockSpec(tri.shape, lambda i: (0, 0)),
        ],
        out_specs=(row, row, row, row),
        out_shape=(
            jax.ShapeDtypeStruct((r,), jnp.float32),
            jax.ShapeDtypeStruct((r,), jnp.float32),
            jax.ShapeDtypeStruct((r,), jnp.float32),
            jax.ShapeDtypeStruct((r,), jnp.int32),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="cluster_trace_triton",
    )(rays, near, tri)

    code = code[:r0]
    face = jnp.where(
        code >= 0,
        jnp.take(ct.face_id.reshape(-1), jnp.maximum(code, 0)),
        -1,
    ).astype(jnp.int32)
    return Hit(t=t[:r0], u=u[:r0], v=v[:r0], face=face)


def trace_any_triton(o, d, t_max, tables, active=None, tile=64, **kw):
    """Any-hit query (shadow rays): True where some valid hit exists."""
    hit = trace_clustered_triton(
        o, d, t_max, tables, active, tile=tile, any_hit=True, **kw
    )
    return hit.face >= 0
