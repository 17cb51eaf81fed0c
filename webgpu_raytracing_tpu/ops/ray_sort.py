"""Ray reordering for traversal coherence — the bounce-segment path.

Bounce rays are incoherent in pixel order: the rays of one tile
collectively enter many more clusters than each ray needs. Sorting rays
by their *two nearest hit clusters* groups rays that start traversal in
the same part of the scene, so a tile's clusters mostly serve all of its
rays. Every trace result is grouping-independent (tested); only the work
per tile changes.

This is the renderer's wavefront-compaction analog as well (BASELINE
config #5): dead lanes (Russian-roulette kills, misses) sort to the back,
so whole trailing tiles carry ``t_max = 0`` and exit their round loops
immediately (or are not traced at all — ``sorted_trace(live_slice=…)``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import F32_MAX, MIN_DIST
from .intersect import safe_inv_dir

_INF = float(F32_MAX)


def nearest_cluster_key(
    o: jnp.ndarray,  # (R, 3)
    d: jnp.ndarray,  # (R, 3)
    t_max: jnp.ndarray,  # (R,) 0 for dead lanes
    boxes: jnp.ndarray,  # (C, 6)
    chunk: int = 65536,
) -> jnp.ndarray:
    """Coherence key: ``cid0 * (C+1) + cid1`` of the ray's two nearest-entry
    hit boxes (cid = C when fewer than 1/2 boxes are hit, sorting dead
    and miss rays to the back). Computed with the same dense slab test the
    tracer's near pass uses. The key only orders rays: trace results never
    depend on it. ``sorted_trace``'s ``live_slice`` does rely on its miss
    class — a ray keyed as a miss enters none of ``boxes`` (for two-level
    tables these are the super boxes, which contain every child box)."""
    r = o.shape[0]
    c = boxes.shape[0]
    chunk = min(chunk, max(128, -(-r // 128) * 128))
    inv_d = safe_inv_dir(d)

    def per_chunk(args):
        oc, ic, tc = args
        # per-axis accumulation keeps temporaries 2-D (chunk, C); a
        # (chunk, C, 3) broadcast de-fuses into multi-GB traffic
        near = jnp.full((oc.shape[0], c), -_INF, jnp.float32)
        far = jnp.full((oc.shape[0], c), _INF, jnp.float32)
        for ax in range(3):
            t0 = (boxes[None, :, ax] - oc[:, ax : ax + 1]) * ic[:, ax : ax + 1]
            t1 = (
                boxes[None, :, 3 + ax] - oc[:, ax : ax + 1]
            ) * ic[:, ax : ax + 1]
            near = jnp.maximum(near, jnp.minimum(t0, t1))
            far = jnp.minimum(far, jnp.maximum(t0, t1))
        hit = (near < far) & (near < tc[:, None]) & (far > MIN_DIST)
        nears = jnp.where(hit, jnp.maximum(near, 0.0), _INF)
        iota = jax.lax.broadcasted_iota(jnp.int32, nears.shape, 1)
        # pack (near, cid) into one sortable int32 (cid in the mantissa
        # LSBs): each "nearest" pick is ONE min-reduce instead of min +
        # argmin-probe chains. Near-ties within the truncation granularity
        # break toward the lower cid.
        cbits = max(1, (c - 1).bit_length())
        kmask = (1 << cbits) - 1
        import numpy as _np

        miss_th = int(_np.float32(_INF).view(_np.int32)) & ~kmask
        pk = (
            jax.lax.bitcast_convert_type(nears, jnp.int32) & ~kmask
        ) | iota  # (chunk, C)
        key = jnp.zeros((oc.shape[0],), jnp.int32)
        for _ in range(2):  # two nearest clusters, lexicographic
            k = jnp.min(pk, axis=1)  # (chunk,)
            cid = jnp.where((k & ~kmask) < miss_th, k & kmask, c)
            key = key * (c + 1) + cid
            pk = jnp.where(pk == k[:, None], jnp.int32(0x7FFFFFFF), pk)
        return key

    pad = (-r) % chunk
    if pad:
        o = jnp.concatenate([o, jnp.ones((pad, 3), o.dtype)])
        inv_d = jnp.concatenate([inv_d, jnp.ones((pad, 3), o.dtype)])
        t_max = jnp.concatenate([t_max, jnp.zeros((pad,), t_max.dtype)])
    n_chunks = (r + pad) // chunk
    args = (
        o.reshape(n_chunks, chunk, 3),
        inv_d.reshape(n_chunks, chunk, 3),
        t_max.reshape(n_chunks, chunk),
    )
    keys = jax.lax.map(per_chunk, args).reshape(-1)[:r]
    return keys


def _pack_cols(tree):
    """Flatten a pytree of (R,)/(R, k) 4-byte-dtype arrays into one
    (R, L) int32 matrix (bitcast; bool widens to i32), so a permutation
    is one wide row op instead of one op per leaf."""
    import numpy as _np

    leaves, treedef = jax.tree.flatten(tree)
    arrs = [jnp.asarray(x) for x in leaves]
    cols, specs = [], []
    for x in arrs:
        shp = x.shape
        n = 1 if x.ndim == 1 else int(_np.prod(shp[1:]))
        xi = x.reshape(shp[0], n)
        if xi.dtype == jnp.bool_:
            xi = xi.astype(jnp.int32)
        elif xi.dtype != jnp.int32:
            xi = jax.lax.bitcast_convert_type(xi, jnp.int32)
        specs.append((x.dtype, shp))
        cols.append(xi)
    return jnp.concatenate(cols, axis=1), specs, treedef


def _unpack_cols(packed, specs, treedef):
    import numpy as _np

    out, j = [], 0
    for dtype, shp in specs:
        n = 1 if len(shp) == 1 else int(_np.prod(shp[1:]))
        xi = packed[:, j : j + n]
        j += n
        if dtype == jnp.bool_:
            x = xi != 0
        elif dtype != jnp.int32:
            x = jax.lax.bitcast_convert_type(xi, dtype)
        else:
            x = xi
        # row count comes from the packed matrix, not the spec
        out.append(x.reshape((packed.shape[0],) + shp[1:]))
    return jax.tree.unflatten(treedef, out)


def permute_rows(rid_s, tree):
    """Gather every (R, ...) leaf of ``tree`` to sorted order in ONE
    packed (R, L) row gather (the segment-sorted wavefront's only
    per-segment permutation op)."""
    packed, specs, td = _pack_cols(tree)
    return _unpack_cols(jnp.take(packed, rid_s, axis=0), specs, td)


def scatter_rows(orig, tree):
    """Inverse of the accumulated permutation: row j of ``tree`` lands at
    original index ``orig[j]`` — one packed (R, L) scatter."""
    packed, specs, td = _pack_cols(tree)
    out = jnp.zeros_like(packed).at[orig].set(packed)
    return _unpack_cols(out, specs, td)


def _to_cols(tree):
    """Pytree of (R,)/(R, k) 4-byte leaves → list of (R,) i32 columns +
    reassembly spec (bool widens; f32 bitcasts)."""
    import numpy as _np

    leaves, treedef = jax.tree.flatten(tree)
    cols, specs = [], []
    for x in (jnp.asarray(v) for v in leaves):
        shp = x.shape
        n = 1 if x.ndim == 1 else int(_np.prod(shp[1:]))
        xi = x.reshape(shp[0], n)
        if xi.dtype == jnp.bool_:
            xi = xi.astype(jnp.int32)
        elif xi.dtype != jnp.int32:
            xi = jax.lax.bitcast_convert_type(xi, jnp.int32)
        specs.append((x.dtype, shp, n))
        cols.extend(xi[:, j] for j in range(n))
    return cols, specs, treedef


def _from_cols(cols, specs, treedef):
    out, j = [], 0
    for dtype, shp, n in specs:
        xi = jnp.stack(cols[j : j + n], axis=-1)
        j += n
        if dtype == jnp.bool_:
            x = xi != 0
        elif dtype != jnp.int32:
            x = jax.lax.bitcast_convert_type(xi, dtype)
        else:
            x = xi
        out.append(x.reshape(shp))
    return jax.tree.unflatten(treedef, out)


def sorted_trace(trace_fn, o, d, t_max, tables, active=None, extra=None,
                 live_slice=None, tail=None):
    """Run ``trace_fn(o, d, t_max, tables, active)`` with rays permuted by
    the nearest-cluster key; every (R,)-leading leaf of the result is
    restored to original ray order. ``lax.sort`` is stable, so the
    permutation (and the traced image) is deterministic. The ``active``
    mask is folded into ``t_max`` (dead lane ⇒ empty interval).

    ``live_slice`` (static float < 1) slices the TRACE to the leading
    ``live_slice * r`` rows of the sorted stream: rays with no entered
    cluster — dead lanes (RR kills, prior misses) and live rays whose
    line hits no cluster box — key to the miss class at the BACK of
    the sort, and their result is already known. The slice is exact:
    the cond predicate counts non-miss keys, the sliced branch
    concatenates ``tail(tm_s[w:])`` (the caller's miss constructor),
    and slicing at a 128-multiple preserves every surviving tile's ray
    grouping bit-for-bit; overflow runs the full-width branch.

    Both permutation legs ride the sort itself: the forward leg is ONE
    stable sort of (key | rid | ray columns), and the unsort is ONE sort
    of (rid_s | result columns) — rid_s is a permutation, so sorting by
    it restores pixel order exactly, with no separate gather or
    scatter."""
    r = o.shape[0]
    if active is not None:
        t_max = jnp.where(active, t_max, 0.0)
    # two-level tables sort by the SUPER boxes: same coherence signal at
    # a fraction of the dense-test cost (C2 ≈ C/group boxes per ray)
    key = nearest_cluster_key(o, d, t_max, tables.clusters.sort_box)
    rid = jnp.arange(r, dtype=jnp.int32)
    in_cols, in_specs, in_td = _to_cols(
        (o, d, t_max) if extra is None else (o, d, t_max, extra)
    )
    sorted_ops = jax.lax.sort(
        tuple([key, rid] + in_cols), num_keys=1, is_stable=True
    )
    rid_s = sorted_ops[1]
    ins = _from_cols(list(sorted_ops[2:]), in_specs, in_td)
    if extra is None:
        o_s, d_s, tm_s = ins
        ex_s = None
    else:
        o_s, d_s, tm_s, ex_s = ins

    def run_at(width):
        args = (o_s[:width], d_s[:width], tm_s[:width], tables, None)
        if extra is not None:
            args = args + (ex_s[:width],)
        return trace_fn(*args)

    w = r
    if live_slice is not None and tail is not None and live_slice < 1.0:
        w = min(r, ((int(r * live_slice) + 127) // 128) * 128)
    if w < r:
        # miss-class threshold: key >= c*(c+1) iff the ray's NEAREST
        # cluster is already the miss sentinel (no entered cluster)
        c = tables.clusters.sort_box.shape[0]
        n_act = jnp.sum(
            (sorted_ops[0] < jnp.int32(c * (c + 1))).astype(jnp.int32)
        )

        def sliced(_):
            res_w = run_at(w)
            return jax.tree.map(
                lambda a, b: jnp.concatenate([a, jnp.asarray(b)]),
                res_w,
                tail(tm_s[w:]),
            )

        res_s = jax.lax.cond(n_act <= w, sliced, lambda _: run_at(r), None)
    else:
        res_s = run_at(r)

    leaves = [jnp.asarray(x) for x in jax.tree.leaves(res_s)]
    sortable = all(
        x.shape[:1] == (r,) and (x.dtype == jnp.bool_ or x.dtype.itemsize == 4)
        for x in leaves
    )
    if sortable:
        out_cols, out_specs, out_td = _to_cols(res_s)
        unsorted = jax.lax.sort(
            tuple([rid_s] + out_cols), num_keys=1, is_stable=False
        )
        return _from_cols(list(unsorted[1:]), out_specs, out_td)

    def unsort(x):
        x = jnp.asarray(x)
        return jnp.zeros(x.shape, x.dtype).at[rid_s].set(x)

    return jax.tree.map(unsort, res_s)
