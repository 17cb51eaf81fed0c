"""The path integrator — wavefront formulation.

Semantics from the reference megakernel's ``pixelColor``
(render.ts:1167-1212): at most ``maxBounces - 1`` path segments; emission
accumulates into color weighted by throughput; throughput multiplies by
albedo; bounce directions are cosine-weighted (``normalize(n + sphere)``,
rng.ts:88-100); Russian roulette on the max throughput channel
(render.ts:1201-1208); environment radiance on miss (render.ts:1183-1186).

Wavefront shape: instead of one divergent bounce loop per pixel thread,
the whole ray batch advances one segment at a time (a fixed unroll —
``bounces_depth`` is static config), with dead lanes masked. RNG advances
are masked per lane to replicate the SIMT draw order exactly.

Also here: the light-sampling chain (``sampleLights → sampleModel →
sampleFace``, render.ts:849-869) and the ``pointColor`` direct-lighting
estimator (render.ts:1143-1157). In the reference ``pointColor`` is dead
code — the megakernel never calls it — so it is exposed as the optional
``direct`` integrator (BASELINE config #1: "direct lighting only") and via
``RenderSettings.next_event_estimation``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import F32_MAX, INV_PI, RenderSettings, ShadingType
from ..models.scene import SceneTables
from . import detmath, rng
from .envmap import sample_environment
from .traverse import Hit, trace_any, trace_closest


def _resolve_backend(settings) -> str:
    """The traversal backend: ``settings.traversal``, where "auto" is the
    Triton tile kernel on a GPU and the XLA clustered path elsewhere.
    "triton" compiles only for a GPU, so asking for it elsewhere is an
    error rather than a silent fallback."""
    import jax

    backend = settings.traversal
    platform = jax.default_backend()
    if backend == "auto":
        return "triton" if platform == "gpu" else "clustered"
    if backend == "triton" and platform != "gpu":
        raise ValueError(
            f"traversal='triton' needs a GPU; the default backend is "
            f"{platform!r} (use traversal='auto' or 'clustered')"
        )
    if backend not in ("triton", "clustered", "threaded"):
        raise ValueError(f"unknown traversal {backend!r}")
    return backend


def _clustered_fn(backend, settings, any_hit):
    """(o, d, t_max, tables, active) -> Hit for a clustered backend."""
    if backend == "triton":
        from . import cluster_triton

        return functools.partial(
            cluster_triton.trace_clustered_triton,
            tile=settings.trace_tile,
            any_hit=any_hit,
        )
    from .cluster_trace import trace_closest_clustered

    return functools.partial(
        trace_closest_clustered, tile=settings.trace_tile, any_hit=any_hit
    )


def _live_fraction(settings, seg, closest):
    """Static live prefix of a sorted leg (RenderSettings.live_slice):
    later segments are mostly dead or escaping lanes, keyed to the back
    of the sort. None = trace the full width."""
    if not settings.live_slice or seg == 0:
        return None
    if closest:
        return 0.75 if seg == 1 else 0.5
    return 0.375 if seg == 1 else 0.25


def _trace_closest(
    o, d, t_max, tables, settings, active=None, sort=False, seg=0,
):
    """Closest-hit dispatch (static on settings.traversal). ``sort``
    (static) routes the batch through the nearest-cluster ray sort
    (ops/ray_sort.py) — on for incoherent bounce segments, off for camera
    rays, which are already tile-coherent."""
    backend = _resolve_backend(settings)
    if backend == "threaded":
        return trace_closest(o, d, t_max, tables, active)
    fn = _clustered_fn(backend, settings, any_hit=False)
    if not (sort and settings.sort_bounce_rays):
        return fn(o, d, t_max, tables, active)
    from .ray_sort import sorted_trace

    def miss_tail(tm_tail):
        zeros = jnp.zeros(tm_tail.shape, jnp.float32)
        return Hit(
            t=tm_tail, u=zeros, v=zeros,
            face=jnp.full(tm_tail.shape, -1, jnp.int32),
        )

    return sorted_trace(
        fn, o, d, t_max, tables, active,
        live_slice=_live_fraction(settings, seg, closest=True),
        tail=miss_tail,
    )


def _trace_any(o, d, t_max, tables, settings, active=None, sort=False, seg=0):
    """Any-hit dispatch (shadow rays): True where the segment is blocked."""
    backend = _resolve_backend(settings)
    if backend == "threaded":
        return trace_any(o, d, t_max, tables, active)
    hit_fn = _clustered_fn(backend, settings, any_hit=True)

    def fn(o, d, t_max, tables, active):
        return hit_fn(o, d, t_max, tables, active).face >= 0

    if not (sort and settings.sort_bounce_rays):
        return fn(o, d, t_max, tables, active)
    from .ray_sort import sorted_trace

    def clear_tail(tm_tail):
        return jnp.zeros(tm_tail.shape, jnp.bool_)

    return sorted_trace(
        fn, o, d, t_max, tables, active,
        live_slice=_live_fraction(settings, seg, closest=False),
        tail=clear_tail,
    )


_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0


def _bitcast_i32(x):
    import jax

    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _bitcast_f32(x):
    import jax

    return jax.lax.bitcast_convert_type(x, jnp.float32)


def offset_ray(p: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Self-intersection-safe point offset along the geometric normal —
    the reference's WGSL VERBATIM (render.ts:905-917), which has both of
    the Ray-Tracing-Gems ch. 6 ``select`` conditions inverted relative
    to the paper it cites (render.ts:871-875).

    The inversion is replicated deliberately (it was "fixed" in round 1,
    reverted in round 3): for a hit point with a component that is
    EXACTLY ±0.0 and an offset of the opposite sign, the int path
    computes ``bitcast<f32>(0 - ofI)`` = NaN — the reference then traces
    a NaN-origin ray, every box/triangle test fails, and the path falls
    through to the skybox. That event is not epsilon-rare on this scene
    (axis-crossing walls produce exact-zero components at ~1e-3/segment
    rates), so matching the reference's image at equal spp REQUIRES
    reproducing it bit-for-bit. NaN origins are miss-everything in every
    backend here (slab/MT/bilinear gates all compare false), which is
    exactly the reference's behavior.

    :func:`offset_ray_paper` keeps the paper's (correct) version for
    comparison/tests."""
    from .strictf import smul

    of_i = (_INT_SCALE * n).astype(jnp.int32)  # vec3i() truncs toward 0
    p_int = _bitcast_f32(
        _bitcast_i32(p) + jnp.where(p < 0.0, of_i, -of_i)
    )
    p_float = p + smul(jnp.float32(_FLOAT_SCALE), n)
    return jnp.where(jnp.abs(p) < _ORIGIN, p_int, p_float)


def offset_ray_paper(p: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """The Ray Tracing Gems ch. 6 version as published (both selects the
    paper's way round) — NOT reference behavior; kept for tests and as
    documentation of the reference bug."""
    of_i = (_INT_SCALE * n).astype(jnp.int32)
    p_int = _bitcast_f32(
        _bitcast_i32(p) + jnp.where(p < 0.0, -of_i, of_i)
    )
    p_float = p + _FLOAT_SCALE * n
    return jnp.where(jnp.abs(p) < _ORIGIN, p_float, p_int)


def face_point(tri_row: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """facePoint (render.ts:876-882): p0 + e1*u + e2*v from barycentrics.
    Strict products (ops/strictf.py): the result's exact-zero components
    drive offsetRay's NaN behaviour — parity needs bit-equality."""
    from .strictf import szero

    z = szero()
    p0 = tri_row[..., 0:3]
    e1 = tri_row[..., 3:6]
    e2 = tri_row[..., 6:9]
    return (p0 + (e1 * u[..., None] + z)) + (e2 * v[..., None] + z)


def face_point_offset(tri_row, shade_row, u, v):
    """facePointOffset (render.ts:883-889): offset along the geometric
    face normal."""
    p = face_point(tri_row, u, v)
    fn = shade_row[..., 0:3]
    return offset_ray(p, fn)


def face_normal(shade_row, u, v, shading: ShadingType):
    """faceNormal (render.ts:891-900). Phong interpolation does NOT
    normalize (parity with the WGSL). Strict products (strictf.py)."""
    if shading == ShadingType.PHONG:
        from .strictf import szero

        z = szero()
        n0 = shade_row[..., 3:6]
        n1 = shade_row[..., 6:9]
        n2 = shade_row[..., 9:12]
        w = (1.0 - u - v)[..., None]
        return (
            (n0 * w + z) + (n1 * u[..., None] + z)
        ) + (n2 * v[..., None] + z)
    return shade_row[..., 0:3]


class LightSample(NamedTuple):
    p: jnp.ndarray  # (R,) 1/pdf
    point: jnp.ndarray  # (R, 3)
    normal: jnp.ndarray  # (R, 3)
    material_idx: jnp.ndarray  # (R,) i32


def sample_lights(state, tables: SceneTables, settings: RenderSettings):
    """sampleLights → sampleModel(models[0]) → sampleFace
    (render.ts:849-869). Model 0 is the light by scene contract."""
    offset = tables.model_face_offset[0]
    count = tables.model_face_count[0]
    u1, state = rng.random_1u(state)
    face_idx = offset + (u1 % count.astype(jnp.uint32)).astype(jnp.int32)
    t2, state = rng.random_2(state)
    uv = rng.sample_intriangle(t2)
    u, v = uv[..., 0], uv[..., 1]
    tri = jnp.take(tables.tri, face_idx, axis=0)
    shade = jnp.take(tables.shade_normal, face_idx, axis=0)
    point = face_point_offset(tri, shade, u, v)
    normal = face_normal(shade, u, v, settings.shading_type)
    # 1/pdf = area-ish factor |cross(e1, e2)|/2 × face count
    # (render.ts:862-869; the reference uses cross of the stored edge slots)
    cr = jnp.cross(tri[..., 3:6], tri[..., 6:9])
    area = jnp.sqrt(jnp.sum(cr * cr, axis=-1)) / 2.0
    p = area * count.astype(jnp.float32)
    mat = jnp.take(tables.face_material, face_idx, axis=0)
    return LightSample(p=p, point=point, normal=normal, material_idx=mat), state


def direct_light(
    point: jnp.ndarray,  # (R, 3) shading point (already offset)
    normal: jnp.ndarray,  # (R, 3) shading normal
    state: jnp.ndarray,
    tables: SceneTables,
    settings: RenderSettings,
    active: jnp.ndarray | None = None,
    sort: bool = False,
    seg: int = 0,
):
    """pointColor (render.ts:1143-1157): one-or-more light samples with
    shadow rays; emission × cosine / r² × (1/pdf).

    NaN shading points (the reference's inverted offsetRay select —
    see :func:`offset_ray` — produces NaN origins on exact-zero
    components) propagate through d_sq/cosine into the contribution and
    poison the pixel, exactly as the reference's pointColor would
    (WGSL max/divide propagate NaN the same way); ~1e-3 of NEE-shaded
    pixels on this scene. Deliberate parity, not a bug."""
    r = point.shape[0]
    color = jnp.zeros((r, 3), jnp.float32)
    for _ in range(settings.samples_per_point):
        ls, state = sample_lights(state, tables, settings)
        ds = ls.point - point
        d_sq = jnp.sum(ds * ds, axis=-1)
        inv_d = detmath.det_div(
            1.0, detmath.det_sqrt(jnp.maximum(d_sq, 1e-20))
        )
        dirn = ds * inv_d[..., None]
        shadowed = _trace_any(
            point, dirn, detmath.det_sqrt(jnp.maximum(d_sq, 0.0)), tables,
            settings, active, sort=sort, seg=seg,
        )
        vis = jnp.where(shadowed, 0.0, 1.0)
        cosine = jnp.maximum(jnp.sum(dirn * normal, axis=-1), 0.0)
        emission = jnp.take(tables.mat_emission, ls.material_idx, axis=0)
        contrib = (vis * cosine * ls.p / jnp.maximum(d_sq, 1e-20))[..., None]
        color = color + emission * contrib
    return color / float(settings.samples_per_point), state


class PathResult(NamedTuple):
    color: jnp.ndarray  # (R, 3)
    state: jnp.ndarray  # (R,) uint32
    first_hit: Hit  # primary-segment hit (G-buffer source)
    rays: jnp.ndarray  # () f32: rays actually traced (bench accounting)


def path_trace(
    o: jnp.ndarray,  # (R, 3)
    d: jnp.ndarray,  # (R, 3)
    t_max0: jnp.ndarray,  # (R,) primary-segment bound (hit-dist predictor)
    state: jnp.ndarray,  # (R,) uint32
    tables: SceneTables,
    env_data,
    settings: RenderSettings,
) -> PathResult:
    """pixelColor (render.ts:1167-1212), wavefront-unrolled. With
    env_importance_sampling, each vertex additionally next-event-samples
    the environment and both strategies are MIS-combined (balance
    heuristic) — a capability the reference lacks (config #3)."""
    env_is = settings.env_importance_sampling
    if env_is:
        from .env_sample import (
            balance_weight,
            bsdf_pdf,
            env_pdf,
            sample_env,
        )

        dist = env_data
        env_img = dist.img
    else:
        env_img = env_data

    r = o.shape[0]
    color = jnp.zeros((r, 3), jnp.float32)
    throughput = jnp.ones((r, 3), jnp.float32)
    alive = jnp.ones((r,), bool)
    first_hit = None
    rays = jnp.zeros((), jnp.float32)
    prev_bsdf_pdf = jnp.zeros((r,), jnp.float32)  # MIS carry

    # Chained segment sorting (see RenderSettings.chained_sort): permute
    # the whole per-lane state into nearest-cluster order once per
    # segment; every op below is per-lane, so only the FINAL color/state
    # need one scatter back to pixel order. ``orig`` carries the composed
    # permutation's inverse target.
    chained = (
        settings.chained_sort
        and settings.sort_bounce_rays
        and _resolve_backend(settings) != "threaded"
    )
    orig = None

    # Deferred environment lookup: each lane misses at most once, so the
    # miss direction/weight are recorded per segment and the (gather-heavy,
    # per-lane) environment texture fetch runs ONCE after the loop instead
    # of once per segment — same radiance, 1/n_segments the HBM gathers.
    env_dir = jnp.zeros((r, 3), jnp.float32)
    env_w = jnp.zeros((r, 3), jnp.float32)
    env_mis_pdf = jnp.full((r,), -1.0, jnp.float32)  # ≥0 ⇒ MIS-weighted

    n_segments = max(settings.bounces_depth - 1, 0)
    for seg in range(n_segments):
        rays = rays + jnp.sum(alive.astype(jnp.float32))
        t_max = t_max0 if seg == 0 else jnp.full((r,), F32_MAX, jnp.float32)
        if chained and seg > 0:
            from .ray_sort import nearest_cluster_key, permute_rows

            import jax as _jax

            key = nearest_cluster_key(
                o,
                d,
                jnp.where(alive, t_max, 0.0),
                tables.clusters.sort_box,
            )
            rid = jnp.arange(r, dtype=jnp.int32)
            _, perm = _jax.lax.sort((key, rid), num_keys=1)
            if orig is None:
                orig = jnp.arange(r, dtype=jnp.int32)
            st = {
                "o": o, "d": d, "state": state, "color": color,
                "throughput": throughput, "alive": alive,
                "env_dir": env_dir, "env_w": env_w,
                "env_mis_pdf": env_mis_pdf, "orig": orig,
            }
            if env_is:
                st["prev_bsdf_pdf"] = prev_bsdf_pdf
            st = permute_rows(perm, st)
            o, d, state, color = st["o"], st["d"], st["state"], st["color"]
            throughput, alive = st["throughput"], st["alive"]
            env_dir, env_w = st["env_dir"], st["env_w"]
            env_mis_pdf, orig = st["env_mis_pdf"], st["orig"]
            if env_is:
                prev_bsdf_pdf = st["prev_bsdf_pdf"]
        sort_here = seg > 0 and not chained
        hit = _trace_closest(
            o, d, t_max, tables, settings, active=alive, sort=sort_here,
            seg=seg,
        )
        if seg == 0:
            first_hit = hit

        found = hit.face >= 0
        # miss → environment radiance, path ends (render.ts:1183-1186)
        miss = alive & ~found
        env_dir = jnp.where(miss[..., None], d, env_dir)
        env_w = jnp.where(miss[..., None], throughput, env_w)
        if env_is and seg > 0:
            # the previous vertex also env-NEE'd: weigh the BSDF strategy
            env_mis_pdf = jnp.where(miss, prev_bsdf_pdf, env_mis_pdf)

        h = alive & found
        face = jnp.maximum(hit.face, 0)
        mat = jnp.take(tables.face_material, face, axis=0)
        emission = jnp.take(tables.mat_emission, mat, axis=0)
        albedo = jnp.take(tables.mat_color, mat, axis=0)
        # strict mul (strictf.py): the accumulation is part of the
        # bit-parity surface vs the scalar reference
        from .strictf import smul

        color = jnp.where(
            h[..., None], color + smul(emission, throughput), color
        )
        throughput = jnp.where(h[..., None], throughput * albedo, throughput)

        tri = jnp.take(tables.tri, face, axis=0)
        shade = jnp.take(tables.shade_normal, face, axis=0)
        n = face_normal(shade, hit.u, hit.v, settings.shading_type)
        new_o = face_point_offset(tri, shade, hit.u, hit.v)

        if settings.next_event_estimation:
            # chained: lanes are already origin-grouped by this segment's
            # permutation, and shadow directions converge on the light —
            # the shadow trace needs no sort leg of its own
            nee, state = direct_light(
                new_o, n, state, tables, settings, active=h,
                sort=sort_here, seg=seg,
            )
            color = jnp.where(
                h[..., None], color + nee * throughput, color
            )
            rays = rays + jnp.sum(h.astype(jnp.float32)) * float(
                settings.samples_per_point
            )

        # env-NEE depth limit (RenderSettings.env_nee_depth): vertices
        # past the limit keep BSDF sampling as their ONLY env strategy,
        # so their escaping directions must carry MIS weight 1 — the
        # prev_bsdf_pdf sentinel below. Unbiased at any depth; the
        # variance reduction env-NEE buys concentrates at the first
        # vertices (throughput is largest there), while each env-NEE
        # vertex costs an UNBOUNDED any-hit leg (the config-#3 wall).
        run_env = env_is and (
            settings.env_nee_depth == 0 or seg < settings.env_nee_depth
        )
        if run_env:
            # environment next-event estimation at this vertex
            ed, erad, epdf, s_env = sample_env(dist, state)
            state = rng.masked_advance(state, s_env, h)
            nn = detmath.normalize(n)
            facing = jnp.sum(ed * nn, axis=-1) > 0.0
            blocked = _trace_any(
                new_o, ed, jnp.full((r,), F32_MAX, jnp.float32), tables,
                settings, active=h & facing, sort=sort_here, seg=seg,
            )
            vis = h & facing & ~blocked
            pb = bsdf_pdf(ed, n)
            w_env = balance_weight(epdf, pb)
            # f = albedo/π is already folded into throughput; × cos/pdf
            contrib = (
                throughput
                * erad
                * (
                    jnp.maximum(jnp.sum(ed * nn, axis=-1), 0.0)
                    * INV_PI
                    * w_env
                    / jnp.maximum(epdf, 1e-20)
                )[..., None]
            )
            color = jnp.where(vis[..., None], color + contrib, color)
            rays = rays + jnp.sum((h & facing).astype(jnp.float32))

        t2, s2 = rng.random_2(state)
        state = rng.masked_advance(state, s2, h)
        new_d = rng.sample_cosine_weighted_hemisphere(t2, n)
        if env_is:
            # -1 sentinel ⇒ the deferred env fetch applies weight 1
            # (no env-NEE competed at this vertex)
            pv = (
                bsdf_pdf(new_d, n)
                if run_env
                else jnp.full((r,), -1.0, jnp.float32)
            )
            prev_bsdf_pdf = jnp.where(h, pv, prev_bsdf_pdf)

        # russian roulette (render.ts:1201-1208)
        p = jnp.max(throughput, axis=-1)
        r1, s3 = rng.random_1(state)
        state = rng.masked_advance(state, s3, h)
        survive = r1 <= p
        throughput = jnp.where(
            (h & survive)[..., None],
            throughput / jnp.maximum(p, 1e-20)[..., None],
            throughput,
        )

        alive = h & survive
        o = jnp.where(alive[..., None], new_o, o)
        d = jnp.where(alive[..., None], new_d, d)

    # the deferred environment contribution (see init above)
    from .strictf import smul as _smul

    env = sample_environment(env_img, env_dir, settings.environment)
    if env_is:
        w_bsdf = balance_weight(
            jnp.maximum(env_mis_pdf, 0.0), env_pdf(dist, env_dir)
        )
        env = env * jnp.where(env_mis_pdf >= 0.0, w_bsdf, 1.0)[..., None]
    color = color + _smul(env, env_w)

    if orig is not None:
        # restore pixel order: the only scatter of the whole chained path
        from .ray_sort import scatter_rows

        color, state = scatter_rows(orig, (color, state))

    if first_hit is None:
        first_hit = Hit(
            t=jnp.full((r,), F32_MAX, jnp.float32),
            u=jnp.zeros((r,), jnp.float32),
            v=jnp.zeros((r,), jnp.float32),
            face=jnp.full((r,), -1, jnp.int32),
        )
    return PathResult(
        color=color, state=state, first_hit=first_hit, rays=rays
    )


def trace_direct(
    o, d, t_max0, state, tables, env_data, settings: RenderSettings
) -> PathResult:
    """Direct-lighting-only integrator (BASELINE config #1): one primary
    hit, emission + NEE, environment on miss."""
    if settings.env_importance_sampling:
        env_data = env_data.img  # EnvDistribution → radiance image
    r = o.shape[0]
    hit = _trace_closest(o, d, t_max0, tables, settings)
    found = hit.face >= 0
    env = sample_environment(env_data, d, settings.environment)
    color = jnp.where(found[..., None], 0.0, env)

    face = jnp.maximum(hit.face, 0)
    mat = jnp.take(tables.face_material, face, axis=0)
    emission = jnp.take(tables.mat_emission, mat, axis=0)
    albedo = jnp.take(tables.mat_color, mat, axis=0)
    tri = jnp.take(tables.tri, face, axis=0)
    shade = jnp.take(tables.shade_normal, face, axis=0)
    n = face_normal(shade, hit.u, hit.v, settings.shading_type)
    point = face_point_offset(tri, shade, hit.u, hit.v)

    nee, state = direct_light(
        point, n, state, tables, settings, active=found
    )
    lit = emission + albedo * nee
    color = jnp.where(found[..., None], lit, color)
    rays = jnp.asarray(
        r * (1 + settings.samples_per_point), jnp.float32
    )
    return PathResult(color=color, state=state, first_hit=hit, rays=rays)
