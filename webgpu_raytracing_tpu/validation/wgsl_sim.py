"""Scalar WGSL-semantics simulator of the reference megakernel.

This is a direct, per-pixel transliteration of the reference's WGSL device
code (render.ts + shaders/rng.ts) into numpy float32 scalar math — an
implementation *independent* of the framework's vectorized wavefront
path (different traversal: the reference's per-object stack walk
(render.ts:433-640) instead of clustered tiles; different control flow:
real divergent branches instead of masks; same bit-exact PCG RNG). Running
both on the same scene/seed and comparing RMSE is the cross-implementation
parity evidence for the north-star correctness clause (BASELINE.md).

Transliterated modules and their sources:

* PCG hash + samplers            shaders/rng.ts:30-131
* interval OR-quirk              render.ts:315-344
* Möller–Trumbore (backface)     render.ts:346-410
* AABB slab test                 render.ts:412-431
* per-object BVH stack traversal render.ts:433-640 (near-child-first
  ordered pushes, t-pruned pops, ≤2-face leaves)
* camera raygen (all 4 projections, thin lens)  render.ts:642-766
* facePoint/offsetRay/faceNormal render.ts:871-930 (NOTE: offsetRay keeps
  the reference's inverted selects verbatim — this simulator reproduces
  the reference bit-for-bit, including its bugs; the framework documents
  and fixes them, see ops/integrator.py:offset_ray)
* equirect skybox (nearest texel) render.ts:932-940
* pixelColor bounce loop + RR    render.ts:1120-1212
* megakernel main + accumulation render.ts:1434-1509

Known deliberate simplification: ``pixelHitDist`` (render.ts:1121-1141)
only produces a *conservative upper bound* on the primary hit distance
(any bound ≥ the true closest t yields the identical closest hit, and the
quad re-tests consume no RNG), so the simulator uses f32max — provably
image-identical and much cheaper than emulating the reference's
local/global face-index confusion at render.ts:784-831.

Python-loop scalar code — intended for small crops (≤64×64); used by
tools/make_reference_golden.py and tests/test_reference_parity.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import (
    EPSILON,
    F32_MAX,
    MIN_DIST,
    FovOrientation,
    LensShape,
    ProjectionType,
    RenderSettings,
    ShadingType,
)

f32 = np.float32
_F32_MAX = f32(F32_MAX)
_EPS = f32(EPSILON)
_EPS2 = f32(EPSILON) * f32(EPSILON)
_MIN_DIST = f32(MIN_DIST)
_TWO_PI = f32(6.28318530717958647692528)
_INV_PI = f32(0.31830988618379067153776)

_M32 = 0xFFFFFFFF


class Rng:
    """var<private> rng_state (shaders/rng.ts:32-40), exact u32 semantics."""

    __slots__ = ("state",)

    def __init__(self, state: int):
        self.state = state & _M32

    def random_1u(self) -> int:
        old = (self.state + 747796405 + 2891336453) & _M32
        word = (((old >> ((old >> 28) + 4)) ^ old) * 277803737) & _M32
        self.state = (word >> 22) ^ word
        return self.state

    def random_1(self) -> f32:
        # f32(u) / f32(0xffffffffu); f32(4294967295) rounds to 2^32
        return f32(f32(self.random_1u()) / f32(4294967295.0))

    def random_2(self) -> np.ndarray:
        x = self.random_1()
        y = self.random_1()
        return np.array([x, y], f32)


def _v3(x, y, z) -> np.ndarray:
    return np.array([x, y, z], f32)


def _normalize(v: np.ndarray) -> np.ndarray:
    return (v / np.sqrt(v.dot(v))).astype(f32)


def sample_sphere(t: np.ndarray) -> np.ndarray:
    """shaders/rng.ts:103-110."""
    ux = f32(t[0] * f32(2.0) - f32(1.0))
    sin_theta = np.sqrt(np.maximum(f32(1.0) - ux * ux, f32(0.0))).astype(f32)
    phi = _TWO_PI * t[1]
    return _v3(
        sin_theta * np.cos(phi, dtype=f32),
        ux,
        sin_theta * np.sin(phi, dtype=f32),
    )


def sample_cosine_weighted_hemisphere(t: np.ndarray, n: np.ndarray) -> np.ndarray:
    """normalize(n + sample_sphere(t)) (shaders/rng.ts:88-100, p=1)."""
    return _normalize(n + sample_sphere(t))


def sample_incircle(t: np.ndarray) -> np.ndarray:
    phi = f32(t[0] * _TWO_PI)
    r = np.sqrt(t[1]).astype(f32)
    return np.array(
        [np.cos(phi, dtype=f32) * r, np.sin(phi, dtype=f32) * r], f32
    )


def sample_insquare(t: np.ndarray) -> np.ndarray:
    return (f32(2.0) * t - f32(1.0)).astype(f32)


def sample_intriangle(t: np.ndarray) -> np.ndarray:
    """select(t, vec2f(1-t.y, t.x), t.x < t.y) (shaders/rng.ts:129-131)."""
    if t[0] < t[1]:
        return np.array([f32(1.0) - t[1], t[0]], f32)
    return t


# --- offsetRay: the reference's WGSL VERBATIM, inverted selects included
# (render.ts:902-917). WGSL select(f, t, cond) returns t when cond.
_ORIGIN = f32(1.0 / 32.0)
_FLOAT_SCALE = f32(1.0 / 65536.0)
_INT_SCALE = f32(256.0)


def _bitcast_add(x: f32, add: int) -> f32:
    i = np.float32(x).view(np.int32)
    return np.int32(int(i) + int(add)).view(np.float32)


def offset_ray(p: np.ndarray, n: np.ndarray) -> np.ndarray:
    """render.ts:902-917 verbatim (with its inverted selects)."""
    out = np.empty(3, f32)
    for k in range(3):
        of_i = int(np.int32(f32(_INT_SCALE * n[k])))
        # WGSL: bitcast<f32>(bitcast<i32>(p) + select(-ofI, ofI, p < 0))
        p_int = _bitcast_add(p[k], of_i if p[k] < 0 else -of_i)
        p_float = f32(p[k] + _FLOAT_SCALE * n[k])
        # WGSL: select(p_float, p_int, abs(p) < origin)
        out[k] = p_int if abs(p[k]) < _ORIGIN else p_float
    return out


@dataclasses.dataclass
class SimScene:
    """Flat buffers in the reference's layout (scene.ts:179-334)."""

    # global face tables (model faces concatenated in subset order)
    p0: np.ndarray  # (F, 3)
    e1: np.ndarray
    e2: np.ndarray
    face_normal: np.ndarray  # (F, 3)
    n0: np.ndarray  # vertex normals
    n1: np.ndarray
    n2: np.ndarray
    face_material: np.ndarray  # (F,)
    # per-model tables
    model_face_offset: np.ndarray  # (M,)
    model_face_count: np.ndarray
    model_bvh_offset: np.ndarray
    # BVH nodes, concatenated (face ids model-LOCAL, like the reference)
    node_min: np.ndarray  # (N, 3)
    node_max: np.ndarray
    node_right: np.ndarray  # (N,) -1 = leaf
    node_face0: np.ndarray
    node_face1: np.ndarray
    # materials
    mat_color: np.ndarray  # (K, 3)
    mat_emission: np.ndarray

    @staticmethod
    def from_scene(scene) -> "SimScene":
        models = scene.models
        fo, fc, bo = [], [], []
        f_off = 0
        n_off = 0
        for m in models:
            fo.append(f_off)
            fc.append(len(m.faces))
            bo.append(n_off)
            f_off += len(m.faces)
            n_off += len(m.bvh)
        cat = lambda attr: np.concatenate(
            [getattr(m.faces, attr) for m in models]
        ).astype(f32)
        return SimScene(
            p0=cat("p0"),
            e1=cat("e1"),
            e2=cat("e2"),
            face_normal=cat("normal"),
            n0=cat("n0"),
            n1=cat("n1"),
            n2=cat("n2"),
            face_material=np.concatenate(
                [m.faces.material_idx for m in models]
            ).astype(np.int32),
            model_face_offset=np.array(fo, np.int64),
            model_face_count=np.array(fc, np.int64),
            model_bvh_offset=np.array(bo, np.int64),
            node_min=np.concatenate([m.bvh.node_min for m in models]).astype(f32),
            node_max=np.concatenate([m.bvh.node_max for m in models]).astype(f32),
            node_right=np.concatenate([m.bvh.right_idx for m in models]),
            node_face0=np.concatenate([m.bvh.face0 for m in models]),
            node_face1=np.concatenate([m.bvh.face1 for m in models]),
            mat_color=np.asarray(scene.mat_color, f32),
            mat_emission=np.asarray(scene.mat_emission, f32),
        )

    @property
    def n_models(self) -> int:
        return len(self.model_face_offset)


@dataclasses.dataclass
class Hit:
    hit: bool
    t: f32
    u: f32
    v: f32
    face_idx: int  # GLOBAL face index (render.ts:592 stores global)
    object_idx: int


def ray_intersect_face(pos, dirn, p0, e1, e2, i_min, i_max):
    """rayIntersectFace (render.ts:359-410): backface-culling MT on stored
    edge vectors; returns (t, u, v) or None."""
    h = np.cross(dirn, e2).astype(f32)
    det = f32(e1.dot(h))
    if det < _EPS2:
        return None
    s = (pos - p0).astype(f32)
    u = f32(s.dot(h))
    if u < f32(0.0) or u > det:
        return None
    q = np.cross(s, e1).astype(f32)
    v = f32(dirn.dot(q))
    if v < f32(0.0) or u + v > det:
        return None
    t = f32(e2.dot(q))
    # the WGSL divides the vec3f(t, u, v) by det directly
    # (render.ts:406-408); a reciprocal-multiply rounds twice and can
    # differ by 1 ulp, flipping strict intervalSurrounds knife edges
    t, u, v = f32(t / det), f32(u / det), f32(v / det)
    # intervalSurrounds: min < t < max, strict (render.ts:333-335)
    if not (i_min < t and t < i_max):
        return None
    return t, u, v


def ray_intersect_bv(pos, dirn, bmin, bmax, i_min, i_max):
    """rayIntersectBV (render.ts:418-431) + the intervalOverlap OR-quirk
    (render.ts:322-324). Division by zero dir components follows IEEE."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = ((bmin - pos) / dirn).astype(f32)
        t1 = ((bmax - pos) / dirn).astype(f32)
    tmin = np.minimum(t0, t1)
    tmax = np.maximum(t0, t1)
    near = f32(max(tmin[0], tmin[1], tmin[2]))
    far = f32(min(tmax[0], tmax[1], tmax[2]))
    # intervalOverlap(interval, Interval(near, far)):
    #   interval.min <= far || near <= interval.max
    if near < far and (i_min <= far or near <= i_max):
        return near
    return None


def ray_intersect_object_bvh(sim: SimScene, pos, dirn, obj: int, max_dist):
    """rayIntersectObjectBVH (render.ts:555-638): iterative stack,
    near-child-first pushes, per-pop t-pruning, ≤2-face leaves."""
    best_t = f32(max_dist)
    best = None
    b_off = sim.model_bvh_offset[obj]
    f_off = sim.model_face_offset[obj]

    root_near = ray_intersect_bv(
        pos, dirn, sim.node_min[b_off], sim.node_max[b_off], _MIN_DIST, best_t
    )
    if root_near is None:
        return best, best_t
    stack = [(0, root_near)]
    while stack:
        idx, entry_t = stack.pop()
        if entry_t > best_t:
            continue
        n = b_off + idx
        right = sim.node_right[n]
        if right == -1:  # leaf
            for local in (sim.node_face0[n], sim.node_face1[n]):
                if local == -1:
                    continue
                g = f_off + local
                r = ray_intersect_face(
                    pos, dirn, sim.p0[g], sim.e1[g], sim.e2[g],
                    _MIN_DIST, best_t,
                )
                if r is None:
                    continue
                best_t = r[0]
                best = Hit(True, r[0], r[1], r[2], int(g), obj)
            continue
        left = idx + 1
        ln = b_off + left
        rn = b_off + right
        lt = ray_intersect_bv(
            pos, dirn, sim.node_min[ln], sim.node_max[ln], _MIN_DIST, best_t
        )
        rt = ray_intersect_bv(
            pos, dirn, sim.node_min[rn], sim.node_max[rn], _MIN_DIST, best_t
        )
        if lt is not None and rt is not None:
            if lt < rt:
                stack.append((right, rt))
                stack.append((left, lt))
            else:
                stack.append((left, lt))
                stack.append((right, rt))
        elif lt is not None:
            stack.append((left, lt))
        elif rt is not None:
            stack.append((right, rt))
    return best, best_t


def ray_intersect_bvh(sim: SimScene, pos, dirn, max_dist) -> Hit:
    """rayIntersectBVH (render.ts:447-464): linear scan of per-object
    BVHs, best-so-far tightening the next object's bound."""
    result = Hit(False, f32(max_dist), f32(0), f32(0), 0, 0)
    best_t = f32(max_dist)
    for obj in range(sim.n_models):
        hit, best_t = ray_intersect_object_bvh(sim, pos, dirn, obj, best_t)
        if hit is not None:
            result = hit
    return result


def face_point_offset(sim: SimScene, g: int, u, v) -> np.ndarray:
    """facePointOffset (render.ts:883-889)."""
    p = (sim.p0[g] + sim.e1[g] * u + sim.e2[g] * v).astype(f32)
    return offset_ray(p, sim.face_normal[g])


def face_normal(sim: SimScene, g: int, u, v, shading: ShadingType) -> np.ndarray:
    """faceNormal (render.ts:891-900) — Phong does NOT normalize."""
    if shading == ShadingType.PHONG:
        w = f32(f32(1.0) - u - v)
        return (sim.n0[g] * w + sim.n1[g] * u + sim.n2[g] * v).astype(f32)
    return sim.face_normal[g]


def sample_skybox(env: np.ndarray | None, dirn: np.ndarray) -> np.ndarray:
    """sampleSkybox (render.ts:932-940): equirect uv, nearest texel
    (non-filtering sampler), clamp-to-edge."""
    if env is None:
        return np.zeros(3, f32)
    u = f32((np.arctan2(dirn[2], dirn[0], dtype=f32) * _INV_PI + f32(1.0)) * f32(0.5))
    v = f32(f32(1.0) - np.arccos(np.clip(dirn[1], -1.0, 1.0), dtype=f32) * _INV_PI)
    h, w = env.shape[0], env.shape[1]
    x = min(max(int(u * w), 0), w - 1)
    y = min(max(int(v * h), 0), h - 1)
    return env[y, x]


def camera_ray(pos2: np.ndarray, view: np.ndarray, rng: Rng, s: RenderSettings):
    """cameraRay (render.ts:749-765)."""
    viewport = np.array([s.width, s.height], f32)
    uv = (f32(2.0) * pos2 - viewport).astype(f32)
    if s.fov_orientation == FovOrientation.VERTICAL:
        uv = (uv / viewport[1]).astype(f32)
    elif s.fov_orientation == FovOrientation.HORIZONTAL:
        uv = (uv / viewport[0]).astype(f32)
    else:
        uv = (uv / np.sqrt(viewport.dot(viewport))).astype(f32)

    fov = f32(s.fov)
    if s.projection_type == ProjectionType.PANINI:
        half_fov = f32(fov / f32(2.0))
        hv = (uv * half_fov).astype(f32)
        pd = f32(s.panini_distance)
        half_panini_fov = np.arctan2(
            np.sin(half_fov, dtype=f32),
            f32(np.cos(half_fov, dtype=f32) + pd),
            dtype=f32,
        )
        hv_pan = (hv * half_panini_fov).astype(f32)
        sx = np.sin(hv_pan[0], dtype=f32)
        cx = np.cos(hv_pan[0], dtype=f32)
        m = f32(
            np.sqrt(f32(1.0) - f32(sx * pd) * f32(sx * pd)).astype(f32)
            + pd * cx
        )
        x = f32(sx * m)
        z = f32(cx * m - pd)
        y = f32(
            np.tan(hv_pan[1], dtype=f32)
            * f32(z + pd * f32(1.0 - s.vertical_compression))
        )
        d = _normalize(_v3(x, y, -z))
    elif s.projection_type == ProjectionType.PERSPECTIVE:
        z = f32(-1.0 / np.tan(fov / f32(2.0), dtype=f32))
        d = _normalize(_v3(uv[0], uv[1], z))
    elif s.projection_type == ProjectionType.FISHEYE:
        ang = (uv * f32(fov / f32(2.0))).astype(f32)
        d = _normalize(
            _v3(
                -np.sin(ang[0], dtype=f32),
                -np.sin(ang[1], dtype=f32) * np.cos(ang[0], dtype=f32),
                np.cos(ang[1], dtype=f32) * np.cos(ang[0], dtype=f32),
            )
        )
    else:  # orthographic
        d = _v3(0.0, 0.0, -1.0)

    # sampleLens (render.ts:740-747): ALWAYS draws random_2
    t2 = rng.random_2()
    lens = (
        sample_incircle(t2)
        if s.lens_shape == LensShape.CIRCLE
        else sample_insquare(t2)
    )
    # thinLensRay (render.ts:695-702)
    o = _v3(lens[0] * f32(s.circle_of_confusion), lens[1] * f32(s.circle_of_confusion), 0.0)
    focus = (-d * f32(f32(s.focus_distance) / d[2])).astype(f32)
    d = _normalize(focus - o)
    if s.projection_type == ProjectionType.ORTHOGRAPHIC:
        fov_distance = f32(fov / np.pi * 4.0)
        o = (o + _v3(uv[0] * fov_distance, uv[1] * fov_distance, 0.0)).astype(f32)

    # ray_transform (render.ts:731-738)
    oh = (view @ np.array([o[0], o[1], o[2], f32(1.0)], f32)).astype(f32)
    o_w = oh[:3]
    d = _normalize(_v3(d[0], d[1], f32(d[2] * oh[3])))
    d_w = (view[:3, :3] @ d).astype(f32)
    return o_w, d_w


def pixel_color(sim, env, pos, dirn, max_dist, rng, s: RenderSettings):
    """pixelColor (render.ts:1167-1212): bounce stack, emission/throughput,
    cosine bounce, Russian roulette. Returns (color, first_hit)."""
    color4 = np.zeros(4, f32)
    throughput = np.ones(3, f32)
    cur_pos, cur_dir, cur_max = pos, dirn, f32(max_dist)
    first_hit = Hit(False, f32(max_dist), f32(0), f32(0), 0, 0)
    top = 0
    max_bounces = s.bounces_depth
    while top < max_bounces - 1:
        hit = ray_intersect_bvh(sim, cur_pos, cur_dir, cur_max)
        if top == 0:
            first_hit = hit
        if not hit.hit:
            sky = sample_skybox(env, cur_dir)
            color4 = color4 + np.array(
                [sky[0] * throughput[0], sky[1] * throughput[1],
                 sky[2] * throughput[2], f32(1.0)], f32
            )
            break
        g = hit.face_idx
        mat = sim.face_material[g]
        emission = sim.mat_emission[mat]
        mat_color = sim.mat_color[mat]
        color3 = (color4[:3] + emission * throughput).astype(f32)
        throughput = (throughput * mat_color).astype(f32)
        normal = face_normal(sim, g, hit.u, hit.v, s.shading_type)
        new_pos = face_point_offset(sim, g, hit.u, hit.v)
        new_dir = sample_cosine_weighted_hemisphere(rng.random_2(), normal)
        top += 1
        color4 = np.array([color3[0], color3[1], color3[2], f32(1.0)], f32)
        # russian roulette (render.ts:1201-1208)
        p = f32(max(throughput[0], throughput[1], throughput[2]))
        if rng.random_1() > p:
            break
        throughput = (throughput / p).astype(f32)
        cur_pos, cur_dir, cur_max = new_pos, new_dir, _F32_MAX
    return color4[:3], first_hit


class WGSLReference:
    """Host-side frame loop (renderFrame, render.ts:1651-1710) over the
    scalar megakernel — the reference renderer in miniature, restricted to
    the settings exercised by the cross-parity goldens (no reprojection,
    no NEE; those are separately unit-tested subsystems)."""

    def __init__(self, scene, settings: RenderSettings, env: np.ndarray | None):
        assert not settings.reproject, "simulator covers reproject=off"
        assert not settings.next_event_estimation
        self.sim = SimScene.from_scene(scene)
        self.s = settings
        self.env = None if env is None else np.asarray(env, f32)
        h, w = settings.height, settings.width
        self.image = np.zeros((h, w, 4), f32)
        self.counter = 0

    def step(self, seed: int, view: np.ndarray, jitter=(0.0, 0.0)) -> None:
        """One progressive frame (megakernel main, render.ts:1434-1509)."""
        s = self.s
        view = np.asarray(view, f32)
        if self.counter == 0:
            self.image[:] = 0
        for py in range(s.height):
            for px in range(s.width):
                idx = px + py * s.width
                rng = Rng(seed + idx)
                pos = np.array(
                    [px + f32(jitter[0]), py + f32(jitter[1])], f32
                )
                color = np.zeros(3, f32)
                samples = 0
                o, d = camera_ray(pos, view, rng, s)
                # pixelHitDist: conservative bound — see module docstring
                c, _ = pixel_color(self.sim, self.env, o, d, _F32_MAX, rng, s)
                color = color + c
                samples += 1
                for _ in range(s.sample_count):
                    jpos = pos + sample_insquare(rng.random_2()) * f32(0.5)
                    o, d = camera_ray(jpos, view, rng, s)
                    c, _ = pixel_color(
                        self.sim, self.env, o, d, _F32_MAX, rng, s
                    )
                    color = color + c
                    samples += 1
                self.image[py, px] += np.array(
                    [color[0], color[1], color[2], f32(samples)], f32
                )
        self.counter += 1
