"""Render orchestration: progressive accumulation + per-frame step.

The reference's per-frame flow (render.ts:1651-1710) writes seed / counter
/ jitter uniforms, dispatches the megakernel over 16×16 workgroups, blits
with tonemapping, and rotates prev-frame buffers with buffer-to-buffer
copies. Shape here:

* the accumulation image is an explicit ``(H, W, 4)`` array — rgb sum in
  ``[..., :3]``, accumulated sample count in ``[..., 3]`` — exactly the
  reference image-buffer layout (render.ts:124-140, 1506-1507), threaded
  through a donated, jitted frame function;
* "clear on counter == 0" (render.ts:1454-1459) is a traced select;
* config changes retrace (static ``RenderSettings``); camera motion only
  feeds a new view matrix — the reference's recompile-vs-uniform split;
* prev-frame rotation (render.ts:1694-1699 copyBufferToBuffer ×4) is a
  host-side functional swap — no device copies at all;
* the pixel dimension is the scaling axis: :func:`render_tile` renders any
  horizontal slab given its global row offset, so multi-chip sharding
  (``parallel/``) is the same code over a row-sharded mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .camera import Camera
from .config import F32_MAX, BlitView, RenderSettings
from .models.scene import Scene, SceneTables
from .ops import rng
from .ops.integrator import face_point_offset, path_trace, trace_direct
from .ops.predictor import predict_hit_dist, quad_faces
from .ops.raygen import camera_rays
from .ops.reproject import reproject, reprojection_frustum
from .ops.tonemap import apply as tonemap_apply
from .ops.tonemap import gamma as tonemap_gamma


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FrameBuffers:
    """Persistent HBM-resident frame state (the reference's storage
    buffers, render.ts:122-159): current accumulation image + G-buffer and
    the previous-frame snapshots used by the temporal layer.

    Sharding contract (parallel/shard.py): the current-frame buffers are
    row-sharded (each chip owns an image slab), while the ``prev_*``
    buffers are REPLICATED — temporal reprojection and the quad hit
    predictor read arbitrary previous-frame pixels (camera motion moves
    content across slabs), so the prev snapshot must be whole on every
    chip; the rotation all-gathers once per updatePrev."""

    image: jax.Array  # (H, W, 4) f32: rgb sum, sample count
    geo_position: jax.Array  # (H, W, 3) f32
    geo_face: jax.Array  # (H, W) i32
    geo_object: jax.Array  # (H, W) i32
    prev_image: jax.Array  # (H, W, 4) f32 — full height, even when sharded
    prev_geo_position: jax.Array  # (H, W, 3) f32 — full height
    prev_geo_face: jax.Array  # (H, W) i32 — full height

    @staticmethod
    def create(
        width: int, height: int, geo_height: int | None = None
    ) -> "FrameBuffers":
        """``geo_height`` mirrors the reference's geometryBufferScale
        allocation (render.ts:141-144): the G-buffer may have fewer rows
        than the image; out-of-range rows behave as "no data" (the
        WebGPU robust-access result — see RenderSettings)."""
        gh = height if geo_height is None else geo_height
        return FrameBuffers(
            image=jnp.zeros((height, width, 4), jnp.float32),
            geo_position=jnp.zeros((gh, width, 3), jnp.float32),
            geo_face=jnp.full((gh, width), -1, jnp.int32),
            geo_object=jnp.zeros((gh, width), jnp.int32),
            prev_image=jnp.zeros((height, width, 4), jnp.float32),
            prev_geo_position=jnp.zeros((gh, width, 3), jnp.float32),
            prev_geo_face=jnp.full((gh, width), -1, jnp.int32),
        )

    def rotated(self) -> "FrameBuffers":
        """Prev-buffer rotation (the updatePrev copy set,
        render.ts:1694-1699). Real device copies, like the reference's
        copyBufferToBuffer — required so the donated frame step never sees
        the same buffer aliased twice."""
        return dataclasses.replace(
            self,
            prev_image=jnp.copy(self.image),
            prev_geo_position=jnp.copy(self.geo_position),
            prev_geo_face=jnp.copy(self.geo_face),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FrameInputs:
    """Per-frame traced values (the reference's uniforms,
    render.ts:57-106, 1658-1665)."""

    view: jax.Array  # (4, 4) f32
    seed: jax.Array  # () uint32
    counter: jax.Array  # () int32
    jitter: jax.Array  # (2,) f32
    frustum: jax.Array  # (4, 3) f32 reprojection frustum of prev view
    prev_origin: jax.Array  # (3,) f32 translation column of prev view

    @staticmethod
    def simple(view, seed, counter) -> "FrameInputs":
        return FrameInputs(
            view=jnp.asarray(view, jnp.float32),
            seed=jnp.uint32(seed),
            counter=jnp.int32(counter),
            jitter=jnp.zeros((2,), jnp.float32),
            frustum=jnp.zeros((4, 3), jnp.float32),
            prev_origin=jnp.zeros((3,), jnp.float32),
        )


def _face_to_object(tables: SceneTables, face: jnp.ndarray) -> jnp.ndarray:
    """Map a global face index to its model (object) index via the model
    table — the reference stores objectIdx from traversal directly."""
    offsets = tables.model_face_offset  # (M,)
    f = jnp.maximum(face, 0)[..., None]
    return (
        jnp.sum((f >= offsets[None, :]).astype(jnp.int32), axis=-1) - 1
    ).astype(jnp.int32)


def render_tile(
    buffers: FrameBuffers,  # slab buffers: (h_tile, W, …)
    tables: SceneTables,
    env_data,
    inputs: FrameInputs,
    row0: jax.Array,  # () i32 global row offset of this slab
    settings: RenderSettings,
    tile_height: int,
) -> Tuple[FrameBuffers, jax.Array]:
    """One progressive frame over a horizontal slab of the image
    (megakernel main, render.ts:1434-1509). Returns (buffers, rays_traced).

    ``row0`` keeps pixel indices global so per-pixel RNG streams
    (``seed + idx``, render.ts:1453) are identical however the image is
    sharded across chips.
    """
    h, w = tile_height, settings.render_width
    r = h * w

    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.int32) + row0,
        jnp.arange(w, dtype=jnp.int32),
        indexing="ij",
    )
    idx = (xs + ys * w).reshape(r)  # imageIdx (render.ts:1258-1260)
    base_pos = (
        jnp.stack([xs, ys], axis=-1).reshape(r, 2).astype(jnp.float32)
        + inputs.jitter[None, :]
    )

    state = rng.seed_state(jnp.broadcast_to(inputs.seed, (r,)), idx)

    # clear on counter == 0 (render.ts:1454-1459)
    clear = (inputs.counter == 0) & (not settings.reproject)
    image = jnp.where(clear, jnp.zeros_like(buffers.image), buffers.image)

    # geometry_buffer_scale < 1 allocates fewer G-buffer rows than the
    # image (render.ts:144); rows past the allocation read as "no data"
    # (face -1 / position 0 — the robust-access analog), so pad the prev
    # snapshots back to full render height for the consumers below
    gh = buffers.prev_geo_face.shape[0]
    if gh < settings.render_height:
        pad_rows = settings.render_height - gh
        prev_geo_face = jnp.pad(
            buffers.prev_geo_face, ((0, pad_rows), (0, 0)),
            constant_values=-1,
        )
        prev_geo_position = jnp.pad(
            buffers.prev_geo_position, ((0, pad_rows), (0, 0), (0, 0))
        )
    else:
        prev_geo_face = buffers.prev_geo_face
        prev_geo_position = buffers.prev_geo_position

    # quad-based hit-distance candidates from the previous G-buffer
    # (render.ts:1121-1141, 1440-1446). Quads are computed over the FULL
    # prev buffer and the slab sliced out after, so 2x2 blocks anchor at
    # global row parity — identical however the image is sharded.
    prev_quads = (
        jax.lax.dynamic_slice(
            quad_faces(prev_geo_face),
            (row0, jnp.int32(0), jnp.int32(0)),
            (h, w, 4),
        ).reshape(r, 4)
        if settings.use_hit_predictor
        else None
    )

    integrator = trace_direct if settings.bounces_depth <= 1 else path_trace

    def one_sample(pos, state):
        o, d, state = camera_rays(pos, inputs.view, state, settings)
        if prev_quads is not None:
            t_max = predict_hit_dist(o, d, prev_quads, tables)
        else:
            t_max = jnp.full((r,), F32_MAX, jnp.float32)
        res = integrator(o, d, t_max, state, tables, env_data, settings)
        return res

    color = jnp.zeros((r, 3), jnp.float32)
    samples = jnp.zeros((r, 1), jnp.float32)
    rays = jnp.zeros((), jnp.float32)

    # primary sample (render.ts:1464-1468)
    res = one_sample(base_pos, state)
    state = res.state
    color = color + res.color
    rays = rays + res.rays
    samples = samples + 1.0

    # G-buffer write from the primary hit (render.ts:1470-1475)
    fh = res.first_hit
    face = jnp.maximum(fh.face, 0)
    tri = jnp.take(tables.tri, face, axis=0)
    shade = jnp.take(tables.shade_normal, face, axis=0)
    primary_point = face_point_offset(tri, shade, fh.u, fh.v)
    # writes past the G-buffer allocation are dropped (bottom rows —
    # imageIdx = x + y*w — exactly the reference's robust-access no-ops)
    g_out = buffers.geo_face.shape[0]
    geo_position = primary_point.reshape(h, w, 3)[:g_out]
    geo_face = fh.face.reshape(h, w)[:g_out]
    geo_object = _face_to_object(tables, fh.face).reshape(h, w)[:g_out]

    # extra stratified-jittered samples (render.ts:1477-1495)
    for _ in range(settings.sample_count):
        t2, state = rng.random_2(state)
        pos = base_pos + rng.sample_insquare(t2) * 0.5
        res = one_sample(pos, state)
        state = res.state
        color = color + res.color
        rays = rays + res.rays
        samples = samples + 1.0

        if settings.reproject:
            # temporal merge per extra sample (render.ts:1485-1494)
            sh = res.first_hit
            sface = jnp.maximum(sh.face, 0)
            stri = jnp.take(tables.tri, sface, axis=0)
            sshade = jnp.take(tables.shade_normal, sface, axis=0)
            spoint = face_point_offset(stri, sshade, sh.u, sh.v)
            rp, state = reproject(
                spoint,
                color,
                state,
                inputs.frustum,
                inputs.prev_origin,
                buffers.prev_image,
                prev_geo_position,
                settings,
            )
            ok = rp.color[..., 3:4] > 0.0
            color = color + jnp.where(
                ok,
                rp.color[..., :3] / jnp.maximum(rp.color[..., 3:4], 1e-20),
                0.0,
            )
            samples = samples + ok.astype(jnp.float32)

    if settings.reproject:
        # final primary-point reprojection REPLACES the accumulation base
        # (render.ts:1497-1500), then the frame still accumulates on top
        # (render.ts:1506-1507)
        rp, state = reproject(
            primary_point,
            color,
            state,
            inputs.frustum,
            inputs.prev_origin,
            buffers.prev_image,
            prev_geo_position,
            settings,
        )
        image = rp.color.reshape(h, w, 4)

    if settings.debug_reprojection:
        new_image = image
    elif settings.blit_view == BlitView.NORMALS:
        # render.ts:1503-1504: the normals view REPLACES the buffer each
        # frame (no progressive accumulation)
        new_image = jnp.concatenate(
            [color, jnp.ones_like(samples)], axis=-1
        ).reshape(h, w, 4)
    else:
        new_image = image + jnp.concatenate(
            [color, samples], axis=-1
        ).reshape(h, w, 4)

    out = dataclasses.replace(
        buffers,
        image=new_image,
        geo_position=geo_position,
        geo_face=geo_face,
        geo_object=geo_object,
    )
    return out, rays


@functools.partial(
    jax.jit,
    static_argnames=("settings",),
    donate_argnames=("buffers",),
)
def render_frame(
    buffers: FrameBuffers,
    tables: SceneTables,
    env_data,
    inputs: FrameInputs,
    settings: RenderSettings,
) -> Tuple[FrameBuffers, jax.Array]:
    """Single-chip frame: the whole image is one tile."""
    return render_tile(
        buffers, tables, env_data, inputs, jnp.int32(0), settings,
        settings.render_height,
    )


@functools.partial(
    jax.jit, static_argnames=("settings", "tile_height")
)
def _render_slab(buffers, tables, env_data, inputs, row0, settings,
                 tile_height):
    return render_tile(
        buffers, tables, env_data, inputs, row0, settings, tile_height
    )


def render_frame_slabs(
    buffers: FrameBuffers,
    tables: SceneTables,
    env_data,
    inputs: FrameInputs,
    settings: RenderSettings,
) -> Tuple[FrameBuffers, jax.Array]:
    """Big-frame path (``frame_slabs`` > 1): render the frame as
    ``frame_slabs`` horizontal slabs, one jitted :func:`render_tile`
    call each (compiled ONCE — ``row0`` is traced), so the wavefront's
    (rays × state-columns) temporaries scale with the slab, not the
    frame.

    Same slab contract as the multi-chip shard_map (parallel/shard.py):
    current-frame rows are sliced per slab, the prev_* snapshots ride
    whole (reprojection and the quad predictor read arbitrary prev
    pixels; ``row0`` keeps pixel indices — and so RNG streams — global,
    making the slab decomposition bit-identical to the single-tile
    frame)."""
    n = settings.frame_slabs
    h = settings.render_height
    assert h % n == 0, f"frame_slabs={n} must divide render_height={h}"
    assert settings.geo_height == h, (
        "frame_slabs requires geometry_buffer_scale == 1 (slab rows must "
        "align between the image and the G-buffer)"
    )
    hs = h // n
    outs = []
    rays = jnp.zeros((), jnp.float32)
    for b in range(n):
        sl = slice(b * hs, (b + 1) * hs)
        slab = dataclasses.replace(
            buffers,
            image=buffers.image[sl],
            geo_position=buffers.geo_position[sl],
            geo_face=buffers.geo_face[sl],
            geo_object=buffers.geo_object[sl],
        )
        out, r = _render_slab(
            slab, tables, env_data, inputs, jnp.int32(b * hs), settings,
            hs,
        )
        outs.append(out)
        rays = rays + r
    merged = dataclasses.replace(
        buffers,
        image=jnp.concatenate([o.image for o in outs], axis=0),
        geo_position=jnp.concatenate(
            [o.geo_position for o in outs], axis=0
        ),
        geo_face=jnp.concatenate([o.geo_face for o in outs], axis=0),
        geo_object=jnp.concatenate([o.geo_object for o in outs], axis=0),
    )
    return merged, rays


@functools.partial(jax.jit, static_argnames=("settings",))
def blit(image: jax.Array, prev_image: jax.Array, settings: RenderSettings):
    """Accumulation buffer → display color (blit fragment shader,
    render.ts:184-244): pick buffer by blit view, rgb / samples ×
    exposure, gamma(1/γ), tonemap."""
    if settings.blit_view == BlitView.NORMALS:
        color = image[..., :3]
    elif settings.blit_view == BlitView.PREV_IMAGE:
        denom = jnp.maximum(prev_image[..., 3:4], 1e-20)
        color = prev_image[..., :3] / denom
    else:
        denom = jnp.maximum(image[..., 3:4], 1e-20)
        color = image[..., :3] / denom
        if settings.blit_view == BlitView.IMAGE:
            color = color * settings.exposure
    color = tonemap_gamma(color, 1.0 / settings.gamma)
    color = tonemap_apply(color, settings.tonemapping)
    color = jnp.clip(color, 0.0, 1.0)
    if color.shape[:2] != (settings.height, settings.width):
        # resolution_scale != 1: the reference's fullscreen blit stretches
        # the scaled backing store to the canvas (render.ts:109-113,
        # 163-183) with the sampler's bilinear filtering
        color = jax.image.resize(
            color, (settings.height, settings.width, 3), method="linear"
        )
    return color


class Renderer:
    """Host-side progressive renderer (the reference's store + renderFrame
    loop in one object). Owns the accumulation state, the reset-on-change
    policy (store.ts:192-344), and the updatePrev rotation schedule
    (render.ts:1651-1657)."""

    def __init__(
        self,
        scene: Scene,
        settings: RenderSettings,
        env_data=None,
        camera: Optional[Camera] = None,
        base_seed: Optional[int] = None,
    ):
        self.scene = scene
        self.settings = settings
        self.tables = scene.tables()
        if env_data is None:
            env_data = jnp.zeros((1, 1, 3), jnp.float32)
        # env_data is either a radiance image or an EnvDistribution pytree
        # (env_importance_sampling)
        self.env_data = (
            env_data
            if hasattr(env_data, "row_cdf")
            else jnp.asarray(env_data)
        )
        self.camera = camera or Camera()
        self.counter = 0
        self.frame_counter = 0  # mod reprojectionRate (render.ts:1650)
        self.buffers = FrameBuffers.create(
            settings.render_width, settings.render_height,
            settings.geo_height,
        )
        self._rng = np.random.default_rng(base_seed)
        self.last_rays = 0.0  # rays traced in the last frame (metrics)
        self._prev_view = np.eye(4, dtype=np.float32)
        self._jitter = None

    # --- reset policy (resetCounter, store.ts:240-242) ---
    def reset(self) -> None:
        self.counter = 0

    def update_settings(self, **kw) -> None:
        """Setting changes retrace + reset accumulation, like the
        reference's reactive pipeline rebuild (gpu.ts:512-525)."""
        self.settings = self.settings.replace(**kw)
        if kw.keys() & {
            "width", "height", "resolution_scale", "geometry_buffer_scale"
        }:
            self.buffers = FrameBuffers.create(
                self.settings.render_width,
                self.settings.render_height,
                self.settings.geo_height,
            )
        self.reset()

    def move_camera(self, d) -> None:
        if self.camera.move(np.asarray(d, dtype=np.float32)):
            self.reset()

    def rotate_camera(self, d) -> None:
        if self.camera.rotate(np.asarray(d, dtype=np.float32)):
            self.reset()

    def step(self, seed: Optional[int] = None) -> None:
        """renderFrame (render.ts:1651-1710)."""
        if seed is None:
            seed = int(self._rng.integers(0, 2**32, dtype=np.uint64))
        rate = self.settings.reprojection_rate
        update_prev = rate == 0 or self.frame_counter % rate == 0
        if rate:
            self.frame_counter = (self.frame_counter + 1) % rate
        if update_prev or self._jitter is None:
            # the reference rewrites the jitter uniform only when
            # updatePrev fires (render.ts:1660-1665), keeping intermediate
            # frames aligned with the prev-buffer snapshot
            self._jitter = (
                (self._rng.random(2).astype(np.float32) - 0.5)
                * self.settings.jitter_strength
            )
        jitter = self._jitter
        frustum = reprojection_frustum(
            self._prev_view,
            self.settings.render_width,
            self.settings.render_height,
            self.settings.fov,
        )
        view = self.camera.view_matrix()
        inputs = FrameInputs(
            view=jnp.asarray(view),
            seed=jnp.uint32(seed),
            counter=jnp.int32(self.counter),
            jitter=jnp.asarray(jitter),
            frustum=jnp.asarray(frustum),
            prev_origin=jnp.asarray(self._prev_view[:3, 3]),
        )
        frame_fn = (
            render_frame_slabs
            if self.settings.frame_slabs > 1
            else render_frame
        )
        self.buffers, rays = frame_fn(
            self.buffers, self.tables, self.env_data, inputs, self.settings
        )
        self.last_rays = float(rays)
        self.counter += 1
        if update_prev:
            self.buffers = self.buffers.rotated()
            self._prev_view = view

    def render(self, spp: int) -> np.ndarray:
        """Accumulate until >= spp samples/pixel; return display image."""
        per_frame = 1 + self.settings.sample_count
        while self.counter * per_frame < spp:
            self.step()
        return self.image()

    def image(self) -> np.ndarray:
        """Display image, top row first. The reference's fullscreen blit
        maps buffer row 0 to the *bottom* of the canvas (uv (0,0) at clip
        (-1,-1), render.ts:163-183, 235-239), so the buffer is flipped
        here to match the on-screen orientation. The debug BVH wireframe
        overlay (render.ts:1685-1692) composites last."""
        img = blit(self.buffers.image, self.buffers.prev_image, self.settings)
        if self.settings.debug_bvh:
            from .ops.wireframe import overlay_wireframe, rasterize_bvh_wireframe

            vp = self.camera.view_projection_matrix(
                self.settings.width, self.settings.height, self.settings.fov
            )
            wire = rasterize_bvh_wireframe(
                self.tables.node_box[:, 0:3],
                self.tables.node_box[:, 3:6],
                jnp.asarray(vp),
                self.settings.width,
                self.settings.height,
            )
            img = overlay_wireframe(img, wire[::-1])
        return np.asarray(img)[::-1]

    # --- checkpoint / resume of the progressive accumulation state ---
    def save_checkpoint(self, path: str) -> None:
        """Atomic: a 4K stress checkpoint is ~0.5 GB and takes tens of
        seconds to serialize on a 1-vCPU host — an interrupt landing
        inside the write must never destroy the previous good
        checkpoint (measured failure mode: a mid-save SIGTERM left a
        truncated npz and the resume died with BadZipFile). Write to a
        sibling temp file, fsync, then os.replace."""
        import os

        arrays = {
            f.name: np.asarray(getattr(self.buffers, f.name))
            for f in dataclasses.fields(FrameBuffers)
        }
        final = path if path.endswith(".npz") else path + ".npz"
        tmp = final + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(
                fh,
                counter=self.counter,
                frame_counter=self.frame_counter,
                cam_position=self.camera.position,
                cam_orientation=self.camera.orientation,
                prev_view=self._prev_view,
                **arrays,
            )
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)

    def load_checkpoint(self, path: str) -> None:
        z = np.load(path)
        self.buffers = FrameBuffers(
            **{
                f.name: jnp.asarray(z[f.name])
                for f in dataclasses.fields(FrameBuffers)
            }
        )
        self.counter = int(z["counter"])
        self.frame_counter = int(z["frame_counter"])
        self.camera.position = z["cam_position"]
        self.camera.orientation = z["cam_orientation"]
        self._prev_view = z["prev_view"]
