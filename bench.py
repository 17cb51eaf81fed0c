"""Benchmark: Mrays/sec on one GPU at 1080p on the bundled OBJ scene.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} plus the
second primary metric from BASELINE.md — the wall-clock to accumulate
256 spp at 1080p — and the device it ran on (platform, device_kind,
count). Each frame adds (1 + sample_count) spp, so with the default
sample_count=1 a full 256-spp accumulation is 128 frames; when the time
budget allows, the bench runs ALL 128 frames and reports the measured
number as "wall_clock_256spp_measured_s" (plus the steady-state
extrapolation "wall_clock_256spp_s"). If the projected full run exceeds
the budget, only the extrapolation is reported.

The environment is the cubemap texture bundled with the scene (config
#2's skybox). The scene and cubemap are read from the checkout's
``assets/`` directory; the bench fails when they are absent, and it
fails when JAX finds no GPU — it never times the CPU.

Ray accounting is honest wavefront accounting: every traced path segment
(primary + bounces, while the lane is alive) counts as one ray; shadow rays
count when NEE is enabled. The counter is computed on-device during the
timed run (a single scalar reduction per segment).
"""

from __future__ import annotations

import json
import os
import time


def device_summary() -> dict:
    """The device JAX computes on; raises when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench: no GPU found (JAX platform {dev.platform!r}); "
            "refusing to time another device"
        )
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def main(
    width: int = 1920,
    height: int = 1080,
    n_frames: int = 16,
    full_spp_budget_s: float = 900.0,
):
    import jax

    device = device_summary()

    from webgpu_raytracing_tpu.utils.paths import (
        ASSETS_DIR,
        enable_compile_cache,
    )

    enable_compile_cache()
    import jax.numpy as jnp

    from webgpu_raytracing_tpu.config import RenderSettings
    from webgpu_raytracing_tpu.models.scene import load_scene
    from webgpu_raytracing_tpu.renderer import (
        FrameBuffers,
        FrameInputs,
        render_frame,
    )
    from webgpu_raytracing_tpu.utils.image import load_cubemap

    obj = os.path.join(ASSETS_DIR, "raytraced-scene.obj")
    mtl = os.path.join(ASSETS_DIR, "raytraced-scene.mtl")
    if not (os.path.exists(obj) and os.path.exists(mtl)):
        raise SystemExit(f"bench: scene assets not found in {ASSETS_DIR}")
    settings = RenderSettings(
        width=width,
        height=height,
        environment="cubemap",
        sample_count=1,
        bounces_depth=4,
    )
    tables = jax.device_put(load_scene(obj, mtl).tables())
    env = jnp.asarray(
        load_cubemap(
            [
                os.path.join(ASSETS_DIR, f"{f}.jpg")
                for f in ("right", "left", "top", "bottom", "front", "back")
            ]
        )
    )
    buffers = FrameBuffers.create(width, height)
    view = jnp.eye(4, dtype=jnp.float32)

    # warmup / compile (two frames: the second covers the donated-buffer
    # signature)
    t0 = time.perf_counter()
    for k in range(2):
        buffers, rays = render_frame(
            buffers, tables, env, FrameInputs.simple(view, k + 1, k),
            settings,
        )
        jax.block_until_ready(rays)
    setup_s = time.perf_counter() - t0

    spp_per_frame = 1 + settings.sample_count
    frames_256 = max(1, round(256 / spp_per_frame))

    def timed_frames(buffers, start_counter, count):
        """Run `count` frames with on-device ray accumulation (no per-frame
        host sync, so dispatches pipeline); block_until_ready ends the
        timed region."""
        total_rays_dev = jnp.zeros((), jnp.float32)
        t0 = time.perf_counter()
        for k in range(count):
            c = start_counter + k
            buffers, rays = render_frame(
                buffers,
                tables,
                env,
                FrameInputs.simple(view, 2654435761 * (c + 2) % (2**32), c),
                settings,
            )
            total_rays_dev = total_rays_dev + rays
        jax.block_until_ready((buffers, total_rays_dev))
        return buffers, float(total_rays_dev), time.perf_counter() - t0

    # Phase 1: headline chunk.
    n1 = min(n_frames, frames_256)
    buffers, rays1, dt1 = timed_frames(buffers, 1, n1)

    # Phase 2: finish the 256-spp accumulation if the budget allows, so the
    # second primary metric is a measurement, not an extrapolation.
    remaining = frames_256 - n1
    projected = dt1 + remaining * (dt1 / n1)
    measured_256 = None
    total_rays, total_dt = rays1, dt1
    if remaining > 0 and projected <= full_spp_budget_s:
        buffers, rays2, dt2 = timed_frames(buffers, 1 + n1, remaining)
        total_rays += rays2
        total_dt += dt2
        measured_256 = dt1 + dt2
    elif remaining == 0:
        measured_256 = dt1

    frames_timed = n1 + (remaining if measured_256 is not None else 0)
    mrays = total_rays / total_dt / 1e6
    secs_256_extrap = frames_256 * (total_dt / frames_timed)
    out = {
        "metric": "Mrays/sec/device @1080p bundled OBJ scene",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / 100.0, 4),
        "wall_clock_256spp_s": round(secs_256_extrap, 1),
        "setup_s": round(setup_s, 1),
        "environment": settings.environment,
        "frames_timed": frames_timed,
        "device": device,
        "peak_bytes_in_use": jax.devices()[0]
        .memory_stats()
        .get("peak_bytes_in_use"),
    }
    if measured_256 is not None:
        out["wall_clock_256spp_measured_s"] = round(measured_256, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
