"""Headless CLI frontend.

The reference's frontend is a SolidJS browser UI (UI.tsx, index.tsx) with
live timers; the headless equivalent is render-to-file plus a benchmark
mode reporting rays/sec and wall-clock-to-N-spp (replacing the UI's
GPU-time/JS-time/Update-time readouts, UI.tsx:26-42), an orbit mode for
the scripted-camera config, and checkpoint/resume of long renders.

Usage:
    python -m webgpu_raytracing_tpu.frontend.cli render --size 512 --spp 16 -o out.png
    python -m webgpu_raytracing_tpu.frontend.cli bench --size 1080p --frames 4
    python -m webgpu_raytracing_tpu.frontend.cli orbit --frames 8 --spp 4 -o orbit_dir
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..utils.paths import ASSETS_DIR

DEFAULT_OBJ = os.path.join(ASSETS_DIR, "raytraced-scene.obj")
DEFAULT_MTL = os.path.join(ASSETS_DIR, "raytraced-scene.mtl")
CUBEMAP_FACES = [
    "right.jpg", "left.jpg", "top.jpg", "bottom.jpg", "front.jpg", "back.jpg",
]


def _enable_cache():
    from ..utils.paths import enable_compile_cache

    enable_compile_cache()


def _parse_size(s: str):
    if s == "1080p":
        return 1920, 1080
    if s == "4k":
        return 3840, 2160
    if "x" in s:
        w, h = s.split("x")
        return int(w), int(h)
    return int(s), int(s)


def _build(args):
    from ..config import RenderSettings, ProjectionType, Tonemapping
    from ..models.scene import load_scene
    from ..renderer import Renderer

    width, height = _parse_size(args.size)
    env_data = None
    environment = args.env
    if environment == "cubemap":
        from ..utils.image import load_cubemap

        base = os.path.dirname(args.obj)
        env_data = load_cubemap(
            [os.path.join(base, f) for f in CUBEMAP_FACES]
        )
    elif environment == "equirect":
        from ..utils.image import read_exr, read_hdr

        path = args.env_file
        if not path or not os.path.exists(path):
            raise SystemExit(
                "--env equirect requires --env-file pointing to an "
                ".exr/.hdr asset"
            )
        env_data = (
            read_exr(path) if path.endswith(".exr") else read_hdr(path)
        )
        if args.env_importance:
            from ..ops.env_sample import build_env_distribution

            env_data = build_env_distribution(env_data)

    settings = RenderSettings(
        width=width,
        height=height,
        sample_count=args.sample_count,
        bounces_depth=args.bounces,
        environment=environment,
        env_importance_sampling=bool(
            args.env_importance and environment == "equirect"
        ),
        projection_type=ProjectionType[args.projection.upper()],
        tonemapping=Tonemapping[args.tonemap.upper()],
        reprojection_rate=args.reprojection_rate,
        debug_bvh=args.debug_bvh,
    )
    settings = _apply_opts(settings, getattr(args, "opt", []))
    if getattr(args, "scene", "bundled") == "analytic":
        from ..models.analytic import analytic_scene

        scene = analytic_scene()
    elif getattr(args, "scene", "bundled") == "stress1m":
        from ..models.stress import stress_scene

        scene = stress_scene(1_000_000)
    else:
        if not (os.path.exists(args.obj) and os.path.exists(args.mtl)):
            raise SystemExit(
                f"scene assets not found ({args.obj}); pass --obj/--mtl "
                "or use --scene analytic / --scene stress1m"
            )
        scene = load_scene(args.obj, args.mtl)
    return Renderer(scene, settings, env_data=env_data, base_seed=args.seed)


def _apply_opts(settings, opts):
    """Apply ``--opt field=value`` overrides, coerced to the dataclass
    field's type (bool accepts 0/1/true/false; enums by member name)."""
    import dataclasses
    import enum

    fields = {f.name: f for f in dataclasses.fields(type(settings))}
    kw = {}
    for item in opts:
        name, _, raw = item.partition("=")
        if name not in fields or not _:
            valid = ", ".join(sorted(fields))
            raise SystemExit(
                f"--opt {item!r}: unknown field {name!r}; valid: {valid}"
            )
        cur = getattr(settings, name)
        if isinstance(cur, bool):
            kw[name] = raw.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, enum.Enum):
            kw[name] = type(cur)[raw.upper()]
        elif isinstance(cur, int):
            kw[name] = int(raw)
        elif isinstance(cur, float):
            kw[name] = float(raw)
        else:
            kw[name] = raw
    return settings.replace(**kw) if kw else settings


def cmd_render(args):
    import contextlib

    from ..utils.image import write_png
    from ..utils.timing import FrameMetrics, profile_trace

    _enable_cache()
    r = _build(args)
    if args.resume and os.path.exists(args.resume):
        r.load_checkpoint(args.resume)
        print(f"resumed at counter={r.counter}")
    metrics = FrameMetrics(path=args.metrics)
    per_frame = 1 + r.settings.sample_count
    prof = profile_trace(args.profile) if args.profile else contextlib.nullcontext()
    with prof:
        while r.counter * per_frame < args.spp:
            t0 = time.perf_counter()
            r.step()
            row = metrics.record(
                time.perf_counter() - t0, r.last_rays,
                r.counter * per_frame,
            )
            print(json.dumps(row))
            if args.checkpoint and r.counter % args.checkpoint_every == 0:
                r.save_checkpoint(args.checkpoint)
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
    metrics.close()
    write_png(args.output, r.image())
    print(f"wrote {args.output}")


def cmd_bench(args):
    import jax

    _enable_cache()
    r = _build(args)
    r.step()  # compile
    jax.block_until_ready(r.buffers.image)
    t0 = time.perf_counter()
    total = 0.0
    for _ in range(args.frames):
        r.step()
        total += r.last_rays
    jax.block_until_ready(r.buffers.image)
    dt = time.perf_counter() - t0
    spp = (1 + r.settings.sample_count) * args.frames
    print(
        json.dumps(
            {
                "metric": f"Mrays/sec @{args.size}",
                "value": round(total / dt / 1e6, 3),
                "unit": "Mrays/s",
                "frames": args.frames,
                "spp": spp,
                "wall_s_per_frame": round(dt / args.frames, 4),
            }
        )
    )


def cmd_orbit(args):
    """Scripted camera orbit with reset-on-move (BASELINE config #4)."""
    from ..camera import orbit_path
    from ..utils.image import write_png

    _enable_cache()
    r = _build(args)
    os.makedirs(args.output, exist_ok=True)
    per_frame = 1 + r.settings.sample_count
    for k, cam in enumerate(
        orbit_path(np.array([0.0, 1.0, -6.0]), 6.0, 1.0, args.frames)
    ):
        r.camera = cam
        r.reset()  # camera moved → accumulation restarts (store.ts:340-343)
        while r.counter * per_frame < args.spp:
            r.step()
        out = os.path.join(args.output, f"orbit_{k:03d}.png")
        write_png(out, r.image())
        print(f"wrote {out} (spp={r.counter * per_frame})")


# BASELINE.json milestone configs (see BASELINE.md) as CLI argv.
CONFIG_PRESETS = {
    # 1: analytic spheres+plane, 256x256 @ 1 spp, direct lighting only
    1: ["render", "--size", "256x256", "--spp", "1", "--bounces", "1",
        "--projection", "perspective", "--scene", "analytic"],
    # 2: bundled OBJ + BVH, 512x512 @ 4 spp, cubemap skybox
    2: ["render", "--size", "512x512", "--spp", "4", "--env", "cubemap"],
    # 3: OBJ + 4k HDR env importance sampling, 1080p @ 16 spp
    3: ["render", "--size", "1080p", "--spp", "16", "--env", "equirect",
        "--env-importance"],
    # 4: progressive accumulation to 1024 spp with scripted orbit
    4: ["orbit", "--size", "256x256", "--spp", "1024", "--frames", "4"],
    # 5: 1M-triangle stress scene, 4K @ 256 spp. One slab: the whole
    # 4K frame peaks at 25.5 GB of device memory on an 80 GB H100
    # (PERF.md), so renderer.render_frame_slabs is not needed here
    5: ["render", "--size", "4k", "--spp", "256", "--scene", "stress1m"],
}


def cmd_config(args):
    """BASELINE.json milestone configs (see BASELINE.md)."""
    argv = list(CONFIG_PRESETS[args.n])
    if args.output:
        argv += ["-o", args.output]
    if args.env_file:
        argv += ["--env-file", args.env_file]
    if args.spp is not None:
        i = argv.index("--spp")
        argv[i + 1] = str(args.spp)
    print(json.dumps({"config": args.n, "argv": argv}))
    main(argv)


def cmd_compare(args):
    """RMSE between two images (the parity metric, BASELINE.md)."""
    from ..utils.image import read_image, rmse

    a = read_image(args.a)
    b = read_image(args.b)
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch: {a.shape} vs {b.shape}")
    val = rmse(a, b)
    print(json.dumps({"rmse": round(val, 6), "a": args.a, "b": args.b,
                      "within_1e-2": bool(val <= 1e-2)}))


def cmd_serve(args):
    """Live progressive viewer (the reference's defining capability:
    index.tsx:19-28 rAF loop + UI.tsx panel + controls.ts FPS camera)."""
    _enable_cache()
    from .viewer import serve

    renderer = _build(args)
    serve(
        renderer,
        host=args.host,
        port=args.port,
        scale=args.view_scale,
        max_frames=args.max_frames,
    )


def build_parser():
    p = argparse.ArgumentParser(prog="webgpu_raytracing_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument(
            "--scene", default="bundled",
            choices=["bundled", "analytic", "stress1m"],
        )
        sp.add_argument("--obj", default=DEFAULT_OBJ)
        sp.add_argument("--mtl", default=DEFAULT_MTL)
        sp.add_argument("--size", default="256x256")
        sp.add_argument("--spp", type=int, default=8)
        sp.add_argument("--sample-count", type=int, default=1)
        sp.add_argument("--bounces", type=int, default=4)
        sp.add_argument(
            "--env",
            default="procedural",
            choices=["procedural", "cubemap", "equirect", "black", "white"],
        )
        sp.add_argument("--env-file", default=None)
        sp.add_argument(
            "--env-importance", action="store_true",
            help="luminance importance sampling of the equirect env (MIS)",
        )
        sp.add_argument(
            "--projection",
            default="panini",
            choices=["fisheye", "panini", "perspective", "orthographic"],
        )
        sp.add_argument(
            "--tonemap",
            default="none",
            choices=["reinhard", "filmic", "aces", "lottes", "none"],
        )
        sp.add_argument("--reprojection-rate", type=int, default=0)
        sp.add_argument("--debug-bvh", action="store_true")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument(
            "--opt", action="append", default=[], metavar="FIELD=VALUE",
            help="override any RenderSettings field by name (repeatable), "
            "e.g. --opt chained_sort=1 --opt traversal=clustered --opt "
            "trace_tile=128 — the A/B knob for perf work",
        )

    sp = sub.add_parser("render", help="render to PNG")
    common(sp)
    sp.add_argument("-o", "--output", default="out.png")
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--checkpoint-every", type=int, default=16)
    sp.add_argument("--resume", default=None)
    sp.add_argument("--metrics", default=None, help="JSONL metrics path")
    sp.add_argument("--profile", default=None, help="jax.profiler trace dir")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("compare", help="RMSE between two images")
    sp.add_argument("a")
    sp.add_argument("b")
    sp.set_defaults(fn=cmd_compare)

    sp = sub.add_parser(
        "config", help="run a BASELINE milestone config (1-5)"
    )
    sp.add_argument("n", type=int, choices=[1, 2, 3, 4, 5])
    sp.add_argument("-o", "--output", default=None)
    sp.add_argument("--env-file", default=None,
                    help="equirect .exr/.hdr for config 3")
    sp.add_argument("--spp", type=int, default=None, help="override spp")
    sp.set_defaults(fn=cmd_config)

    sp = sub.add_parser("bench", help="throughput benchmark")
    common(sp)
    sp.add_argument("--frames", type=int, default=4)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("orbit", help="scripted camera orbit")
    common(sp)
    sp.add_argument("-o", "--output", default="orbit_out")
    sp.add_argument("--frames", type=int, default=8)
    sp.set_defaults(fn=cmd_orbit)

    sp = sub.add_parser(
        "serve",
        help="live progressive viewer (browser at http://host:port)",
    )
    common(sp)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8787)
    sp.add_argument("--view-scale", type=int, default=2,
                    help="browser upscaling of the render")
    sp.add_argument("--max-frames", type=int, default=None)
    sp.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
