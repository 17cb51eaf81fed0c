#!/usr/bin/env python3
"""On-card smoke test: the renderer's main path on one GPU, end to end.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the row-sharded config-#5
                                   # frame against the same frame on one

Phases on one card, in one process (a second JAX process could not get
the card's memory):

* ``config1_analytic`` — BASELINE config #1 (analytic scene, 256², direct
  lighting, so every pixel runs the any-hit shadow leg), through the CLI;
* ``stress1m_1080p`` — the 1M-triangle scene at 1920x1080, default
  settings, a few frames, through the CLI;
* ``config5_4k`` — the config-#5 preset (stress1m at 3840x2160), two
  frames, through the CLI;
* ``kernel_vs_xla`` — one frame with ``traversal`` resolved to the Triton
  kernel ("auto") and to the plain XLA path ("clustered"), interleaved
  (xla, kernel, kernel, xla) and cache-warm, on stress1m 1080p and
  analytic 256²; the frame RMSE between the two;
* ``trace_parity`` — the kernel against the threaded oracle
  (``ops/traverse.py``) on all primary rays of a 1080p stress1m frame, one
  sorted bounce segment and its shadow rays, and the analytic scene;
* ``wgsl_parity`` — the analytic 48² frame against the WGSL-semantics
  simulator at equal spp, with and without the ``detmath`` chain.

Each phase prints one JSON line; any failed check raises, so the script
exits non-zero. The card's name and power limit come from ``nvidia-smi``
in a subprocess. The last line is the device summary JSON. Without a GPU
the script fails before running any phase. Outputs (PNGs, per-frame
metrics) go to ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

# §4 tolerances: knife-edge flips from FMA contraction on the card
FACE_AGREE_MIN = 0.9999
T_REL_TOL = 1e-5
FRAME_RMSE_KERNEL_VS_XLA = 1e-3
FRAME_RMSE_VS_WGSL = 1e-2


def log(**kw) -> None:
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def require_gpus(n: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})"
        )
    if len(devs) < n:
        raise SystemExit(f"chip_smoke: needs {n} GPUs, found {len(devs)}")
    return devs


def memory(dev=None) -> dict:
    """``memory_stats()`` of a device (the first by default)."""
    import jax

    return (dev or jax.devices()[0]).memory_stats() or {}


def peak_bytes(dev=None):
    return memory(dev).get("peak_bytes_in_use")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def normalized(img):
    import numpy as np

    img = np.asarray(img, np.float64)
    return img[..., :3] / np.maximum(img[..., 3:4], 1e-20)


def rmse(a, b) -> float:
    import numpy as np

    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


# ---------------------------------------------------------------- phases


def cli_render(label: str, argv: list) -> dict:
    """Render through ``cli.main`` and summarize its per-frame metrics:
    the first frame carries compilation (set-up), the rest are steady."""
    import numpy as np

    from webgpu_raytracing_tpu.frontend import cli
    from webgpu_raytracing_tpu.utils.image import read_image

    metrics = os.path.join(OUT_DIR, f"{label}.jsonl")
    png = os.path.join(OUT_DIR, f"{label}.png")
    if os.path.exists(metrics):
        os.remove(metrics)
    cli.main(argv + ["--metrics", metrics, "-o", png])
    with open(metrics) as fh:
        rows = [json.loads(line) for line in fh]
    img = read_image(png)
    check(np.isfinite(img).all() and img.ndim == 3, f"{label}: bad image")
    steady = rows[1:] or rows
    frame_s = float(np.median([r["frame_ms"] for r in steady])) / 1e3
    rays = float(np.median([r["rays"] for r in steady]))
    check(rays > 0, f"{label}: no rays traced")
    out = {
        "phase": label,
        "frames": len(rows),
        "spp": rows[-1]["spp"],
        "image": list(img.shape),
        "first_frame_s": rows[0]["frame_ms"] / 1e3,
        "compile_s": max(0.0, rows[0]["frame_ms"] / 1e3 - frame_s),
        "frame_s": frame_s,
        "rays_per_frame": rays,
        "mrays_per_s": rays / frame_s / 1e6,
        "peak_bytes_in_use": peak_bytes(),
    }
    log(**out)
    return out


def phase_cli_frames() -> None:
    from webgpu_raytracing_tpu.frontend.cli import CONFIG_PRESETS

    def with_spp(argv, spp):
        argv = list(argv)
        argv[argv.index("--spp") + 1] = str(spp)
        return argv

    # ascending size, so each cumulative peak belongs to its phase
    cli_render("config1_analytic", with_spp(CONFIG_PRESETS[1], 8))
    cli_render(
        "stress1m_1080p",
        ["render", "--scene", "stress1m", "--size", "1080p", "--spp", "8"],
    )
    cli_render("config5_4k", with_spp(CONFIG_PRESETS[5], 4))


def build_renderer(argv: list):
    from webgpu_raytracing_tpu.frontend import cli

    return cli._build(cli.build_parser().parse_args(argv))


def phase_kernel_vs_xla() -> None:
    """Frame time with traversal resolved to each backend, one process,
    interleaved (xla, kernel, kernel, xla), after a warm-up frame each."""
    import numpy as np

    from webgpu_raytracing_tpu.ops.integrator import _resolve_backend

    cases = (
        ("stress1m_1080p",
         ["render", "--scene", "stress1m", "--size", "1080p"]),
        ("analytic_256", ["render", "--scene", "analytic", "--size", "256"]),
    )
    for label, argv in cases:
        r = build_renderer(argv)
        check(_resolve_backend(r.settings) == "triton",
              "auto must pick the kernel on a GPU")
        times = {"clustered": [], "auto": []}
        images = {}
        for arm in ("clustered", "auto"):  # warm-up (compiles)
            r.update_settings(traversal=arm)
            r.step(seed=1)
        for arm in ("clustered", "auto", "auto", "clustered"):
            r.update_settings(traversal=arm)  # resets accumulation
            t0 = time.perf_counter()
            r.step(seed=1234)  # the step reads its ray count back
            times[arm].append(time.perf_counter() - t0)
            images[arm] = np.asarray(r.buffers.image)
        a, b = normalized(images["clustered"]), normalized(images["auto"])
        check(np.array_equal(images["clustered"][..., 3],
                             images["auto"][..., 3]), "unequal spp")
        frame_rmse = rmse(a, b)
        out = {
            "phase": f"kernel_vs_xla_{label}",
            "xla_frame_s": times["clustered"],
            "kernel_frame_s": times["auto"],
            "rays_per_frame": r.last_rays,
            "frame_rmse": frame_rmse,
            "pixels_differing": int((np.abs(a - b).max(-1) > 1e-6).sum()),
        }
        log(**out)
        check(frame_rmse <= FRAME_RMSE_KERNEL_VS_XLA,
              f"{label}: kernel-vs-XLA frame RMSE {frame_rmse}")
        del r


def compare_hits(label, got, ref, active=None) -> dict:
    import numpy as np

    gf, rf = np.asarray(got.face), np.asarray(ref.face)
    gt, rt = np.asarray(got.t), np.asarray(ref.t)
    sel = np.ones(gf.shape, bool) if active is None else np.asarray(active)
    agree = (gf == rf)[sel]
    both = (gf == rf) & (rf >= 0) & sel
    rel = np.abs(gt - rt)[both] / np.maximum(1.0, np.abs(rt[both]))
    out = {
        "rays": int(sel.sum()),
        "hits_ref": int((rf[sel] >= 0).sum()),
        "face_agree": float(agree.mean()),
        "face_differ": int((~agree).sum()),
        "t_max_rel_err": float(rel.max()) if rel.size else 0.0,
        "t_over_tol": int((rel > T_REL_TOL).sum()),
    }
    log(phase="trace_parity", leg=label, **out)
    check(out["face_agree"] >= FACE_AGREE_MIN, f"{label}: face agreement")
    check(out["t_over_tol"] == 0, f"{label}: t beyond {T_REL_TOL}")
    return out


def compare_flags(label, got, ref, active) -> None:
    import numpy as np

    sel = np.asarray(active)
    agree = (np.asarray(got) == np.asarray(ref))[sel]
    log(phase="trace_parity", leg=label, rays=int(sel.sum()),
        blocked_ref=int(np.asarray(ref)[sel].sum()),
        flag_agree=float(agree.mean()), flag_differ=int((~agree).sum()))
    check(agree.mean() >= FACE_AGREE_MIN, f"{label}: blocked-flag agreement")


def phase_trace_parity() -> None:
    """Kernel vs the threaded oracle at real widths."""
    import jax
    import jax.numpy as jnp

    from webgpu_raytracing_tpu.config import F32_MAX
    from webgpu_raytracing_tpu.ops import integrator, rng
    from webgpu_raytracing_tpu.ops.raygen import camera_rays
    from webgpu_raytracing_tpu.ops.traverse import trace_any, trace_closest

    for label, argv in (
        ("stress1m_1080p",
         ["render", "--scene", "stress1m", "--size", "1080p"]),
        ("analytic_256", ["render", "--scene", "analytic", "--size", "256"]),
    ):
        r = build_renderer(argv)
        s, tables = r.settings, jax.device_put(r.tables)
        w, h = s.render_width, s.render_height
        n = w * h
        ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        pos = jnp.stack([xs, ys], -1).reshape(n, 2).astype(jnp.float32)
        state = rng.seed_state(
            jnp.full((n,), 99, jnp.uint32), jnp.arange(n, dtype=jnp.int32)
        )
        view = jnp.asarray(r.camera.view_matrix())
        o, d, state = jax.jit(camera_rays, static_argnames="settings")(
            pos, view, state, s
        )
        t_max = jnp.full((n,), F32_MAX, jnp.float32)

        closest = jax.jit(
            integrator._trace_closest,
            static_argnames=("settings", "sort", "seg"),
        )
        any_hit = jax.jit(
            integrator._trace_any, static_argnames=("settings", "sort", "seg")
        )
        oracle = jax.jit(trace_closest)
        oracle_any = jax.jit(trace_any)

        ref = oracle(o, d, t_max, tables)
        got = closest(o, d, t_max, tables, s)
        compare_hits(f"{label}_primary", got, ref)

        # one bounce segment from the oracle's primary hits, traced the
        # way the integrator traces it (sorted, live-sliced), and its
        # light-sample shadow rays
        @jax.jit
        def bounce(hit, state, tables):
            face = jnp.maximum(hit.face, 0)
            tri = jnp.take(tables.tri, face, axis=0)
            shade = jnp.take(tables.shade_normal, face, axis=0)
            nrm = integrator.face_normal(shade, hit.u, hit.v, s.shading_type)
            new_o = integrator.face_point_offset(tri, shade, hit.u, hit.v)
            t2, state = rng.random_2(state)
            new_d = rng.sample_cosine_weighted_hemisphere(t2, nrm)
            ls, state = integrator.sample_lights(state, tables, s)
            ds = ls.point - new_o
            dist = jnp.sqrt(jnp.sum(ds * ds, axis=-1))
            sdir = ds / jnp.maximum(dist, 1e-20)[:, None]
            return new_o, new_d, sdir, dist

        active = ref.face >= 0
        new_o, new_d, sdir, dist = bounce(ref, state, tables)
        ref_b = oracle(new_o, new_d, t_max, tables, active)
        got_b = closest(new_o, new_d, t_max, tables, s, active,
                        sort=True, seg=1)
        compare_hits(f"{label}_bounce_sorted", got_b, ref_b, active)
        ref_s = oracle_any(new_o, sdir, dist, tables, active)
        got_s = any_hit(new_o, sdir, dist, tables, s, active,
                        sort=True, seg=1)
        compare_flags(f"{label}_shadow_sorted", got_s, ref_s, active)
        del r


@contextlib.contextmanager
def plain_math():
    """Swap the ``detmath`` chain for the platform's own divide, sqrt and
    trig (measurement only), dropping compiled frames around it."""
    import jax
    import jax.numpy as jnp

    from webgpu_raytracing_tpu.ops import detmath, raygen

    def normalize(v, eps=1e-20):
        return v / jnp.maximum(
            jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True)), eps
        )

    plain = {
        "det_div": lambda a, b: jnp.asarray(a, jnp.float32) / b,
        "det_sqrt": jnp.sqrt,
        "det_sincos": lambda x: (jnp.sin(x), jnp.cos(x)),
        "det_sin": jnp.sin,
        "det_cos": jnp.cos,
        "det_tan": jnp.tan,
        "normalize": normalize,
    }
    alias = {"_det_div": "det_div", "_det_sincos": "det_sincos",
             "_det_tan": "det_tan", "_normalize": "normalize"}
    saved = {k: getattr(detmath, k) for k in plain}
    saved_r = {k: getattr(raygen, k) for k in alias}
    jax.clear_caches()
    try:
        for k, f in plain.items():
            setattr(detmath, k, f)
        for k, v in alias.items():
            setattr(raygen, k, plain[v])
        yield
    finally:
        for k, f in saved.items():
            setattr(detmath, k, f)
        for k, f in saved_r.items():
            setattr(raygen, k, f)
        jax.clear_caches()


def phase_wgsl_parity() -> None:
    """The analytic 48² frame against the WGSL-semantics simulator."""
    import numpy as np

    from webgpu_raytracing_tpu.camera import Camera
    from webgpu_raytracing_tpu.config import RenderSettings
    from webgpu_raytracing_tpu.models.analytic import analytic_scene
    from webgpu_raytracing_tpu.renderer import Renderer
    from webgpu_raytracing_tpu.validation.envs import synthetic_equirect
    from webgpu_raytracing_tpu.validation.wgsl_sim import WGSLReference

    size, seeds = 48, (12345, 987654321)
    settings = RenderSettings(
        width=size, height=size, environment="equirect",
        sample_count=1, bounces_depth=4,
    )
    scene, env = analytic_scene(), synthetic_equirect()
    sim = WGSLReference(scene, settings, env)
    for seed in seeds:
        sim.step(seed, Camera().view_matrix())

    def render():
        r = Renderer(scene, settings, env_data=env)
        for seed in seeds:
            r.step(seed=seed)
        return np.asarray(r.buffers.image)

    results = {}
    for arm in ("detmath", "plain_math"):
        ctx = plain_math() if arm == "plain_math" else contextlib.nullcontext()
        with ctx:
            img = render()
        check(np.array_equal(img[..., 3], sim.image[..., 3]), "unequal spp")
        a, b = normalized(img), normalized(sim.image)
        results[arm] = {
            "rmse": rmse(a, b),
            "pixels_differing": int((np.abs(a - b).max(-1) > 1e-6).sum()),
        }
    log(phase="wgsl_parity", size=size, spp=int(sim.image[0, 0, 3]),
        **results)
    check(results["detmath"]["rmse"] <= FRAME_RMSE_VS_WGSL,
          f"RMSE vs WGSL simulator {results['detmath']['rmse']}")


def phase_four() -> None:
    """Config #5 (stress1m, 4K) row-sharded over 4 cards against the same
    frame on one card. Per-pixel RNG is globally indexed, so the two
    images must be identical."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from webgpu_raytracing_tpu.frontend.cli import CONFIG_PRESETS
    from webgpu_raytracing_tpu.parallel.shard import (
        make_mesh,
        replicate,
        shard_buffers,
        sharded_render_frame,
    )
    from webgpu_raytracing_tpu.renderer import (
        FrameBuffers,
        FrameInputs,
        render_frame,
        render_frame_slabs,
    )

    r = build_renderer(list(CONFIG_PRESETS[5]))
    settings = r.settings
    inputs = FrameInputs.simple(r.camera.view_matrix(), 4321, 0)
    mesh = make_mesh(4)
    shard_settings = settings.replace(frame_slabs=1)
    fn = sharded_render_frame(mesh, shard_settings)
    tables = replicate(r.tables, mesh)
    env = replicate(r.env_data, mesh)
    inp = replicate(inputs, mesh)
    times = []
    for _ in range(2):  # compile + one steady frame (counter 0: no accum)
        bufs = shard_buffers(
            FrameBuffers.create(settings.render_width, settings.render_height),
            mesh,
        )
        t0 = time.perf_counter()
        bufs, rays = fn(bufs, tables, env, inp)
        jax.block_until_ready((bufs, rays))
        times.append(time.perf_counter() - t0)
    shards = [
        {"device": str(s.device), "rows": list(s.data.shape)[:2],
         "slab_bytes": int(s.data.nbytes),
         "bytes_in_use": memory(s.device).get("bytes_in_use"),
         "peak_bytes_in_use": memory(s.device).get("peak_bytes_in_use")}
        for s in bufs.image.addressable_shards
    ]
    sharded = np.asarray(bufs.image)
    sharded_rays = float(rays)
    check(len({s["device"] for s in shards}) == 4, "slabs not on 4 devices")
    check(all(s["bytes_in_use"] is None or s["bytes_in_use"] >= s["slab_bytes"]
              for s in shards), "a device does not hold its slab")
    del bufs, tables, env, inp

    dev0 = jax.devices()[0]
    one = jax.device_put(
        FrameBuffers.create(settings.render_width, settings.render_height),
        dev0,
    )
    frame_fn = render_frame_slabs if settings.frame_slabs > 1 else render_frame
    t0 = time.perf_counter()
    one, rays1 = frame_fn(
        one, jax.device_put(r.tables, dev0), jnp.asarray(r.env_data),
        inputs, settings,
    )
    single = np.asarray(one.image)
    single_s = time.perf_counter() - t0
    differ = (sharded != single).any(-1)
    out = {
        "phase": "four_card_sharded_config5",
        "sharded_first_frame_s": times[0],
        "sharded_frame_s": times[1],
        "single_card_first_frame_s": single_s,
        "rays": sharded_rays,
        "rays_single": float(rays1),
        "pixels_differing": int(differ.sum()),
        "rmse": rmse(normalized(sharded), normalized(single)),
        "shards": shards,
    }
    log(**out)
    check(out["pixels_differing"] == 0,
          f"sharded frame differs from one-card frame in "
          f"{out['pixels_differing']} pixels (rmse {out['rmse']})")
    check(sharded_rays == float(rays1), "ray counts differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="only the config-#5 frame sharded over 4 cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import webgpu_raytracing_tpu  # noqa: F401  (fails outside a checkout)

    devs = require_gpus(4 if args.four else 1)
    from webgpu_raytracing_tpu.utils.paths import enable_compile_cache

    cache = enable_compile_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    log(phase="setup", card=card_line(), compile_cache=cache,
        jax_devices=[d.device_kind for d in devs],
        xla_flags=os.environ.get("XLA_FLAGS", ""))
    print(card_line(), flush=True)

    t_all = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_cli_frames()
        phase_kernel_vs_xla()
        phase_trace_parity()
        phase_wgsl_parity()
    log(phase="done", wall_s=time.perf_counter() - t_all)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
