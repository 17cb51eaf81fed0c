"""Generate a cross-reference golden: the scalar WGSL-semantics simulator
(webgpu_raytracing_tpu/validation/wgsl_sim.py) rendering a scene at a
small crop, saved to tests/golden/.

This is the reference-implementation side of the north-star correctness
clause ("≤ 1e-2 RMSE vs WebGPU reference at equal spp", BASELINE.md): the
simulator transliterates the reference's WGSL megakernel scalar-for-scalar
(including its PCG RNG bit stream), so its output stands in for a WebGPU
capture.

Run from the repo root:
    python tools/make_reference_golden.py             # bundled OBJ scene
    python tools/make_reference_golden.py analytic    # seeded analytic scene
Takes minutes (pure-Python per-pixel loop).
"""

import os
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import numpy as np

from webgpu_raytracing_tpu.camera import Camera
from webgpu_raytracing_tpu.config import RenderSettings
from webgpu_raytracing_tpu.validation.wgsl_sim import WGSLReference
from webgpu_raytracing_tpu.validation.envs import synthetic_equirect

SIZE = int(os.environ.get("GOLDEN_SIZE", 48))
FRAMES = 2
SEEDS = [12345, 987654321]


def main(which: str = "bundled"):
    settings = RenderSettings(
        width=SIZE, height=SIZE, environment="equirect",
        sample_count=1, bounces_depth=4,
    )
    if which == "analytic":
        from webgpu_raytracing_tpu.models.analytic import analytic_scene

        scene = analytic_scene()
        out = f"tests/golden/wgsl_analytic_{SIZE}x{SIZE}.npz"
    else:
        from webgpu_raytracing_tpu.models.scene import load_scene
        from webgpu_raytracing_tpu.utils.paths import ASSETS_DIR

        scene = load_scene(
            os.path.join(ASSETS_DIR, "raytraced-scene.obj"),
            os.path.join(ASSETS_DIR, "raytraced-scene.mtl"),
        )
        out = f"tests/golden/wgsl_reference_{SIZE}x{SIZE}.npz"
    env = synthetic_equirect()
    view = Camera().view_matrix()

    ref = WGSLReference(scene, settings, env)
    for i, seed in enumerate(SEEDS[:FRAMES]):
        t0 = time.time()
        ref.step(seed, view)
        print(f"frame {i}: {time.time() - t0:.1f}s", flush=True)

    np.savez_compressed(
        out,
        image=ref.image,
        seeds=np.array(SEEDS[:FRAMES], np.int64),
        size=np.array([SIZE, SIZE]),
        view=view,
    )
    spp = ref.image[..., 3:4]
    print("mean spp:", float(spp.mean()))
    print(f"saved {out}")


if __name__ == "__main__":
    main(*sys.argv[1:])
