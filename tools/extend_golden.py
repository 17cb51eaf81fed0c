"""Extend the 512x512 WGSL-semantics golden from 4 to 16 spp.

VERDICT r4 #5: show the 512^2 hardware-parity residue (61 knife-edge
pixels at 4 spp, RMSE 0.00746) washes out at config #2's own 16-spp
operating point the way the 48^2 convergence study did. The scalar
simulator costs ~40 min/frame at 512^2 on this 1-vCPU host, so this
continues the checked-in 2-frame golden (tests/golden/
wgsl_reference_512x512.npz) with 6 more seeded frames instead of
re-rendering from scratch: progressive accumulation is a running
(sum_color, sum_samples) buffer (render.ts:1506-1507), so stepping the
simulator from the stored image is exactly the 8-frame render.

Run from the repo root:  python tools/extend_golden.py
Writes tests/golden/wgsl_reference_512x512_16spp.npz after EVERY frame
(resumable: reads the 16spp file back if present).
"""

import os
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import numpy as np

from webgpu_raytracing_tpu.camera import Camera
from webgpu_raytracing_tpu.config import RenderSettings
from webgpu_raytracing_tpu.models.scene import load_scene
from webgpu_raytracing_tpu.validation.wgsl_sim import WGSLReference

from webgpu_raytracing_tpu.utils.paths import ASSETS_DIR
from webgpu_raytracing_tpu.validation.envs import synthetic_equirect

SIZE = 512
# seeds 3..8 continue the checked-in [12345, 987654321]
ALL_SEEDS = [12345, 987654321, 5551212, 31337, 271828, 141421, 999331, 777777]
OUT = f"tests/golden/wgsl_reference_{SIZE}x{SIZE}_16spp.npz"
BASE = f"tests/golden/wgsl_reference_{SIZE}x{SIZE}.npz"


def main():
    settings = RenderSettings(
        width=SIZE, height=SIZE, environment="equirect",
        sample_count=1, bounces_depth=4,
    )
    scene = load_scene(
        os.path.join(ASSETS_DIR, "raytraced-scene.obj"),
        os.path.join(ASSETS_DIR, "raytraced-scene.mtl"),
    )
    env = synthetic_equirect()
    view = Camera().view_matrix()

    src = OUT if os.path.exists(OUT) else BASE
    g = np.load(src)
    done = len(g["seeds"])
    assert list(g["seeds"]) == ALL_SEEDS[:done], "seed chain mismatch"
    ref = WGSLReference(scene, settings, env)
    ref.image = np.array(g["image"], np.float32)
    ref.counter = done
    print(f"resuming from {src} at frame {done}", flush=True)

    for i in range(done, len(ALL_SEEDS)):
        t0 = time.time()
        ref.step(ALL_SEEDS[i], view)  # step() increments ref.counter
        np.savez_compressed(
            OUT,
            image=ref.image,
            seeds=np.array(ALL_SEEDS[: i + 1], np.int64),
            size=np.array([SIZE, SIZE]),
            view=view,
        )
        print(
            f"frame {i}: {time.time() - t0:.1f}s  mean spp "
            f"{float(ref.image[..., 3].mean()):.1f}  saved {OUT}",
            flush=True,
        )


if __name__ == "__main__":
    main()
