"""Cross-implementation RMSE convergence study.

Runs the scalar WGSL-semantics simulator (validation/wgsl_sim.py) and the
framework renderer over the same seed sequence at 48x48 and reports the
normalized-radiance RMSE at increasing spp. The north-star clause
(BASELINE.md) is stated "at equal spp"; isolated decorrelated edge pixels
make low-spp RMSE an overestimate of bias, so the trend matters: true
bias would plateau, Monte-Carlo decorrelation shrinks as ~1/sqrt(spp).

Run from the repo root:  python tools/parity_convergence.py
Pure CPU; ~30-60 min (the simulator is a per-pixel Python loop).
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
from webgpu_raytracing_tpu.renderer import Renderer
from webgpu_raytracing_tpu.validation.wgsl_sim import WGSLReference

from test_reference_parity import _rmse as rmse_ref
from webgpu_raytracing_tpu.utils.paths import ASSETS_DIR
from webgpu_raytracing_tpu.validation.envs import synthetic_equirect

SIZE = 48
FRAMES = 32  # 2 spp per frame -> 64 spp total
SEEDS = [(12345 + 2654435761 * k) % (2**31) for k in range(FRAMES)]
CHECKPOINTS = (2, 4, 8, 16, 32)  # frames -> spp = 2x


rmse = rmse_ref  # single-source the parity metric with the tests


def norm(img):
    return img[..., :3] / np.maximum(img[..., 3:4], 1e-20)


def main():
    # chained_sort=False: this tool measures SEMANTIC bit-identity of the
    # integrator vs the scalar WGSL simulator; the chained graph shifts
    # ~1-ulp XLA fusion noise onto a few % of pixels (see
    # tests/test_chained_sort.py), which is irrelevant to RMSE but would
    # understate the bit-identical fraction this study reports.
    settings = RenderSettings(
        width=SIZE, height=SIZE, environment="equirect",
        sample_count=1, bounces_depth=4, chained_sort=False,
    )
    scene = load_scene(
        os.path.join(ASSETS_DIR, "raytraced-scene.obj"),
        os.path.join(ASSETS_DIR, "raytraced-scene.mtl"),
    )
    env = synthetic_equirect()
    view = Camera().view_matrix()

    sim = WGSLReference(scene, settings, env)
    ours = Renderer(scene, settings, env_data=env)
    for k, seed in enumerate(SEEDS):
        t0 = time.time()
        sim.step(seed, view)
        ours.step(seed=seed)
        frames = k + 1
        if frames in CHECKPOINTS:
            a = np.asarray(ours.buffers.image)
            b = sim.image
            assert np.array_equal(a[..., 3], b[..., 3]), "spp mismatch"
            e = rmse(norm(a), norm(b))
            spp = int(a[..., 3].max())
            print(
                f"spp {spp:3d}: RMSE {e:.5f}  (x sqrt(spp) = {e * np.sqrt(spp):.4f})",
                flush=True,
            )
        else:
            print(f"frame {frames}: {time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
