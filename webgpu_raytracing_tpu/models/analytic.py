"""The analytic scene (BASELINE config #1): two spheres on a ground plane
under a spherical light — generated, so it needs no asset files."""

from __future__ import annotations

import numpy as np

from .scene import Scene, scene_from_facesets
from .test_models import ground_plane, uv_sphere


def analytic_scene() -> Scene:
    """Light sphere (model 0, the NEE light by contract), two diffuse
    spheres and a 40x40 ground plane."""
    return scene_from_facesets(
        [
            ("light", uv_sphere((0, 6, -6), 1.0, material_idx=0,
                                lat=8, lon=12)),
            ("sphere_a", uv_sphere((-1.4, 1.0, -6), 1.0, material_idx=1)),
            ("sphere_b", uv_sphere((1.4, 0.8, -7), 0.8, material_idx=2)),
            ("plane", ground_plane(0.0, 20.0, material_idx=3)),
        ],
        np.array(
            [[0, 0, 0], [0.8, 0.3, 0.3], [0.3, 0.4, 0.8], [0.7, 0.7, 0.7]],
            np.float32,
        ),
        np.array(
            [[12, 12, 12], [0, 0, 0], [0, 0, 0], [0, 0, 0]], np.float32
        ),
    )
