"""Test configuration.

The suite runs on the CPU by default (``JAX_PLATFORMS=cpu`` unless the
caller sets another platform) with 8 virtual devices, so sharding tests
have a mesh. Tests marked ``gpu`` need a GPU: the ``gpu_device`` fixture
skips them when JAX finds none. Run them on a card, in one process so it
owns the card, with::

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from webgpu_raytracing_tpu.utils.paths import (  # noqa: E402
    ASSETS_DIR,
    enable_compile_cache,
)

enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX finds none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev


@pytest.fixture
def interpreted_kernel(monkeypatch):
    """Route ``traversal="triton"`` through the Triton kernel under the
    Pallas interpreter, so the full frame path runs the kernel on the
    CPU. Compiled frames are dropped before and after, so no cached
    executable crosses the boundary."""
    import functools

    import jax

    from webgpu_raytracing_tpu.ops import cluster_triton, integrator

    resolve = integrator._resolve_backend
    monkeypatch.setattr(
        integrator,
        "_resolve_backend",
        lambda s: "triton" if s.traversal == "triton" else resolve(s),
    )
    monkeypatch.setattr(
        cluster_triton,
        "trace_clustered_triton",
        functools.partial(
            cluster_triton.trace_clustered_triton, interpret=True
        ),
    )
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def reference_assets():
    """Paths to the bundled scene assets (pure data, read-only)."""
    obj = os.path.join(ASSETS_DIR, "raytraced-scene.obj")
    mtl = os.path.join(ASSETS_DIR, "raytraced-scene.mtl")
    if not (os.path.exists(obj) and os.path.exists(mtl)):
        pytest.skip("bundled scene assets not in the checkout")
    return obj, mtl


@pytest.fixture(scope="session")
def cornell_scene(reference_assets):
    from webgpu_raytracing_tpu.models import load_scene

    obj, mtl = reference_assets
    return load_scene(obj, mtl)


@pytest.fixture
def rng_np():
    return np.random.default_rng(1234)
