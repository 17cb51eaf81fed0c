"""Where the program keeps its files: all of them inside the checkout.

* ``assets/`` — the bundled OBJ/MTL scene and cubemap (read-only data;
  absent until they are added to the repository — callers fall back to
  the seeded scenes ``--scene analytic`` / ``--scene stress1m``);
* ``build/`` — the native loader library, compiled on first use;
* ``.jax_cache/`` — JAX's persistent compilation cache, unless
  ``JAX_COMPILATION_CACHE_DIR`` names another directory.

``build/`` and ``.jax_cache/`` are listed in ``.gitignore``.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
ASSETS_DIR = os.path.join(REPO_ROOT, "assets")
BUILD_DIR = os.path.join(REPO_ROOT, "build")
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache goes to the checkout's
    ``.jax_cache/`` — a fixed path, so a later process finds it again."""
    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_CACHE_DIR
