"""Entry-point plumbing that needs no accelerator: the compile-cache
location, the PNG codec, and chip_smoke.py's refusal to run without a GPU
or outside a checkout."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from webgpu_raytracing_tpu.utils import paths
from webgpu_raytracing_tpu.utils.image import (
    decode_png,
    encode_png,
    read_image,
    write_png,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """$JAX_COMPILATION_CACHE_DIR wins and nothing is set in code;
    without it the cache is the checkout's fixed, gitignored .jax_cache."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv(paths.CACHE_ENV, str(tmp_path))
        assert paths.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv(paths.CACHE_ENV, raising=False)
        assert paths.enable_compile_cache() == paths.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == paths.DEFAULT_CACHE_DIR
        assert os.path.dirname(paths.DEFAULT_CACHE_DIR) == ROOT
        with open(os.path.join(ROOT, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize(
    "kind", ["rgb_u8", "rgba_u8", "rgb_float"],
)
def test_png_roundtrip(tmp_path, kind):
    """numpy+zlib PNG encoder/decoder round trip (no Pillow on the path)."""
    rng = np.random.default_rng(4)
    if kind == "rgb_float":
        img = rng.random((13, 7, 3)).astype(np.float32)
        want = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    else:
        c = 3 if kind == "rgb_u8" else 4
        img = want = rng.integers(0, 256, (9, 11, c), dtype=np.uint8)
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(data), want)
    if want.shape[2] == 3:
        path = str(tmp_path / "x.png")
        write_png(path, img)
        np.testing.assert_allclose(read_image(path), want / 255.0, atol=1e-7)


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """No GPU (or no package beside the script): non-zero exit and no
    result line."""
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    proc = _run_smoke(cwd)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert "ok" not in rec
