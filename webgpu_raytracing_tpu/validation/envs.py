"""Deterministic environments for parity runs."""

from __future__ import annotations

import numpy as np


def synthetic_equirect(h: int = 64, w: int = 128) -> np.ndarray:
    """Deterministic stand-in for the reference's 4k EXR skybox (the asset
    is not bundled): a smooth sky gradient with a bright sun patch, shared
    verbatim by the renderer and the WGSL simulator — exercising the
    identical equirect nearest-texel fetch path (render.ts:932-940)."""
    ys = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xs = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    r = 0.4 + 0.5 * ys + 0.05 * np.sin(xs * 12.0)
    g = 0.5 + 0.4 * ys + 0.05 * np.cos(xs * 7.0)
    b = 0.8 + 0.2 * ys
    img = np.stack(
        [np.broadcast_to(c, (h, w)) for c in (r, g, b)], axis=-1
    ).astype(np.float32)
    sun = np.exp(
        -(((ys - 0.75) * 8.0) ** 2 + ((xs - 0.3) * 8.0) ** 2)
    ).astype(np.float32)
    return img + 20.0 * sun[..., None] * np.array([1.0, 0.9, 0.7], np.float32)
