"""Metrics / tracing / observability (SURVEY.md §5).

The reference surfaces three live timers — GPU-time from timestamp queries
(gpu.ts:58-108), JS-time per renderFrame (render.ts:1706) and frame dt
(store.ts:282-285) — on its UI overlay. Headless equivalents:

* :class:`FrameMetrics` — per-frame device wall-clock (the render step is
  synchronized by its scalar readback, so host wall ≈ device time),
  rays/s, spp, written as JSONL for machine consumption;
* :func:`profile_trace` — wraps a block in ``jax.profiler.trace`` so
  kernels show up in TensorBoard/xprof (the timestamp-query analog);
* :func:`timed` — ad-hoc wall-clock context manager.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional


@dataclasses.dataclass
class FrameMetrics:
    """Rolling per-frame metrics sink (optionally JSONL-backed)."""

    path: Optional[str] = None
    smoothing: float = 0.9  # like useSmoothedValue (utils.ts:37-48)
    _fh: object = None
    frame: int = 0
    smoothed_ms: float = 0.0

    def __post_init__(self):
        if self.path:
            self._fh = open(self.path, "a")

    def record(self, wall_s: float, rays: float, spp: float) -> dict:
        self.frame += 1
        ms = wall_s * 1e3
        self.smoothed_ms = (
            ms
            if self.frame == 1
            else self.smoothing * self.smoothed_ms + (1 - self.smoothing) * ms
        )
        row = {
            "frame": self.frame,
            "frame_ms": round(ms, 3),
            "smoothed_ms": round(self.smoothed_ms, 3),
            "mrays_per_s": round(rays / max(wall_s, 1e-9) / 1e6, 4),
            "rays": rays,
            "spp": spp,
        }
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        return row

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def timed(label: str = "", sink=None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    msg = {"label": label, "wall_s": round(dt, 4)}
    (sink or print)(json.dumps(msg) if sink is None else msg)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """jax.profiler trace around a block — the analog of the reference's
    GPU timestamp queries; view with TensorBoard or Perfetto."""
    import jax

    with jax.profiler.trace(log_dir):
        yield
    print(json.dumps({"profile": log_dir}))
