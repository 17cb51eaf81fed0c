"""HDR environment importance sampling with multiple importance sampling.

New capability beyond the reference (BASELINE config #3: "4k HDR env
importance sampling"): the reference only ever evaluates its equirect
skybox on BSDF-sampled misses (render.ts:1183-1186). Here the environment
can additionally be *sampled* — a luminance-weighted 2-D distribution over
the equirect texels (marginal CDF over rows, conditional CDF per row),
inverted on-device with vectorized binary search — and combined with the
cosine-sampled BSDF strategy via the balance heuristic so bright suns stop
being variance bombs.

pdf bookkeeping (solid-angle measure): texel selection probability is
L·sinθ/Σ(L·sinθ) and a texel spans solid angle sinθ·2π²/(H·W), so the
sinθ factors cancel:
  p_env(texel y,x) = L(y,x) · (H·W) / (Σ(L·sinθ) · 2π²)
  p_bsdf(ω)        = max(cosθ_n, 0) / π          (cosine hemisphere)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import INV_PI, PI
from . import detmath, rng
from .envmap import equirect_uv


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnvDistribution:
    """Sampling tables for an equirect environment (device pytree)."""

    img: jax.Array  # (H, W, 3) radiance
    row_cdf: jax.Array  # (H,) inclusive marginal CDF over rows
    cond_cdf: jax.Array  # (H, W) inclusive conditional CDF per row
    lum: jax.Array  # (H, W) luminance (pdf numerator)
    total: jax.Array  # () Σ lum·sinθ (pdf normalizer)


def build_env_distribution(img: np.ndarray) -> EnvDistribution:
    """Host-side table build from an (H, W, 3) equirect radiance map."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[0], img.shape[1]
    lum = (
        0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    ).astype(np.float64)
    lum = np.maximum(lum, 1e-12)
    # v = 1 - acos(y)/π (envmap.py): row index v·H ⇒ θ = π(1 - (y+.5)/H)
    theta = np.pi * (1.0 - (np.arange(h) + 0.5) / h)
    sin_t = np.maximum(np.sin(theta), 1e-6)
    weighted = lum * sin_t[:, None]
    row_sum = weighted.sum(axis=1)
    total = row_sum.sum()
    row_cdf = np.cumsum(row_sum) / total
    cond_cdf = np.cumsum(weighted, axis=1) / row_sum[:, None]
    cond32 = cond_cdf.astype(np.float32)
    return EnvDistribution(
        img=jnp.asarray(img),
        row_cdf=jnp.asarray(row_cdf.astype(np.float32)),
        cond_cdf=jnp.asarray(cond32),
        lum=jnp.asarray(lum.astype(np.float32)),
        total=jnp.asarray(np.float32(total)),
    )


def _invert_cdf(cdf_rows: jnp.ndarray, u: jnp.ndarray, axis_len: int):
    """First index with cdf[i] >= u = count of entries < u (the CDF rows
    are monotone inclusive cumsums, so the compare-count IS the binary
    search result, fully vectorized, no data-dependent control flow)."""
    return jnp.clip(
        jnp.sum((cdf_rows < u[..., None]).astype(jnp.int32), axis=-1),
        0,
        axis_len - 1,
    )


def _chunked_map(fn, args, n, budget_elems: int):
    """lax.map over ray chunks so per-chunk temporaries stay bounded —
    a 1080p bounce wave is ~2M lanes, and materializing a (R, W=4096)
    gather/compare at once is a 34 GB allocation. Shapes must be static: n is the
    static lane count, budget_elems bounds chunk·W elements."""
    batch = max(1, min(n, budget_elems))
    return jax.lax.map(fn, args, batch_size=batch)


def sample_env(
    dist: EnvDistribution, state: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Draw (direction, radiance, pdf, state) per lane."""
    h, w = dist.img.shape[0], dist.img.shape[1]
    t2, state = rng.random_2(state)
    u1, u2 = t2[..., 0], t2[..., 1]

    flat_shape = u1.shape
    u1f, u2f = u1.reshape(-1), u2.reshape(-1)
    n = u1f.shape[0]

    def row_body(u):
        return _invert_cdf(dist.row_cdf, u, h)

    row = _chunked_map(
        row_body, u1f, n, budget_elems=(8 << 20) // max(1, h)
    )

    def col_body(args):
        r, u = args
        return _invert_cdf(jnp.take(dist.cond_cdf, r, axis=0), u, w)

    col = _chunked_map(
        col_body, (row, u2f), n, budget_elems=(8 << 20) // max(1, w)
    )
    row = row.reshape(flat_shape)
    col = col.reshape(flat_shape)

    vq = (row.astype(jnp.float32) + 0.5) / h
    uq = (col.astype(jnp.float32) + 0.5) / w
    theta = PI * (1.0 - vq)  # inverse of v = 1 - θ/π
    phi = uq * 2.0 * PI - PI  # inverse of u = (atan2(z,x)/π + 1)/2
    sin_t = jnp.sin(theta)
    d = jnp.stack(
        [sin_t * jnp.cos(phi), jnp.cos(theta), sin_t * jnp.sin(phi)],
        axis=-1,
    )

    lum = dist.lum[row, col]
    pdf = lum / dist.total * (h * w) / (2.0 * PI * PI)
    radiance = dist.img[row, col]
    return d, radiance, pdf, state


def env_pdf(dist: EnvDistribution, d: jnp.ndarray) -> jnp.ndarray:
    """pdf of drawing direction d from the env distribution."""
    h, w = dist.img.shape[0], dist.img.shape[1]
    uv = equirect_uv(d)
    col = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    row = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    lum = dist.lum[row, col]
    return lum / dist.total * (h * w) / (2.0 * PI * PI)


def bsdf_pdf(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Cosine-hemisphere pdf around (unnormalized-tolerant) normal n."""
    nn = detmath.normalize(n)
    cos_t = jnp.sum(d * nn, axis=-1)
    return jnp.maximum(cos_t, 0.0) * INV_PI


def balance_weight(p_self: jnp.ndarray, p_other: jnp.ndarray):
    return p_self / jnp.maximum(p_self + p_other, 1e-20)
