"""Device RNG + sampling library.

Re-implements the reference's WGSL RNG (shaders/rng.ts:30-168) as
*vectorized, stateless-style* JAX uint32 ops: instead of a
``var<private> rng_state`` per GPU thread, the state is an explicit
``(lanes,)`` uint32 array threaded through the computation. Draw-for-draw
the sequence matches the WGSL exactly (same hash, same draw order), so a
render seeded identically to the reference consumes identical random
numbers — the foundation for RMSE parity at equal spp.

Every sampler returns ``(value, new_state)``; masked variants advance the
state only on active lanes, mirroring divergent-branch draw order in the
SIMT original.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..config import PI, TWO_PI

UINT_MAX_F = 4294967295.0  # f32(0xffffffffu)


def seed_state(seed: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """rng_state = seed + idx (render.ts:1453)."""
    return (seed.astype(jnp.uint32) + idx.astype(jnp.uint32)).astype(jnp.uint32)


def random_1u(state: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """PCG-style hash, exact replica of shaders/rng.ts:34-40.

    old = state + 747796405 + 2891336453 (mod 2^32)
    word = ((old >> ((old >> 28) + 4)) ^ old) * 277803737
    state' = (word >> 22) ^ word
    """
    state = state.astype(jnp.uint32)
    old = state + jnp.uint32(747796405) + jnp.uint32(2891336453)
    shift = (old >> jnp.uint32(28)) + jnp.uint32(4)
    word = ((old >> shift) ^ old) * jnp.uint32(277803737)
    new_state = (word >> jnp.uint32(22)) ^ word
    return new_state, new_state


def random_1(state):
    """f32 in [0, 1] (shaders/rng.ts:43-45)."""
    u, state = random_1u(state)
    return u.astype(jnp.float32) / jnp.float32(UINT_MAX_F), state


def random_2(state):
    """vec2(random_1(), random_1()) — draw order x then y (rng.ts:16-28)."""
    x, state = random_1(state)
    y, state = random_1(state)
    return jnp.stack([x, y], axis=-1), state


def random_3(state):
    x, state = random_1(state)
    y, state = random_1(state)
    z, state = random_1(state)
    return jnp.stack([x, y, z], axis=-1), state


def masked_advance(state, new_state, active):
    """Advance RNG state only where ``active`` — replicates per-thread
    divergent draw counts of the SIMT reference in vectorized form."""
    return jnp.where(active, new_state, state)


# ---------------------------------------------------------------------------
# Samplers (shaders/rng.ts:69-131). Pure functions of the random inputs.
# ---------------------------------------------------------------------------


def sample_circle(t):
    """rng.ts:69-72 — point on the unit circle.

    det_sincos (ops/detmath.py): per-lane trig lowers differently per
    backend (an ulp or two); lens and bounce directions inherit it and
    chaotic path divergence amplifies it into whole-image cross-backend
    RMSE. The double-f32 version is bit-identical across backends."""
    from .detmath import det_sincos

    phi = t * TWO_PI
    s, c = det_sincos(phi)
    return jnp.stack([c, s], axis=-1)


def sample_incircle(t):
    """rng.ts:74-76 — uniform in unit disc; t is (..., 2).
    det_sqrt: an in-fusion sqrt may be 1 ulp off (detmath)."""
    from .detmath import det_sqrt

    return sample_circle(t[..., 0]) * det_sqrt(t[..., 1])[..., None]


def sample_sphere(t):
    """rng.ts:102-109 — uniform on unit sphere; t is (..., 2).
    det_sincos: see :func:`sample_circle`. Strict products (strictf):
    the u² and sinθ·trig muls otherwise may contract into neighbouring
    adds as FMAs (1 ulp off strict), and the result feeds every bounce
    direction through ``normalize(n + sphere)``."""
    from .detmath import det_sincos, det_sqrt
    from .strictf import smul

    u = t[..., 0] * 2.0 - 1.0
    v = t[..., 1]
    sin_theta = det_sqrt(jnp.maximum(1.0 - smul(u, u), 0.0))
    phi = TWO_PI * v
    sphi, cphi = det_sincos(phi)
    x = smul(sin_theta, cphi)
    z = smul(sin_theta, sphi)
    return jnp.stack([x, u, z], axis=-1)


def sample_hemisphere(t, n):
    """rng.ts:111-119 — uniform hemisphere around n (via faceForward)."""
    v = sample_sphere(t)
    # WGSL faceForward(v, v, -n): returns v if dot(v, -n) < 0 else -v.
    d = jnp.sum(v * n, axis=-1, keepdims=True)
    return jnp.where(d > 0, v, -v)


def sample_cosine_weighted_hemisphere(t, n):
    """rng.ts:88-100 — the live branch: normalize(n + sample_sphere(t)).

    NOTE: the reference does not normalize ``n`` first (Phong-interpolated
    normals arrive unnormalized, render.ts:891-900); replicated as-is.
    """
    v = n + sample_sphere(t)
    from .detmath import normalize  # deferred: rng has no jax-op deps

    return normalize(v)


def sample_insquare(t):
    """rng.ts:125-127 — uniform in [-1, 1]^2."""
    return 2.0 * t - 1.0


def sample_intriangle(t):
    """Uniform barycentric (u, v) in the unit triangle.

    NOTE: the reference's sampler (rng.ts:129-131) is buggy — when
    ``t.x >= t.y`` it returns ``t`` unreflected, so ~25% of its samples land
    outside the triangle (u + v > 1). That only feeds ``sampleFace`` in the
    reference's *dead* NEE path; since our direct-lighting integrator is
    live, we use the standard correct reflection instead.
    """
    u = t[..., 0]
    v = t[..., 1]
    flip = u + v > 1.0
    return jnp.stack(
        [jnp.where(flip, 1.0 - u, u), jnp.where(flip, 1.0 - v, v)], axis=-1
    )


def sample_insphere(t):
    """rng.ts:121-123; t is (..., 3)."""
    return sample_sphere(t[..., :2]) * jnp.cbrt(t[..., 2])[..., None]


# 1/pdf family (rng.ts:133-167)
def pdf_inv_sphere():
    return 2.0 * TWO_PI


def pdf_inv_hemisphere():
    return TWO_PI


def pdf_inv_circle():
    return TWO_PI


def pdf_inv_incircle():
    return PI


def pdf_inv_insphere():
    return PI * 4.0 / 3.0


def pdf_inv_intriangle():
    return 0.5


def pdf_inv_insquare():
    return 4.0
