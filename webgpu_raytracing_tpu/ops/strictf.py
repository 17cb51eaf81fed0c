"""Contraction-proof f32 arithmetic for decision-critical paths.

XLA fuses elementwise graphs and lowers ``a*b + c`` with LLVM's
``contract`` fast-math flag, producing FMA instructions whose
un-rounded products differ from strict IEEE f32 mul-then-add by 1 ulp.
``optimization_barrier``, ``reduce_precision`` (full f32) and bitcast
round-trips are all simplified away before lowering, so none of them
stops the contraction (measured — see tools/ notes in git history).

What does work: force every product through ``x*y + zero`` where
``zero`` is an optimization-barrier'd 0.0 the simplifier cannot fold.
If the compiler contracts it the result is ``fma(x, y, 0) = fl(x*y)``
(one correct rounding); if it does not, it is ``fl(fl(x*y) + 0) =
fl(x*y)``. Either way the product is rounded to f32 BEFORE any
consumer add — bit-identical to the scalar reference semantics on
every backend, at the cost of one extra VPU add per product.

(Sign-of-zero caveat: ``fl(x*y) = -0`` becomes ``+0`` through ``+0.0``.
The only consumer that can see the difference is offsetRay's bitcast
path, where both ±0 produce a NaN origin — behaviour-identical.)

Used by the Möller–Trumbore evaluators that define cross-implementation
parity (ops/intersect.py, cluster_trace exact re-adjudication) and the
hit-point reconstruction chain (facePoint / offsetRay / faceNormal), so the
framework's intersection DECISIONS match the WGSL-semantics simulator
(validation/wgsl_sim.py) bit-for-bit under jit on every backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def szero():
    """A 0.0 the HLO simplifier cannot fold into its consumers."""
    return jax.lax.optimization_barrier(jnp.float32(0.0))


def smul(x, y, z=None):
    """Strict ``fl(x*y)`` — contraction-proof (see module docstring)."""
    return x * y + (szero() if z is None else z)


def sdot3(a, b):
    """Strict 3-component dot with left-associated f32 adds — the WGSL
    ``dot(vec3f, vec3f)`` evaluation order."""
    z = szero()
    p = a * b + z
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def scross(a, b):
    """Strict component-wise cross product (every product rounded
    before the subtraction, as in scalar evaluation)."""
    z = szero()
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [
            (ay * bz + z) - (az * by + z),
            (az * bx + z) - (ax * bz + z),
            (ax * by + z) - (ay * bx + z),
        ],
        axis=-1,
    )
