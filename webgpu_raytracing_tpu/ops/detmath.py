"""Cross-backend-deterministic f32 helpers.

XLA backends are free to lower an f32 division or square root inside a
fusion as a reciprocal (or rsqrt) plus refinement, and to evaluate trig
with their own polynomials, so the same graph can give quotients, roots
and sines 1-2 ulp apart on two backends. Every camera and bounce
direction goes through these operations, and chaotic path divergence
amplifies ulp noise into whole-image RMSE between backends.

The remedy: take whatever quotient the platform gives, then apply one
exact-residual correction step — Dekker/Veltkamp two-product to compute
``r = num - q·den`` exactly, then ``q + r/den``. The correction converges
to the correctly rounded quotient however the embedded divides are
approximated, so every backend lands on the same bits; where the
platform divide is already correctly rounded the step is a bitwise no-op.
``det_sqrt`` does the same for square roots, and the trig functions below
are evaluated in double-f32 from IEEE mul/add alone.

WGSL ``normalize()`` is exact-rounded per IEEE div/sqrt on the driver
stacks the golden was validated against (the CPU simulator matches the
48² golden bit-exactly), so deterministic-normalize is also the
faithful-parity choice, not just a cross-backend convenience. Whether the
GPU build needs the chain is measured by ``chip_smoke.py``'s wgsl_parity
phase, which renders with and without it.
"""

from __future__ import annotations

import jax.numpy as jnp

# Veltkamp split constant for f32: 2^12 + 1 (splits a 24-bit mantissa
# into two 12-bit halves so products of halves are exact in f32).
_SPLIT = 4097.0


def _two_prod(x, y):
    """Exact f32 product: returns (p, err) with x*y == p + err exactly
    (Dekker two-product via Veltkamp splitting; no FMA dependence).

    The ``optimization_barrier`` calls are load-bearing: in real-sized
    fusions XLA's algebraic simplifier treats the split as associative
    algebra — ``cx - (cx - x)`` folds to ``x``, the error term collapses
    to zero, and the "corrected" result silently degrades to the plain
    platform product. The returned ``p`` is barriered too so callers'
    ``(x - p) - err`` residuals can't re-fuse with the product."""
    import jax

    p = jax.lax.optimization_barrier(x * y)
    cx = jax.lax.optimization_barrier(jnp.float32(_SPLIT) * x)
    xh = cx - (cx - x)
    xl = x - xh
    cy = jax.lax.optimization_barrier(jnp.float32(_SPLIT) * y)
    yh = cy - (cy - y)
    yl = y - yh
    err = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    return p, err


def det_div(num, den):
    """num / den, correctly rounded on every backend. One Newton/Dekker
    residual correction on top of the platform quotient."""
    num = jnp.asarray(num, jnp.float32)
    den = jnp.asarray(den, jnp.float32)
    q = num / den
    p, err = _two_prod(q, den)
    r = (num - p) - err
    res = q + r / den
    # Veltkamp splitting overflows for |x| > ~8.3e34 (4097*x -> inf), so
    # the correction can be NaN where the plain quotient is finite (e.g.
    # huge t from a grazing near-zero det). Fall back to the platform
    # quotient there — those magnitudes are far outside the parity-
    # sensitive range anyway.
    return jnp.where(jnp.isfinite(res), res, q)


def det_sqrt(x):
    """sqrt(x), correctly rounded on every backend. An rsqrt-based
    in-fusion lowering can come back 1 ulp off; one exact-residual Newton
    step on top of the platform sqrt lands every backend on the correctly
    rounded result (a bitwise no-op where the platform sqrt already is).
    Zeros, infs and NaNs pass through."""
    x = jnp.asarray(x, jnp.float32)
    s = jnp.sqrt(x)
    p, err = _two_prod(s, s)
    r = (x - p) - err
    res = s + r / (2.0 * s)
    return jnp.where((s > 0) & jnp.isfinite(s), res, s)


def normalize(v: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """v / max(|v|, eps) along the last axis, bit-identical across
    backends.

    The squared-norm sum is left UNGUARDED on purpose: the WGSL
    simulator's ``np.dot`` norm matches the contracted form, and a strict
    (smul) rewrite changes CPU bits away from the golden. The sqrt goes
    through det_sqrt and the divide through det_div (both bitwise no-ops
    on the CPU, so the golden is untouched)."""
    n = jnp.maximum(
        det_sqrt(jnp.sum(v * v, axis=-1, keepdims=True)), eps
    )
    return det_div(v, n)


# ---------------------------------------------------------------------------
# Deterministic trigonometry (double-f32).
#
# An XLA backend may lower f32 sin/cos/tan to its own polynomial
# approximations, 1-2 ulp from correctly rounded libm results on a large
# fraction of lanes. Per-lane trig feeds every camera direction
# (Panini/fisheye raygen) and every bounce direction
# (rng.sample_sphere's cos/sin(2πv)), so ulp noise there is amplified by
# chaotic path divergence into whole-image RMSE.
#
# These versions compute sin/cos in double-f32 (each product exact by
# Veltkamp two-product or contraction-guarded, each sum an error-free
# transform), accurate to ~2^-44 relative, then round once. The result
# bits are a pure function of IEEE f32 mul/add — which ARE bit-identical
# across backends — so every backend agrees EXACTLY. Against libm
# (np.sin, the WGSL-simulator semantics) the value is the correctly
# rounded f32 except when the true value sits within ~2^-44 of a rounding
# boundary (~1e-6 of uniform draws — measured by tests/test_ops.py's
# sweep), which is far below the per-frame knife-edge rates that matter.
#
# Valid input range: |x| <= 4π (raygen args are <= π, sampler args are
# 2π·u ∈ [0, 2π]); beyond that the 3-chunk Cody-Waite reduction loses
# accuracy gracefully (n grows), it does not fail abruptly.
# ---------------------------------------------------------------------------

# π/2 in three f32 chunks (Cody-Waite): c1 + c2 + c3 = π/2 ± ~2^-76.
# Generated from 60 digits of π with decimal arithmetic:
#   c1 = f32(π/2); c2 = f32(π/2 - c1); c3 = f32(π/2 - c1 - c2)
_PIO2_1 = 1.5707963705062866
_PIO2_2 = -4.371138828673793e-08
_PIO2_3 = -1.7151245100058819e-15
_TWO_OVER_PI = 0.6366197466850281     # f32(2/π)

# Taylor coefficients: leading terms as double-f32 (hi, lo) pairs
# (hi = f32(c), lo = f32(c - hi), generated with decimal arithmetic),
# tail terms plain f32 (their magnitude keeps the f32 rounding below
# 2^-44 of the result). sin(r) = r·(1 + s·S(s)), cos(r) = 1 + s·C(s),
# s = r².
_S1 = (-0.1666666716337204, 4.967053879312289e-09)      # -1/3!
_S2 = (0.008333333767950535, -4.34617203337595e-10)     # +1/5!
_S3 = (-0.00019841270113829523, 2.725596874933456e-12)  # -1/7!
_S4 = 2.7557318844628753e-06                            # +1/9!
_S5 = -2.5052107943679403e-08                           # -1/11!
_S6 = 1.6059044372074283e-10                            # +1/13!
_C1 = (-0.5, 0.0)                                       # -1/2! (exact)
_C2 = (0.0416666679084301, -1.2417634698280722e-09)     # +1/4!
_C3 = (-0.0013888889225199819, 3.3631094437103215e-11)  # -1/6!
_C4 = (2.4801587642286904e-05, -3.40699609366682e-13)   # +1/8!
_C5 = -2.755731998149713e-07                            # -1/10!
_C6 = 2.0876755879584152e-09                            # +1/12!
_C7 = -1.147074536050896e-11                            # -1/14!


def _two_sum(a, b):
    """Error-free sum: a + b == s + err exactly (Knuth).

    The intermediate ``s`` is barriered: in a large graph XLA's
    algebraic simplifier sees through the transform (patterns like
    ``(a+b)-a``) and cancels the error term, collapsing the double-f32
    value back to single precision (measured: the sincos core lost 20
    bits without this). The barrier is a compile-time fence only."""
    import jax

    s = a + b
    sb = jax.lax.optimization_barrier(s)
    bb = sb - a
    err = (a - (sb - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Error-free renormalization. Dekker's 2-op form ``err = b-(s-a)``
    is ALGEBRAICALLY SIMPLIFIED AWAY by XLA (measured: err came back
    ~0 and the df pair collapsed to single precision); Knuth's
    branch-free form survives, so use it even where |a| >= |b| holds."""
    return _two_sum(a, b)


def _smul(a, b):
    """Contraction-proof product: a separate mul that XLA cannot fold
    into a neighbouring add as an FMA (the +0.0 through an optimization
    barrier idiom of ops/strictf.py, inlined to avoid a cyclic import)."""
    import jax

    z = jax.lax.optimization_barrier(jnp.float32(0.0))
    return a * b + z


def _df_add(a, b):
    ah, al = a
    bh, bl = b
    s, e = _two_sum(ah, bh)
    return _quick_two_sum(s, e + (al + bl))


def _df_mul(a, b):
    ah, al = a
    bh, bl = b
    p, e = _two_prod(ah, bh)
    # cross terms are inexact f32 products; guard them against FMA
    # contraction so every backend accumulates identical low bits
    return _quick_two_sum(p, e + (_smul(ah, bl) + _smul(al, bh)))


def _df_mul_f(a, b):
    ah, al = a
    p, e = _two_prod(ah, b)
    return _quick_two_sum(p, e + _smul(al, b))


def _sincos_core(x):
    """Reduced-range double-f32 sin/cos: returns (sin_df, cos_df, q)
    where q = round(x·2/π) mod 4 picks the quadrant and the df pair is
    evaluated on r = x - q·π/2, |r| <= π/4 + ulp."""
    x = jnp.asarray(x, jnp.float32)
    n = jnp.round(x * jnp.float32(_TWO_OVER_PI))
    # r = x - n·(c1+c2+c3) in double-f32 (products exact via two_prod)
    p1, e1 = _two_prod(n, jnp.float32(_PIO2_1))
    r = _df_add(_two_sum(x, -p1), (-e1, jnp.float32(0.0)))
    p2, e2 = _two_prod(n, jnp.float32(_PIO2_2))
    r = _df_add(r, (-p2, -e2))
    r = _df_add(r, (-_smul(n, jnp.float32(_PIO2_3)), jnp.float32(0.0)))

    s = _df_mul(r, r)
    sh = s[0]

    def df_c(c):
        return (jnp.float32(c[0]), jnp.float32(c[1]))

    # sin tail: S3 + s·(S4 + s·(S5 + s·S6)) — tail in f32, top terms df
    t_f = jnp.float32(_S4) + sh * (jnp.float32(_S5) + sh * jnp.float32(_S6))
    acc = _df_add(df_c(_S3), _df_mul_f(s, t_f))
    acc = _df_add(df_c(_S2), _df_mul(s, acc))
    acc = _df_add(df_c(_S1), _df_mul(s, acc))
    t = _df_mul(s, acc)  # s·S(s)
    sin_r = _df_mul(r, _df_add((jnp.float32(1.0), jnp.float32(0.0)), t))

    # cos tail: C4 + s·(C5 + s·(C6 + s·C7))
    c_f = jnp.float32(_C5) + sh * (jnp.float32(_C6) + sh * jnp.float32(_C7))
    acc = _df_add(df_c(_C4), _df_mul_f(s, c_f))
    acc = _df_add(df_c(_C3), _df_mul(s, acc))
    acc = _df_add(df_c(_C2), _df_mul(s, acc))
    acc = _df_add(df_c(_C1), _df_mul(s, acc))
    cos_r = _df_add(
        (jnp.float32(1.0), jnp.float32(0.0)), _df_mul(s, acc)
    )

    q = n.astype(jnp.int32) & 3
    return sin_r, cos_r, q


def _df_round(a):
    return a[0] + a[1]


def det_sincos(x):
    """(sin x, cos x), bit-identical across backends, ≈ correctly rounded
    (mis-rounds ~1e-6 of uniform draws — see the module comment)."""
    sin_r, cos_r, q = _sincos_core(x)
    sr, cr = _df_round(sin_r), _df_round(cos_r)
    odd = (q & 1) == 1
    s = jnp.where(odd, cr, sr)
    c = jnp.where(odd, sr, cr)
    neg_s = (q == 2) | (q == 3)
    neg_c = (q == 1) | (q == 2)
    return jnp.where(neg_s, -s, s), jnp.where(neg_c, -c, c)


def det_sin(x):
    return det_sincos(x)[0]


def det_cos(x):
    return det_sincos(x)[1]


def det_tan(x):
    """tan x via the double-f32 quotient of the unrounded sin/cos pair
    (rounding sin and cos first would cost ~1.5 ulp vs libm tan)."""
    sin_r, cos_r, q = _sincos_core(x)
    odd = (q & 1) == 1
    # tan = sin/cos; odd quadrants: tan(x) = -cos_r/sin_r
    num = (
        jnp.where(odd, -cos_r[0], sin_r[0]),
        jnp.where(odd, -cos_r[1], sin_r[1]),
    )
    den = (
        jnp.where(odd, sin_r[0], cos_r[0]),
        jnp.where(odd, sin_r[1], cos_r[1]),
    )
    neg = (q == 2) | (q == 3)
    num = (jnp.where(neg, -num[0], num[0]), jnp.where(neg, -num[1], num[1]))
    den = (jnp.where(neg, -den[0], den[0]), jnp.where(neg, -den[1], den[1]))
    # df division: platform quotient + one exact-residual refinement —
    # the platform's 1-2 ulp q0 noise cancels in the correction
    q0 = num[0] / den[0]
    rem = _df_add(num, [-v for v in _df_mul_f(den, q0)])
    q1 = (rem[0] + rem[1]) / den[0]
    return q0 + q1
