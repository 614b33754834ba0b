"""Double-float (two-f32) arithmetic for the device programs.

The clustering decision path needs ~f64 precision over data held as f32
pairs: the device programs use classic double-float arithmetic (Dekker
1971 / Knuth TAOCP 4.2.2), where every value is an unevaluated sum hi + lo
of two float32s, giving ~2^-47 relative accuracy from natively-rounded f32
ops.  The one product error term (two_prod) is taken by exact float64
widening, so the backend must run with jax_enable_x64.

This is NOT bit-exact float64.  Device decisions are therefore always taken
with a margin: |value - threshold| must exceed a margin that dominates the
dd error bound, otherwise the caller aborts to the float64 host oracle
(cluster/device_loop.py).  The margin machinery is what makes approximate
arithmetic safe; this module only needs to be *accurate*, not exact.

All functions are elementwise over jnp arrays and shape-polymorphic; a dd
number is a (hi, lo) tuple of same-shape float32 arrays with |lo| <= ulp(hi).

Error bounds (relative, for normalized inputs): add/sub/mul/div/sqrt each
<= ~4 * 2^-48; chains of ~30 ops stay well under 2^-40, so decision margins
of 1e-9 leave >3 decimal orders of headroom.
"""
from __future__ import annotations

import numpy as np


def _jnp():
    import jax.numpy as jnp

    return jnp


def _harden(x):
    """Round-trip through int32 bits: makes the rounded f32 value opaque to
    the backend's fast-math rewrites.  XLA:CPU emits fusion kernels whose
    LLVM gets to contract/reassociate FP chains (and optimization_barrier
    is dropped during HLO optimization), which silently destroys error-free
    transforms — e.g. `p + e` with a rematerialized `p = a * b` becomes
    fma(a, b, e), double-counting the product error two_prod extracted
    (observed: ~half-ulp corruption of dd lo parts, CPU jit only).  An
    integer XOR between two bitcasts cannot be folded away and no FP
    rewrite crosses it.  Cost: 3 cheap elementwise int ops per pivot.
    Guarded by test_ddf32_jit_exactness."""
    import jax

    jnp = _jnp()
    i = jax.lax.bitcast_convert_type(x, jnp.int32)
    return jax.lax.bitcast_convert_type(i ^ jnp.int32(0), jnp.float32)


# -- error-free transforms ---------------------------------------------------

def two_sum(a, b):
    """s + e == a + b exactly (Knuth), s = fl(a+b)."""
    s = _harden(a + b)
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, _harden(e)


def quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = _harden(a + b)
    e = b - (s - a)
    return s, _harden(e)


def two_prod(a, b):
    """p + e == a * b exactly.  The f32 product is exact in float64 (24+24
    significand bits), so p is its rounding and e the rounded-off rest.  p
    is a CONVERT of the f64 product, which no consumer can contract into an
    FMA (backends contract `a * b + e` into fma(a, b, e), double-counting
    the error term that a Dekker split would have extracted)."""
    import jax

    if not jax.config.jax_enable_x64:
        raise RuntimeError("dd arithmetic needs jax_enable_x64")
    jnp = _jnp()
    a64 = a.astype(jnp.float64) if hasattr(a, "astype") else np.float64(a)
    b64 = b.astype(jnp.float64) if hasattr(b, "astype") else np.float64(b)
    prod = a64 * b64
    p = _harden(prod.astype(jnp.float32))
    e = _harden((prod - p.astype(jnp.float64)).astype(jnp.float32))
    return p, e


# -- dd arithmetic ------------------------------------------------------------

def dd(hi, lo=None):
    """Pairs from HOST data stay numpy, so they are embedded into the HLO as
    literals; a jnp.asarray here would create a device array that becomes a
    jaxpr constant, which lowering copies back from the device."""
    import jax

    if isinstance(hi, jax.Array) or isinstance(lo, jax.Array):
        jnp = _jnp()
        hi = jnp.asarray(hi, jnp.float32)
        if lo is None:
            lo = jnp.zeros_like(hi)
        return hi, jnp.asarray(lo, jnp.float32)
    hi = np.asarray(hi, np.float32)
    if lo is None:
        lo = np.zeros_like(hi)
    return hi, np.asarray(lo, np.float32)


def dd_neg(x):
    return -x[0], -x[1]


def dd_add(x, y):
    sh, se = two_sum(x[0], y[0])
    se = se + x[1] + y[1]
    return quick_two_sum(sh, se)


def dd_sub(x, y):
    return dd_add(x, dd_neg(y))


def dd_mul(x, y):
    ph, pe = two_prod(x[0], y[0])
    pe = pe + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(ph, pe)


def dd_div(x, y):
    q1 = x[0] / y[0]
    # r = x - q1 * y, exactly to dd precision
    ph, pl = two_prod(q1, y[0])
    pl = pl + q1 * y[1]
    rh, rl = dd_add(x, (-ph, -pl))
    q2 = (rh + rl) / y[0]
    return quick_two_sum(q1, q2)


def dd_sqrt(x):
    """Newton step on f32 sqrt; x must be >= 0 (hi == 0 handled)."""
    jnp = _jnp()
    q1 = jnp.sqrt(x[0])
    ph, pl = two_prod(q1, q1)
    rh, rl = dd_add(x, (-ph, -pl))
    safe = jnp.where(q1 > 0, q1, 1.0)
    q2 = jnp.where(q1 > 0, (rh + rl) / (2.0 * safe), 0.0)
    return quick_two_sum(q1, q2)


def dd_abs(x):
    jnp = _jnp()
    neg = x[0] < 0
    return jnp.where(neg, -x[0], x[0]), jnp.where(neg, -x[1], x[1])


# -- conversions --------------------------------------------------------------

def dd_from_i32(v):
    """Exact dd from int32-valued data (|v| < 2^31 < 2^48: always exact)."""
    jnp = _jnp()
    hi = v.astype(jnp.float32)
    lo = (v - hi.astype(jnp.int64)).astype(jnp.float32)
    return hi, lo


def dd_from_i64(v):
    """dd from int64; exact for |v| < 2^48 (callers stay in that envelope)."""
    jnp = _jnp()
    hi = v.astype(jnp.float32)
    lo = (v - hi.astype(jnp.int64)).astype(jnp.float32)
    return hi, lo


def split_f64(v: np.ndarray):
    """HOST-side split of float64 constants into dd pairs (~2^-48 accurate)."""
    v = np.asarray(v, dtype=np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def dd_to_f64(x) -> np.ndarray:
    """HOST-side readback."""
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


# -- comparisons --------------------------------------------------------------

def dd_cmp(x, y):
    """Elementwise sign of (x - y): -1 / 0 / +1 as int32."""
    jnp = _jnp()
    d = dd_sub(x, y)
    return jnp.sign(d[0]) + jnp.where(d[0] == 0, jnp.sign(d[1]), 0.0)


def dd_eq(x, y):
    return (x[0] == y[0]) & (x[1] == y[1])


def dd_lt(x, y):
    return (x[0] < y[0]) | ((x[0] == y[0]) & (x[1] < y[1]))


def dd_gt(x, y):
    return dd_lt(y, x)


def dd_where(cond, x, y):
    jnp = _jnp()
    return jnp.where(cond, x[0], y[0]), jnp.where(cond, x[1], y[1])


def dd_approx(x):
    """f32 approximation of the dd value (for margin magnitude checks)."""
    return x[0] + x[1]
