"""Device-resident mean-shift accumulation.

The reference's accumulation phase (ClusterFactory.cpp:552-610 driving
Trainer::get_close, Trainer.cpp:22-71) is a sequential, data-dependent loop:
each step scans a length window of the live pool against the current center,
absorbs classifier positives, and re-centers on the member closest to the
member mean.  Driving this loop from the host with one device dispatch per
window pays a dispatch and a fetch per center.  This module re-expresses the
WHOLE phase as one on-device `lax.while_loop`: histograms, lengths, alive
masks, and membership live in device memory; the host receives only the
final (assignment, step, centers) arrays.

Exactness strategy (decisions must match the float64 host oracle bit for
bit, while the per-pair arithmetic stays in 32-bit types):

  - all pairwise sufficient statistics (sum-min, dot, EMD prefix) are exact
    integer arithmetic (envelope_check);
  - the classifier epilogue (derive singles, normalize, combos, GLM sum,
    the dist used for argmax) runs in double-float f32 arithmetic
    (ops/ddf32.py, ~2^-45 relative error);
  - the rounded-logistic gates compare the GLM sum against float64 edges
    precomputed by bit-bisection on the host (model/thresholds.py);
  - EVERY data-dependent decision carries a margin guard: if any decision
    falls within `margin` of an edge/tie (and is not provably an exact
    tie of identical integer inputs), the loop aborts with its full state
    and the host oracle resumes the run from that exact point
    (MeanShiftEngine._host_accumulate_loop) — so the device path can never
    change a clustering decision relative to the float64 semantics;
  - closest-to-mean (DivergencePoint::distance_d against the member mean,
    ClusterFactory.cpp:337-380) is computed from exact integer stats with
    per-bin guards on the two float64 rounding corners (round of the f64
    mean, trunc of count+mean), see _mean_round_guard.

bvec window semantics (bvec.cpp:260-330 + the binary-search quirks kept by
cluster/bvec.py) are reproduced with closed forms over masked reductions:
the reference's in-bin search is lower_bound with `high` initialized to
size-1, so an absent boundary resolves to min(lower_bound, size-1) and a
present one to its first/last occurrence; empty bins redirect to the
first/last non-empty bin at slot 0.
"""
from __future__ import annotations

import math
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..features import flags as F
from ..model.classifier import CompiledModel
from ..model import thresholds as TH
from ..kmer.counting import PointSet
from ..ops import ddf32 as DD
from .bvec import BVec

# singles the dd epilogue can derive from the integer stats
DD_DERIVABLE = frozenset({
    F.FEAT_MANHATTAN, F.FEAT_EUCLIDEAN, F.FEAT_INTERSECTION,
    F.FEAT_KULCZYNSKI2, F.FEAT_SIMRATIO, F.FEAT_NORMALIZED_VECTORS,
    F.FEAT_PEARSON_COEFF, F.FEAT_D2z, F.FEAT_EUCLIDEAN_Z, F.FEAT_EMD,
    F.FEAT_LENGTHD,
})

# blockwise extraslow singles (--feat extraslow, Feature.cpp:378-457):
# per-pair values computable from the two count blocks + magnitudes in f32
# with propagated ABSOLUTE error bounds, like the log pair below.  MISMATCH
# and JACCARD are integer-exact (err 0); the rest follow the nonneg-term or
# exact-integer-log-ratio recipes (see block_singles_stats).
BLOCK_DERIVABLE = frozenset({
    F.FEAT_MISMATCH, F.FEAT_JACCARD, F.FEAT_CANBERRA, F.FEAT_KULCZYNSKI1,
    F.FEAT_CHI_SQUARED, F.FEAT_HARMONIC_MEAN, F.FEAT_SQCHORD,
    F.FEAT_HELLINGER, F.FEAT_K_DIV, F.FEAT_KL_COND,
})

# log-divergence singles (--feat slow adds these, CRunner.cpp:366-378):
# computed per pair from the count blocks as f32 with propagated ABSOLUTE
# error bounds — the probability ratios are exact integer ratios
# (p_i/mp) / (q_i/mq) = (p_i*mq) / (q_i*mp), so only the final f32
# divisions/logs round, and the margin machinery covers the difference
# from the host's f64 values
LOG_DERIVABLE = frozenset({F.FEAT_JEFFEREY_DIV, F.FEAT_JENSEN_SHANNON})

# relative margin under which a decision is "uncertain" and the device
# aborts to the host oracle.  dd-f32 carries ~3e-14 relative error and the
# identity-form singles differ from the host's direct sums by <~1e-11
# (worst case: pearson's cancelling covariance), so 1e-8 leaves >2 orders
# of headroom while tripping ~never on real data.  Read at CONSTRUCTION
# time (not import) so tests can force margins per run.
def DEFAULT_MARGIN() -> float:
    return float(os.environ.get("MC2_DD_MARGIN", "1e-8"))


# tie margin for comparing two values produced by the SAME dd pipeline
# (dist argmax, distance_d argmin): the identity-vs-direct formula
# difference largely cancels between the two sides, so only the ~5e-14
# relative dd error matters, and the principled per-value bound
# (8 * dist_err, propagated with 32x per-op safety) is ALSO applied — this
# floor is belt-and-braces.  1e-12 keeps ~20x headroom over the measured
# end-to-end error; a 1e-10 floor trips on genuinely distinct candidates
# ~2000x above the dd precision (cause-2 aborts in tie-dense tails), and a
# shared 1e-8 margin aborts on genuine ~1e-8-relative distance_d gaps.
def DEFAULT_TIE_MARGIN() -> float:
    return float(os.environ.get("MC2_DD_TIE_MARGIN", "1e-12"))


def resolve_margins(margin, tie_margin):
    """(margin, tie_margin) with env defaults and the forced-margin rule:
    a forced-huge decision margin must drag the tie margin with it."""
    m = float(DEFAULT_MARGIN() if margin is None else margin)
    t = float(DEFAULT_TIE_MARGIN() if tie_margin is None else tie_margin)
    if m > 1e-8:
        t = max(t, m * 1e-2)
    return m, t

_WC = 2048  # scan chunk rows (static shape inside the loop)

# fixed patch shape for abort-resume carries (make_carry/_patch_big):
# one shape -> one precompiled apply function
_PATCH_P = 8192
_PATCH_Q = 1024

# fixed diff-FETCH shapes (the download mirror of the diff-patch upload):
# on an abort-resume, the program also emits the rows whose state changed
# SINCE THE CARRY IT WAS LAUNCHED FROM, so the host fetches ~300 KB instead
# of the full multi-MB packed state (the 100k window was fetch-bound at
# ~0.5-2 s per resume round trip).  Overflow falls back to the full fetch.
_DIFF_P = 16384
_DIFF_Q = 4096


def _shape_bucket(x: int, floor: int = 1024) -> int:
    """Smallest of {2^a, 3*2^(a-1)} >= x (>= floor).  Padded program shapes
    are bucketed so the XLA compile cache hits across datasets of similar
    size instead of recompiling per exact n."""
    if x <= floor:
        return floor
    p = 1 << (x - 1).bit_length()
    c = (3 * p) // 4
    return c if c >= x else p


# which integer pair statistics each single consumes; unused stats are
# replaced by zeros so XLA dead-code-eliminates their computation (the tie
# signatures then compare equal on those slots, which is sound: the dd
# value depends only on the used stats)
_NEED_SUMMIN = frozenset({F.FEAT_MANHATTAN, F.FEAT_INTERSECTION,
                          F.FEAT_KULCZYNSKI2})
_NEED_DOT = frozenset({F.FEAT_EUCLIDEAN, F.FEAT_SIMRATIO,
                       F.FEAT_NORMALIZED_VECTORS, F.FEAT_PEARSON_COEFF,
                       F.FEAT_D2z, F.FEAT_EUCLIDEAN_Z})


def stat_needs(singles) -> Tuple[bool, bool, bool]:
    s = set(singles)
    return (bool(s & _NEED_SUMMIN), bool(s & _NEED_DOT), F.FEAT_EMD in s)


def log_needs(singles) -> Tuple[bool, bool]:
    s = set(singles)
    return (F.FEAT_JEFFEREY_DIV in s, F.FEAT_JENSEN_SHANNON in s)


def log_div_stats(jnp, A, B, magA, magB, need_jd: bool, need_js: bool):
    """Jefferey and Jensen-Shannon divergences (Feature.cpp:956-978,
    984-1009) for int32 count blocks A, B [W, D] with pseudo-magnitudes
    magA, magB [W].  Returns (jd, js, jd_err, js_err) float32 [W]; the err
    arrays are ABSOLUTE bounds on |device - host f64|.

    Exactness: p_i/mp / (q_i/mq) = (p_i*mq)/(q_i*mp) — the numerators are
    exact int64 products < 2^31 (envelope: maxc * maxmag), so each log
    argument rounds exactly once to f32 (~6e-8 rel), giving ~2e-7 absolute
    error per log term; per-term and tree-summation errors are bounded by
    the companion |term| sums with 4-5x safety factors."""
    W = A.shape[0]
    z = np.zeros((W,), np.float32)
    if not (need_jd or need_js):
        return z, z, z, z
    i64 = lambda v: v.astype(jnp.int64)
    f32 = lambda v: v.astype(jnp.float32)
    mA = i64(magA)[:, None]
    mB = i64(magB)[:, None]
    ppn = f32(i64(A) * mB)            # exact ints, one f32 rounding
    pqn = f32(i64(B) * mA)
    magAf = f32(magA)
    magBf = f32(magB)
    if need_jd:
        dnum = f32(i64(A) * mB - i64(B) * mA)   # exact int difference
        lr = jnp.log(ppn / pqn)
        term = dnum * lr
        invm = np.float32(1.0) / (magAf * magBf)
        jd = term.sum(axis=1) * invm
        jd_err = (np.float32(1e-6) * jnp.abs(dnum).sum(axis=1)
                  + np.float32(4e-6) * jnp.abs(term).sum(axis=1)) * invm
    else:
        jd, jd_err = z, z
    if need_js:
        sn = ppn + pqn
        lp = jnp.log(2.0 * ppn / sn)
        lq = jnp.log(2.0 * pqn / sn)
        ta = f32(A) * lp
        tb = f32(B) * lq
        js = np.float32(0.5) * (ta.sum(axis=1) / magAf
                                + tb.sum(axis=1) / magBf)
        js_abs = np.float32(0.5) * (jnp.abs(ta).sum(axis=1) / magAf
                                    + jnp.abs(tb).sum(axis=1) / magBf)
        # sum_i A_i / magA == 1 exactly, hence the constant first bound
        js_err = np.float32(1e-6) + np.float32(4e-6) * js_abs
    else:
        js, js_err = z, z
    return jd, js, jd_err, js_err


def block_singles_stats(jnp, A, B, magA, magB, d: int, flags):
    """{flag: (value_f32 [W], abs_err_f32 [W])} for BLOCK_DERIVABLE singles
    (host oracles: features/host.py, reference Feature.cpp:378-457).

    A, B int32 count blocks [W, D]; magA, magB int32 pseudo-magnitudes.
    Exactness recipes (the margin machinery relies on the err bounds):
      - integer-exact singles (mismatch Feature.cpp:1941, jaccard :1681):
        counts < 2^24 are exact in f32, err 0;
      - nonneg-term sums (canberra :1970, kulczynski1 :2001, chi2 :1142,
        harmonic :1202): integer numerators are exact (via int64), one f32
        division rounds per term, terms never cancel — err <= eps * value
        with a 4-5x tree-summation safety factor;
      - sqrt/cancellation sums (sqchord :736, hellinger :1082): per-term
        error scales with companion magnitude sums computed alongside;
      - exact-integer log ratios (k_div :1281, kl_cond :1315): the log
        argument is a ratio of exact int64 products, so each log sees a
        once-rounded value (same recipe as log_div_stats), bounded via
        companion |term| sums.
    """
    out = {}
    f32 = lambda v: v.astype(jnp.float32)
    i64 = lambda v: v.astype(jnp.int64)
    need = set(flags)
    W = A.shape[0]
    zero = jnp.zeros((W,), jnp.float32)
    e_sum = np.float32(4e-6)        # per-term + tree-summation coefficient
    e_one = np.float32(6e-8)        # one f32 rounding
    if F.FEAT_MISMATCH in need:
        v = f32((A != B).sum(axis=1, dtype=jnp.int32))
        out[F.FEAT_MISMATCH] = (v, zero)
    if F.FEAT_JACCARD in need:
        hit = ((A == B) & (A > 1)).sum(axis=1, dtype=jnp.int32)
        # 1/d is a power of two: the scale is exact in f32
        out[F.FEAT_JACCARD] = (f32(hit) * np.float32(1.0 / d), zero)
    if {F.FEAT_CANBERRA, F.FEAT_KULCZYNSKI1, F.FEAT_CHI_SQUARED,
            F.FEAT_HARMONIC_MEAN, F.FEAT_SQCHORD} & need:
        sAB = f32(A + B)
        if F.FEAT_CANBERRA in need:
            v = (f32(jnp.abs(A - B)) / sAB).sum(axis=1)
            out[F.FEAT_CANBERRA] = (v, e_sum * v + np.float32(1e-7))
        if F.FEAT_KULCZYNSKI1 in need:
            v = (f32(jnp.abs(A - B)) / f32(jnp.minimum(A, B))).sum(axis=1)
            out[F.FEAT_KULCZYNSKI1] = (v, e_sum * v + np.float32(1e-7))
        if F.FEAT_CHI_SQUARED in need:
            dd2 = i64(A - B)
            v = (f32(dd2 * dd2) / sAB).sum(axis=1)
            out[F.FEAT_CHI_SQUARED] = (v, e_sum * v + np.float32(1e-7))
        if F.FEAT_HARMONIC_MEAN in need:
            v = 2.0 * (f32(i64(A) * i64(B)) / sAB).sum(axis=1)
            out[F.FEAT_HARMONIC_MEAN] = (v, e_sum * v + np.float32(1e-7))
        if F.FEAT_SQCHORD in need:
            rt = jnp.sqrt(f32(i64(A) * i64(B)))
            v = (sAB - 2.0 * rt).sum(axis=1)
            # cancellation: per-term error ~ 2 eps sqrt(AB) + eps (A+B)
            comp = rt.sum(axis=1)
            err = np.float32(4.0) * e_one * comp + e_sum * jnp.abs(v) \
                + np.float32(1e-7)
            out[F.FEAT_SQCHORD] = (v, err)
    if F.FEAT_HELLINGER in need:
        # sqrt(2 * sum (sqrt(A d / magA) - sqrt(B d / magB))^2); A*d exact
        # in int64, one rounding per division and sqrt
        xa = jnp.sqrt(f32(i64(A) * np.int64(d)) / f32(magA)[:, None])
        xb = jnp.sqrt(f32(i64(B) * np.int64(d)) / f32(magB)[:, None])
        diff = xa - xb
        S = (diff * diff).sum(axis=1)
        compS = (jnp.abs(diff) * (xa + xb)).sum(axis=1)
        errS = np.float32(6.0) * e_one * compS + e_sum * S
        v = jnp.sqrt(2.0 * S)
        vf = jnp.maximum(v, np.float32(1e-3))
        out[F.FEAT_HELLINGER] = (v, errS / vf + e_one * v
                                 + np.float32(1e-7))
    if F.FEAT_K_DIV in need:
        # sum (A/magA) log(2 A magB / (A magB + B magA)): exact int64
        # numerators/denominators, so the log argument rounds once
        num = f32(np.int64(2) * i64(A) * i64(magB)[:, None])
        den = f32(i64(A) * i64(magB)[:, None] + i64(B) * i64(magA)[:, None])
        lg = jnp.log(num / den)
        pp = f32(A) / f32(magA)[:, None]
        term = pp * lg
        v = term.sum(axis=1)
        # sum pp == 1 exactly, hence the constant first bound
        err = np.float32(1e-6) + np.float32(5e-6) * jnp.abs(term).sum(axis=1)
        out[F.FEAT_K_DIV] = (v, err)
    if F.FEAT_KL_COND in need:
        a4 = 4
        gp = A.reshape(W, d // a4, a4)
        gq = B.reshape(W, d // a4, a4)
        sp = gp.sum(axis=2, dtype=jnp.int32)
        sq = gq.sum(axis=2, dtype=jnp.int32)
        # log(cp/cq) = log(gp sq / (gq sp)): exact int64 products
        lg = jnp.log(f32(i64(gp) * i64(sq)[:, :, None])
                     / f32(i64(gq) * i64(sp)[:, :, None]))
        cp = f32(gp) / f32(sp)[:, :, None]
        cq = f32(gq) / f32(sq)[:, :, None]
        inner_p = (cp * lg).sum(axis=2)
        inner_q = (-cq * lg).sum(axis=2)
        outer_p = (f32(sp) * inner_p).sum(axis=1)
        outer_q = (f32(sq) * inner_q).sum(axis=1)
        v = (outer_p / f32(magA) + outer_q / f32(magB)) * np.float32(0.5)
        abs_p = (f32(sp) * jnp.abs(cp * lg).sum(axis=2)).sum(axis=1)
        abs_q = (f32(sq) * jnp.abs(cq * lg).sum(axis=2)).sum(axis=1)
        err = np.float32(1e-6) + np.float32(5e-6) * (
            abs_p / f32(magA) + abs_q / f32(magB))
        out[F.FEAT_KL_COND] = (v, err)
    return out


def emd_rowsum(jnp, diff_i32):
    """sum_j |prefix_j(diff)| per row as int64.  The prefix sums are exact
    int32 (|prefix| <= pseudo-magnitude < 2^24, envelope_check) and the
    row total accumulates in int64, so the EMD stat cannot wrap for any
    in-envelope input.  On the GPU this cumsum form ran faster than
    blocked triangular matmuls at WC = 2048, D = 1,024 and 4,096 (both
    bit-exact; chip_smoke.py phase 3 times the two)."""
    return jnp.abs(jnp.cumsum(diff_i32, axis=1)).sum(axis=1,
                                                      dtype=jnp.int64)


# Device cost model of the accumulate loop, for its per-dispatch budget:
# microseconds per loop step plus nanoseconds per length-passed pair scored,
# fitted by chip_smoke.py phase 3 on the 100k pool (NVIDIA H100 80GB HBM3,
# power limit 400 W: 648.7 us/step, 154.2 ns/pair).
STEP_COST_US = 649.0
PAIR_COST_NS = 154.0


def dispatch_cost_us(iters, pairs):
    """Estimated device microseconds of `iters` loop steps that scored
    `pairs` length-passed pairs (traced int scalars -> float64)."""
    import jax.numpy as jnp

    return (iters.astype(jnp.float64) * np.float64(STEP_COST_US)
            + pairs.astype(jnp.float64) * np.float64(PAIR_COST_NS * 1e-3))


class DeviceLoopUnsupported(Exception):
    pass


def _step_cap() -> int:
    """Validated MC2_DEV_STEP_CAP (profiling-only step limit).  A stray or
    malformed value must fail loudly, not silently truncate a real run."""
    raw = os.environ.get("MC2_DEV_STEP_CAP", "0")
    try:
        cap = int(raw)
    except ValueError:
        raise RuntimeError(
            f"MC2_DEV_STEP_CAP={raw!r} is not an integer") from None
    if cap < 0:
        raise RuntimeError(f"MC2_DEV_STEP_CAP={cap} must be >= 0")
    return cap


class ResumeState(NamedTuple):
    """Host continuation point after a guarded abort."""
    stage: int                 # 1: redo window scan; 2: redo closest-to-mean
    clusters_done: list        # list of Cluster (complete)
    current_rows: list         # members of the open cluster, reference order
    last_row: int              # current center row
    bv: BVec                   # pool state at the abort point


class _ModelPack(NamedTuple):
    singles: tuple
    is_sim: tuple
    mins: tuple                # host f64 per single
    dens: tuple                # host f64 (max - min) per single
    combos: tuple              # ((kind, idxs), ...)
    weights: tuple             # host f64, [0] = intercept
    pos_edge: float            # f64 GLM-sum edge for round(prob) > 0
    has_log: bool              # any full-vector (log/blockwise) single
    blk: tuple                 # BLOCK_DERIVABLE singles selected


def _pack_model(model: CompiledModel) -> _ModelPack:
    singles = tuple(model.singles)
    allowed = DD_DERIVABLE | LOG_DERIVABLE | BLOCK_DERIVABLE
    if not set(singles) <= allowed:
        bad = sorted(F.FEAT_NAMES.get(s, hex(s))
                     for s in set(singles) - allowed)
        raise DeviceLoopUnsupported(
            f"features {bad} have no device implementation")
    edge = TH.positive_edge(model.bias)
    if not math.isfinite(edge):
        # decision is constant in s; encode as a huge finite edge
        edge = -1e30 if edge < 0 else 1e30
    return _ModelPack(
        singles=singles,
        is_sim=tuple(bool(F.FEAT_IS_SIM[s]) for s in singles),
        mins=tuple(float(v) for v in model.mins),
        dens=tuple(float(ma - mi) for mi, ma in zip(model.mins, model.maxs)),
        combos=tuple((kind, tuple(idxs)) for kind, idxs in model.combos),
        weights=tuple(float(w) for w in model.weights),
        pos_edge=float(edge),
        # blockwise singles (log pair + BLOCK_DERIVABLE) depend on the FULL
        # count vectors, so exact-tie certification needs row identity
        has_log=bool(set(singles) & (LOG_DERIVABLE | BLOCK_DERIVABLE)),
        blk=tuple(s for s in singles if s in BLOCK_DERIVABLE),
    )


def _index_of_vec(bounds: np.ndarray, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized BVec._index_of (bvec.cpp:122-147): returns (low, high)
    with the reference's initialization quirks."""
    nb = len(bounds)
    hi_cnt = np.searchsorted(bounds, x, side="right")
    low = np.where(hi_cnt == 0, nb - 1,
                   np.where(hi_cnt >= nb, nb - 1, hi_cnt - 1))
    high = np.where(hi_cnt == 0, 0,
                    np.where(hi_cnt >= nb, nb - 1, hi_cnt - 1))
    return low.astype(np.int32), high.astype(np.int32)


def envelope_check_vals(maxc: int, maxmag: int, maxlen: int,
                        self_dots: np.ndarray) -> None:
    """The exact-arithmetic envelope shared by the device programs,
    checkable from metadata alone (multihost stores never materialize the
    full count matrix on one host)."""
    if maxmag >= 2**24:
        raise DeviceLoopUnsupported("pseudo-magnitude >= 2^24")
    if maxc * maxmag >= 2**31:
        raise DeviceLoopUnsupported("dot product >= 2^31")
    if maxc * 4 * _WC >= 2**31:  # widest scan chunk (large-pool setting)
        raise DeviceLoopUnsupported("chunk column sums >= 2^31")
    if maxlen >= 2**31:
        raise DeviceLoopUnsupported("length >= 2^31")
    if len(self_dots) and int(self_dots.max()) >= 2**31:
        raise DeviceLoopUnsupported("self dot >= 2^31")


def envelope_check(ps, model_singles_checked=True):
    """Raise DeviceLoopUnsupported outside the exact-arithmetic envelope
    shared by the device accumulate/update programs."""
    maxc = int(ps.counts.max()) if ps.n else 0
    maxmag = int(ps.mags.max()) if ps.n else 0
    self_dots = np.einsum(
        "ij,ij->i", ps.counts.astype(np.int64), ps.counts.astype(np.int64)
    )
    envelope_check_vals(maxc, maxmag, int(ps.lengths.max()) if ps.n else 0,
                        self_dots)
    return self_dots


# relative error of the dd pipeline (measured ~5e-14 end-to-end; 2^-40
# leaves a 9000x cushion) and the host oracle's pairwise-summation epsilon
_ETA = np.float32(2.0**-40)
_EPS64 = 1.1e-16


def derive_singles_dd(pack, d, jnp, stats, a, b):
        """Singles from the integer pair statistics, in dd arithmetic.

        stats: dict summin/dot/emd (int32 [W]); a/b: per-side dicts with
        mags/selfdot (int32/int64), std dd pairs, lens (int32).  Returns
        (singles, errs): dd values plus ABSOLUTE error bounds per single —
        the bound covers both the dd arithmetic and the difference between
        the identity-form value and the host oracle's direct f64 sums
        (which matters where sums cancel: d2z, euclidean_z)."""
        summin, dot, emd = stats["summin"], stats["dot"], stats["emd"]
        i64 = lambda v: v.astype(jnp.int64)
        mag_a, mag_b = i64(a["mags"]), i64(b["mags"])
        self_a, self_b = i64(a["selfdot"]), i64(b["selfdot"])
        dd_i = DD.dd_from_i64
        # exact integer building blocks
        norm2 = self_a + self_b - 2 * i64(dot)          # < 2^33
        dd_dot = dd_i(i64(dot))
        # 1 / d is a power of two: scaling by it is exact in f32
        inv_d = np.float32(1.0 / d)

        out = []
        errs = []
        cache = {}
        # host pairwise-summation absolute coefficients (see docstring):
        # pearson is protected by Cauchy-Schwarz (sum|dp dq| <= sqrt(na nb)),
        # d2z's denominator is d x smaller, euclidean_z cancels openly
        eta_host = np.float32(_EPS64 * (np.log2(max(d, 2)) + 2))
        eta_d2z = np.float32(_EPS64 * (np.log2(max(d, 2)) + 2) * d)

        def sqrt_norm2():
            if "sq" not in cache:
                cache["sq"] = DD.dd_sqrt(dd_i(norm2))
            return cache["sq"]

        def cov():
            # dot - mags_a * mags_b / d, all exact until the dd conversion
            if "cov" not in cache:
                mm = mag_a * mag_b                      # < 2^48 exact
                t = dd_i(mm)
                t = (t[0] * inv_d, t[1] * inv_d)        # exact scale
                cache["cov"] = DD.dd_sub(dd_dot, t)
            return cache["cov"]

        def var_side(side, mag, self_):
            key = "var_" + side
            if key not in cache:
                mm = mag * mag
                t = dd_i(mm)
                t = (t[0] * inv_d, t[1] * inv_d)
                cache[key] = DD.dd_sub(dd_i(self_), t)
            return cache[key]

        for flag in pack.singles:
            if flag == F.FEAT_MANHATTAN:
                out.append(dd_i(mag_a + mag_b - 2 * i64(summin)))
                errs.append(jnp.zeros_like(out[-1][0]))
            elif flag == F.FEAT_EUCLIDEAN:
                out.append(sqrt_norm2())
                errs.append(_ETA * jnp.abs(out[-1][0]))
            elif flag == F.FEAT_INTERSECTION:
                out.append(DD.dd_div(dd_i(2 * i64(summin)), dd_i(mag_a + mag_b)))
                errs.append(_ETA * jnp.abs(out[-1][0]))
            elif flag == F.FEAT_KULCZYNSKI2:
                ap = dd_i(mag_a)
                ap = (ap[0] * inv_d, ap[1] * inv_d)
                aq = dd_i(mag_b)
                aq = (aq[0] * inv_d, aq[1] * inv_d)
                num = DD.dd_add(ap, aq)
                num = (num[0] * np.float32(d), num[1] * np.float32(d))
                den = DD.dd_mul(ap, aq)
                den = (den[0] * np.float32(2.0), den[1] * np.float32(2.0))
                coeff = DD.dd_div(num, den)
                out.append(DD.dd_mul(coeff, dd_i(i64(summin))))
                errs.append(_ETA * jnp.abs(out[-1][0]))
            elif flag == F.FEAT_SIMRATIO:
                out.append(DD.dd_div(dd_dot, DD.dd_add(dd_dot, sqrt_norm2())))
                errs.append(_ETA * jnp.abs(out[-1][0]))
            elif flag == F.FEAT_NORMALIZED_VECTORS:
                out.append(DD.dd_div(dd_dot, DD.dd_sqrt(dd_i(self_a * self_b))))
                errs.append(_ETA * jnp.abs(out[-1][0]))
            elif flag == F.FEAT_PEARSON_COEFF:
                na = var_side("a", mag_a, self_a)
                nb_ = var_side("b", mag_b, self_b)
                out.append(DD.dd_div(cov(), DD.dd_sqrt(DD.dd_mul(na, nb_))))
                errs.append(_ETA * jnp.abs(out[-1][0]) + eta_host)
            elif flag == F.FEAT_D2z:
                sa, sb = a["std"], b["std"]
                out.append(DD.dd_div(cov(), DD.dd_mul(sa, sb)))
                errs.append(_ETA * jnp.abs(out[-1][0]) + eta_d2z)
            elif flag == F.FEAT_EUCLIDEAN_Z:
                sa, sb = a["std"], b["std"]
                na = var_side("a", mag_a, self_a)
                nb_ = var_side("b", mag_b, self_b)
                ea = DD.dd_div(na, DD.dd_mul(sa, sa))
                eb = DD.dd_div(nb_, DD.dd_mul(sb, sb))
                dz = DD.dd_div(cov(), DD.dd_mul(sa, sb))
                t = DD.dd_add(ea, eb)
                t = DD.dd_sub(t, (dz[0] * np.float32(2.0), dz[1] * np.float32(2.0)))
                out.append(DD.dd_sqrt(t))
                # cancellation in na/s^2 + nb/s^2 - 2 dz amplifies both the
                # dd error and the host's summation error relative to ez
                t_mag = jnp.abs(ea[0]) + jnp.abs(eb[0]) + 2 * jnp.abs(dz[0])
                ezv = jnp.maximum(jnp.abs(out[-1][0]), np.float32(1e-3))
                errs.append((_ETA * t_mag + eta_d2z) / (2 * ezv)
                            + _ETA * ezv)
            elif flag == F.FEAT_EMD:
                out.append(dd_i(i64(emd)))
                errs.append(jnp.zeros_like(out[-1][0]))
            elif flag == F.FEAT_JEFFEREY_DIV:
                # f32 value with an explicit absolute error bound
                # (log_div_stats); the lo limb is zero by construction
                out.append((stats["jd"], jnp.zeros_like(stats["jd"])))
                errs.append(stats["jd_err"])
            elif flag == F.FEAT_JENSEN_SHANNON:
                out.append((stats["js"], jnp.zeros_like(stats["js"])))
                errs.append(stats["js_err"])
            elif flag in BLOCK_DERIVABLE:
                v, e = stats["blk"][flag]
                out.append((v, jnp.zeros_like(v)))
                errs.append(e)
            elif flag == F.FEAT_LENGTHD:
                la, lb = i64(a["lens"]), i64(b["lens"])
                out.append(dd_i(jnp.abs(la - lb)))
                errs.append(jnp.zeros_like(out[-1][0]))
            else:  # pragma: no cover - guarded by _pack_model
                raise AssertionError(flag)
        return out, errs

def epilogue_dd(pack, singles_err):
    """(s, dist, s_err, dist_err) from (singles, errs): the model decision
    path (normalize -> combos -> weighted sum, model/classifier.py) in dd
    with first-order ABSOLUTE error propagation.  The error bounds are what
    make the decision margins sound: normalization subtracts near-equal
    values and the GLM terms cancel, so relative-to-|s| margins understate
    the true uncertainty (first seen as a flipped 6th digit in fastcar
    regression output)."""
    import jax.numpy as jnp

    singles_dd, singles_errs = singles_err
    pk = pack
    normed = []
    nerrs = []
    for i, v in enumerate(singles_dd):
        mn = DD.dd(*(np.float32(x) for x in DD.split_f64(np.float64(pk.mins[i]))))
        dn = DD.dd(*(np.float32(x) for x in DD.split_f64(np.float64(pk.dens[i]))))
        z = DD.dd_div(DD.dd_sub(v, mn), dn)
        inv_den = np.float32(1.0 / abs(pk.dens[i])) if pk.dens[i] != 0 \
            else np.float32(np.inf)
        ze = (singles_errs[i]
              + _ETA * (jnp.abs(v[0]) + np.float32(abs(pk.mins[i])))) * inv_den \
            + _ETA * jnp.abs(z[0])
        if not pk.is_sim[i]:
            one = DD.dd(np.float32(1.0), np.float32(0.0))
            z = DD.dd_sub(one, z)
            ze = ze + _ETA
        normed.append(z)
        nerrs.append(ze)
    combos = []
    cerrs = []

    def mul_err(c, ce, z, ze):
        nc = DD.dd_mul(c, z)
        nce = ce * jnp.abs(z[0]) + ze * jnp.abs(c[0]) + _ETA * jnp.abs(nc[0])
        return nc, nce

    for kind, idxs in pk.combos:
        if kind == F.COMBO_XY:
            c, ce = normed[idxs[0]], nerrs[idxs[0]]
            for j in idxs[1:]:
                c, ce = mul_err(c, ce, normed[j], nerrs[j])
        elif kind == F.COMBO_X2Y2:
            c, ce = mul_err(normed[idxs[0]], nerrs[idxs[0]],
                            normed[idxs[0]], nerrs[idxs[0]])
            for j in idxs[1:]:
                c, ce = mul_err(c, ce, normed[j], nerrs[j])
                c, ce = mul_err(c, ce, normed[j], nerrs[j])
        elif kind == F.COMBO_XY2:
            i0, i1 = idxs
            c, ce = mul_err(normed[i0], nerrs[i0], normed[i1], nerrs[i1])
            c, ce = mul_err(c, ce, normed[i1], nerrs[i1])
        elif kind == F.COMBO_X2Y:
            i0, i1 = idxs
            c, ce = mul_err(normed[i0], nerrs[i0], normed[i0], nerrs[i0])
            c, ce = mul_err(c, ce, normed[i1], nerrs[i1])
        else:  # pragma: no cover
            raise AssertionError(kind)
        combos.append(c)
        cerrs.append(ce)
    w0 = DD.split_f64(np.float64(pk.weights[0]))
    ssum = DD.dd(np.float32(w0[0]), np.float32(w0[1]))
    s_err = jnp.zeros_like(combos[0][0]) if combos else np.float32(0.0)
    s_err = s_err + _ETA * np.float32(abs(pk.weights[0]))
    for c, ce, w in zip(combos, cerrs, pk.weights[1:]):
        wd = DD.split_f64(np.float64(w))
        ssum = DD.dd_add(
            ssum, DD.dd_mul(c, DD.dd(np.float32(wd[0]), np.float32(wd[1]))))
        aw = np.float32(abs(w))
        s_err = s_err + aw * ce + _ETA * aw * jnp.abs(c[0])
    if combos:
        dist, dist_err = combos[0], cerrs[0]
    else:
        dist = DD.dd(np.float32(0.0), np.float32(0.0))
        dist_err = np.float32(0.0)
    return ssum, dist, s_err, dist_err


# X2Y2 squares each subsequent factor twice via mul_err above, which is
# exactly prod(z_j^2) with its error; see classifier.combo_matrix.


class DeviceAccumulator:
    """One-dispatch accumulation for a PointSet + trained model.

    Prepared from a finalized BVec (before any pop).  `run()` returns either
    (clusters_raw, None) on full completion or (None, ResumeState) on a
    guarded abort; raises DeviceLoopUnsupported when the dataset/model is
    outside the exact-arithmetic envelope.
    """

    def __init__(self, ps: PointSet, model: CompiledModel, sim: float,
                 margin: Optional[float] = None,
                 tie_margin: Optional[float] = None,
                 shared_counts=None, self_dots=None, maxc=None,
                 row_fetch=None):
        self.ps = ps
        self.model = model
        self.sim = float(sim)
        self.margin, self.tie_margin = resolve_margins(margin, tie_margin)
        self.pack = _pack_model(model)
        # counts already resident on the device in natural row order (the
        # DeviceUpdater's upload): the program then permutes on device from
        # a 64 KB order vector instead of re-uploading the multi-MB flat
        # array
        self.shared_counts = shared_counts
        # multihost stores hold no host count matrix: metadata envelope
        # values come precomputed and single rows come through `row_fetch`
        self._row_fetch = row_fetch
        if ps.counts is not None:
            self._self_dots = envelope_check(ps)
            self._maxc = int(ps.counts.max()) if ps.n else 0
        else:
            if shared_counts is None or self_dots is None or maxc is None:
                raise DeviceLoopUnsupported(
                    "countless point set needs shared_counts+self_dots+maxc")
            self._self_dots = np.asarray(self_dots)
            self._maxc = int(maxc)
            envelope_check_vals(
                self._maxc, int(ps.mags.max()) if ps.n else 0,
                int(ps.lengths.max()) if ps.n else 0, self._self_dots)
        self._d = ps.dim
        # scan chunk rows: window flat-spans grow with n (they cover dead
        # rows too), so large pools use wider chunks — fewer inner loop
        # iterations for the same masked work
        self._wc = int(os.environ.get("MC2_DEV_WC", "0")) or _WC

    # -- host-side preparation ------------------------------------------------

    def _prepare(self, bv: BVec):
        ps = self.ps
        order = np.concatenate([b for b in bv.bins]) if bv.size() else np.zeros(0, np.int64)
        n = len(order)
        if n != ps.n:
            raise DeviceLoopUnsupported("bvec does not cover the point set")
        nb = len(bv.bins)
        bin_sizes = np.array([len(b) for b in bv.bins], dtype=np.int64)
        bin_start = np.zeros(nb + 1, dtype=np.int32)
        np.cumsum(bin_sizes, out=bin_start[1:])
        bin_ids = np.repeat(np.arange(nb, dtype=np.int32), bin_sizes)

        lens = ps.lengths[order]
        L = lens.astype(np.float64)
        blen = (L * self.sim).astype(np.int64)   # uint64 trunc of f64 product
        elen = (L / self.sim).astype(np.int64)
        bounds = np.asarray(bv.begin_bounds, dtype=np.int64)
        fbin0, _ = _index_of_vec(bounds, blen)
        _, bbin0 = _index_of_vec(bounds, elen)

        # bucketed padded shapes: the compiled program depends only on
        # (npad, nb_pad, D, dtype, model), so nearby dataset sizes reuse the
        # XLA compile cache; n itself is a runtime scalar argument
        npad = _shape_bucket(n + self._wc + 8)
        nb_pad = _shape_bucket(nb, floor=8)

        def padded(a, fill, dtype):
            out = np.full(npad, fill, dtype=dtype)
            out[:n] = a
            return out

        # trailing empty bins: bin_start pads with n (zero-size bins past
        # the last real bin never match any alive row)
        bin_start_pad = np.full(nb_pad + 1, n, dtype=np.int32)
        bin_start_pad[: nb + 1] = bin_start

        host = {
            "order": order,
            "n": n,
            "nb": nb,
            "bin_start": bin_start,
            "bounds": list(bv.begin_bounds),
        }
        if self.shared_counts is not None:
            order_pad = np.zeros(npad, dtype=np.int32)
            order_pad[:n] = order
            counts_entry = {"counts_nat": self.shared_counts,
                            "order_pad": order_pad}
        else:
            flat = np.zeros((npad, ps.counts.shape[1]), dtype=ps.counts.dtype)
            flat[:n] = ps.counts[order]
            counts_entry = {"counts": flat}
        dev = {
            **counts_entry,
            "lens": padded(lens, np.iinfo(np.int32).max, np.int32),
            "bin_ids": padded(bin_ids, nb_pad, np.int32),
            "blen": padded(blen, 0, np.int32),
            "elen": padded(elen, 0, np.int32),
            "fbin0": padded(fbin0, 0, np.int32),
            "bbin0": padded(bbin0, 0, np.int32),
            "mags": padded(ps.mags[order], 0, np.int32),
            "selfdot": padded(self._self_dots[order], 0, np.int32),
            "bin_start": bin_start_pad,
            "n": np.int32(n),
            "maxc": np.int64(self._maxc),
        }
        sh, sl = DD.split_f64(ps.stddevs[order])
        dev["std_h"] = padded(sh, 1.0, np.float32)
        dev["std_l"] = padded(sl, 0.0, np.float32)
        dev.update(self._fresh_carry(n, npad, order))
        return host, dev

    def _fresh_carry(self, n: int, npad: int, order: np.ndarray) -> dict:
        """Initial loop state as ARGUMENTS (so an abort-resume can relaunch
        the same compiled program from an arbitrary point)."""
        alive0 = np.zeros(npad, bool)
        alive0[:n] = True
        assign0 = np.full(npad, -1, np.int32)
        astep0 = np.zeros(npad, np.int32)
        msum0 = np.zeros(self._d, np.int64)
        if n:
            alive0[0] = False          # first pop seeds cluster 0
            assign0[0] = 0
            msum0[:] = self._rows_host(order[:1])[0].astype(np.int64)
        return {
            "alive0": alive0, "assign0": assign0, "astep0": astep0,
            "centers0": np.zeros(npad, np.int32),
            "cid0": np.int32(0), "stepc0": np.int32(1),
            "cur0": np.int32(0), "msum0": msum0, "mcnt0": np.int32(1),
            "envlo0": np.int32(0), "envhi0": np.int32(1),
            "done0": np.bool_(n == 0),
        }

    def make_carry(self, clusters_done, current_rows, last_row,
                   alive_rows) -> dict:
        """Loop state equivalent to: `clusters_done` complete, the open
        cluster holding `current_rows` (reference member order) centered on
        `last_row`, and `alive_rows` still in the pool.  Used to re-enter
        the device program after the host resolves ONE margin-uncertain
        step exactly."""
        host = self._ready[0]
        n = host["n"]
        npad = int(self._ready[1]["lens"].shape[0])
        # natural row -> flat position under the ORIGINAL bvec layout
        pos = np.empty(self.ps.n, np.int64)
        pos[host["order"]] = np.arange(n)
        alive0 = np.zeros(npad, bool)
        if len(alive_rows):
            alive0[pos[np.asarray(alive_rows, dtype=np.int64)]] = True
        assign0 = np.full(npad, -1, np.int32)
        astep0 = np.zeros(npad, np.int32)
        centers0 = np.zeros(npad, np.int32)
        cid0 = len(clusters_done)
        if cid0:
            # vectorized over all clusters (a python per-cluster loop cost
            # tens of seconds per resume at 70k clusters)
            lens_c = np.array([len(m) for _, m in clusters_done],
                              dtype=np.int64)
            all_members = np.concatenate(
                [np.asarray(m, dtype=np.int64) for _, m in clusters_done])
            cl_ids = np.repeat(np.arange(cid0, dtype=np.int32), lens_c)
            starts = np.cumsum(lens_c) - lens_c
            positions = (np.arange(len(all_members), dtype=np.int64)
                         - np.repeat(starts, lens_c)).astype(np.int32)
            mflat = pos[all_members]
            assign0[mflat] = cl_ids
            astep0[mflat] = positions
            centers0[:cid0] = pos[np.array([c for c, _ in clusters_done],
                                           dtype=np.int64)]
        cur = np.asarray(current_rows, dtype=np.int64)
        cflat = pos[cur]
        assign0[cflat] = cid0
        astep0[cflat] = np.arange(len(cur), dtype=np.int32)
        msum0 = self._rows_host(cur).astype(np.int64).sum(axis=0)
        # host mirror of the launch state: the program's diff-fetch output
        # is relative to THIS state, so the next abort's full state is
        # mirror + ~KBs of fetched diffs (DeviceCombined.run)
        self._carry_pack = ((assign0.astype(np.int64) + 1) << 33) \
            | (astep0.astype(np.int64) << 1) | alive0.astype(np.int64)
        self._carry_centers = centers0.astype(np.int64).copy()
        big = self._patch_big(alive0, assign0, astep0, centers0, npad)
        return {
            **big,
            "cid0": np.int32(cid0),
            # future absorb stamps must exceed every position index used
            "stepc0": np.int32(n + 2),
            "cur0": np.int32(pos[last_row]),
            "msum0": msum0, "mcnt0": np.int32(len(cur)),
            "envlo0": np.int32(cflat.min()),
            "envhi0": np.int32(cflat.max() + 1),
            "done0": np.bool_(False),
        }

    def _patch_big(self, alive0, assign0, astep0, centers0, npad: int):
        """The four [npad] carry arrays, as device-side patches of the last
        abort state when the diff is small (a resume after k host steps
        touches only the rows those steps absorbed/seeded)."""
        prev = getattr(self, "_res_dev", None)
        ph = getattr(self, "_res_host", None)
        full = {"alive0": alive0, "assign0": assign0, "astep0": astep0,
                "centers0": centers0}
        if prev is None or ph is None:
            return full
        idx = np.nonzero((alive0 != ph["alive"]) | (assign0 != ph["assign"])
                         | (astep0 != ph["astep"]))[0].astype(np.int32)
        cidx = np.nonzero(centers0 != ph["centers"])[0].astype(np.int32)
        # ONE fixed patch shape: the apply function is precompiled during
        # ensure_ready (pre-stamp) — a per-bucket jit here would compile
        # mid-run
        if len(idx) > _PATCH_P or len(cidx) > _PATCH_Q:
            return full
        apply = getattr(self, "_patch_apply", None)
        if apply is None:
            return full

        import jax.numpy as jnp

        def pad(a, m, fill):
            out = np.full(m, fill, dtype=a.dtype)
            out[: len(a)] = a
            return out

        drop = np.int32(npad)
        a_d, s_d, t_d, c_d = apply(
            prev[0], prev[1], prev[2], prev[3],
            jnp.asarray(pad(idx, _PATCH_P, drop)),
            jnp.asarray(pad(alive0[idx], _PATCH_P, False)),
            jnp.asarray(pad(assign0[idx], _PATCH_P, 0)),
            jnp.asarray(pad(astep0[idx], _PATCH_P, 0)),
            jnp.asarray(pad(cidx, _PATCH_Q, drop)),
            jnp.asarray(pad(centers0[cidx], _PATCH_Q, 0)),
        )
        return {"alive0": a_d, "assign0": s_d, "astep0": t_d,
                "centers0": c_d}

    def _rows_host(self, rows: np.ndarray) -> np.ndarray:
        """Histogram rows on the host (local matrix, or fetched from the
        sharded global matrix on multihost runs)."""
        if self.ps.counts is not None:
            return self.ps.counts[rows]
        return self._row_fetch(np.asarray(rows))

    # -- dd epilogue ------------------------------------------------------------

    def _derive_singles_dd(self, jnp, stats, a, b):
        return derive_singles_dd(self.pack, self._d, jnp, stats, a, b)

    def _epilogue_dd(self, jnp, singles_err):
        return epilogue_dd(self.pack, singles_err)


    # -- the device program ----------------------------------------------------

    def _build_program(self, host, dev):
        """Returns a jitted program taking the `dev` array dict as its ONE
        argument.  The arrays must be arguments, not closure captures: a
        captured counts array gets inlined into the HLO as a literal (tens
        of MB of program text to compile and cache), while as parameters
        the program is a few hundred KB and its cache key depends only on
        the bucketed shapes + model constants."""
        import jax
        import jax.numpy as jnp

        nb = len(dev["bin_start"]) - 1          # bucketed bin count
        npad = len(dev["lens"])
        D = (dev["counts_nat"] if "counts_nat" in dev
             else dev["counts"]).shape[1]
        WC = self._wc
        margin = np.float32(self.margin)
        tie_margin = np.float32(self.tie_margin)
        edge_dd = DD.dd(*(np.float32(x) for x in
                          DD.split_f64(np.float64(self.pack.pos_edge))))
        edge_scale = np.float32(max(abs(self.pack.pos_edge), 1.0))
        need_summin, need_dot, need_emd = stat_needs(self.pack.singles)
        need_jd, need_js = log_needs(self.pack.singles)
        NONE = np.int32(npad)

        C = None  # bound to the traced argument dict by program()

        class Carry(NamedTuple):
            alive: jnp.ndarray       # [npad] bool
            assign: jnp.ndarray      # [npad] int32, -1 = unassigned
            astep: jnp.ndarray       # [npad] int32
            centers: jnp.ndarray     # [n+1] int32 flat pos of final centers
            cid: jnp.ndarray         # int32 current cluster id
            stepc: jnp.ndarray       # int32 monotone event counter
            cur: jnp.ndarray         # int32 flat pos of current center
            msum: jnp.ndarray        # [D] int64 member count-vector sum
            mcnt: jnp.ndarray        # int32 member count
            env_lo: jnp.ndarray      # int32 member envelope in flat coords
            env_hi: jnp.ndarray
            done: jnp.ndarray        # bool
            abort: jnp.ndarray       # int32 0/1/2
            cause: jnp.ndarray       # int32 abort-cause bits (1 gate,
                                     # 2 argmax tie, 4 cross-chunk tie)
            iters: jnp.ndarray       # int32 safety counter
            wins: jnp.ndarray        # int32 windows scanned (stats)
            pairs: jnp.ndarray       # int64 length-passed pairs scored

        def row_i32(p):
            return jax.lax.dynamic_slice(C["counts"], (p, np.int32(0)), (1, D))[0].astype(jnp.int32)

        def side_consts(p):
            return {
                "mags": C["mags"][p],
                "selfdot": C["selfdot"][p],
                "std": (C["std_h"][p], C["std_l"][p]),
                "lens": C["lens"][p],
            }

        def scan_window(st: "Carry", rank, crank, gfront, gback, p_lo,
                        p_hi, blen_c, elen_c):
            """Chunked window scan: classifier + dist argmax + absorb prep."""
            cc = row_i32(st.cur)
            c_side = side_consts(st.cur)
            neg_inf = np.float32(-np.inf)

            class SC(NamedTuple):
                j: jnp.ndarray
                bh: jnp.ndarray          # best dist dd
                bl: jnp.ndarray
                berr: jnp.ndarray        # best's absolute dist error bound
                bpos: jnp.ndarray        # flat pos of best (NONE if none)
                bsig: tuple              # best's integer/dd signature
                any_pos: jnp.ndarray
                uncert: jnp.ndarray
                msum: jnp.ndarray        # [D] int64 absorbed sums
                mcnt: jnp.ndarray
                pmask: jnp.ndarray       # [npad] bool positives
                npairs: jnp.ndarray      # int64 length-passed rows scored

            zero_sig = (np.int32(0), np.int32(0), np.int64(0),
                        np.int32(0), np.int32(0), np.int32(0),
                        np.float32(0), np.float32(0))

            # iterate ONLY the fixed-grid chunks holding a live candidate:
            # window flat-spans cover dead rows and grow with n — in the 1M
            # tie-dense tail a window spans ~250 chunks of which ~15 hold
            # any of the ~30k alive rows, so the bare per-chunk loop
            # iteration (slices and masks) would dominate the step.
            # Per-chunk alive counts come from boundary gathers on the
            # existing alive cumsum (no [npad] scatter per step); the
            # live-chunk list is a stable argsort of the emptiness mask (not
            # jnp.nonzero, whose reduce-window lowering needs far more
            # memory at the 1M shapes), ascending so cross-chunk
            # first-strict-max tie semantics are preserved
            NCH = (npad + WC - 1) // WC
            grid = np.arange(NCH + 1, dtype=np.int32) * WC
            lo_b = jnp.clip(grid[:-1], p_lo, p_hi)
            hi_b = jnp.clip(grid[1:], p_lo, p_hi)
            ab = lambda x: jnp.where(
                x <= 0, 0, crank[jnp.clip(x, 1, npad) - 1])
            have_c = (ab(hi_b) - ab(lo_b)) > 0
            nz_chunks = jnp.argsort(~have_c, stable=True).astype(jnp.int32)
            nchunks = have_c.sum(dtype=jnp.int32)

            def chunk_body(sc: SC):
                start = nz_chunks[sc.j] * WC
                start_c = jnp.minimum(start, np.int32(npad - WC))
                offs = start_c + np.arange(WC, dtype=np.int32)
                in_rng = (offs >= p_lo) & (offs < p_hi)
                aliv = jax.lax.dynamic_slice(st.alive, (start_c,), (WC,))
                rk = jax.lax.dynamic_slice(rank, (start_c,), (WC,))
                ll = jax.lax.dynamic_slice(C["lens"], (start_c,), (WC,))
                msk = in_rng & aliv & (rk >= gfront) & (rk < gback)
                pass_m = msk & (ll >= blen_c) & (ll <= elen_c)
                # chunks with no candidate skip the whole scoring pipeline
                # (a real branch on the device): window flat-spans cover dead rows
                # and grow with n, so late-phase scans are mostly empty —
                # every update below is a no-op when pass_m is all-False
                return jax.lax.cond(
                    pass_m.any(),
                    lambda a: _chunk_heavy(*a),
                    lambda a: a[0]._replace(j=a[0].j + 1),
                    (sc, start_c, pass_m, ll),
                )

            def _chunk_heavy(sc: SC, start_c, pass_m, ll):
                blk = jax.lax.dynamic_slice(
                    C["counts"], (start_c, np.int32(0)), (WC, D)).astype(jnp.int32)
                summin = (jnp.minimum(blk, cc[None, :]).sum(axis=1, dtype=jnp.int32)
                          if need_summin else np.zeros((WC,), np.int32))
                dot = ((blk * cc[None, :]).sum(axis=1, dtype=jnp.int32)
                       if need_dot else np.zeros((WC,), np.int32))
                emd = (emd_rowsum(jnp, blk - cc[None, :])
                       if need_emd else np.zeros((WC,), np.int64))

                b_side = {
                    "mags": jax.lax.dynamic_slice(C["mags"], (start_c,), (WC,)),
                    "selfdot": jax.lax.dynamic_slice(C["selfdot"], (start_c,), (WC,)),
                    "std": (jax.lax.dynamic_slice(C["std_h"], (start_c,), (WC,)),
                            jax.lax.dynamic_slice(C["std_l"], (start_c,), (WC,))),
                    "lens": ll,
                }
                a_bc = {
                    "mags": jnp.broadcast_to(c_side["mags"], (WC,)),
                    "selfdot": jnp.broadcast_to(c_side["selfdot"], (WC,)),
                    "std": (jnp.broadcast_to(c_side["std"][0], (WC,)),
                            jnp.broadcast_to(c_side["std"][1], (WC,))),
                    "lens": jnp.broadcast_to(c_side["lens"], (WC,)),
                }
                # reference order: feat->compute(candidate, center)
                stats = {"summin": summin, "dot": dot, "emd": emd}
                if need_jd or need_js:
                    jd, js, jde, jse = log_div_stats(
                        jnp, blk, jnp.broadcast_to(cc[None, :], (WC, D)),
                        b_side["mags"], a_bc["mags"], need_jd, need_js)
                    stats.update(jd=jd, js=js, jd_err=jde, js_err=jse)
                if self.pack.blk:
                    stats["blk"] = block_singles_stats(
                        jnp, blk, jnp.broadcast_to(cc[None, :], (WC, D)),
                        b_side["mags"], a_bc["mags"], D, self.pack.blk)
                singles = self._derive_singles_dd(jnp, stats, b_side, a_bc)
                s_dd, dist_dd, s_err, dist_err = self._epilogue_dd(jnp, singles)

                # positive gate: uncertain within the propagated ABSOLUTE
                # error bound (times a safety factor) or the relative
                # margin knob, whichever is larger
                diff = DD.dd_sub(s_dd, edge_dd)
                pos = pass_m & ((diff[0] > 0) | ((diff[0] == 0) & (diff[1] >= 0)))
                s_scale = jnp.maximum(jnp.abs(s_dd[0]), edge_scale)
                thr = jnp.maximum(8 * s_err, margin * s_scale)
                unc = pass_m & (jnp.abs(diff[0] + diff[1]) <= thr)

                # dist argmax, first strict max in flat order
                vh = jnp.where(pass_m, dist_dd[0], neg_inf)
                vl = jnp.where(pass_m, dist_dd[1], neg_inf)
                mh = jnp.max(vh)
                is_mh = (vh == mh) & pass_m
                ml = jnp.max(jnp.where(is_mh, vl, neg_inf))
                cand = is_mh & (vl == ml)
                first_i = jnp.argmax(cand)
                chunk_any = pass_m.any()
                # jnp.asarray: unused stats are numpy zero placeholders
                # (so XLA dead-code-eliminates their computation), which
                # cannot be indexed by the traced first_i directly
                sig = tuple(jnp.asarray(x) for x in (
                    summin, dot, emd, b_side["mags"], b_side["selfdot"],
                    ll, b_side["std"][0], b_side["std"][1]))
                bsig = tuple(x[first_i] for x in sig)
                sig_eq_best = pass_m
                for x, bx in zip(sig, bsig):
                    sig_eq_best &= (x == bx)
                if self.pack.has_log:
                    # log divergences depend on the FULL count vectors, not
                    # the summary stats — an "exact tie" is only certified
                    # when the candidate rows are identical
                    sig_eq_best &= (blk == blk[first_i][None, :]).all(axis=1)
                vexact_eq = (vh == vh[first_i]) & (vl == vl[first_i])
                scale = jnp.maximum(jnp.abs(mh), np.float32(1.0))
                tie_thr = jnp.maximum(8 * (dist_err + dist_err[first_i]),
                                      tie_margin * scale)
                near = pass_m & (jnp.abs((vh - vh[first_i]) + (vl - vl[first_i]))
                                 <= tie_thr)
                unc_mask = near & ~(vexact_eq & sig_eq_best)
                unc_tie = unc_mask.any() & chunk_any
                # telemetry: dd-value COLLISIONS (bit 8: distinct stats,
                # equal dd values — unrankable on this arithmetic) vs
                # within-threshold near values (bit 16: possibly clearable
                # with tighter error bounds)
                tie_kind = jnp.where(
                    (unc_mask & vexact_eq).any() & chunk_any,
                    np.int32(8), 0) | jnp.where(
                    (unc_mask & ~vexact_eq).any() & chunk_any,
                    np.int32(16), 0)

                # merge chunk best into carry best.  Lexicographic dd
                # compares (valid for quick_two_sum-normalized pairs) — NOT
                # dd_sub, whose two_sum NaNs out against the inf carry init.
                carry_valid = sc.bpos != NONE
                lgt = (vh[first_i] > sc.bh) | \
                    ((vh[first_i] == sc.bh) & (vl[first_i] > sc.bl))
                leq = (vh[first_i] == sc.bh) & (vl[first_i] == sc.bl)
                better = chunk_any & (~carry_valid | lgt)
                sig_eq_carry = np.bool_(True)
                for bx, cx in zip(bsig, sc.bsig):
                    sig_eq_carry &= (bx == cx)
                if self.pack.has_log:
                    # certify cross-chunk exact ties by row identity (the
                    # summary signature does not determine log divergences)
                    crow = row_i32(jnp.minimum(sc.bpos, np.int32(npad - 1)))
                    sig_eq_carry &= (blk[first_i] == crow).all()
                dapx = (vh[first_i] + vl[first_i]) - (sc.bh + sc.bl)
                cross_thr = jnp.maximum(
                    8 * (dist_err[first_i] + sc.berr),
                    tie_margin * jnp.maximum(jnp.abs(sc.bh), np.float32(1.0)))
                cross_near = chunk_any & carry_valid & (jnp.abs(dapx) <= cross_thr)
                unc_cross = cross_near & ~(leq & sig_eq_carry)
                nbh = jnp.where(better, vh[first_i], sc.bh)
                nbl = jnp.where(better, vl[first_i], sc.bl)
                nberr = jnp.where(better, dist_err[first_i], sc.berr)
                npos = jnp.where(better, start_c + first_i.astype(jnp.int32), sc.bpos)
                nsig = tuple(jnp.where(better, bx, cx)
                             for bx, cx in zip(bsig, sc.bsig))

                # absorb bookkeeping (int32 column sums are exact: maxc * WC
                # < 2^31 is part of the envelope)
                csum = jnp.where(pos[:, None], blk, 0).sum(axis=0, dtype=jnp.int32)
                old = jax.lax.dynamic_slice(sc.pmask, (start_c,), (WC,))
                pmask = jax.lax.dynamic_update_slice(sc.pmask, old | pos, (start_c,))

                return SC(
                    j=sc.j + 1,
                    bh=nbh, bl=nbl, berr=nberr, bpos=npos, bsig=nsig,
                    any_pos=sc.any_pos | pos.any(),
                    uncert=sc.uncert
                    | jnp.where(unc.any(), np.int32(1), 0)
                    | jnp.where(unc_tie, np.int32(2) | tie_kind, 0)
                    | jnp.where(unc_cross, np.int32(4), 0),
                    msum=sc.msum + csum.astype(jnp.int64),
                    mcnt=sc.mcnt + pos.sum(dtype=jnp.int32),
                    pmask=pmask,
                    npairs=sc.npairs + pass_m.sum(dtype=jnp.int64),
                )

            init = SC(
                j=np.int32(0), bh=neg_inf, bl=neg_inf,
                berr=np.float32(0.0), bpos=NONE,
                bsig=zero_sig, any_pos=np.bool_(False), uncert=np.int32(0),
                msum=np.zeros(D, np.int64), mcnt=np.int32(0),
                pmask=np.zeros(npad, bool),
                npairs=np.int64(0),
            )
            sc = jax.lax.while_loop(lambda s: s.j < nchunks, chunk_body, init)
            return sc

        def closest_to_mean(st: "Carry", msum, mcnt, env_lo, env_hi):
            """argmin_p distance_d(p, mean) over members, reference member
            order (astep, flat) for ties; returns (flat_pos, uncertain)."""
            num = msum                               # int64 [D]
            den = mcnt.astype(jnp.int64)
            q = num // den
            rem = num - q * den
            r = ((2 * num + den) // (2 * den)).astype(jnp.int32)  # round-half-up
            s_floor = jnp.sum(q)
            # guards on the two f64 corners (see module docstring)
            # integer comparison against the floored product is exact:
            # rem <= t (t real) <=> rem <= floor(t) for integer rem, so no
            # +1 slop — the thresholds are << 1 for any realistic cluster
            # (a trip needs (q + 2) * den on the order of 2^51)
            half_lhs = jnp.abs(2 * rem - den)
            tol_half = ((q + 2) * den) >> 51
            g1 = (half_lhs != 0) & (half_lhs <= tol_half)
            tol_f = ((q + 2) * den) >> 52
            g2 = (rem != 0) & (rem <= tol_f)
            tol_c = ((q + C["maxc"] + 2) * den) >> 52
            g3 = (rem != 0) & ((den - rem) <= tol_c)
            unc_bins = (g1 | g2 | g3).any()

            neg_inf = np.float32(-np.inf)
            pos_inf = np.float32(np.inf)

            class MC(NamedTuple):
                j: jnp.ndarray
                vh: jnp.ndarray
                vl: jnp.ndarray
                bkey: jnp.ndarray      # int64 packed (astep, flat) of best
                bsig: tuple            # (dist2, mag) of best
                uncert: jnp.ndarray

            # member-holding fixed-grid chunks only (the member envelope
            # spans many non-member rows; see the scan_window chunk-skip
            # note) — members always lie inside the envelope, so per-chunk
            # member counts are plain reshape reductions
            NCH = (npad + WC - 1) // WC
            memb_all = (st.assign == st.cid)
            pad_n = NCH * WC - npad
            mm = jnp.concatenate(
                [memb_all, np.zeros(pad_n, bool)]) if pad_n else memb_all
            have_c = mm.reshape(NCH, WC).sum(axis=1, dtype=jnp.int32) > 0
            nz_chunks = jnp.argsort(~have_c, stable=True).astype(jnp.int32)
            nchunks = have_c.sum(dtype=jnp.int32)

            def chunk_body(mc: MC):
                start = nz_chunks[mc.j] * WC
                start_c = jnp.minimum(start, np.int32(npad - WC))
                offs = start_c + np.arange(WC, dtype=np.int32)
                in_rng = (offs >= env_lo) & (offs < env_hi)
                asg = jax.lax.dynamic_slice(st.assign, (start_c,), (WC,))
                stp = jax.lax.dynamic_slice(st.astep, (start_c,), (WC,))
                memb = in_rng & (asg == st.cid)
                # member-free chunks skip the distance pipeline (the member
                # envelope spans many non-member rows); every update below
                # is a no-op when memb is all-False
                return jax.lax.cond(
                    memb.any(),
                    lambda a: _mc_heavy(*a),
                    lambda a: a[0]._replace(j=a[0].j + 1),
                    (mc, start_c, offs, memb, stp),
                )

            def _mc_heavy(mc: MC, start_c, offs, memb, stp):
                blk = jax.lax.dynamic_slice(
                    C["counts"], (start_c, np.int32(0)), (WC, D)).astype(jnp.int32)
                dist2 = 2 * jnp.minimum(blk, r[None, :]).sum(axis=1, dtype=jnp.int32)
                mags = jax.lax.dynamic_slice(C["mags"], (start_c,), (WC,))
                mag = mags.astype(jnp.int64) + s_floor
                # v = 10000 * (1 - frac^2), frac = dist/mag  (f64 ops in dd)
                frac = DD.dd_div(DD.dd_from_i64(dist2.astype(jnp.int64)),
                                 DD.dd_from_i64(mag))
                f2 = DD.dd_mul(frac, frac)
                one = (np.float32(1.0), np.float32(0.0))
                u = DD.dd_sub(one, f2)
                vh_, vl_ = u[0] * np.float32(10000.0), u[1] * np.float32(10000.0)
                vh = jnp.where(memb, vh_, pos_inf)
                vl = jnp.where(memb, vl_, pos_inf)
                # chunk argmin by (v, astep, flat)
                mh = jnp.min(vh)
                is_m = (vh == mh) & memb
                ml = jnp.min(jnp.where(is_m, vl, pos_inf))
                cand = is_m & (vl == ml)
                key = stp.astype(jnp.int64) * np.int64(npad) + offs.astype(jnp.int64)
                ckey = jnp.min(jnp.where(cand, key, np.int64(2**62)))
                ci = jnp.argmax(cand & (key == ckey))
                chunk_any = memb.any()
                csig = (dist2[ci], mag[ci])
                # near-tie guards within the chunk (exact int-equal is safe)
                sig_eq = memb & (dist2 == csig[0]) & (mag == csig[1])
                # absolute floor: v = 1e4*(1-frac^2) carries ~3e-9 absolute
                # dd error near frac ~= 1, where |v| itself goes to zero
                scale = jnp.maximum(jnp.abs(mh), np.float32(1.0))
                thr_m = jnp.maximum(tie_margin * scale, np.float32(1e-7))
                near = memb & (jnp.abs((vh - mh) + (vl - ml)) <= thr_m)
                unc_tie = (near & ~sig_eq).any() & chunk_any

                # lexicographic dd compare against the carry (see the
                # scan_window note: dd_sub NaNs against the inf init)
                carry_valid = jnp.isfinite(mc.vh)
                llt = (mh < mc.vh) | ((mh == mc.vh) & (ml < mc.vl))
                leq = (mh == mc.vh) & (ml == mc.vl)
                better = chunk_any & (~carry_valid | llt)
                better_key = chunk_any & carry_valid & leq & (ckey < mc.bkey)
                take = better | better_key
                sig_eq_carry = (csig[0] == mc.bsig[0]) & (csig[1] == mc.bsig[1])
                dapx = (mh + ml) - (mc.vh + mc.vl)
                cross_near = chunk_any & carry_valid & (
                    jnp.abs(dapx) <= jnp.maximum(
                        tie_margin *
                        jnp.maximum(jnp.abs(mc.vh), np.float32(1.0)),
                        np.float32(1e-7)))
                unc_cross = cross_near & ~(leq & sig_eq_carry)

                return MC(
                    j=mc.j + 1,
                    vh=jnp.where(take, mh, mc.vh),
                    vl=jnp.where(take, ml, mc.vl),
                    bkey=jnp.where(take, ckey, mc.bkey),
                    bsig=tuple(jnp.where(take, a_, b_)
                               for a_, b_ in zip(csig, mc.bsig)),
                    uncert=mc.uncert | unc_tie | unc_cross,
                )

            init = MC(j=np.int32(0), vh=pos_inf, vl=pos_inf,
                      bkey=np.int64(2**62),
                      bsig=(np.int32(0), np.int64(0)),
                      uncert=np.bool_(False))
            mc = jax.lax.while_loop(lambda s: s.j < nchunks, chunk_body, init)
            best_flat = (mc.bkey % np.int64(npad)).astype(jnp.int32)
            return best_flat, mc.uncert | unc_bins

        def body(st: Carry):
            alive_i = st.alive.astype(jnp.int32)
            crank = jnp.cumsum(alive_i)
            rank = crank - alive_i
            total = crank[-1]
            # alive rank at each bin start; bins are contiguous in flat order
            ras = jnp.concatenate([rank[C["bin_start"]][:nb], total[None]])
            bin_cnt = ras[1:] - ras[:-1]

            # flat position of the g-th alive row (0-based): crank is a
            # nondecreasing cumsum, so this is one log-depth searchsorted —
            # the previous full-[npad] scatter was the dominant fixed cost
            # per step at large n (131072-wide scatter every iteration)
            def posr_at(g):
                return jnp.searchsorted(crank, g + 1, side="left"
                                        ).astype(jnp.int32)

            blen_c = C["blen"][st.cur]
            elen_c = C["elen"][st.cur]
            nonempty = bin_cnt > 0
            any_ne = total > 0
            first_ne = jnp.argmax(nonempty).astype(jnp.int32)
            last_ne = np.int32(nb - 1) - jnp.argmax(nonempty[::-1]).astype(jnp.int32)

            def inner(target, b0, is_front):
                empty = bin_cnt[b0] == 0
                b = jnp.where(empty, first_ne if is_front else last_ne, b0)
                inbin = st.alive & (C["bin_ids"] == b)
                lb = jnp.sum(inbin & (C["lens"] < target), dtype=jnp.int32)
                eq = jnp.sum(inbin & (C["lens"] == target), dtype=jnp.int32)
                nbn = bin_cnt[b]
                absent = jnp.minimum(lb, jnp.maximum(nbn - 1, 0))
                present_slot = lb if is_front else lb + eq - 1
                slot = jnp.where(eq > 0, present_slot, absent)
                slot = jnp.where(empty, 0, slot)
                return b, slot

            fb, fslot = inner(blen_c, C["fbin0"][st.cur], True)
            bb, bslot = inner(elen_c, C["bbin0"][st.cur], False)
            gfront = ras[fb] + fslot
            gback = ras[bb] + bslot
            have_window = any_ne & (gback > gfront)
            p_lo = jnp.where(have_window,
                             posr_at(jnp.where(have_window, gfront, 0)), 0)
            p_hi = jnp.where(
                have_window,
                posr_at(jnp.where(have_window, gback - 1, 0)) + 1,
                0,
            )

            sc = scan_window(st, rank, crank, gfront, gback, p_lo, p_hi,
                             blen_c, elen_c)
            is_min = ~sc.any_pos
            best_valid = sc.bpos != NONE

            def uncertain_case(st):
                return st._replace(abort=np.int32(1), done=np.bool_(True),
                                   cause=sc.uncert)

            def min_case(st: Carry):
                centers = st.centers.at[st.cid].set(st.cur)
                seed = jnp.where(best_valid, sc.bpos, posr_at(np.int32(0)))
                none_left = (~best_valid) & (total == 0)
                seed_row = jnp.where(none_left, 0, seed)
                alive = st.alive.at[seed_row].set(
                    jnp.where(none_left, st.alive[seed_row], False))
                new_cid = st.cid + 1
                assign = st.assign.at[seed_row].set(
                    jnp.where(none_left, st.assign[seed_row], new_cid))
                astep = st.astep.at[seed_row].set(
                    jnp.where(none_left, st.astep[seed_row], st.stepc))
                msum = jnp.where(none_left, st.msum,
                                 row_i32(seed_row).astype(jnp.int64))
                return st._replace(
                    alive=alive, assign=assign, astep=astep, centers=centers,
                    cid=new_cid, stepc=st.stepc + 1, cur=seed_row,
                    msum=msum, mcnt=np.int32(1),
                    env_lo=seed_row, env_hi=seed_row + 1,
                    done=none_left,
                )

            def absorb_case(st: Carry):
                alive = st.alive & ~sc.pmask
                assign = jnp.where(sc.pmask, st.cid, st.assign)
                astep = jnp.where(sc.pmask, st.stepc, st.astep)
                msum = st.msum + sc.msum
                mcnt = st.mcnt + sc.mcnt
                env_lo = jnp.minimum(st.env_lo, p_lo)
                env_hi = jnp.maximum(st.env_hi, p_hi)
                st2 = st._replace(alive=alive, assign=assign, astep=astep,
                                  stepc=st.stepc + 1, msum=msum, mcnt=mcnt,
                                  env_lo=env_lo, env_hi=env_hi)
                best_flat, unc = closest_to_mean(st2, msum, mcnt, env_lo, env_hi)
                return jax.lax.cond(
                    unc,
                    lambda s: s._replace(abort=np.int32(2), done=np.bool_(True)),
                    lambda s: s._replace(cur=best_flat),
                    st2,
                )

            st = st._replace(
                wins=st.wins + have_window.astype(jnp.int32),
                pairs=st.pairs + sc.npairs,
            )
            st = jax.lax.cond(
                sc.uncert != 0,
                uncertain_case,
                lambda s: jax.lax.cond(is_min, min_case, absorb_case, s),
                st,
            )
            return st._replace(iters=st.iters + 1)

        def program(Carg):
            nonlocal C
            C = dict(Carg)  # helper closures resolve C to the traced arg
            if "counts_nat" in C:
                # device-side permute into bvec-flat order: pad rows point
                # at row 0 (their values are masked out before every use)
                C["counts"] = C["counts_nat"][C["order_pad"]]
            n_s = C["n"]
            max_iters = 2 * n_s.astype(jnp.int32) + 16
            # profiling hook: cap the step count to measure marginal
            # per-step cost of the compiled program (output is then
            # truncated/invalid; never set outside experiments)
            cap = _step_cap()
            if cap:
                max_iters = jnp.minimum(max_iters, np.int32(cap))

            # execution-cost budget per dispatch: the loop yields (abort=4,
            # state carried) when the estimated cost (dispatch_cost_us)
            # reaches ~30 s, and the host relaunches from the state without
            # any resolution, so no single dispatch runs unbounded.
            budget_us = np.float64(
                int(os.environ.get("MC2_DEV_BUDGET_US", "30000000")))

            def cond(st: Carry):
                return (~st.done) & (st.iters < max_iters) \
                    & (dispatch_cost_us(st.iters, st.pairs) < budget_us)

            # initial state from ARGUMENTS: a fresh run passes the
            # first-pop state (_fresh_carry); an abort-resume passes the
            # host-resolved continuation point (make_carry)
            st = Carry(
                alive=C["alive0"], assign=C["assign0"], astep=C["astep0"],
                centers=C["centers0"],
                cid=C["cid0"], stepc=C["stepc0"], cur=C["cur0"],
                msum=C["msum0"], mcnt=C["mcnt0"],
                env_lo=C["envlo0"], env_hi=C["envhi0"],
                done=C["done0"], abort=np.int32(0),
                cause=np.int32(0),
                iters=np.int32(0),
                wins=np.int32(0), pairs=np.int64(0),
            )
            st = jax.lax.while_loop(cond, body, st)
            # budget exit with no abort recorded -> segment boundary
            seg_hit = (~st.done) & (st.abort == 0) \
                & (dispatch_cost_us(st.iters, st.pairs) >= budget_us)
            st = st._replace(
                abort=jnp.where(seg_hit, np.int32(4), st.abort))
            # ONE packed i64 output so the host pays a single fetch:
            #   [0:8]  scalars (abort, cid, cur, iters, wins, pairs, 0, 0)
            #   [8:8+npad]       per-row state: (assign+1)<<33|astep<<1|alive
            #   [8+npad:8+2npad] centers
            # The raw state arrays are ALSO returned (never fetched) as the
            # device-resident base for the resume-patch path.
            i64 = lambda v: v.astype(jnp.int64)
            scalars = jnp.stack([
                i64(st.abort), i64(st.cid), i64(st.cur), i64(st.iters),
                i64(st.wins), st.pairs, i64(st.cause), np.int64(0)])
            row_pack = ((i64(st.assign) + 1) << 33) \
                | (i64(st.astep) << 1) | i64(st.alive)
            packed = jnp.concatenate([scalars, row_pack, i64(st.centers)])
            # diff vs the LAUNCH state (the resume carry): rows changed +
            # centers appended, in fixed-size buffers -> a resume fetch is
            # ~300 KB instead of the full packed state.  small layout:
            #   [0:8] scalars  [8] diff count  [9] cid0
            #   [10:10+P] changed row indices  [10+P:10+2P] their row_pack
            #   [10+2P:10+2P+Q] centers[cid0:cid0+Q]
            pack0 = ((i64(C["assign0"]) + 1) << 33) \
                | (i64(C["astep0"]) << 1) | i64(C["alive0"])
            dmask = row_pack != pack0
            dpc = min(_DIFF_P, npad)        # small pools: buffers <= npad
            dqc = min(_DIFF_Q, npad)
            didx = jnp.nonzero(dmask, size=dpc,
                               fill_value=npad)[0].astype(jnp.int32)
            dval = row_pack[jnp.minimum(didx, np.int32(npad - 1))]
            cid0 = C["cid0"].astype(jnp.int32)
            cstart = jnp.minimum(cid0, np.int32(max(npad - dqc, 0)))
            cnew = jax.lax.dynamic_slice(st.centers, (cstart,), (dqc,))
            small = jnp.concatenate([
                scalars,
                jnp.stack([dmask.sum(dtype=jnp.int64), i64(cstart)]),
                i64(didx), dval, i64(cnew)])
            return (packed, small, st.alive, st.assign, st.astep,
                    st.centers)

        # the unjitted core is what DeviceCombined composes with the
        # update-phase program into one dispatch (device_session.py)
        self._core_program = program
        return jax.jit(program)

    # -- public entry ------------------------------------------------------------

    def ensure_ready(self, bv: BVec) -> None:
        """Prepare, upload (forced), lower and compile for this pool state
        so a later run(bv) on the same state only executes.  Called by
        DeviceSession before the measured clustering window opens."""
        import jax.numpy as jnp
        import jax

        if not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)
        host, dev = self._prepare(bv)
        prog = self._build_program(host, dev)
        Cdev = {k: jnp.asarray(v) for k, v in dev.items()}
        compiled = prog.lower(Cdev).compile()
        # force the per-run uploads to completion now (async dispatch would
        # otherwise bill them to the first execute)
        for v in Cdev.values():
            np.asarray(v.ravel()[-1] if v.ndim else v)
        self._ready = (host, Cdev, compiled)
        self._compile_patch_apply(int(Cdev["lens"].shape[0]))

    def _compile_patch_apply(self, npad: int) -> None:
        """Precompile the fixed-shape resume-patch apply (used by
        make_carry/_patch_big) so no compilation happens mid-run."""
        import jax
        import jax.numpy as jnp

        def apply(alive, assign, astep, centers, ip, av, sv, tv, cp, cv):
            return (alive.at[ip].set(av, mode="drop"),
                    assign.at[ip].set(sv, mode="drop"),
                    astep.at[ip].set(tv, mode="drop"),
                    centers.at[cp].set(cv, mode="drop"))

        self._patch_apply = jax.jit(apply).lower(
            jax.ShapeDtypeStruct((npad,), bool),
            jax.ShapeDtypeStruct((npad,), jnp.int32),
            jax.ShapeDtypeStruct((npad,), jnp.int32),
            jax.ShapeDtypeStruct((npad,), jnp.int32),
            jax.ShapeDtypeStruct((_PATCH_P,), jnp.int32),
            jax.ShapeDtypeStruct((_PATCH_P,), bool),
            jax.ShapeDtypeStruct((_PATCH_P,), jnp.int32),
            jax.ShapeDtypeStruct((_PATCH_P,), jnp.int32),
            jax.ShapeDtypeStruct((_PATCH_Q,), jnp.int32),
            jax.ShapeDtypeStruct((_PATCH_Q,), jnp.int32),
        ).compile()

    def _ready_matches(self, bv: BVec) -> bool:
        ready = getattr(self, "_ready", None)
        if ready is None:
            return False
        host = ready[0]
        order = np.concatenate([b for b in bv.bins]) if bv.size() \
            else np.zeros(0, np.int64)
        return (len(order) == host["n"]
                and np.array_equal(order, host["order"]))

    def run(self, bv: BVec, carry: Optional[dict] = None):
        """Returns (clusters_raw, None) on completion, or (None, ResumeState)
        on a guarded abort.  clusters_raw is a list of (center_row,
        [member_rows...]) in creation order.  `carry` (from make_carry)
        re-enters the precompiled program at a host-resolved continuation
        point; bv is then ignored for preparation (the carry encodes the
        pool state) but still received for interface symmetry."""
        import jax

        if not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)
        import time

        profile = bool(os.environ.get("MC2_DEVICE_PROF"))
        t0 = time.time()
        if carry is not None:
            import jax.numpy as jnp

            host, Cdev, compiled = self._ready
            Cdev = dict(Cdev)
            Cdev.update({k: jnp.asarray(v) for k, v in carry.items()})
            t1 = t1b = t2 = time.time()
        elif self._ready_matches(bv):
            host, Cdev, compiled = self._ready
            t1 = t1b = t2 = time.time()
        else:
            host, dev = self._prepare(bv)
            t1 = time.time()
            prog = self._build_program(host, dev)
            import jax.numpy as jnp

            Cdev = {k: jnp.asarray(v) for k, v in dev.items()}
            lowered = prog.lower(Cdev)
            t1b = time.time()
            compiled = lowered.compile()
            t2 = time.time()
        res = compiled(Cdev)
        npad_out = int(Cdev["lens"].shape[0])
        packed = np.asarray(res[0])     # the ONE fetch round trip
        t3 = time.time()
        self.last_exec_seconds = t3 - t2
        if profile:
            print(f"device accumulate: prepare {t1 - t0:.2f}s, "
                  f"lower {t1b - t1:.2f}s, compile {t2 - t1b:.2f}s, "
                  f"execute {t3 - t2:.2f}s", flush=True)
        return self.consume(packed[:8 + 2 * npad_out], res[2:6], host,
                            npad_out)

    def consume(self, packed: np.ndarray, state_res, host, npad_out: int):
        """(clusters_raw, None) or (None, ResumeState) from the program's
        packed i64 output.  `state_res` is the 4-tuple of device-side
        (alive, assign, astep, centers) buffers seeding the resume-patch
        path."""
        profile = bool(os.environ.get("MC2_DEVICE_PROF"))
        abort, cid, cur, iters, wins, pairs = packed[:6]
        self.last_abort_cause = int(packed[6])
        row_pack = packed[8:8 + npad_out]
        alive = (row_pack & 1).astype(bool)
        astep = ((row_pack >> 1) & 0xFFFFFFFF).astype(np.int32)
        assign = ((row_pack >> 33) - 1).astype(np.int32)
        centers = packed[8 + npad_out:].astype(np.int32)
        # abort-state reuse: keep the output buffers ON DEVICE plus host
        # copies, so a resume only uploads the rows the host steps changed
        # (make_carry patch path) instead of the full multi-MB state
        self._res_dev = state_res
        self._res_host = {"alive": alive.copy(), "assign": assign.copy(),
                          "astep": astep.copy(), "centers": centers.copy()}
        self.last_steps = int(iters)
        self.last_windows = int(wins)
        self.last_pairs = int(pairs)
        if profile:
            print(f"device accumulate: {int(iters)} steps, "
                  f"{int(wins)} windows, {int(pairs)} pairs", flush=True)
        n = host["n"]
        alive, assign, astep = alive[:n], assign[:n], astep[:n]
        order = host["order"]
        n_it = int(iters)
        if n_it >= 2 * n + 16:
            raise RuntimeError("device accumulate exceeded its iteration bound")
        cap = _step_cap()
        if cap and n_it >= cap and int(abort) == 0 and alive.any():
            # the cap truncated the loop: the clustering is INVALID.  Allow
            # it only for explicit profiling sessions, and say so loudly.
            if not os.environ.get("MC2_DEVICE_PROF"):
                raise RuntimeError(
                    f"MC2_DEV_STEP_CAP={cap} truncated the accumulate loop "
                    f"({n_it} steps, pool not empty) — unset it for real "
                    "runs; it exists only for profiling experiments")
            print(f"WARNING: MC2_DEV_STEP_CAP={cap} truncated the device "
                  "accumulate loop; output below is NOT a valid clustering",
                  flush=True)
        abort = int(abort)

        def clusters_upto(n_clusters):
            """[(center_row, members)] for cluster ids 0..n_clusters-1 in
            ONE lexsort — a per-cluster nonzero scan is O(C * n) and cost
            tens of seconds per call at 1M rows / 70k clusters."""
            rows = np.nonzero((assign >= 0) & (assign < n_clusters))[0]
            key = astep[rows].astype(np.int64) * (n + 1) + rows
            srt = np.lexsort((key, assign[rows]))
            rows_s = rows[srt]
            asg_s = assign[rows_s]
            bounds = np.searchsorted(asg_s, np.arange(n_clusters + 1))
            return [
                (int(order[centers[c]]),
                 order[rows_s[bounds[c]:bounds[c + 1]]].tolist())
                for c in range(n_clusters)
            ]

        if abort == 0:
            return clusters_upto(int(cid)), None
        # guarded abort: reconstruct the exact host state
        done_clusters = clusters_upto(int(cid))
        cur_rows = np.nonzero(assign == int(cid))[0]
        key = astep[cur_rows].astype(np.int64) * (n + 1) + cur_rows
        cur_flat = cur_rows[np.argsort(key, kind="stable")]
        current_rows = order[cur_flat].tolist()
        # rebuild a BVec directly from the alive flags (order preserved;
        # __init__ fields are fully overwritten below)
        bv2 = BVec(self.ps.lengths, bin_size=1000)
        bv2.begin_bounds = list(host["bounds"])
        bv2._bounds_arr = np.asarray(bv2.begin_bounds, dtype=np.int64)
        bv2._lengths = np.asarray(self.ps.lengths, dtype=np.int64)
        bin_start = host["bin_start"]
        bins, marks = [], []
        for b in range(host["nb"]):
            span = np.arange(bin_start[b], bin_start[b + 1])
            keep = span[alive[span]]
            bins.append(order[keep].astype(np.int64))
            marks.append(np.zeros(len(keep), dtype=bool))
        bv2.bins = bins
        bv2.marks = marks
        state = ResumeState(
            stage=abort,
            clusters_done=done_clusters,
            current_rows=current_rows,
            last_row=int(order[cur]),
            bv=bv2,
        )
        return None, state
