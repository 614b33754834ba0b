"""Training pair tables on device (P4, SURVEY §2.8).

The reference builds its [pairs x singles] feature matrix with an OpenMP
parallel-for over pairs (Predictor.cpp:344) and warms the selector cache the
same way (BestFirstSelector.cpp:112-128).  This module computes the raw
singles table for the semi-synthetic training pairs as ONE batched device
kernel — integer-exact pair statistics plus the dd-f32 epilogue shared with
the clustering engine (cluster/device_loop.derive_singles_dd) — instead of a
host loop.

Exactness contract.  Two things downstream consume the raw table:

  1. The min/max normalization bounds, serialized into weights.txt at 17
     digits (Predictor.cpp:27-121) — these must be BIT-EXACT float64.  The
     dd values carry per-entry absolute error bounds, so the pairs whose
     interval [raw-err, raw+err] overlaps the achievable min/max are
     re-computed by the float64 host path and the exact extrema taken; the
     true extreme pair is provably inside that candidate set.
  2. The normalized feature matrix feeding the GLM solves and accuracy
     counts during selection.  dd raw values sit within ~1e-13 relative of
     the float64 oracle's; the selection outcome (feature sets, printed
     accuracies) only differs if some prediction lands within that sliver
     of a rounding edge.  tests/test_training_device.py pins golden-config
     equality of the selected sets, weights and serialized bounds against
     the host oracle build.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..kmer.counting import PointSet
from ..ops import ddf32 as DD
from ..cluster.device_loop import (
    DD_DERIVABLE,
    DeviceLoopUnsupported,
    derive_singles_dd,
    envelope_check,
    stat_needs,
    emd_rowsum,
)


class _SinglesPack(NamedTuple):
    singles: tuple


def _bucket(n: int) -> int:
    return 1 << max(10, (max(n, 2) - 1).bit_length())


class DeviceTableBuilder:
    """Raw-singles tables for (a_row, b_row) pair lists on the device.

    Raises DeviceLoopUnsupported when the point set is outside the exact
    integer envelope or a single is not dd-derivable.
    """

    def __init__(self, ps: PointSet, singles: List[int]):
        import jax
        import jax.numpy as jnp

        if not set(singles) <= DD_DERIVABLE:
            raise DeviceLoopUnsupported(
                f"singles {singles} not dd-derivable")
        if not jax.config.jax_enable_x64:
            # the integer stats envelope needs real int64 (mag products
            # reach 2^48); without x64 jax silently truncates to int32
            jax.config.update("jax_enable_x64", True)
        self.jax = jax
        self.jnp = jnp
        self.ps = ps
        self.singles = list(singles)
        self.pack = _SinglesPack(singles=tuple(singles))
        self_dots = envelope_check(ps)
        self.d = ps.dim

        self.counts = jnp.asarray(ps.counts)
        self.mags = jnp.asarray(ps.mags.astype(np.int32))
        self.selfdot = jnp.asarray(self_dots.astype(np.int32))
        self.lens = jnp.asarray(ps.lengths.astype(np.int32))
        sh, sl = DD.split_f64(ps.stddevs)
        self.std_h = jnp.asarray(sh)
        self.std_l = jnp.asarray(sl)
        self._arrs = (self.counts, self.mags, self.selfdot, self.lens,
                      self.std_h, self.std_l)
        self._jit = jax.jit(self._impl)

    def _side(self, mags, selfdot, std_h, std_l, lens, idx):
        return {
            "mags": mags[idx],
            "selfdot": selfdot[idx],
            "std": (std_h[idx], std_l[idx]),
            "lens": lens[idx],
        }

    def _impl(self, counts, mags, selfdot, lens, std_h, std_l,
              a_idx, b_idx):
        import jax
        jnp = self.jnp
        A = counts[a_idx].astype(jnp.int32)
        B = counts[b_idx].astype(jnp.int32)
        nsm, ndot, nemd = stat_needs(self.singles)
        W = A.shape[0]
        summin = (jnp.minimum(A, B).sum(axis=1, dtype=jnp.int32)
                  if nsm else np.zeros((W,), np.int32))
        dot = ((A * B).sum(axis=1, dtype=jnp.int32)
               if ndot else np.zeros((W,), np.int32))
        emd = (emd_rowsum(jnp, A - B)
               if nemd else np.zeros((W,), np.int64))
        stats = {"summin": summin, "dot": dot, "emd": emd}
        vals, errs = derive_singles_dd(
            self.pack, self.d, jnp, stats,
            self._side(mags, selfdot, std_h, std_l, lens, a_idx),
            self._side(mags, selfdot, std_h, std_l, lens, b_idx))
        hi = jnp.stack([v[0] for v in vals], axis=1)
        lo = jnp.stack([v[1] for v in vals], axis=1)
        err = jnp.stack([jnp.broadcast_to(e, hi[:, 0].shape) for e in errs],
                        axis=1)
        return hi, lo, err

    MAX_CHUNK = 1 << 17

    def raw_with_err(self, a_rows, b_rows) -> Tuple[np.ndarray, np.ndarray]:
        """[P, S] float64 raw singles (dd hi+lo) + absolute error bounds."""
        jnp = self.jnp
        a_rows = np.ascontiguousarray(a_rows, dtype=np.int32)
        b_rows = np.ascontiguousarray(b_rows, dtype=np.int32)
        n = len(a_rows)
        if n == 0:
            S = len(self.singles)
            return np.zeros((0, S)), np.zeros((0, S))
        if n > self.MAX_CHUNK:
            parts = [self.raw_with_err(a_rows[s:s + self.MAX_CHUNK],
                                       b_rows[s:s + self.MAX_CHUNK])
                     for s in range(0, n, self.MAX_CHUNK)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        m = _bucket(n)
        ap = np.zeros(m, np.int32)
        bp = np.zeros(m, np.int32)
        ap[:n] = a_rows
        bp[:n] = b_rows
        hi, lo, err = self.jax.device_get(
            self._jit(*self._arrs, jnp.asarray(ap), jnp.asarray(bp)))
        raw = hi.astype(np.float64)[:n] + lo.astype(np.float64)[:n]
        return raw, err.astype(np.float64)[:n]


def device_raw_singles(ps: PointSet, a_rows, b_rows, singles,
                       host_exact_fn) -> Optional[np.ndarray]:
    """[P, S] raw singles through the device with exact extrema.

    host_exact_fn(idx) must return the float64-oracle raw rows for the pair
    subset idx (native raw_singles_batch / features.host).  Every pair whose
    dd error interval could reach a per-single min or max is re-computed
    exactly and its row overwritten, so downstream normalization bounds are
    bit-identical to the host build.  Returns None when the device path is
    unsupported (caller falls back to host).
    """
    try:
        builder = DeviceTableBuilder(ps, singles)
    except DeviceLoopUnsupported as e:
        print(f"device training tables unavailable ({e}); host builds them")
        return None
    raw, err = builder.raw_with_err(a_rows, b_rows)
    if not len(raw):
        return raw
    # min-candidates: pairs whose interval can reach min_k(raw_k + e_k) —
    # the true arg-extreme is provably inside this set, and (by the same
    # interval argument) no un-replaced approximate value can lie outside
    # the exact extrema, so the matrix min/max ARE the oracle bounds
    slack = 8 * err + 1e-12 * np.maximum(np.abs(raw), 1.0)
    cand = ((raw - slack) <= (raw + slack).min(axis=0)[None, :]) | \
           ((raw + slack) >= (raw - slack).max(axis=0)[None, :])
    rows = np.nonzero(cand.any(axis=1))[0]
    if len(rows):
        exact = host_exact_fn(rows)
        raw[rows] = exact
    return raw
