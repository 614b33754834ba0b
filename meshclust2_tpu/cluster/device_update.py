"""Device-batched update/merge phase.

The reference's update phase (ClusterFactory.cpp:287-401,635-655) is, per
iteration, three embarrassingly-parallel batches: classifier-filter every
center against its +/-delta neighborhood members (Trainer::filter,
Trainer.cpp:122-141), re-center each cluster on the member closest to the
member mean (Trainer::closest, Trainer.cpp:143-157), and score the
(i, i+1..i+delta) center pairs for merging (Trainer::merge,
Trainer.cpp:73-109).  Unlike the accumulate phase there is no per-center
sequential dependence, so this path is NOT a device-resident loop: it is
one large device batch per sub-phase — O(iterations) dispatches total (~45
for the default 15 iterations), each a wide batch,
versus the reference's O(centers x members) scalar loop.  The iteration
control flow and the merge bookkeeping (an order-dependent list splice,
ClusterFactory.cpp:382-401) stay on the host where they are O(C) numpy work.

Exactness contract (same as cluster/device_loop.py): integer-exact pairwise
stats + dd-f32 epilogue + float64 decision edges.  Each batch returns the
GLM sum and dist as dd pairs; the HOST converts them to f64 and applies the
edges with a margin — pairs inside the margin are re-scored by the float64
host oracle (cheap: they are rare and the batch boundary is already on the
host), so decisions always match the reference bit for bit.

Closest-to-mean runs on device as segmented integer reductions
(num/den rounding corners guarded per bin exactly as in device_loop), with
per-center host fallback on any guard trip.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..model.classifier import CompiledModel
from ..model import thresholds as TH
from ..kmer.counting import PointSet
from ..ops import ddf32 as DD
from .device_loop import (
    DeviceLoopUnsupported,
    resolve_margins,
    _pack_model,
    derive_singles_dd,
    emd_rowsum,
    envelope_check,
    epilogue_dd,
    block_singles_stats,
    log_div_stats,
    log_needs,
    stat_needs,
)

# coarse (4x-stepped) buckets: every distinct bucket size costs a jit
# trace + compile (or compile-cache load), which at the observed call sizes
# outweighs the padded-execute cost of a 4x-wide bucket
_PAIR_BUCKETS = [1 << b for b in range(10, 22, 2)]


def _bucket(n: int) -> int:
    for b in _PAIR_BUCKETS:
        if n <= b:
            return b
    return int(2 ** int(np.ceil(np.log2(max(n, 2)))))


class DeviceUpdater:
    """Batched device scoring + closest-to-mean for the update/merge phase."""

    def __init__(self, ps: PointSet, model: CompiledModel, sim: float,
                 margin=None, tie_margin=None, store=None):
        import jax
        import jax.numpy as jnp

        if not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)
        self.jax = jax
        self.jnp = jnp
        self.ps = ps
        self.model = model
        self.sim = float(sim)
        self.margin, self.tie_margin = resolve_margins(margin, tie_margin)
        self.pack = _pack_model(model)
        self.d = ps.dim
        self.maxc = int(ps.counts.max()) if ps.n else 0

        if store is not None:
            # shared DeviceStore (device_session): uploads happen ONCE per
            # run, not once per device engine
            envelope_check(ps)
            self.counts = store.counts
            self.mags = store.mags
            self.selfdot = store.selfdot
            self.lens = store.lens
            self.std_h = store.std_h
            self.std_l = store.std_l
        else:
            self_dots = envelope_check(ps)

            # rows padded to a bucketed count so every kernel's cache key
            # (and the accumulate program reusing self.counts, device_loop)
            # depends only on the bucket, not the exact dataset size;
            # padding rows are never indexed
            from .device_loop import _shape_bucket

            nb = _shape_bucket(max(ps.n, 1))

            def rowpad(a):
                out = np.zeros((nb,) + a.shape[1:], dtype=a.dtype)
                out[: ps.n] = a
                return jnp.asarray(out)

            self.counts = rowpad(ps.counts)       # natural width
            self.mags = rowpad(ps.mags.astype(np.int32))
            self.selfdot = rowpad(self_dots.astype(np.int32))
            self.lens = rowpad(ps.lengths.astype(np.int32))
            sh, sl = DD.split_f64(ps.stddevs)
            self.std_h = rowpad(sh)
            self.std_l = rowpad(sl)
        # per-point arrays are jit ARGUMENTS, never closure captures: a
        # captured counts array is inlined into the HLO as a multi-MB
        # literal, exploding compile time per pair-count bucket (see
        # device_loop._build_program)
        self._arrs = (self.counts, self.mags, self.selfdot, self.lens,
                      self.std_h, self.std_l)

        self._score_jit = jax.jit(self._score_impl)
        self._closest_jit = {}

        # f64 decision edges (host-side application)
        self.band0 = TH.nonzero_bands(model.bias)   # c_round(prob) != 0
        self.band1 = TH.merge_band(model.bias)      # c_round(prob) == 1

        self.scored_pairs = 0
        self.rechecked_pairs = 0
        # MC2_DEVICE_PROF accounting
        self.t_score = 0.0
        self.t_closest = 0.0
        self.n_score = 0
        self.n_closest = 0

    def prof_line(self) -> str:
        return (f"device update: score {self.t_score:.2f}s/{self.n_score} "
                f"calls, closest {self.t_closest:.2f}s/{self.n_closest} "
                f"calls, {self.scored_pairs} pairs "
                f"({self.rechecked_pairs} host-rechecked)")

    # -- pair scoring -----------------------------------------------------------

    @staticmethod
    def _arr_side(mags, selfdot, std_h, std_l, lens, idx):
        return {
            "mags": mags[idx],
            "selfdot": selfdot[idx],
            "std": (std_h[idx], std_l[idx]),
            "lens": lens[idx],
        }

    def _score_core(self, counts, mags, selfdot, lens, std_h, std_l,
                    a_idx, b_idx):
        """(s_dd, dist_dd, s_err, dist_err) for pairs (a_idx[i], b_idx[i])
        in the reference's argument order — the shared scoring trunk of
        every update-phase kernel."""
        import jax
        jnp = self.jnp
        A = counts[a_idx].astype(jnp.int32)
        B = counts[b_idx].astype(jnp.int32)
        nsm, ndot, nemd = stat_needs(self.pack.singles)
        njd, njs = log_needs(self.pack.singles)
        W = A.shape[0]
        summin = (jnp.minimum(A, B).sum(axis=1, dtype=jnp.int32)
                  if nsm else np.zeros((W,), np.int32))
        dot = ((A * B).sum(axis=1, dtype=jnp.int32)
               if ndot else np.zeros((W,), np.int32))
        emd = (emd_rowsum(jnp, A - B)
               if nemd else np.zeros((W,), np.int64))
        stats = {"summin": summin, "dot": dot, "emd": emd}
        if njd or njs:
            jd, js, jde, jse = log_div_stats(jnp, A, B, mags[a_idx],
                                             mags[b_idx], njd, njs)
            stats.update(jd=jd, js=js, jd_err=jde, js_err=jse)
        if self.pack.blk:
            stats["blk"] = block_singles_stats(
                jnp, A, B, mags[a_idx], mags[b_idx], self.d, self.pack.blk)
        singles = derive_singles_dd(
            self.pack, self.d, jnp, stats,
            self._arr_side(mags, selfdot, std_h, std_l, lens, a_idx),
            self._arr_side(mags, selfdot, std_h, std_l, lens, b_idx))
        return epilogue_dd(self.pack, singles)

    def _score_impl(self, counts, mags, selfdot, lens, std_h, std_l,
                    a_idx, b_idx):
        s_dd, dist_dd, s_err, dist_err = self._score_core(
            counts, mags, selfdot, lens, std_h, std_l, a_idx, b_idx)
        return s_dd[0], s_dd[1], dist_dd[0], dist_dd[1], s_err, dist_err

    def _band_device(self, s_dd, s_err, band):
        """Traced version of _band_decide: in-band and margin-uncertainty
        masks for the dd GLM sums against [lo, hi).  Decisions agree with
        the float64 host oracle everywhere outside the uncertainty mask
        (the dd-vs-f64 representation difference is covered by 8*s_err)."""
        jnp = self.jnp
        lo, hi = band
        inb = jnp.ones_like(s_dd[0], dtype=bool)
        unc = jnp.zeros_like(inb)
        for edge, ge in ((lo, True), (hi, False)):
            if np.isfinite(edge):
                e_dd = tuple(np.float32(x)
                             for x in DD.split_f64(np.float64(edge)))
                diff = DD.dd_sub(s_dd, e_dd)
                ge_mask = (diff[0] > 0) | ((diff[0] == 0) & (diff[1] >= 0))
                inb = inb & (ge_mask if ge else ~ge_mask)
                thr = jnp.maximum(
                    8 * s_err,
                    np.float32(self.margin * max(abs(edge), 1.0)))
                unc = unc | (jnp.abs(diff[0] + diff[1]) <= thr)
            elif (edge == -np.inf) != ge:
                # hi == -inf or lo == +inf: band empty
                inb = inb & False
        return inb, unc

    MAX_PAIR_CHUNK = 1 << 17

    def score_sum_dist(self, a_rows, b_rows) -> Tuple[np.ndarray, np.ndarray]:
        """(s, dist) as float64 approximations (dd hi+lo, ~1e-13 relative)
        for pairs (a_rows[i], b_rows[i]) with the reference's argument
        order.  Decisions from these values are only trusted outside the
        margin (see decide_*)."""
        jnp = self.jnp
        a_rows = np.ascontiguousarray(a_rows, dtype=np.int32)
        b_rows = np.ascontiguousarray(b_rows, dtype=np.int32)
        n = len(a_rows)
        if n == 0:
            return np.zeros(0), np.zeros(0)
        if n > self.MAX_PAIR_CHUNK:
            parts = []
            serrs, derrs = [], []
            for st in range(0, n, self.MAX_PAIR_CHUNK):
                parts.append(self.score_sum_dist(
                    a_rows[st:st + self.MAX_PAIR_CHUNK],
                    b_rows[st:st + self.MAX_PAIR_CHUNK]))
                serrs.append(self.last_serr)
                derrs.append(self.last_derr)
            self.last_serr = np.concatenate(serrs)
            self.last_derr = np.concatenate(derrs)
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        import time as _time

        t0 = _time.time()
        m = _bucket(n)
        ap = np.zeros(m, np.int32)
        bp = np.zeros(m, np.int32)
        ap[:n] = a_rows
        bp[:n] = b_rows
        res = self._score_jit(*self._arrs, jnp.asarray(ap), jnp.asarray(bp))
        self.scored_pairs += n
        # ONE device->host transfer for all six result arrays: each separate
        # np.asarray is its own blocking transfer
        sh, sl, dh, dl, serr, derr = (
            np.asarray(x) for x in self.jax.device_get(res))
        s = sh.astype(np.float64)[:n] + sl.astype(np.float64)[:n]
        dist = dh.astype(np.float64)[:n] + dl.astype(np.float64)[:n]
        self.last_serr = serr.astype(np.float64)[:n]
        self.last_derr = derr.astype(np.float64)[:n]
        self.t_score += _time.time() - t0
        self.n_score += 1
        return s, dist

    def _band_decide(self, s: np.ndarray, band) -> Tuple[np.ndarray, np.ndarray]:
        """in-band mask + uncertainty mask for s against [lo, hi).  The
        margin scales with the per-pair GLM term magnitudes (last_smag):
        cancellation makes the dd error track sum |c_j w_j|, not |s|."""
        lo, hi = band
        err = getattr(self, "last_serr", np.zeros(len(s)))
        inb = np.ones(len(s), dtype=bool)
        unc = np.zeros(len(s), dtype=bool)
        for edge, ge in ((lo, True), (hi, False)):
            if np.isfinite(edge):
                inb &= (s >= edge) if ge else (s < edge)
                thr = np.maximum(8 * err, self.margin * max(abs(edge), 1.0))
                unc |= np.abs(s - edge) <= thr
            elif (edge == -np.inf) != ge:
                # hi == -inf or lo == +inf: band empty
                inb &= False
        return inb, unc

    # -- closest to mean --------------------------------------------------------

    def _closest_core(self, counts, mags, rows, seg, valid, C: int):
        """Traced per-segment closest-to-mean over (rows, seg) pairs with a
        validity mask; returns (first [C] int64 pair position with P = no
        member, uncertain [C] bool)."""
        import jax
        jnp = self.jnp
        maxc = np.int64(self.maxc)
        P = rows.shape[0]
        if True:
            cnt = jax.ops.segment_sum(valid.astype(jnp.int64), seg,
                                      num_segments=C)
            # one int32 gather serves both the segment sums and the dist2
            # pass below; the big [P, D] reduction runs in int32 (half the
            # bytes of int64) whenever per-bin cluster
            # sums provably fit (maxc * n < 2^31 — true for every uint8
            # dataset), widening only the small [C, D] result
            blk32 = counts[rows].astype(jnp.int32)
            blk32m = jnp.where(valid[:, None], blk32, 0)
            if int(self.maxc) * max(int(self.ps.n), 1) < 2**31:
                num = jax.ops.segment_sum(blk32m, seg,
                                          num_segments=C).astype(jnp.int64)
            else:
                num = jax.ops.segment_sum(blk32m.astype(jnp.int64), seg,
                                          num_segments=C)
            den = jnp.maximum(cnt, 1)[:, None]
            q = num // den
            rem = num - q * den
            r = ((2 * num + den) // (2 * den)).astype(jnp.int32)
            s_floor = q.sum(axis=1)
            # f64 rounding-corner guards (device_loop.closest_to_mean)
            # integer comparison against the floored product is exact:
            # rem <= t (t real) <=> rem <= floor(t) for integer rem, so no
            # +1 slop — the thresholds are << 1 for any realistic cluster
            # (a trip needs (q + 2) * den on the order of 2^51)
            half_lhs = jnp.abs(2 * rem - den)
            tol_half = ((q + 2) * den) >> 51
            g1 = (half_lhs != 0) & (half_lhs <= tol_half)
            tol_f = ((q + 2) * den) >> 52
            g2 = (rem != 0) & (rem <= tol_f)
            tol_c = ((q + maxc + 2) * den) >> 52
            g3 = (rem != 0) & ((den - rem) <= tol_c)
            seg_unc = (g1 | g2 | g3).any(axis=1)

            # (blk32 already gathered above)
            dist2 = 2 * jnp.minimum(blk32, r[seg]).sum(axis=1, dtype=jnp.int32)
            mag = mags[rows].astype(jnp.int64) + s_floor[seg]
            frac = DD.dd_div(DD.dd_from_i64(dist2.astype(jnp.int64)),
                             DD.dd_from_i64(mag))
            f2 = DD.dd_mul(frac, frac)
            one = (np.float32(1.0), np.float32(0.0))
            u = DD.dd_sub(one, f2)
            vh = u[0] * np.float32(10000.0)
            vl = u[1] * np.float32(10000.0)
            inf = np.float32(np.inf)
            vh = jnp.where(valid, vh, inf)
            vl = jnp.where(valid, vl, inf)
            mh = jax.ops.segment_min(vh, seg, num_segments=C)
            is_m = valid & (vh == mh[seg])
            ml = jax.ops.segment_min(jnp.where(is_m, vl, inf), seg,
                                     num_segments=C)
            cand = is_m & (vl == ml[seg])
            pos = np.arange(P, dtype=np.int64)
            first = jax.ops.segment_min(jnp.where(cand, pos, np.int64(P)),
                                        seg, num_segments=C)
            # near-tie guard: non-candidates within margin of the minimum,
            # excluding exact integer-equal stats (which tie safely)
            fd2 = jnp.where(first[seg] < P, dist2[first[seg].astype(jnp.int32)], 0)
            fmg = jnp.where(first[seg] < P, mag[first[seg].astype(jnp.int32)], 0)
            sig_eq = (dist2 == fd2) & (mag == fmg)
            scale = jnp.maximum(jnp.abs(mh[seg]), np.float32(1.0))
            near = valid & (jnp.abs((vh - mh[seg]) + (vl - ml[seg]))
                            <= np.float32(self.tie_margin) * scale)
            tie_unc = jax.ops.segment_max((near & ~sig_eq).astype(jnp.int32),
                                          seg, num_segments=C) > 0
            return first, seg_unc | tie_unc

    # -- fused per-iteration kernels -------------------------------------------

    def _build_iter(self, P: int, C: int):
        """Filter decisions + segmented closest-to-mean fused into ONE
        dispatch per update iteration, returning only the decision masks
        (2 bytes/pair) instead of six dd/error arrays (24 bytes/pair)."""
        import jax

        def impl(counts, mags, selfdot, lens, std_h, std_l,
                 cen_rows, b_rows, seg, valid):
            a_idx = cen_rows[seg]
            s_dd, _dist, s_err, _derr = self._score_core(
                counts, mags, selfdot, lens, std_h, std_l, a_idx, b_rows)
            inb, unc = self._band_device(s_dd, s_err, self.band0)
            keep = valid & ~inb
            first, cunc = self._closest_core(counts, mags, b_rows, seg,
                                             keep, C)
            return keep, valid & unc, first, cunc

        return jax.jit(impl)

    def _build_merge(self, P: int, C: int):
        """Merge decisions + per-segment best-candidate argmax on device
        (engine._merge_pass semantics: res1 = c_round(prob) == 1; the later
        candidate wins distance ties, Trainer.cpp:104).  Returns per-pair
        uncertainty plus per-center (any, best pair position, ambiguous);
        ambiguous or uncertain segments are re-scored by the host oracle."""
        import jax
        jnp = self.jnp

        def impl(counts, mags, selfdot, lens, std_h, std_l,
                 cen_rows, jj, seg, valid):
            a_idx = cen_rows[jj]
            b_idx = cen_rows[seg]
            s_dd, dist_dd, s_err, dist_err = self._score_core(
                counts, mags, selfdot, lens, std_h, std_l, a_idx, b_idx)
            inb, unc = self._band_device(s_dd, s_err, self.band1)
            res1 = valid & inb
            neg_inf = np.float32(-np.inf)
            vh = jnp.where(res1, dist_dd[0], neg_inf)
            vl = jnp.where(res1, dist_dd[1], neg_inf)
            mh = jax.ops.segment_max(vh, seg, num_segments=C)
            is_m = res1 & (vh == mh[seg])
            ml = jax.ops.segment_max(jnp.where(is_m, vl, neg_inf), seg,
                                     num_segments=C)
            cand = is_m & (vl == ml[seg])
            pos = np.arange(P, dtype=np.int32)
            best = jax.ops.segment_max(jnp.where(cand, pos, -1), seg,
                                       num_segments=C)
            any_m = jax.ops.segment_max(res1.astype(jnp.int32), seg,
                                        num_segments=C) > 0
            # near-tie ambiguity among res1 candidates (host merge_decisions
            # semantics: near non-equal values force a full host re-score)
            derr_max = jax.ops.segment_max(
                jnp.where(res1, dist_err, np.float32(0.0)), seg,
                num_segments=C)
            dapx = (vh + vl) - (mh[seg] + ml[seg])
            thr = jnp.maximum(
                8 * (dist_err + derr_max[seg]),
                np.float32(self.tie_margin) *
                jnp.maximum(jnp.abs(mh[seg]), np.float32(1.0)))
            near = res1 & (jnp.abs(dapx) <= thr)
            eq = (vh == mh[seg]) & (vl == ml[seg])
            amb = jax.ops.segment_max((near & ~eq).astype(jnp.int32), seg,
                                      num_segments=C) > 0
            return valid & unc, any_m, best, amb

        return jax.jit(impl)

    MAX_ITER_PAIRS = 1 << 17

    def filter_closest(self, cen_rows: np.ndarray, b_rows: np.ndarray,
                       seg: np.ndarray, C: int):
        """One fused device call: update-filter keep decisions plus
        per-center closest-to-mean over the kept pairs.  Returns (keep [P],
        keep_uncertain [P], first [C] pair position into b_rows with P = no
        kept member, closest_uncertain [C]).  seg must be nondecreasing."""
        import time as _time

        jnp = self.jnp
        P = len(b_rows)
        if P == 0:
            return (np.zeros(0, bool), np.zeros(0, bool),
                    np.full(C, 0, np.int64), np.zeros(C, bool))
        if P > self.MAX_ITER_PAIRS:
            cut = int(np.searchsorted(seg, seg[self.MAX_ITER_PAIRS // 2],
                                      side="left"))
            if cut == 0 or cut >= P:
                cut = P // 2
            c_mid = int(seg[cut])
            k1, u1, f1, c1 = self.filter_closest(cen_rows[:c_mid],
                                                 b_rows[:cut], seg[:cut],
                                                 c_mid)
            k2, u2, f2, c2 = self.filter_closest(cen_rows[c_mid:],
                                                 b_rows[cut:],
                                                 seg[cut:] - c_mid,
                                                 C - c_mid)
            f2 = np.where(f2 < (P - cut), f2 + cut, P)
            f1 = np.where(f1 < cut, f1, P)
            return (np.concatenate([k1, k2]), np.concatenate([u1, u2]),
                    np.concatenate([f1, f2]), np.concatenate([c1, c2]))
        t0 = _time.time()
        Pb = _bucket(P)
        Cb = _bucket(max(C, 1))
        key = ("iter", Pb, Cb)
        if key not in self._closest_jit:
            self._closest_jit[key] = self._build_iter(Pb, Cb)
        cp = np.zeros(Cb, np.int32)
        cp[:C] = cen_rows[:C] if len(cen_rows) >= C else \
            np.pad(cen_rows, (0, C - len(cen_rows)))
        bp = np.zeros(Pb, np.int32)
        sp = np.full(Pb, Cb - 1, np.int32)
        vp = np.zeros(Pb, bool)
        bp[:P] = b_rows
        sp[:P] = seg
        vp[:P] = True
        keep, kunc, first, cunc = self.jax.device_get(
            self._closest_jit[key](*self._arrs, jnp.asarray(cp),
                                   jnp.asarray(bp), jnp.asarray(sp),
                                   jnp.asarray(vp)))
        self.scored_pairs += P
        first = np.asarray(first)[:C]
        first = np.where(first >= P, P, first)
        self.t_closest += _time.time() - t0
        self.n_closest += 1
        return (np.asarray(keep)[:P], np.asarray(kunc)[:P],
                first.astype(np.int64), np.asarray(cunc)[:C])

    def merge_segmented(self, cen_rows: np.ndarray, jj: np.ndarray,
                        seg: np.ndarray, C: int):
        """One fused device call for the merge pass: per-pair res1
        uncertainty plus per-center (any res1, best candidate pair position,
        ambiguous ranking).  seg must be nondecreasing."""
        import time as _time

        jnp = self.jnp
        P = len(jj)
        if P == 0:
            return (np.zeros(0, bool), np.zeros(C, bool),
                    np.full(C, -1, np.int64), np.zeros(C, bool))
        if P > self.MAX_ITER_PAIRS:
            cut = int(np.searchsorted(seg, seg[self.MAX_ITER_PAIRS // 2],
                                      side="left"))
            if cut == 0 or cut >= P:
                cut = P // 2
            c_mid = int(seg[cut])
            # candidate center indices jj exceed c_mid in the first half;
            # cen_rows must stay whole (jj spans up to i + delta)
            u1, a1, b1, m1 = self.merge_segmented(cen_rows, jj[:cut],
                                                  seg[:cut], c_mid)
            u2, a2, b2, m2 = self.merge_segmented(cen_rows, jj[cut:],
                                                  seg[cut:] - c_mid,
                                                  C - c_mid)
            b2 = np.where(b2 >= 0, b2 + cut, -1)
            return (np.concatenate([u1, u2]), np.concatenate([a1, a2]),
                    np.concatenate([b1, b2]), np.concatenate([m1, m2]))
        t0 = _time.time()
        Pb = _bucket(P)
        Cbank = _bucket(max(len(cen_rows), 1))
        Cb = _bucket(max(C, 1))
        key = ("merge", Pb, Cbank, Cb)
        if key not in self._closest_jit:
            self._closest_jit[key] = self._build_merge(Pb, Cb)
        cp = np.zeros(Cbank, np.int32)
        cp[: len(cen_rows)] = cen_rows
        jp = np.zeros(Pb, np.int32)
        sp = np.full(Pb, Cb - 1, np.int32)
        vp = np.zeros(Pb, bool)
        jp[:P] = jj
        sp[:P] = seg
        vp[:P] = True
        unc, any_m, best, amb = self.jax.device_get(
            self._closest_jit[key](*self._arrs, jnp.asarray(cp),
                                   jnp.asarray(jp), jnp.asarray(sp),
                                   jnp.asarray(vp)))
        self.scored_pairs += P
        best = np.asarray(best)[:C].astype(np.int64)
        best = np.where(best >= P, -1, best)
        self.t_score += _time.time() - t0
        self.n_score += 1
        return (np.asarray(unc)[:P], np.asarray(any_m)[:C], best,
                np.asarray(amb)[:C])

