"""Whole-phase device-resident update/merge.

The reference's update phase (ClusterFactory.cpp:635-655) iterates <= 15
times: re-center every cluster on the member of its +/-delta neighborhood
closest to the classifier-filtered member mean (ClusterFactory.cpp:287-335,
Trainer.cpp:122-157), then merge adjacent centers the classifier calls the
same (ClusterFactory.cpp:382-401, Trainer.cpp:73-109), with early stop when
the cluster count matches the count three iterations earlier, and one final
delta=0 re-centering pass (ClusterFactory.cpp:648-650).

Run per iteration, the phase is ~15 device dispatches, each with its own
upload and fetch.  This module compiles the ENTIRE phase — iteration loop,
early stop, merge bookkeeping and the final pass — into ONE jitted program
over the shared DeviceStore, so the phase is one dispatch and one fetch.

Neighborhoods without ragged pair lists: a member row of the cluster at
rank r participates in the re-centering of centers at ranks r-delta..r+delta,
so the (row, center) pair set is exactly rows x (2*delta+1) rank offsets.
Each offset is one full-array pass: gather the per-row target center,
length-window + classify -> keep, segment-sum kept histograms per center,
then a second offset sweep for closest-to-mean.  The merge pass scores
(rank i, rank i+q) center pairs per offset q and replays absorb events
sequentially (events only — merges are sparse) with O(rows) masked updates,
preserving exact member order via per-row (cluster, seq) keys.

Exactness contract (same as cluster/device_loop.py): integer-exact pair
statistics, dd-f32 epilogue with propagated error bounds, float64 decision
edges bit-bisected on the host, and margin guards on EVERY data-dependent
decision.  Uncertainty anywhere in an iteration aborts the program at that
iteration's START (the iteration is never half-applied); the host resumes
the per-iteration path from there, so output always matches the float64
host semantics bit for bit.
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np

from ..model.classifier import CompiledModel
from ..model import thresholds as TH
from ..kmer.counting import PointSet
from ..ops import ddf32 as DD
from .device_loop import (
    DeviceLoopUnsupported,
    resolve_margins,
    _pack_model,
    _shape_bucket,
    derive_singles_dd,
    emd_rowsum,
    epilogue_dd,
    block_singles_stats,
    log_div_stats,
    log_needs,
    stat_needs,
)


# Device seconds per update-phase iteration at the 131,072-row bucket,
# measured by chip_smoke.py phase 3 on the 100k pool (NVIDIA H100 80GB HBM3,
# power limit 400 W: 0.0468 s).
ITER_SECONDS_131072 = 0.047

# Share of the device's allocator limit one [CB, D] accumulator may take:
# the phase holds a few such buffers at once beside the store.
ACC_MEMORY_FRACTION = 0.25
# XLA:CPU reports no memory stats; its host-memory budget stays fixed.
CPU_ACC_BUDGET_BYTES = 4 << 30


def accumulator_budget_bytes(device=None) -> int:
    """Bytes one [CB, D] update-phase accumulator may take on `device`
    (default: the first device)."""
    import jax

    dev = device or jax.devices()[0]
    stats = dev.memory_stats()
    if stats is None:
        if dev.platform == "cpu":
            return CPU_ACC_BUDGET_BYTES
        raise RuntimeError(
            f"{dev.platform} device {dev.device_kind!r} reports no memory "
            "stats; cannot size the update-phase accumulators")
    return int(stats["bytes_limit"] * ACC_MEMORY_FRACTION)


class PhaseResult(NamedTuple):
    abort: int          # 0 done (final pass applied); 1 uncertainty at
                        # iteration `it` (state = that iteration's start);
                        # 2 loop done, final pass uncertain (state = post-loop)
    it: int             # iterations fully applied
    hist: List[int]     # cluster count after each applied iteration
    clusters: list      # [(center_row, [member_rows...])] in slot order
    pairs: int          # length-passed pairs scored (stats parity)


class DevicePhaseUpdater:
    def __init__(self, ps: PointSet, model: CompiledModel, sim: float,
                 store, delta: int = 5, iterations: int = 15,
                 margin=None, tie_margin=None):
        self.ps = ps
        self.model = model
        self.sim = float(sim)
        self.store = store
        self.delta = int(delta)
        self.iterations = int(iterations)
        self.margin, self.tie_margin = resolve_margins(margin, tie_margin)
        self.pack = _pack_model(model)
        self.d = ps.dim
        self.maxc = (int(ps.counts.max()) if ps.counts is not None and ps.n
                     else int(getattr(store, "maxc", 0)))
        self.NB = store.nb
        # slot arrays and segment-sum accumulators are sized by a CLUSTER
        # bucket CB (<= NB): clusters are far fewer than rows (10k -> 788,
        # 1M -> ~73-100k), and the [slots, D] accumulators set the memory
        # (a [2^20, 1024] i64 msum is 8.6 GB; [131072, 1024] is 1.07 GB)
        # AND the scatter cost (8x smaller scatter targets).
        # The default covers every measured dataset; run() lazily compiles
        # a bigger bucket when a run arrives with more clusters.
        self.CB = min(self.NB, _shape_bucket(max(self.NB // 8, 1024)))
        # row chunk: bounds the [rows, D] i32 gather/score temporaries (at
        # the 1M bucket a full-width pass would materialize ~4 GB per temp)
        self.RC = min(self.NB, max(1 << 14, (1 << 29) // (4 * self.d)))
        # int32 segment sums are exact when per-bin cluster sums fit
        self.sum32 = self.maxc * max(int(ps.n), 1) < 2**31
        self.band0 = TH.nonzero_bands(model.bias)   # c_round(prob) != 0
        self.band1 = TH.merge_band(model.bias)      # c_round(prob) == 1
        self._compiled_by_cb = {}
        self._check_cb(self.CB)

    def seg_iters(self) -> int:
        """Iterations per dispatch: bounded so one phase segment runs about
        30 s of estimated device time (ITER_SECONDS_131072, scaled
        linearly with the row bucket)."""
        env = os.environ.get("MC2_PHASE_SEG")
        if env:
            return max(1, int(env))
        est = ITER_SECONDS_131072 * self.NB / 131072.0
        return max(1, min(self.iterations, int(30.0 / max(est, 0.05))))

    def _check_cb(self, cb: int) -> None:
        """Memory guard for one CB bucket's [CB, D] accumulators."""
        width = 4 if self.sum32 else 8
        budget = accumulator_budget_bytes()
        if cb * self.d * width > budget:
            raise DeviceLoopUnsupported(
                f"update-phase accumulators too large ({cb}x{self.d}, "
                f"budget {budget} bytes)")

    @property
    def _compiled(self):
        return self._compiled_by_cb.get(self.CB)

    # -- traced helpers ---------------------------------------------------------

    def _band_device(self, jnp, s_dd, s_err, band):
        """In-band + margin-uncertainty masks for dd GLM sums against
        [lo, hi) (device_update._band_device semantics)."""
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
                inb = inb & False
        return inb, unc

    def _score_rows(self, jax, jnp, S, a_rows, b_rows, b_block=None):
        """(s_dd, dist_dd, s_err, dist_err) for row-index vectors with the
        reference argument order (a = center/candidate, b = member).
        `b_block` optionally supplies the b-side count block directly (a
        contiguous dynamic_slice is cheaper than a row gather when b_rows
        is a consecutive chunk)."""
        A = S["counts"][a_rows].astype(jnp.int32)
        B = b_block if b_block is not None \
            else S["counts"][b_rows].astype(jnp.int32)
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
            jd, js, jde, jse = log_div_stats(jnp, A, B, S["mags"][a_rows],
                                             S["mags"][b_rows], njd, njs)
            stats.update(jd=jd, js=js, jd_err=jde, js_err=jse)
        if self.pack.blk:
            stats["blk"] = block_singles_stats(
                jnp, A, B, S["mags"][a_rows], S["mags"][b_rows], self.d,
                self.pack.blk)
        side = lambda r: {
            "mags": S["mags"][r], "selfdot": S["selfdot"][r],
            "std": (S["std_h"][r], S["std_l"][r]), "lens": S["lens"][r],
        }
        singles = derive_singles_dd(
            self.pack, self.d, jnp, stats, side(a_rows), side(b_rows))
        return epilogue_dd(self.pack, singles)

    # -- program ----------------------------------------------------------------

    def _build(self, CB: int):
        import jax
        import jax.numpy as jnp

        NB = self.NB
        D = self.d
        RC = min(self.RC, NB)
        NCHUNK = (NB + RC - 1) // RC
        delta = self.delta
        ITER = self.iterations
        margin = np.float32(self.margin)
        tie_margin = np.float32(self.tie_margin)
        maxc = np.int64(self.maxc)
        sum32 = self.sum32
        BIGKEY = np.int64(2**62)
        pos_inf = np.float32(np.inf)
        neg_inf = np.float32(-np.inf)

        class St(NamedTuple):
            assign: jnp.ndarray    # [NB] i32 slot per row
            seq: jnp.ndarray       # [NB] i32 member position
            cen: jnp.ndarray       # [CB] i32 center row per slot
            alivec: jnp.ndarray    # [CB] bool slot alive
            clen: jnp.ndarray      # [CB] i32 member count per slot
            hist: jnp.ndarray      # [ITER] i32 count after iteration k
            it: jnp.ndarray        # i32
            done: jnp.ndarray      # bool
            abort: jnp.ndarray     # i32
            pairs: jnp.ndarray     # i64

        def ranks(alivec):
            ai = alivec.astype(jnp.int32)
            crank = jnp.cumsum(ai)
            rank = crank - ai
            Ctot = crank[-1]
            idxs = jnp.where(alivec, rank, np.int32(CB))
            inv = jnp.zeros(CB, jnp.int32).at[idxs].set(
                np.arange(CB, dtype=np.int32), mode="drop")
            return rank, inv, Ctot

        def mean_guards(num, den_raw):
            """Rounded mean + f64 rounding-corner guards per slot
            (device_loop.closest_to_mean semantics, vectorized [CB, D])."""
            num = num.astype(jnp.int64)
            den = jnp.maximum(den_raw, 1)[:, None].astype(jnp.int64)
            q = num // den
            rem = num - q * den
            r = ((2 * num + den) // (2 * den)).astype(jnp.int32)
            s_floor = q.sum(axis=1)
            half_lhs = jnp.abs(2 * rem - den)
            tol_half = ((q + 2) * den) >> 51
            g1 = (half_lhs != 0) & (half_lhs <= tol_half)
            tol_f = ((q + 2) * den) >> 52
            g2 = (rem != 0) & (rem <= tol_f)
            tol_c = ((q + maxc + 2) * den) >> 52
            g3 = (rem != 0) & ((den - rem) <= tol_c)
            unc = ((g1 | g2 | g3).any(axis=1)) & (den_raw > 0)
            return r, s_floor, unc

        def program(S, assign0, seq0, cen0, alivec0, clen0, n, it0,
                    hist0, seg):
            valid_row = np.arange(NB, dtype=np.int32) < n

            def row_chunk(arr, ci):
                start = (ci * RC).astype(jnp.int32) if hasattr(ci, "astype") \
                    else jnp.int32(ci * RC)
                return jax.lax.dynamic_slice(arr, (start,), (RC,))

            def filter_mean(st, off_lo: int, off_hi: int):
                """Classify passes + segment sums over the given rank
                offsets, row-chunked so temporaries stay [RC, D].  Returns
                (keepbits [NB] i32, mcnt [CB] i32, r, s_floor, unc,
                pairs)."""
                rank, inv, Ctot = ranks(st.alivec)
                rrank = rank[st.assign]

                def step_body(ci_flat, carry):
                    keepbits, msum, mcnt, unc, pairs = carry
                    ci_flat = jnp.asarray(ci_flat).astype(jnp.int32)
                    oi = ci_flat // NCHUNK
                    ch = ci_flat % NCHUNK
                    o = off_lo + oi
                    r0 = ch * RC
                    rows = r0 + np.arange(RC, dtype=np.int32)
                    asg = row_chunk(st.assign, ch)
                    rr = row_chunk(rrank, ch)
                    t_rank = rr + (o - delta)
                    tvalid = (rows < n) & (t_rank >= 0) & (t_rank < Ctot) \
                        & st.alivec[asg]
                    t_slot = inv[jnp.clip(t_rank, 0, CB - 1)]
                    cr = st.cen[t_slot]
                    lens_c = row_chunk(S["lens"], ch)
                    lp = tvalid & (lens_c >= S["blen"][cr]) \
                        & (lens_c <= S["elen"][cr])
                    pairs = pairs + lp.sum(dtype=jnp.int64)
                    B = jax.lax.dynamic_slice(
                        S["counts"], (r0, np.int32(0)),
                        (RC, D)).astype(jnp.int32)
                    s_dd, _dist, s_err, _derr = self._score_rows(
                        jax, jnp, S, cr, rows, b_block=B)
                    # band0 is the round-to-ZERO band: kept members are the
                    # ones OUTSIDE it (c_round(prob) != 0, Trainer.cpp:134)
                    inb, bunc = self._band_device(jnp, s_dd, s_err,
                                                  self.band0)
                    keep = lp & ~inb
                    unc = unc | (lp & bunc).any()
                    Bm = jnp.where(keep[:, None], B, 0)
                    if sum32:
                        msum = msum + jax.ops.segment_sum(
                            Bm, t_slot, num_segments=CB)
                    else:
                        msum = msum + jax.ops.segment_sum(
                            Bm.astype(jnp.int64), t_slot, num_segments=CB)
                    mcnt = mcnt + jax.ops.segment_sum(
                        keep.astype(jnp.int32), t_slot, num_segments=CB)
                    kb = row_chunk(keepbits, ch) | (keep.astype(jnp.int32) << o)
                    keepbits = jax.lax.dynamic_update_slice(
                        keepbits, kb, (r0,))
                    return keepbits, msum, mcnt, unc, pairs

                init = (jnp.zeros(NB, jnp.int32),
                        jnp.zeros((CB, D),
                                  jnp.int32 if sum32 else jnp.int64),
                        jnp.zeros(CB, jnp.int32),
                        jnp.zeros((), bool), jnp.zeros((), jnp.int64))
                keepbits, msum, mcnt, unc, pairs = jax.lax.fori_loop(
                    0, (off_hi - off_lo + 1) * NCHUNK, step_body, init)
                r, s_floor, g_unc = mean_guards(msum, mcnt)
                unc = unc | g_unc.any()
                return keepbits, mcnt, r, s_floor, unc, pairs

            def closest(st, off_lo: int, off_hi: int, keepbits, r, s_floor):
                """Per-slot argmin of distance_d(member, rounded mean) over
                kept pairs, reference gather order for ties.  Returns
                (best_row [CB] i32 with NB = none, unc).  Row-chunked; the
                cross-chunk merge reuses the cross-offset carry compare
                (sound for the same reason: near-ties that cross a chunk
                boundary trip the cross_near guard)."""
                rank, inv, Ctot = ranks(st.alivec)
                rrank = rank[st.assign]

                class CC(NamedTuple):
                    ci: jnp.ndarray
                    vh: jnp.ndarray     # [CB] per-slot best
                    vl: jnp.ndarray
                    key: jnp.ndarray    # [CB] i64 (window, seq) of best
                    row: jnp.ndarray    # [CB] i32
                    d2: jnp.ndarray     # [CB] i32 tie signature
                    mg: jnp.ndarray     # [CB] i64
                    unc: jnp.ndarray

                def off_body(cc: CC):
                    oi = cc.ci // NCHUNK
                    ch = cc.ci % NCHUNK
                    o = off_lo + oi
                    r0 = (ch * RC).astype(jnp.int32)
                    rows = r0 + np.arange(RC, dtype=np.int32)
                    asg = row_chunk(st.assign, ch)
                    rr = row_chunk(rrank, ch)
                    t_rank = rr + (o - delta)
                    tvalid = (rows < n) & (t_rank >= 0) & (t_rank < Ctot) \
                        & st.alivec[asg]
                    t_slot = inv[jnp.clip(t_rank, 0, CB - 1)]
                    kb = row_chunk(keepbits, ch)
                    keep = tvalid & (((kb >> o) & 1) > 0)
                    B = jax.lax.dynamic_slice(
                        S["counts"], (r0, np.int32(0)),
                        (RC, D)).astype(jnp.int32)
                    rg = r[t_slot]
                    dist2 = 2 * jnp.minimum(B, rg).sum(axis=1,
                                                       dtype=jnp.int32)
                    mag = row_chunk(S["mags"], ch).astype(jnp.int64) \
                        + s_floor[t_slot]
                    frac = DD.dd_div(DD.dd_from_i64(dist2.astype(jnp.int64)),
                                     DD.dd_from_i64(mag))
                    f2 = DD.dd_mul(frac, frac)
                    u = DD.dd_sub((np.float32(1.0), np.float32(0.0)), f2)
                    vh_ = u[0] * np.float32(10000.0)
                    vl_ = u[1] * np.float32(10000.0)
                    vh = jnp.where(keep, vh_, pos_inf)
                    vl = jnp.where(keep, vl_, pos_inf)
                    mh = jax.ops.segment_min(vh, t_slot, num_segments=CB)
                    is_m = keep & (vh == mh[t_slot])
                    ml = jax.ops.segment_min(jnp.where(is_m, vl, pos_inf),
                                             t_slot, num_segments=CB)
                    cand = is_m & (vl == ml[t_slot])
                    w = np.int64(2 * delta) - o.astype(jnp.int64)
                    key = (w << 32) | row_chunk(st.seq, ch).astype(jnp.int64)
                    ckey = jax.ops.segment_min(
                        jnp.where(cand, key, BIGKEY), t_slot,
                        num_segments=CB)
                    # chunk-local argmin row, then absolute
                    iota = np.arange(RC, dtype=np.int32)
                    cloc = jax.ops.segment_min(
                        jnp.where(cand & (key == ckey[t_slot]),
                                  iota, np.int32(RC)),
                        t_slot, num_segments=CB)
                    have = cloc < RC
                    cloc_c = jnp.minimum(cloc, RC - 1)
                    crow = jnp.where(have, r0 + cloc_c, np.int32(NB))
                    cd2 = jnp.where(have, dist2[cloc_c], 0)
                    cmg = jnp.where(have, mag[cloc_c], 0)
                    # near-tie guard within the chunk (exact int-equal safe)
                    sig_eq = keep & (dist2 == cd2[t_slot]) \
                        & (mag == cmg[t_slot])
                    scale = jnp.maximum(jnp.abs(mh[t_slot]), np.float32(1.0))
                    thr = jnp.maximum(tie_margin * scale, np.float32(1e-7))
                    near = keep & (jnp.abs((vh - mh[t_slot])
                                           + (vl - ml[t_slot])) <= thr)
                    o_unc = jax.ops.segment_max(
                        (near & ~sig_eq).astype(jnp.int32), t_slot,
                        num_segments=CB) > 0

                    # merge into per-slot carry (lexicographic dd compare)
                    carry_valid = jnp.isfinite(cc.vh)
                    llt = (mh < cc.vh) | ((mh == cc.vh) & (ml < cc.vl))
                    leq = (mh == cc.vh) & (ml == cc.vl)
                    better = have & (~carry_valid | llt)
                    better_key = have & carry_valid & leq & (ckey < cc.key)
                    take = better | better_key
                    sig_eq_c = (cd2 == cc.d2) & (cmg == cc.mg)
                    dapx = (mh + ml) - (cc.vh + cc.vl)
                    cross_near = have & carry_valid & (
                        jnp.abs(dapx) <= jnp.maximum(
                            tie_margin * jnp.maximum(jnp.abs(cc.vh),
                                                     np.float32(1.0)),
                            np.float32(1e-7)))
                    unc_cross = cross_near & ~(leq & sig_eq_c)
                    sel = lambda a, b: jnp.where(take, a, b)
                    return CC(
                        ci=cc.ci + 1,
                        vh=sel(mh, cc.vh), vl=sel(ml, cc.vl),
                        key=sel(ckey, cc.key),
                        row=sel(crow, cc.row),
                        d2=sel(cd2, cc.d2), mg=sel(cmg, cc.mg),
                        unc=cc.unc | o_unc | unc_cross,
                    )

                init = CC(ci=jnp.zeros((), jnp.int32),
                          vh=jnp.full(CB, pos_inf),
                          vl=jnp.full(CB, pos_inf),
                          key=jnp.full(CB, BIGKEY),
                          row=jnp.full(CB, NB, jnp.int32),
                          d2=jnp.zeros(CB, jnp.int32),
                          mg=jnp.zeros(CB, jnp.int64),
                          unc=jnp.zeros(CB, bool))
                nsteps = (off_hi - off_lo + 1) * NCHUNK
                cc = jax.lax.while_loop(lambda c: c.ci < nsteps, off_body,
                                        init)
                return cc.row, (cc.unc & st.alivec).any()

            def recenter(st, off_lo: int, off_hi: int):
                keepbits, mcnt, r, s_floor, unc1, pairs = \
                    filter_mean(st, off_lo, off_hi)
                best_row, unc2 = closest(st, off_lo, off_hi, keepbits, r,
                                         s_floor)
                return best_row, mcnt, unc1 | unc2, pairs

            def merge_pass(st):
                """Merge decisions + sequential absorb replay."""
                rank, inv, Ctot = ranks(st.alivec)
                slots = np.arange(CB, dtype=np.int32)

                class MC(NamedTuple):
                    q: jnp.ndarray
                    any: jnp.ndarray    # [NB]
                    bh: jnp.ndarray
                    bl: jnp.ndarray
                    berr: jnp.ndarray   # [NB] best's absolute dist error
                    bj: jnp.ndarray     # [NB] best candidate slot
                    sig: tuple          # candidate center-row signature
                    unc: jnp.ndarray
                    pairs: jnp.ndarray

                def q_body(mc: MC):
                    tq = rank + mc.q
                    tvalid = st.alivec & (tq < Ctot)
                    j_slot = inv[jnp.clip(tq, 0, CB - 1)]
                    ci = st.cen[slots]
                    cj = st.cen[j_slot]
                    lp = tvalid & (S["lens"][cj] >= S["blen"][ci]) \
                        & (S["lens"][cj] <= S["elen"][ci])
                    pairs = mc.pairs + lp.sum(dtype=jnp.int64)
                    s_dd, dist_dd, s_err, dist_err = self._score_rows(
                        jax, jnp, S, cj, ci)
                    inb, bunc = self._band_device(jnp, s_dd, s_err,
                                                  self.band1)
                    res1 = lp & inb
                    unc = mc.unc | (lp & bunc & st.alivec)
                    vh = jnp.where(res1, dist_dd[0], neg_inf)
                    vl = jnp.where(res1, dist_dd[1], neg_inf)
                    # later candidate wins ties: replace on >= (dd-lex)
                    carry_valid = mc.any
                    gt = (vh > mc.bh) | ((vh == mc.bh) & (vl > mc.bl))
                    eq = (vh == mc.bh) & (vl == mc.bl)
                    take = res1 & (~carry_valid | gt | eq)
                    sig = (cj,)
                    sig_eq = sig[0] == mc.sig[0]
                    dapx = (vh + vl) - (mc.bh + mc.bl)
                    thr = jnp.maximum(
                        8 * (dist_err + mc.berr),
                        tie_margin * jnp.maximum(jnp.abs(mc.bh),
                                                 np.float32(1.0)))
                    near = res1 & carry_valid & (jnp.abs(dapx) <= thr)
                    unc = unc | (near & ~(eq & sig_eq))
                    sel = lambda a, b: jnp.where(take, a, b)
                    return MC(
                        q=mc.q + 1,
                        any=mc.any | res1,
                        bh=sel(vh, mc.bh), bl=sel(vl, mc.bl),
                        berr=sel(dist_err, mc.berr),
                        bj=sel(j_slot, mc.bj),
                        sig=(sel(sig[0], mc.sig[0]),),
                        unc=unc, pairs=pairs,
                    )

                init = MC(q=jnp.ones((), jnp.int32),
                          any=jnp.zeros(CB, bool),
                          bh=jnp.full(CB, neg_inf),
                          bl=jnp.full(CB, neg_inf),
                          berr=jnp.zeros(CB, jnp.float32),
                          bj=jnp.full(CB, CB, jnp.int32),
                          sig=(jnp.full(CB, -1, jnp.int32),),
                          unc=jnp.zeros(CB, bool),
                          pairs=jnp.zeros((), jnp.int64))
                mc = jax.lax.while_loop(lambda c: c.q <= delta, q_body,
                                        init)
                t_dst = jnp.where(mc.any & st.alivec, mc.bj,
                                  np.int32(CB))
                unc = (mc.unc & st.alivec).any()

                # sequential replay over merge EVENTS (ascending slot ==
                # ascending rank; a destination j > i is never yet deleted)
                class RP(NamedTuple):
                    assign: jnp.ndarray
                    seq: jnp.ndarray
                    clen: jnp.ndarray
                    alivec: jnp.ndarray
                    pending: jnp.ndarray

                def rp_body(rp: RP):
                    src = jnp.argmax(rp.pending).astype(jnp.int32)
                    dst = t_dst[src]
                    m = rp.assign == src
                    seq = jnp.where(m, rp.seq + rp.clen[dst], rp.seq)
                    assign = jnp.where(m, dst, rp.assign)
                    clen = rp.clen.at[dst].add(rp.clen[src])
                    clen = clen.at[src].set(0)
                    return RP(assign=assign, seq=seq, clen=clen,
                              alivec=rp.alivec.at[src].set(False),
                              pending=rp.pending.at[src].set(False))

                rp = jax.lax.while_loop(
                    lambda r_: r_.pending.any(), rp_body,
                    RP(assign=st.assign, seq=st.seq, clen=st.clen,
                       alivec=st.alivec,
                       pending=st.alivec & (t_dst < CB)))
                return st._replace(assign=rp.assign, seq=rp.seq,
                                   clen=rp.clen, alivec=rp.alivec), \
                    unc, mc.pairs

            def iteration(st: St):
                best_row, mcnt, unc1, pairs1 = recenter(st, 0, 2 * delta)
                # kept-empty + delta>0: center unchanged
                new_cen = jnp.where(
                    st.alivec & (mcnt > 0) & (best_row < NB),
                    jnp.minimum(best_row, NB - 1), st.cen)
                st2 = st._replace(cen=new_cen)
                st3, unc2, pairs2 = merge_pass(st2)
                newC = st3.alivec.sum(dtype=jnp.int32)
                st3 = st3._replace(
                    hist=st3.hist.at[st.it].set(newC),
                    it=st.it + 1,
                    pairs=st.pairs + pairs1 + pairs2,
                )
                return st3, unc1 | unc2

            def body(st: St):
                prevC = st.alivec.sum(dtype=jnp.int32)
                stop = (st.it >= 3) & (
                    prevC == st.hist[jnp.maximum(st.it - 3, 0)])
                stop = stop | (st.it >= ITER)
                # segment budget (seg_iters): long phases run as bounded
                # segments; abort=3 = "segment boundary", the host
                # relaunches from the carried state
                seg_end = (st.it - it0) >= seg

                def run_iter(st):
                    st2, unc = iteration(st)
                    return jax.lax.cond(
                        unc,
                        lambda s: s[0]._replace(abort=np.int32(1),
                                                done=np.bool_(True)),
                        lambda s: s[1],
                        (st, st2),
                    )

                return jax.lax.cond(
                    stop,
                    lambda s: s._replace(done=np.bool_(True)),
                    lambda s: jax.lax.cond(
                        seg_end,
                        lambda z: z._replace(abort=np.int32(3),
                                             done=np.bool_(True)),
                        run_iter,
                        s,
                    ),
                    st,
                )

            st = St(
                assign=assign0, seq=seq0, cen=cen0, alivec=alivec0,
                clen=clen0,
                hist=hist0,
                it=it0.astype(jnp.int32),
                done=jnp.zeros((), bool),
                abort=jnp.zeros((), jnp.int32),
                pairs=jnp.zeros((), jnp.int64),
            )
            st = jax.lax.while_loop(lambda s: ~s.done, body, st)

            def final_pass(st: St):
                best_row, mcnt, unc, pairs = recenter(st, delta, delta)
                # kept-empty + delta==0: members[0] = the seq==0 row
                fm = jnp.zeros(CB, jnp.int32).at[
                    jnp.where(valid_row & (st.seq == 0), st.assign,
                              np.int32(CB))
                ].set(np.arange(NB, dtype=np.int32), mode="drop")
                new_cen = jnp.where(
                    st.alivec,
                    jnp.where((mcnt > 0) & (best_row < NB),
                              jnp.minimum(best_row, NB - 1), fm),
                    st.cen)
                st2 = st._replace(cen=new_cen,
                                  pairs=st.pairs + pairs)
                return jax.lax.cond(
                    unc,
                    lambda s: s[0]._replace(abort=np.int32(2)),
                    lambda s: s[1],
                    (st, st2),
                )

            st = jax.lax.cond(
                st.abort == 0, final_pass, lambda s: s, st)
            # ONE packed i64 output (one fetch round trip, see device_loop):
            #   [0:3]               abort, it, pairs
            #   [3:3+ITER]          hist
            #   [HDR:HDR+NB]        per-row: assign<<32 | seq
            #   [HDR+NB:HDR+NB+CB]  per-slot: cen<<32 | clen<<1 | alivec
            i64 = lambda v: v.astype(jnp.int64)
            head = jnp.concatenate([
                jnp.stack([i64(st.abort), i64(st.it), st.pairs]),
                i64(st.hist)])
            rowp = (i64(st.assign) << 32) | i64(st.seq)
            slotp = (i64(st.cen) << 32) | (i64(st.clen) << 1) \
                | i64(st.alivec)
            return jnp.concatenate([head, rowp, slotp])

        return program

    # -- host API ---------------------------------------------------------------

    def _store_arrays(self):
        if getattr(self, "_S", None) is None:
            self._S = {
                "counts": self.store.counts, "mags": self.store.mags,
                "selfdot": self.store.selfdot, "lens": self.store.lens,
                "std_h": self.store.std_h, "std_l": self.store.std_l,
                "blen": self.store.blen, "elen": self.store.elen,
            }
        return self._S

    def _get_compiled(self, cb: int):
        import jax
        import jax.numpy as jnp

        got = self._compiled_by_cb.get(cb)
        if got is not None:
            return got
        if not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)
        S = self._store_arrays()
        NB = self.NB
        zr = jnp.zeros(NB, jnp.int32)
        zi = jnp.zeros(cb, jnp.int32)
        zb = jnp.zeros(cb, bool)
        prog = self._build(cb)
        compiled = jax.jit(prog).lower(
            S, zr, zr, zi, zb, zi, np.int32(0), np.int32(0),
            jnp.zeros(self.iterations, jnp.int32),
            np.int32(0)).compile()
        self._compiled_by_cb[cb] = compiled
        return compiled

    def ensure_ready(self) -> None:
        self._get_compiled(self.CB)

    def unpack(self, packed: np.ndarray, cb: int) -> PhaseResult:
        """PhaseResult from the program's single packed i64 output."""
        NB = self.NB
        ITER = self.iterations
        n = self.ps.n
        abort = int(packed[0])
        it = int(packed[1])
        pairs = int(packed[2])
        hist = packed[3:3 + ITER]
        HDR = 3 + ITER
        rowp = packed[HDR:HDR + NB][:n]
        assign = (rowp >> 32).astype(np.int64)
        seq = (rowp & 0xFFFFFFFF).astype(np.int64)
        slotp = packed[HDR + NB:HDR + NB + cb]
        cen = (slotp >> 32).astype(np.int64)
        clen = ((slotp >> 1) & 0x7FFFFFFF).astype(np.int64)
        alivec = (slotp & 1).astype(bool)

        # reconstruct clusters in slot (creation) order, members by seq
        order = np.lexsort((seq, assign))
        a_sorted = assign[order]
        slots = np.nonzero(alivec)[0]
        bounds = np.searchsorted(a_sorted, np.concatenate([slots, [cb]]))
        out = []
        for k, s in enumerate(slots):
            mem = order[bounds[k]:bounds[k + 1]]
            out.append((int(cen[s]), mem.tolist()))
            if len(mem) != int(clen[s]):  # pragma: no cover - invariant
                raise RuntimeError("device phase clen mismatch")
        return PhaseResult(abort=abort, it=it,
                           hist=[int(h) for h in hist[:it]],
                           clusters=out, pairs=pairs)

    def pick_cb(self, C0: int) -> Optional[int]:
        """Smallest usable slot bucket for C0 clusters (None = fall back)."""
        if C0 <= self.CB:
            return self.CB
        cb = _shape_bucket(C0)
        if cb > self.NB:
            return None
        try:
            self._check_cb(cb)
        except DeviceLoopUnsupported:
            return None
        return cb

    def init_arrays(self, clusters, cb: int):
        NB = self.NB
        assign0 = np.zeros(NB, np.int32)
        seq0 = np.zeros(NB, np.int32)
        cen0 = np.zeros(cb, np.int32)
        alivec0 = np.zeros(cb, bool)
        clen0 = np.zeros(cb, np.int32)
        for j, cl in enumerate(clusters):
            mem = np.asarray(cl.members, dtype=np.int64)
            assign0[mem] = j
            seq0[mem] = np.arange(len(mem), dtype=np.int32)
            cen0[j] = cl.center_row
            alivec0[j] = True
            clen0[j] = len(mem)
        return assign0, seq0, cen0, alivec0, clen0

    def run(self, clusters, it0: int = 0,
            hist0=None) -> Optional[PhaseResult]:
        """clusters: list of objects with .center_row / .members (natural
        rows, reference order).  Runs the phase in bounded segments (see
        seg_iters) until done/abort.  Returns a PhaseResult; None when the
        slot count exceeds every usable bucket."""
        import time as _time

        import jax.numpy as jnp

        cb = self.pick_cb(len(clusters))
        if cb is None:
            return None
        compiled = self._get_compiled(cb)
        seg = self.seg_iters()
        hist = np.zeros(self.iterations, np.int32)
        if hist0 is not None:
            hist[:len(hist0)] = hist0
        pairs = 0
        t0 = _time.time()
        while True:
            assign0, seq0, cen0, alivec0, clen0 = self.init_arrays(
                clusters, cb)
            res = compiled(
                self._store_arrays(), jnp.asarray(assign0),
                jnp.asarray(seq0), jnp.asarray(cen0), jnp.asarray(alivec0),
                jnp.asarray(clen0), np.int32(self.ps.n), np.int32(it0),
                jnp.asarray(hist), np.int32(seg))
            packed = np.asarray(res)    # one fetch per segment
            pr = self.unpack(packed, cb)
            pairs += pr.pairs
            if pr.abort != 3:
                self.last_exec_seconds = _time.time() - t0
                return pr._replace(pairs=pairs)
            # segment boundary: relaunch from the carried state
            from .engine import Cluster as _Cl

            clusters = [_Cl(center_row=c, members=list(m))
                        for c, m in pr.clusters]
            it0 = pr.it
            hist[:len(pr.hist)] = pr.hist
