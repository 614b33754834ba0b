"""Batched device (XLA) feature scoring.

The classifier's hot loop — score one center against a window of candidate
histograms (Trainer.cpp:22-71, the reference's OpenMP hot loop P6) — is
re-expressed as a single batched device computation over the [B, 4^k] block:

  - every selected single feature is computed from elementwise reductions
    and dot products over the block, which XLA fuses;
  - per-point reusable quantities (self dot products, log planes, grouped
    sums, rank planes, n2-normalized planes, d2s expectation planes) are
    precomputed once per dataset, turning many pairwise formulas into plain
    dots;
  - normalization, combo products, GLM weights and the logistic decision run
    as a tiny epilogue on device;
  - results come back as float32 plus a *margin*: candidates whose decision
    is within the margin of the rounding threshold are re-checked with the
    float64 host oracle, so fast-path scoring never changes a clustering
    decision relative to the exact semantics.

Batch shapes are padded to power-of-two buckets to bound XLA recompilation.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Dict, Sequence, Tuple

import numpy as np

from ..features import flags as F
from ..features import host as H
from ..kmer.counting import PointSet
from ..model.classifier import CompiledModel

# decisions closer than this to a rounding threshold get re-checked in f64
DEFAULT_PROB_MARGIN = 2e-4
# candidates whose dist is within this relative band of the max get
# re-ranked in f64
DEFAULT_DIST_REL_BAND = 1e-4

_BUCKETS = [64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072]


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return int(2 ** math.ceil(math.log2(n)))


class DeviceFeatureEngine:
    """Per-dataset device state + jitted pairwise singles computation for a
    static tuple of single-feature flags."""

    def __init__(self, ps: PointSet, singles: Sequence[int]):
        import jax
        import jax.numpy as jnp

        self.jax = jax
        self.jnp = jnp
        self.ps = ps
        self.singles = tuple(singles)
        self.k = ps.k
        d = ps.dim
        self.d = d

        c = ps.counts.astype(np.float32)
        self.counts = jnp.asarray(c)
        self.mags = jnp.asarray(ps.mags.astype(np.float32))
        self.lengths = jnp.asarray(ps.lengths.astype(np.float32))
        self.stddevs = jnp.asarray(ps.stddevs.astype(np.float32))
        self.one_mers = jnp.asarray(ps.one_mers.astype(np.float32))
        self.real_mags = jnp.asarray((ps.mags - d).astype(np.float32))

        need = set(self.singles)
        self.planes: Dict[str, object] = {}

        if need & {F.FEAT_NORMALIZED_VECTORS, F.FEAT_SIMRATIO, F.FEAT_PEARSON_COEFF}:
            self.planes["self_dot"] = jnp.asarray(
                (c.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
            )
        if need & {F.FEAT_MARKOV, F.FEAT_SIM_MM}:
            logc = np.log(c)
            self.planes["log_counts"] = jnp.asarray(logc.astype(np.float32))
            g = c.reshape(ps.n, d // 4, 4).sum(axis=2)
            self.planes["group_sums"] = jnp.asarray(g.astype(np.float32))
            self.planes["log_group_sums"] = jnp.asarray(np.log(g).astype(np.float32))
            self.planes["sum_log_counts"] = jnp.asarray(
                logc.sum(axis=1).astype(np.float32)
            )
            self.planes["sum_log_group"] = jnp.asarray(
                np.log(g).sum(axis=1).astype(np.float32)
            )
        if F.FEAT_SIM_MM in need:
            # markov(x, x) per point, for d_markov's denominator
            # (Feature.cpp:1429-1433)
            a = H.side_from_pointset(ps, np.arange(ps.n))
            self.planes["markov_self"] = jnp.asarray(
                H.markov(a, a).astype(np.float32)
            )
        if F.FEAT_SPEARMAN in need:
            ranks = H.tiedrank(ps.counts.astype(np.float64))
            e = (d + 1) / 2.0
            rdev = (ranks - e).astype(np.float32)
            self.planes["rank_dev"] = jnp.asarray(rdev)
            self.planes["rank_dev_ss"] = jnp.asarray(
                (rdev.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
            )
        for flag, name in ((F.FEAT_N2R, "n2r"), (F.FEAT_N2RC, "n2rc"), (F.FEAT_N2RRC, "n2rrc")):
            if flag in need:
                self.planes[name] = jnp.asarray(self._n2_plane(flag))
        if need & {F.FEAT_D2s, F.FEAT_D2_star}:
            ex, _ = H._expected_counts(H.side_from_pointset(ps, np.arange(ps.n)))
            self.planes["h_plane"] = jnp.asarray((c - ex).astype(np.float32))
        if F.FEAT_D2_star in need:
            # digit-count matrix: pq1 = exp(dig_count @ log combined 1-mer probs)
            digs = H.digit_matrix(self.k)
            dc = np.zeros((d, 4), dtype=np.float32)
            for b in range(4):
                dc[:, b] = (digs == b).sum(axis=1)
            self.planes["digit_count"] = jnp.asarray(dc)

        self._pair_fn = jax.jit(self._build_pair_fn())

    def _n2_plane(self, flag: int) -> np.ndarray:
        ps = self.ps
        c = ps.counts.astype(np.float64)
        if flag == F.FEAT_N2R:
            idx = H.reverse_index(ps.k)
            v = c + c[:, idx]
        elif flag == F.FEAT_N2RC:
            idx = H.reverse_complement_index(ps.k)
            v = c + c[:, idx]
        else:
            v = c + c[:, H.reverse_index(ps.k)] + c[:, H.reverse_complement_index(ps.k)]
        m = v.mean(axis=1, keepdims=True)
        s = np.sqrt(((v - m) ** 2).mean(axis=1, keepdims=True))
        z = (v - m) / s
        z = z / np.linalg.norm(z, axis=1, keepdims=True)
        return z.astype(np.float32)

    # ------------------------------------------------------------------

    def _build_pair_fn(self):
        jnp = self.jnp
        d = self.d
        singles = self.singles
        planes = self.planes

        def pair_singles(a_idx, b_idx):
            """a_idx, b_idx: int32 [B] -> [B, S] float32 raw singles with the
            reference's (a, b) argument-order semantics."""
            A = self.counts[a_idx]          # [B, D]
            Bc = self.counts[b_idx]
            magA = self.mags[a_idx]
            magB = self.mags[b_idx]
            outs = []

            # shared reductions, computed lazily once
            shared: Dict[str, object] = {}

            def get(key):
                if key in shared:
                    return shared[key]
                if key == "diff":
                    v = A - Bc
                elif key == "sum_min":
                    v = jnp.minimum(A, Bc).sum(axis=1)
                elif key == "sum_absdiff":
                    v = jnp.abs(get("diff")).sum(axis=1)
                elif key == "sum_sqdiff":
                    df = get("diff")
                    v = (df * df).sum(axis=1)
                elif key == "dot":
                    v = (A * Bc).sum(axis=1)
                elif key == "pp":
                    v = A / magA[:, None]
                elif key == "pq":
                    v = Bc / magB[:, None]
                shared[key] = v
                return v

            for flag in singles:
                if flag == F.FEAT_HELLINGER:
                    ap = magA / d
                    aq = magB / d
                    df = jnp.sqrt(A / ap[:, None]) - jnp.sqrt(Bc / aq[:, None])
                    outs.append(jnp.sqrt(2 * (df * df).sum(axis=1)))
                elif flag == F.FEAT_MANHATTAN:
                    outs.append(get("sum_absdiff"))
                elif flag == F.FEAT_EUCLIDEAN:
                    outs.append(jnp.sqrt(get("sum_sqdiff")))
                elif flag == F.FEAT_CHI_SQUARED:
                    df = get("diff")
                    outs.append((df * df / (A + Bc)).sum(axis=1))
                elif flag == F.FEAT_NORMALIZED_VECTORS:
                    da = planes["self_dot"][a_idx]
                    db = planes["self_dot"][b_idx]
                    outs.append(get("dot") / jnp.sqrt(da * db))
                elif flag == F.FEAT_HARMONIC_MEAN:
                    outs.append(2 * (A * Bc / (A + Bc)).sum(axis=1))
                elif flag == F.FEAT_JEFFEREY_DIV:
                    pp, pq = get("pp"), get("pq")
                    outs.append(((pp - pq) * jnp.log(pp / pq)).sum(axis=1))
                elif flag == F.FEAT_K_DIV:
                    pp, pq = get("pp"), get("pq")
                    avg = 0.5 * (pp + pq)
                    outs.append((pp * jnp.log(pp / avg)).sum(axis=1))
                elif flag == F.FEAT_PEARSON_COEFF:
                    ap = magA / d
                    aq = magB / d
                    dot = get("dot") - d * ap * aq
                    na = planes["self_dot"][a_idx] - d * ap * ap
                    nb = planes["self_dot"][b_idx] - d * aq * aq
                    outs.append(dot / jnp.sqrt(na * nb))
                elif flag == F.FEAT_SQCHORD:
                    outs.append((A + Bc - 2 * jnp.sqrt(A * Bc)).sum(axis=1))
                elif flag == F.FEAT_KL_COND:
                    gp = A.reshape(-1, d // 4, 4)
                    gq = Bc.reshape(-1, d // 4, 4)
                    sp = gp.sum(axis=2, keepdims=True)
                    sq = gq.sum(axis=2, keepdims=True)
                    cp = gp / sp
                    cq = gq / sq
                    lg = jnp.log(cp / cq)
                    op = (sp[:, :, 0] * (cp * lg).sum(axis=2)).sum(axis=1)
                    oq = (sq[:, :, 0] * (-cq * lg).sum(axis=2)).sum(axis=1)
                    outs.append((op / magA + oq / magB) / 2)
                elif flag in (F.FEAT_MARKOV, F.FEAT_SIM_MM):
                    lpA = planes["log_counts"][a_idx]
                    lpB = planes["log_counts"][b_idx]
                    gA = planes["group_sums"][a_idx]
                    gB = planes["group_sums"][b_idx]
                    lgA = planes["log_group_sums"][a_idx]
                    lgB = planes["log_group_sums"][b_idx]
                    slA = planes["sum_log_counts"][a_idx]
                    slB = planes["sum_log_counts"][b_idx]
                    sgA = planes["sum_log_group"][a_idx]
                    sgB = planes["sum_log_group"][b_idx]
                    # markov(a,b) = 0.5 * [ sum (a-1)(log b - log gb) +
                    #                       sum (b-1)(log a - log ga) ]
                    t1 = (A * lpB).sum(axis=1) - slB - (gA * lgB).sum(axis=1) + 4 * sgB
                    t2 = (Bc * lpA).sum(axis=1) - slA - (gB * lgA).sum(axis=1) + 4 * sgA
                    mk = 0.5 * (t1 + t2)
                    if flag == F.FEAT_MARKOV:
                        outs.append(mk)
                    else:
                        msA = planes["markov_self"][a_idx]
                        msB = planes["markov_self"][b_idx]
                        rmA = self.real_mags[a_idx]
                        rmB = self.real_mags[b_idx]
                        dm_ab = jnp.log(mk / msB) / rmB
                        dm_ba = jnp.log(mk / msA) / rmA
                        outs.append(1 - jnp.exp(0.5 * (dm_ab + dm_ba)))
                elif flag == F.FEAT_INTERSECTION:
                    outs.append(2 * get("sum_min") / (magA + magB))
                elif flag == F.FEAT_RRE_K_R:
                    gp = A.reshape(-1, d // 4, 4)
                    gq = Bc.reshape(-1, d // 4, 4)
                    sp = gp.sum(axis=2, keepdims=True)
                    sq = gq.sum(axis=2, keepdims=True)
                    cp = gp / sp
                    cq = gq / sq
                    avg = 0.5 * (cp + cq)
                    op = (gp * jnp.log(cp / avg) / sp).sum(axis=(1, 2))
                    oq = (gq * jnp.log(cq / avg) / sq).sum(axis=(1, 2))
                    outs.append(0.5 * (op + oq))
                elif flag == F.FEAT_D2z:
                    ap = magA / d
                    aq = magB / d
                    dot = get("dot") - d * ap * aq
                    outs.append(dot / (self.stddevs[a_idx] * self.stddevs[b_idx]))
                elif flag == F.FEAT_EUCLIDEAN_Z:
                    sa = self.stddevs[a_idx][:, None]
                    sb = self.stddevs[b_idx][:, None]
                    pz = (A - (magA / d)[:, None]) / sa
                    qz = (Bc - (magB / d)[:, None]) / sb
                    df = pz - qz
                    outs.append(jnp.sqrt((df * df).sum(axis=1)))
                elif flag == F.FEAT_EMD:
                    cd = jnp.cumsum(get("diff"), axis=1)
                    outs.append(jnp.abs(cd).sum(axis=1))
                elif flag == F.FEAT_SPEARMAN:
                    ra = planes["rank_dev"][a_idx]
                    rb = planes["rank_dev"][b_idx]
                    cov = (ra * rb).sum(axis=1)
                    sp = planes["rank_dev_ss"][a_idx]
                    sq = planes["rank_dev_ss"][b_idx]
                    outs.append(1 - cov / (jnp.sqrt(sp) * jnp.sqrt(sq)))
                elif flag == F.FEAT_JACCARD:
                    hit = (A == Bc) & (A > 1)
                    outs.append(hit.sum(axis=1).astype(jnp.float32) / d)
                elif flag == F.FEAT_LENGTHD:
                    outs.append(jnp.abs(self.lengths[a_idx] - self.lengths[b_idx]))
                elif flag == F.FEAT_D2s:
                    hp = planes["h_plane"][a_idx]
                    hq = planes["h_plane"][b_idx]
                    denom = jnp.hypot(hp, hq)
                    outs.append(
                        jnp.where(denom != 0, hp * hq / jnp.where(denom == 0, 1.0, denom), 0.0).sum(axis=1)
                    )
                elif flag == F.FEAT_D2_star:
                    hp = planes["h_plane"][a_idx]
                    hq = planes["h_plane"][b_idx]
                    cm = (self.one_mers[a_idx] + self.one_mers[b_idx]) / (
                        (magA + magB)[:, None]
                    )
                    # product over index digits as a matmul in log space:
                    # pq1[i] = prod_j cm[digit_j(i)] = exp(digit_count @ log cm)
                    pq1 = jnp.exp(jnp.matmul(
                        planes["digit_count"], jnp.log(cm).T,
                        precision=self.jax.lax.Precision.HIGHEST)).T  # [B, D]
                    rm_sum = self.real_mags[a_idx] + self.real_mags[b_idx]
                    e = rm_sum[:, None] * pq1 + 1
                    pq_len = jnp.sqrt(self.real_mags[a_idx] * self.real_mags[b_idx])
                    denom = e * pq_len[:, None]
                    outs.append(
                        jnp.where(denom > 0, hp * hq / jnp.where(denom <= 0, 1.0, denom), 0.0).sum(axis=1)
                    )
                elif flag == F.FEAT_AFD:
                    # k must be 2 (Feature.cpp:1884-1888): 16 single-element groups
                    first_i = np.arange(d)
                    oa = self.one_mers[a_idx][:, first_i // 4]
                    ob = self.one_mers[b_idx][:, first_i // 4]
                    x = A / oa
                    y = Bc / ob
                    df = jnp.abs(x - y)
                    unsq = df * (1 + df) ** -14.0
                    outs.append((unsq * unsq).sum(axis=1))
                elif flag == F.FEAT_MISMATCH:
                    outs.append((A != Bc).sum(axis=1).astype(jnp.float32))
                elif flag == F.FEAT_CANBERRA:
                    outs.append((jnp.abs(get("diff")) / (A + Bc)).sum(axis=1))
                elif flag == F.FEAT_KULCZYNSKI1:
                    outs.append((jnp.abs(get("diff")) / jnp.minimum(A, Bc)).sum(axis=1))
                elif flag == F.FEAT_KULCZYNSKI2:
                    ap = magA / d
                    aq = magB / d
                    coeff = d * (ap + aq) / (2 * ap * aq)
                    outs.append(coeff * get("sum_min"))
                elif flag == F.FEAT_SIMRATIO:
                    outs.append(get("dot") / (get("dot") + jnp.sqrt(get("sum_sqdiff"))))
                elif flag == F.FEAT_JENSEN_SHANNON:
                    pp, pq = get("pp"), get("pq")
                    avg = 0.5 * (pp + pq)
                    s = pp * jnp.log(pp / avg) + pq * jnp.log(pq / avg)
                    outs.append(s.sum(axis=1) / 2)
                elif flag in (F.FEAT_N2R, F.FEAT_N2RC, F.FEAT_N2RRC):
                    name = {F.FEAT_N2R: "n2r", F.FEAT_N2RC: "n2rc", F.FEAT_N2RRC: "n2rrc"}[flag]
                    za = planes[name][a_idx]
                    zb = planes[name][b_idx]
                    outs.append((za * zb).sum(axis=1))
                else:
                    raise ValueError(f"feature {flag} has no device implementation")
            return jnp.stack(outs, axis=1)

        return pair_singles

    # largest single device batch: bounds the [B, D] float32 gather
    # intermediates (131072 x 65536 x 4B = 32 GB worst case at k=8, but
    # 0.5 GB at the common k=5) and caps compile-shape count
    MAX_DEVICE_BATCH = 1 << 17

    def singles_batch(self, a_rows: np.ndarray, b_rows: np.ndarray) -> np.ndarray:
        """Raw singles [B, S] float32 (numpy) for pairs (a_rows[i], b_rows[i]),
        padded internally to a bucket size and chunked to bound device
        memory."""
        jnp = self.jnp
        n = len(a_rows)
        cap = self.MAX_DEVICE_BATCH
        if n > cap:
            parts = [
                self.singles_batch(a_rows[s : s + cap], b_rows[s : s + cap])
                for s in range(0, n, cap)
            ]
            return np.concatenate(parts, axis=0)
        m = _bucket(n)
        a_pad = np.zeros(m, dtype=np.int32)
        b_pad = np.zeros(m, dtype=np.int32)
        a_pad[:n] = a_rows
        b_pad[:n] = b_rows
        out = self._pair_fn(jnp.asarray(a_pad), jnp.asarray(b_pad))
        return np.asarray(out)[:n]


class DeviceScorer:
    """Scorer protocol implementation over DeviceFeatureEngine with exact
    float64 rechecks on borderline decisions."""

    def __init__(
        self,
        ps: PointSet,
        model: CompiledModel,
        exact_recheck: bool = True,
        prob_margin: float = DEFAULT_PROB_MARGIN,
        dist_band: float = DEFAULT_DIST_REL_BAND,
    ):
        self.ps = ps
        self.model = model
        self.engine = DeviceFeatureEngine(ps, model.singles)
        self.exact_recheck = exact_recheck
        self.prob_margin = prob_margin
        self.dist_band = dist_band
        from ..cluster.engine import HostScorer

        self._host = HostScorer(ps, model)
        self.rechecked_pairs = 0
        self.scored_pairs = 0

    def score(self, a_rows, b_rows) -> Tuple[np.ndarray, np.ndarray]:
        a_rows = np.atleast_1d(np.asarray(a_rows))
        b_rows = np.atleast_1d(np.asarray(b_rows))
        if len(b_rows) == 1 and len(a_rows) > 1:
            b_rows = np.broadcast_to(b_rows, a_rows.shape)
        if len(a_rows) == 1 and len(b_rows) > 1:
            a_rows = np.broadcast_to(a_rows, b_rows.shape)
        raw = self.engine.singles_batch(a_rows, b_rows).astype(np.float64)
        _, prob, dist = self.model.decision_from_raw(raw)
        self.scored_pairs += len(a_rows)
        if self.exact_recheck:
            # borderline classification decisions (round at 0.5 / 1.5)
            frac = np.abs(prob - np.floor(prob) - 0.5)
            borderline = frac < self.prob_margin
            # near-argmax dist candidates: re-rank exactly so that argmax
            # matches the float64 semantics
            if len(dist):
                m = dist.max()
                tol = self.dist_band * max(abs(m), 1.0)
                near = dist >= m - tol
                # always include the argmax itself (near.any() is always
                # true): the contract is that the max VALUE is exact f64,
                # not just the arg — a lone near candidate was previously
                # skipped, leaving the f32-path value at the max
                if near.any():
                    borderline |= near
            idx = np.nonzero(borderline)[0]
            if len(idx):
                self.rechecked_pairs += len(idx)
                p2, d2 = self._host.score(a_rows[idx], b_rows[idx])
                prob[idx] = p2
                dist[idx] = d2
        return prob, dist
