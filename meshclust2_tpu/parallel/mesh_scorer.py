"""Multi-chip sharded scorer: the engine's Scorer protocol over a device
mesh.

Scores one replicated center against the WHOLE row-sharded histogram
matrix in a single shard_map step (rows stay device-local; no collective
is needed for the scores), then the host slices out the contiguous
candidate window the bvec asked for.  This is the at-scale formulation of
the reference's P6 window scan (SURVEY §2.8): when windows grow with N,
scoring all local rows per step costs the same dispatch and keeps every
chip busy; scores come back row-sharded and only the window slice is
materialized on host.

Exactness: device singles are float32 with the same borderline-recheck
discipline as DeviceScorer — decisions within a margin of the rounding
threshold, and near-argmax distances, are recomputed by the float64 host
oracle, so clustering decisions match the exact semantics.

Feature support matches the integer-statistics set
(cluster/device_loop.DD_DERIVABLE): the presets the default configs select
(manhattan, euclidean, intersection, kulczynski2, simratio,
normalized_vectors, pearson, d2z, euclidean_z, emd, lengthd).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np

from ..features import flags as F

MESH_SUPPORTED = frozenset({
    F.FEAT_MANHATTAN, F.FEAT_EUCLIDEAN, F.FEAT_INTERSECTION,
    F.FEAT_KULCZYNSKI2, F.FEAT_SIMRATIO, F.FEAT_NORMALIZED_VECTORS,
    F.FEAT_PEARSON_COEFF, F.FEAT_D2z, F.FEAT_EUCLIDEAN_Z, F.FEAT_EMD,
    F.FEAT_LENGTHD,
})


class MeshScorer:
    """Scorer over a 1-D data mesh; requires model singles in
    MESH_SUPPORTED (create() returns None otherwise)."""

    @classmethod
    def create(cls, ps, model, mesh=None, exact_recheck: bool = True):
        if not set(model.singles) <= MESH_SUPPORTED:
            return None
        return cls(ps, model, mesh=mesh, exact_recheck=exact_recheck)

    def __init__(self, ps, model, mesh=None, exact_recheck: bool = True,
                 prob_margin: float = 2e-4, dist_band: float = 1e-4):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .mesh import make_mesh

        self.ps = ps
        self.model = model
        self.mesh = mesh or make_mesh()
        self.axis = self.mesh.axis_names[0]
        self.n_dev = self.mesh.devices.size
        self.exact_recheck = exact_recheck
        self.prob_margin = prob_margin
        self.dist_band = dist_band

        d = ps.dim
        n = ps.n
        pad = (-n) % self.n_dev
        self.n_pad = n + pad

        def padded(arr, fill=0.0):
            a = np.asarray(arr, dtype=np.float32)
            if pad:
                shape = (pad,) + a.shape[1:]
                a = np.concatenate([a, np.full(shape, fill, a.dtype)])
            return a

        spec_rows = P(self.axis)
        spec_mat = P(self.axis, None)

        def shard(a, spec):
            return jax.device_put(jnp.asarray(a), NamedSharding(self.mesh, spec))

        counts = padded(ps.counts)
        self.counts = shard(counts, spec_mat)
        # padding rows get mag 1 to avoid 0/0 in the epilogue
        self.mags = shard(padded(ps.mags, fill=float(d)), spec_rows)
        self.lengths = shard(padded(ps.lengths), spec_rows)
        self.stddevs = shard(padded(ps.stddevs, fill=1.0), spec_rows)
        self_dots = np.einsum(
            "ij,ij->i", counts.astype(np.float64), counts.astype(np.float64)
        ).astype(np.float32)
        self.self_dots = shard(self_dots, spec_rows)

        self._fn = self._build(d)
        self._pair_fn = self._build_pairs(d)
        from ..cluster.engine import HostScorer

        self._host = HostScorer(ps, model)
        self.scored_pairs = 0
        self.rechecked_pairs = 0

    # mixed-center batches replicate their unique rows on every device;
    # bound that working set (merge batches reference only center rows, so
    # this covers them at any realistic scale)
    MAX_PAIR_UNIQUE_ROWS = 1 << 14

    # ------------------------------------------------------------------

    def _singles_epilogue(self, d: int):
        """Shared singles + decision epilogue; `pairwise` selects whether
        the second side is one replicated center row or a per-pair batch."""
        import jax.numpy as jnp

        model = self.model
        singles = model.singles
        bias = float(getattr(model, "bias", 0.0))
        w = jnp.asarray(model.weights, dtype=jnp.float32)
        mn = jnp.asarray(model.mins, dtype=jnp.float32)
        mx = jnp.asarray(model.maxs, dtype=jnp.float32)
        sim = jnp.asarray(model.is_sim)
        combo_spec = tuple(
            (kind, tuple(idxs)) for kind, idxs in model.combos
        )

        def base(H, mg, ln, sd, sdot, center, c_mg, c_ln, c_sd, c_sdot,
                 pairwise=False):
            cb = center if pairwise else center[None, :]
            outs = []
            summin = jnp.minimum(H, cb).sum(axis=1)
            diff = H - cb
            dot = (H * cb).sum(axis=1)
            for flag in singles:
                if flag == F.FEAT_MANHATTAN:
                    outs.append(jnp.abs(diff).sum(axis=1))
                elif flag == F.FEAT_EUCLIDEAN:
                    outs.append(jnp.sqrt((diff * diff).sum(axis=1)))
                elif flag == F.FEAT_INTERSECTION:
                    outs.append(2 * summin / (mg + c_mg))
                elif flag == F.FEAT_KULCZYNSKI2:
                    ap = mg / d
                    aq = c_mg / d
                    outs.append(d * (ap + aq) / (2 * ap * aq) * summin)
                elif flag == F.FEAT_SIMRATIO:
                    nrm = jnp.sqrt((diff * diff).sum(axis=1))
                    outs.append(dot / (dot + nrm))
                elif flag == F.FEAT_NORMALIZED_VECTORS:
                    outs.append(dot / jnp.sqrt(sdot * c_sdot))
                elif flag == F.FEAT_PEARSON_COEFF:
                    ap = mg / d
                    aq = c_mg / d
                    cov = dot - d * ap * aq
                    na = sdot - d * ap * ap
                    nb = c_sdot - d * aq * aq
                    outs.append(cov / jnp.sqrt(na * nb))
                elif flag == F.FEAT_D2z:
                    ap = mg / d
                    aq = c_mg / d
                    outs.append((dot - d * ap * aq) / (sd * c_sd))
                elif flag == F.FEAT_EUCLIDEAN_Z:
                    ap = mg / d
                    aq = c_mg / d
                    na = (sdot - d * ap * ap) / (sd * sd)
                    nb = (c_sdot - d * aq * aq) / (c_sd * c_sd)
                    dz = (dot - d * ap * aq) / (sd * c_sd)
                    outs.append(jnp.sqrt(na + nb - 2 * dz))
                elif flag == F.FEAT_EMD:
                    outs.append(jnp.abs(jnp.cumsum(diff, axis=1)).sum(axis=1))
                elif flag == F.FEAT_LENGTHD:
                    outs.append(jnp.abs(ln - c_ln))
                else:  # pragma: no cover - filtered in create()
                    raise ValueError(flag)
            raw = jnp.stack(outs, axis=1)
            v = (raw - mn[None, :]) / (mx - mn)[None, :]
            v = jnp.where(sim[None, :], v, 1.0 - v)
            cols = []
            for kind, idxs in combo_spec:
                if kind == "xy":
                    c = jnp.prod(v[:, list(idxs)], axis=1)
                elif kind == "x2y2":
                    c = jnp.prod(v[:, list(idxs)] ** 2, axis=1)
                elif kind == "xy2":
                    c = v[:, idxs[0]] * v[:, idxs[1]] ** 2
                else:
                    c = v[:, idxs[0]] ** 2 * v[:, idxs[1]]
                cols.append(c)
            combo = jnp.stack(cols, axis=1)
            s = w[0] + jnp.matmul(combo, w[1:], precision="highest")
            # logistic(s) + bias (Predictor.cpp:310-320 — the --bias knob;
            # omitting it silently flips decisions under -b)
            prob = 1.0 / (1.0 + jnp.exp(-s)) + jnp.float32(bias)
            return prob, combo[:, 0]

        return base

    def _build(self, d: int):
        import jax
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        axis = self.axis
        base = self._singles_epilogue(d)

        def singles_fn(H, mg, ln, sd, sdot, center, c_mg, c_ln, c_sd, c_sdot):
            return base(H, mg, ln, sd, sdot, center, c_mg, c_ln, c_sd,
                        c_sdot, pairwise=False)

        fn = shard_map(
            singles_fn,
            mesh=self.mesh,
            in_specs=(P(axis, None), P(axis), P(axis), P(axis), P(axis),
                      P(), P(), P(), P(), P()),
            out_specs=(P(axis), P(axis)),
        )
        return jax.jit(fn)

    def _build_pairs(self, d: int):
        """Pair-sharded kernel for mixed-center batches (the merge pass,
        Trainer.cpp:73-109): unique rows replicated, pair indices sharded
        over the mesh — every chip scores its pair slice, no collective.
        Every MESH_SUPPORTED single is symmetric, so (a, b) order does not
        matter here."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        axis = self.axis
        base = self._singles_epilogue(d)

        def pair_fn(rows_mat, mg, ln, sd, sdot, a_idx, b_idx):
            H = rows_mat[a_idx]
            center_side = rows_mat[b_idx]
            return base(
                H, mg[a_idx], ln[a_idx], sd[a_idx], sdot[a_idx],
                center_side, mg[b_idx], ln[b_idx], sd[b_idx], sdot[b_idx],
                pairwise=True,
            )

        fn = shard_map(
            pair_fn,
            mesh=self.mesh,
            in_specs=(P(), P(), P(), P(), P(), P(axis), P(axis)),
            out_specs=(P(axis), P(axis)),
        )
        return jax.jit(fn)

    def _score_pairs_sharded(self, a_rows, b_rows):
        import jax.numpy as jnp

        uniq, inv = np.unique(
            np.concatenate([a_rows, b_rows]), return_inverse=True)
        n = len(a_rows)
        a_loc = inv[:n].astype(np.int32)
        b_loc = inv[n:].astype(np.int32)
        pad = (-n) % self.n_dev
        if pad:
            a_loc = np.concatenate([a_loc, np.zeros(pad, np.int32)])
            b_loc = np.concatenate([b_loc, np.zeros(pad, np.int32)])
        ps = self.ps
        rows_mat = jnp.asarray(ps.counts[uniq].astype(np.float32))
        mg = jnp.asarray(ps.mags[uniq].astype(np.float32))
        ln = jnp.asarray(ps.lengths[uniq].astype(np.float32))
        sd = jnp.asarray(ps.stddevs[uniq].astype(np.float32))
        c64 = ps.counts[uniq].astype(np.float64)
        sdot = jnp.asarray(np.einsum("ij,ij->i", c64, c64).astype(np.float32))
        prob, dist = self._pair_fn(rows_mat, mg, ln, sd, sdot,
                                   jnp.asarray(a_loc), jnp.asarray(b_loc))
        return (np.asarray(prob)[:n].astype(np.float64),
                np.asarray(dist)[:n].astype(np.float64))

    # ------------------------------------------------------------------

    def score_center_all(self, center_row: int) -> Tuple[np.ndarray, np.ndarray]:
        """(prob, dist) of EVERY row vs the center, computed sharded."""
        import jax.numpy as jnp

        c = int(center_row)
        center = self.counts[c]
        prob, dist = self._fn(
            self.counts, self.mags, self.lengths, self.stddevs, self.self_dots,
            center, self.mags[c], self.lengths[c], self.stddevs[c],
            self.self_dots[c],
        )
        return (np.asarray(prob)[: self.ps.n].astype(np.float64),
                np.asarray(dist)[: self.ps.n].astype(np.float64))

    def score(self, a_rows, b_rows) -> Tuple[np.ndarray, np.ndarray]:
        """Scorer-protocol entry: requires a constant b (the center)."""
        a_rows = np.atleast_1d(np.asarray(a_rows))
        b_rows = np.atleast_1d(np.asarray(b_rows))
        if len(b_rows) == 1:
            b_rows = np.broadcast_to(b_rows, a_rows.shape)
        if len(a_rows) == 1:
            a_rows = np.broadcast_to(a_rows, b_rows.shape)
        if not (b_rows == b_rows[0]).all():
            # mixed-center batches (the merge pass): pair-sharded over the
            # mesh with the unique rows replicated; falls back to the host
            # oracle only beyond the replication bound
            uniq = np.unique(np.concatenate([a_rows, b_rows]))
            if len(uniq) > self.MAX_PAIR_UNIQUE_ROWS:
                return self._host.score(a_rows, b_rows)
            prob, dist = self._score_pairs_sharded(a_rows, b_rows)
            self.scored_pairs += len(a_rows)
            if self.exact_recheck:
                frac = np.abs(prob - np.floor(prob) - 0.5)
                borderline = frac < self.prob_margin
                idx = np.nonzero(borderline)[0]
                if len(idx):
                    self.rechecked_pairs += len(idx)
                    p2, d2 = self._host.score(a_rows[idx], b_rows[idx])
                    prob[idx] = p2
                    dist[idx] = d2
            return prob, dist
        prob_all, dist_all = self.score_center_all(int(b_rows[0]))
        prob = prob_all[a_rows].copy()
        dist = dist_all[a_rows].copy()
        self.scored_pairs += len(a_rows)
        if self.exact_recheck:
            frac = np.abs(prob - np.floor(prob) - 0.5)
            borderline = frac < self.prob_margin
            if len(dist):
                m = dist.max()
                tol = self.dist_band * max(abs(m), 1.0)
                near = dist >= m - tol
                if near.sum() > 1:
                    borderline |= near
            idx = np.nonzero(borderline)[0]
            if len(idx):
                self.rechecked_pairs += len(idx)
                p2, d2 = self._host.score(a_rows[idx], b_rows[idx])
                prob[idx] = p2
                dist[idx] = d2
        return prob, dist
