"""Multi-process (multi-host) data-parallel clustering runtime.

The reference scales with OpenMP threads on one node (CRunner.cpp:407-422);
the equivalent here is SPMD over a device mesh (SCALING.md):

  - `jax.distributed.initialize()` forms the global runtime (env-driven:
    MC2_COORD, MC2_NPROCS, MC2_PROC_ID — or the platform's defaults);
  - IO splits by contiguous record blocks: every process streams the FASTA
    (headers are cheap), but parses/encodes/counts ONLY its own block;
  - small per-row metadata (lengths, mags, stddevs, one-mers) is
    all-gathered — the "all-gathered length vector" of the design — while
    the [N, 4^k] count matrix exists only as a row-sharded global device
    array assembled with make_array_from_process_local_data and re-ordered
    to the global sort permutation by a sharded take (XLA inserts the
    all-to-all);
  - every process runs the SAME deterministic host control flow (the
    mean-shift engine); scoring goes through the sharded mesh kernels, so
    all processes see identical replicated scores and take identical
    branches — process 0 alone writes the CLSTR;
  - the handful of host-exact computations (borderline f64 rechecks,
    closest-to-mean) fetch just the rows they need from the sharded matrix
    (engine.row_fetcher), keeping host memory O(window), not O(N * 4^k).
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..features import host as H
from ..kmer.counting import PointSet, build_point_set
from .mesh_scorer import MeshScorer


def distributed_args(environ=os.environ) -> Optional[dict]:
    """jax.distributed.initialize arguments from MC2_NPROCS / MC2_PROC_ID /
    MC2_COORD; None for a single process (which drives every local device).

    One process per host is the layout: on one GPU host, one process
    drives all of its cards.  When several processes do share a host (a
    localhost coordinator), each one opens only the card with its own
    process id, so no two processes open the same card."""
    nprocs = int(environ.get("MC2_NPROCS", "1"))
    if nprocs <= 1:
        return None
    coord = environ.get("MC2_COORD", "localhost:9731")
    pid = int(environ["MC2_PROC_ID"])
    args = dict(coordinator_address=coord, num_processes=nprocs,
                process_id=pid)
    if coord.rsplit(":", 1)[0] in ("localhost", "127.0.0.1", "[::1]"):
        args["local_device_ids"] = [pid]
    return args


def initialize_from_env() -> tuple:
    """(process_id, num_processes); single-process when MC2_NPROCS unset."""
    args = distributed_args()
    if args is None:
        return 0, 1
    import jax

    jax.distributed.initialize(**args)
    return args["process_id"], args["num_processes"]


def _stream_records(files: List[str]):
    from ..io.fasta import iter_fasta

    for f in files:
        for header, seq in iter_fasta(f):
            yield header, seq


def load_points_multihost(files: List[str], k: int, datatype: str,
                          process_id: int, num_processes: int):
    """Block-parallel load: returns (meta PointSet with counts=None,
    local_block PointSet, block bounds).  Rows are in global file order;
    sorting happens after the global array is assembled."""
    from ..io.fasta import encode_sequence

    headers: List[str] = []
    raw: List[tuple] = []
    for header, seq in _stream_records(files):
        headers.append(header)
        raw.append((header, seq))
    n = len(headers)
    lo = process_id * n // num_processes
    hi = (process_id + 1) * n // num_processes
    records = [encode_sequence(h, s) for h, s in raw[lo:hi]]
    local = build_point_set(records, k, datatype)
    return headers, local, (lo, hi, n)


class _MetaPS:
    """PointSet-shaped metadata without the count matrix (counts stay
    sharded on device; engine.row_fetcher serves host needs)."""

    def __init__(self, k, headers, lengths, mags, stddevs, one_mers, dim):
        self.k = k
        self.headers = headers
        self.lengths = lengths
        self.mags = mags
        self.stddevs = stddevs
        self.one_mers = one_mers
        self.counts = None
        self.seqs = None
        self._dim = dim

    @property
    def n(self):
        return len(self.headers)

    @property
    def dim(self):
        return self._dim


class FetchOracle:
    """Float64 host oracle over fetched rows (the recheck seam for
    borderline decisions when no process holds the full matrix)."""

    def __init__(self, meta: _MetaPS, model, fetch):
        self.meta = meta
        self.model = model
        self.fetch = fetch

    def _side(self, rows):
        rows = np.asarray(rows)
        return H.PairSide(
            counts=self.fetch(rows).astype(np.float64),
            mags=self.meta.mags[rows].astype(np.float64),
            one_mers=self.meta.one_mers[rows].astype(np.float64),
            stddevs=self.meta.stddevs[rows],
            lengths=self.meta.lengths[rows].astype(np.float64),
            k=self.meta.k,
        )

    def score(self, a_rows, b_rows):
        a_rows = np.atleast_1d(np.asarray(a_rows))
        b_rows = np.atleast_1d(np.asarray(b_rows))
        if len(b_rows) == 1 and len(a_rows) > 1:
            b_rows = np.broadcast_to(b_rows, a_rows.shape)
        if len(a_rows) == 1 and len(b_rows) > 1:
            a_rows = np.broadcast_to(a_rows, b_rows.shape)
        return self.model.score(self._side(a_rows), self._side(b_rows))


class MultihostScorer(MeshScorer):
    """MeshScorer over a pre-assembled global sharded count matrix."""

    def __init__(self, meta: _MetaPS, model, mesh, global_counts, fetch):
        # deliberately NOT calling super().__init__ — arrays are already
        # global/sharded; reuse the kernels and score() protocol.
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.ps = meta
        self.model = model
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_dev = mesh.devices.size
        self.exact_recheck = True
        self.prob_margin = 2e-4
        self.dist_band = 1e-4
        self._fetch = fetch

        n = meta.n
        pad = (-n) % self.n_dev
        self.n_pad = n + pad
        d = meta.dim

        # counts are already device-global; metadata is host-replicated
        self.counts = global_counts.astype(jnp.float32)

        def padded(arr, fill=0.0):
            a = np.asarray(arr, dtype=np.float32)
            if pad:
                a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                               a.dtype)])
            return a

        self.mags = self._to_global(padded(meta.mags, fill=float(d)),
                                    P(self.axis))
        self.lengths = self._to_global(padded(meta.lengths), P(self.axis))
        self.stddevs = self._to_global(padded(meta.stddevs, fill=1.0),
                                       P(self.axis))
        # self-dots from fetched rows would be O(N) traffic; compute on
        # device instead (f32 — used only inside the margin-checked kernel)
        import jax.numpy as jnp

        self.self_dots = (self.counts * self.counts).sum(axis=1)
        self._fn = self._build(d)
        self._pair_fn = self._build_pairs(d)
        self._host = FetchOracle(meta, model, fetch)
        self.scored_pairs = 0
        self.rechecked_pairs = 0

    def _to_global(self, arr, spec):
        """Host value -> global array under `spec` (every process passes its
        local portion; replicated specs take the full array)."""
        import jax
        import jax.numpy as jnp
        from jax.experimental import multihost_utils as mhu
        from jax.sharding import PartitionSpec as P

        if jax.process_count() == 1:
            from jax.sharding import NamedSharding

            return jax.device_put(jnp.asarray(arr),
                                  NamedSharding(self.mesh, spec))
        if all(x is None for x in tuple(spec)) or len(tuple(spec)) == 0:
            local = arr
        else:
            # 1-D row sharding: this process owns a contiguous slice
            G = self.mesh.devices.size
            rows = len(arr) // G
            gis = [i for i, dv in enumerate(self.mesh.devices.flat)
                   if dv.process_index == jax.process_index()]
            lo = min(gis) * rows
            hi = (max(gis) + 1) * rows
            local = arr[lo:hi]
        return mhu.host_local_array_to_global_array(local, self.mesh, spec)

    def _to_host(self, garr):
        """Global (possibly sharded) array -> full numpy on every host."""
        import jax
        from jax.experimental import multihost_utils as mhu

        if jax.process_count() == 1:
            return np.asarray(garr)
        return np.asarray(mhu.process_allgather(garr, tiled=True))

    def score_center_all(self, center_row: int):
        """Multihost override: a global sharded array is not fully
        addressable from one process, so the center row comes from the
        (replicated-output) fetch gather + host metadata, and sharded
        outputs are allgathered back to every host."""
        import jax.numpy as jnp

        c = int(center_row)
        meta = self.ps
        center_np = self._fetch([c])[0].astype(np.float32)
        from jax.sharding import PartitionSpec as P

        prob, dist = self._fn(
            self.counts, self.mags, self.lengths, self.stddevs,
            self.self_dots,
            self._to_global(center_np, P(None)),
            jnp.float32(meta.mags[c]),
            jnp.float32(meta.lengths[c]),
            jnp.float32(meta.stddevs[c]),
            jnp.float32(float((center_np.astype(np.float64) ** 2).sum())),
        )
        return (self._to_host(prob)[: meta.n].astype(np.float64),
                self._to_host(dist)[: meta.n].astype(np.float64))

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
        meta = self.ps
        from jax.sharding import PartitionSpec as P

        fetched = self._fetch(uniq)
        c64 = fetched.astype(np.float64)
        prob, dist = self._pair_fn(
            self._to_global(fetched.astype(np.float32), P(None, None)),
            self._to_global(meta.mags[uniq].astype(np.float32), P(None)),
            self._to_global(meta.lengths[uniq].astype(np.float32), P(None)),
            self._to_global(meta.stddevs[uniq].astype(np.float32), P(None)),
            self._to_global(
                np.einsum("ij,ij->i", c64, c64).astype(np.float32), P(None)),
            self._to_global(a_loc, P(self.axis)),
            self._to_global(b_loc, P(self.axis)),
        )
        return (self._to_host(prob)[:n].astype(np.float64),
                self._to_host(dist)[:n].astype(np.float64))


def build_global_points(files: List[str], k: int, datatype: str,
                        process_id: int, num_processes: int, mesh):
    """Assemble the globally-sorted sharded count matrix + host metadata.

    The IO split is derived FROM the sharding: each process encodes exactly
    the rows its devices' shards cover, so the per-device shard blocks can
    be placed with make_array_from_single_device_arrays without any
    cross-process shuffle.  Sort order matches cli.load_sorted_points
    (headers with C++ std::sort semantics, then lengths); the re-order of
    the sharded matrix is one jitted take (XLA inserts the all-to-all)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..io.fasta import encode_sequence

    headers: List[str] = []
    raw: List[str] = []
    for header, seq in _stream_records(files):
        headers.append(header)
        raw.append(seq)
    n = len(headers)
    d = 4**k
    axis = mesh.axis_names[0]
    devs = list(mesh.devices.flat)
    G = len(devs)
    npad = n + (-n) % G
    shard_rows = npad // G
    local_gis = [i for i, dv in enumerate(devs)
                 if dv.process_index == process_id]
    lo = min(g * shard_rows for g in local_gis)
    hi = min(max((g + 1) * shard_rows for g in local_gis), n)
    lo = min(lo, n)

    records = [encode_sequence(headers[i], raw[i]) for i in range(lo, hi)]
    local = build_point_set(records, k, datatype)

    # all-gather the small per-row metadata (the "length vector"): blocks
    # are disjoint, so a sum over zero-filled full-size arrays assembles
    # them exactly
    def assemble(arr, dtype):
        a = np.asarray(arr, dtype=np.float64)
        full = np.zeros((n,) + a.shape[1:], dtype=np.float64)
        full[lo:hi] = a
        if num_processes > 1:
            from jax.experimental import multihost_utils as mhu

            full = np.asarray(
                mhu.process_allgather(jnp.asarray(full))).sum(axis=0)
        return full.astype(dtype)

    lengths = assemble(local.lengths, np.int64)
    mags = assemble(local.mags, np.int64)
    stds = assemble(local.stddevs, np.float64)
    ones = assemble(local.one_mers, np.uint64)
    # per-row self-dots + global max count: the device-session store needs
    # them and no process holds the full matrix (values < 2^31, f64-exact)
    sdots = assemble(
        np.einsum("ij,ij->i", local.counts.astype(np.int64),
                  local.counts.astype(np.int64)).astype(np.float64),
        np.int64)
    maxc_l = np.array([int(local.counts.max()) if len(records) else 0],
                      dtype=np.int64)
    if num_processes > 1:
        from jax.experimental import multihost_utils as mhu

        maxc = int(np.asarray(
            mhu.process_allgather(jnp.asarray(maxc_l))).max())
    else:
        maxc = int(maxc_l[0])

    # the global sort permutation, computed identically on every process
    from ..native import sort_perm, sort_perm_strings

    p1 = np.asarray(sort_perm_strings(headers))
    p2 = np.asarray(sort_perm(np.asarray(lengths)[p1]))
    perm = p1[p2]

    sharding = NamedSharding(mesh, P(axis, None))
    if num_processes == 1:
        counts_pad = np.zeros((npad, d), dtype=local.counts.dtype)
        counts_pad[:n] = local.counts
        gcounts = jax.device_put(jnp.asarray(counts_pad), sharding)
    else:
        shards = []
        for g in local_gis:
            r0, r1 = g * shard_rows, (g + 1) * shard_rows
            blk = np.zeros((shard_rows, d), dtype=local.counts.dtype)
            s_, e_ = max(r0, lo), min(r1, hi)
            if e_ > s_:
                blk[s_ - r0:e_ - r0] = local.counts[s_ - lo:e_ - lo]
            shards.append(jax.device_put(jnp.asarray(blk), devs[g]))
        gcounts = jax.make_array_from_single_device_arrays(
            (npad, d), sharding, shards)

    perm_pad = np.concatenate(
        [perm, np.arange(n, npad)]).astype(np.int32)

    @jax.jit
    def reorder(c, p):
        out = jnp.take(c, p, axis=0)
        return jax.lax.with_sharding_constraint(
            out, NamedSharding(mesh, P(axis, None)))

    if num_processes == 1:
        perm_g = jax.device_put(jnp.asarray(perm_pad),
                                NamedSharding(mesh, P()))
    else:
        from jax.experimental import multihost_utils as mhu

        perm_g = mhu.host_local_array_to_global_array(perm_pad, mesh, P())
    gcounts = reorder(gcounts, perm_g)

    meta = _MetaPS(
        k=k,
        headers=[headers[i] for i in perm],
        lengths=lengths[perm],
        mags=mags[perm],
        stddevs=stds[perm],
        one_mers=ones[perm],
        dim=d,
    )
    meta.self_dots = sdots[perm]
    meta.maxc = maxc

    from jax.sharding import NamedSharding

    rep = NamedSharding(mesh, P())

    @jax.jit
    def take_rows(c, idx):
        out = jnp.take(c, idx, axis=0)
        return jax.lax.with_sharding_constraint(out, rep)

    def fetch(rows):
        rows = np.asarray(rows, dtype=np.int32)
        if num_processes == 1:
            return np.asarray(take_rows(gcounts, jnp.asarray(rows)))
        from jax.experimental import multihost_utils as mhu

        idx = mhu.host_local_array_to_global_array(rows, mesh, P())
        return np.asarray(mhu.process_allgather(
            take_rows(gcounts, idx), tiled=True))

    return meta, gcounts, fetch


def run_multihost(args) -> int:
    """CLI entry (meshclust2 --multihost): recover-path clustering with the
    model weights trained elsewhere (--recover) — training stays
    single-process (it is seconds of work on thousands of pairs)."""
    import jax

    pid, nprocs = initialize_from_env()
    if args.device == "gpu":
        from ..cli import require_device

        require_device()
    from .mesh import make_mesh
    from ..model.weights import load_weights
    from ..model.classifier import CompiledModel
    from ..cluster.engine import MeanShiftEngine
    from ..io.clstr import write_clstr
    from ..utils.clock import Clock

    clock = Clock()
    if not args.recover:
        print("--multihost requires --recover (train single-process first)",
              file=sys.stderr)
        return 2
    pred = load_weights(args.recover)
    model = CompiledModel(pred.classifier, bias=args.bias)
    mesh = make_mesh()
    meta, gcounts, fetch = build_global_points(
        args.files, pred.k, pred.datatype, pid, nprocs, mesh)
    shards = gcounts.addressable_shards
    print(f"multihost: {nprocs} process(es), {mesh.devices.size} "
          f"{jax.devices()[0].platform} devices; counts {gcounts.shape} "
          f"over {len(gcounts.sharding.device_set)} devices, "
          f"{len(shards)} local shards of {shards[0].data.shape[0]} rows")
    scorer = MultihostScorer(meta, model, mesh, gcounts, fetch)
    sim = pred.id_cutoff

    # the fast path IS the distributed path: the same device-session
    # combined program, GSPMD-sharded over the global mesh.  MultihostScorer remains the replicated-decision
    # fallback for aborts and for models outside the device envelope.
    session = None
    if not os.environ.get("MC2_NO_DEVICE_SESSION"):
        from ..cluster.device_loop import DeviceLoopUnsupported
        from .multihost_session import build_multihost_session

        try:
            session = build_multihost_session(
                meta, model, sim, mesh, gcounts, fetch,
                meta.self_dots, meta.maxc, args.delta, args.iterations)
            scorer.prefers_device_loop = True
        except DeviceLoopUnsupported as e:
            print(f"multihost device session unavailable ({e}); "
                  "per-window mesh scoring", file=sys.stderr)
    engine = MeanShiftEngine(meta, model, sim, scorer=scorer,
                             delta=args.delta, iterations=args.iterations,
                             device_session=session)
    engine.row_fetcher = fetch
    engine._host_oracle_cached = FetchOracle(meta, model, fetch)
    # the clustering window opens after device set-up, as in cli.main
    clock.stamp("read_in_points")
    clusters = engine.run()
    if pid == 0:
        write_clstr(args.output, engine.to_output(clusters))
    clock.stamp("done")
    return 0
