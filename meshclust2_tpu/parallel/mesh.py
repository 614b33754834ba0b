"""Multi-chip sharding: device mesh setup and the sharded compute steps.

The reference is a single-node OpenMP program (SURVEY §2.8); its
equivalent here shards the [N, 4^k] histogram matrix data-parallel across a
jax.sharding Mesh and expresses the cross-device reductions that the
algorithm needs as XLA collectives:

  - pairwise window/center scoring: rows sharded, centers replicated; no
    collective needed for the scores themselves (output stays row-sharded);
  - mean-shift center means: psum of masked local sums and counts;
  - closest-to-mean selection: local argmin + global min via psum-style
    reduction over the device axis;
  - GLM normal equations on sharded pair populations: X^T X and X^T y via
    psum, with the tiny solve replicated.

All functions here are pure and jittable; the mean-shift engine calls them
through shard_map over a 1-D "data" mesh (only all-reduce traffic, no
gathers of histogram data; every device reaches every other over NVLink,
so the mesh follows the algorithm alone).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np

# float32 matmuls that feed decisions and means ask for full f32 precision
# (the GPU would otherwise run them in TF32)
HIGHEST = "highest"


def make_mesh(n_devices: Optional[int] = None, axis: str = "data"):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def classify_kernel_factory(weights, mins, maxs, is_sim, combo_spec,
                            bias: float = 0.0):
    """Build a jittable epilogue: raw singles [B, S] -> (prob, dist) [B].

    combo_spec: tuple of (kind, idx tuple) per combo (model.combo_indices()).
    Mirrors the decision path Predictor.cpp:315-333 in float32.
    """
    import jax.numpy as jnp

    w = jnp.asarray(weights, dtype=jnp.float32)
    mn = jnp.asarray(mins, dtype=jnp.float32)
    mx = jnp.asarray(maxs, dtype=jnp.float32)
    sim = jnp.asarray(is_sim)

    def epilogue(raw):
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
            else:  # x2y
                c = v[:, idxs[0]] ** 2 * v[:, idxs[1]]
            cols.append(c)
        combo = jnp.stack(cols, axis=1)
        s = w[0] + jnp.matmul(combo, w[1:], precision=HIGHEST)
        # prob = logistic(s) + bias (Predictor.cpp:310-320 — the --bias knob)
        prob = 1.0 / (1.0 + jnp.exp(-s)) + jnp.float32(bias)
        return prob, combo[:, 0]

    return epilogue


def sharded_center_scores(mesh, singles_fn, epilogue, axis: str = "data"):
    """Returns a jitted fn: (H_shard_args..., center_args...) -> row-sharded
    (prob, dist).  singles_fn computes raw singles for local rows vs the
    replicated center."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(axis), P(axis)),
    )
    def fn(H_local, center):
        raw = singles_fn(H_local, center)
        return epilogue(raw)

    return jax.jit(fn)


def sharded_mean_update(mesh, axis: str = "data"):
    """Returns a jitted fn computing, per center, the member mean histogram
    and the member closest to it, with members row-sharded:

      (H_local [n_loc, D], mags_local [n_loc], member_mask [C, n_loc])
        -> (closest value [C], closest global row [C])

    Collectives: psum for sums/counts, psum-min trick for global argmin.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(None, axis), P(axis)),
        out_specs=(P(), P()),
    )
    def fn(H_local, mags_local, mask_local, global_rows_local):
        # member mean per center: psum(masked sum) / psum(count)
        sums = jax.lax.psum(
            jnp.matmul(mask_local, H_local, precision=HIGHEST), axis)  # [C, D]
        counts = jax.lax.psum(mask_local.sum(axis=1), axis)      # [C]
        top = sums / jnp.maximum(counts, 1.0)[:, None]
        # distance_d of each local member to its center's mean
        # (DivergencePoint.cpp:54-66, with the reference's truncating uint64
        # mag accumulation)
        r = jnp.floor(top + 0.5)                                  # [C, D]
        dist = 2.0 * jnp.minimum(H_local[None, :, :], r[:, None, :]).sum(-1)
        mag = jnp.trunc(H_local[None, :, :] + top[:, None, :]).sum(-1)
        frac = dist / mag
        d = 10000.0 * (1.0 - frac * frac)                         # [C, n_loc]
        d = jnp.where(mask_local > 0, d, jnp.inf)
        local_min = d.min(axis=1)
        local_arg = global_rows_local[d.argmin(axis=1)]
        # global argmin: min over devices, then the owning device's index.
        # Tie-break: smallest global row (the host engine breaks distance
        # ties by first member-list position instead; MeshScorer runs keep
        # re-centering on the host path, so this only affects direct users
        # of this collective).  Empty centers return -1 like the native
        # argmin kernel.
        gmin = jax.lax.pmin(local_min, axis)
        winner = jnp.where(local_min == gmin, local_arg, jnp.int32(2**30))
        garg = jax.lax.pmin(winner, axis)
        empty = counts <= 0
        gmin = jnp.where(empty, jnp.inf, gmin)
        garg = jnp.where(empty, jnp.int32(-1), garg)
        return gmin, garg

    return jax.jit(fn)


def sharded_glm_solve(mesh, axis: str = "data"):
    """Jitted distributed normal-equation solve: X row-sharded, y row-sharded
    -> replicated weights (GLM.cpp:20-23 with psum-reduced moments)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(),
    )
    def fn(X_local, y_local):
        xtx = jax.lax.psum(
            jnp.matmul(X_local.T, X_local, precision=HIGHEST), axis)
        xty = jax.lax.psum(
            jnp.matmul(X_local.T, y_local, precision=HIGHEST), axis)
        return jnp.linalg.solve(xtx, xty)

    return jax.jit(fn)


def sharded_histogram_build(mesh, k: int, dtype_max: int, axis: str = "data"):
    """Jitted sharded k-mer histogram builder (SURVEY §2.8 P2, the reference
    pipeline Loader.cpp:137-179 + KmerHashTable.cpp:133-256 re-expressed as
    device scatter-adds).

    Input: a [n_loc, L] batch of code sequences, int8, built by
    pack_segment_codes — each row is the record's SEGMENTS flattened with a
    single -1 separator between adjacent segments and -1 padding.  Segment
    semantics therefore fall out of window validity: a k-mer window is
    counted iff all k codes are >= 0, which is exactly "fully inside one
    segment" including the reference's 1 Mbp splits (the rolling hash
    restarts per segment, KmerHashTable.cpp:133-160).

    Output (rows device-local, DP over sequences):
      counts   [n_loc, 4^k] int32: min(1 + count, dtype_max) — the
               pseudocount-1 initializer (Loader.cpp:141) and saturating
               increment (wholesaleIncrementNoOverflow,
               KmerHashTable.cpp:235-256);
      one_mers [n_loc, 4]   int32: 1 + per-base counts over segment
               positions, unsaturated (Loader.cpp:144,150).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    d = 4**k
    sat = np.int64(min(dtype_max, 2**31 - 1))

    def one_seq(codes):
        L = codes.shape[0]
        n = L - k + 1
        valid = jnp.ones(n, dtype=bool)
        idx = jnp.zeros(n, dtype=jnp.int32)
        # k is a small static constant: these are static slices, not gathers
        for j in range(k):
            c = codes[j:j + n].astype(jnp.int32)
            valid &= c >= 0
            idx = idx * 4 + jnp.maximum(c, 0)
        idx = jnp.where(valid, idx, d)  # invalid windows dropped by scatter
        hist = jnp.zeros(d, dtype=jnp.int32).at[idx].add(
            jnp.int32(1), mode="drop")
        counts = jnp.minimum(hist + 1, jnp.int32(sat))
        ones = jnp.zeros(4, dtype=jnp.int32).at[
            jnp.where(codes >= 0, codes.astype(jnp.int32), 4)
        ].add(jnp.int32(1), mode="drop") + 1
        return counts, ones

    @partial(shard_map, mesh=mesh, in_specs=P(axis), out_specs=(P(axis), P(axis)))
    def fn(codes_local):
        return jax.vmap(one_seq)(codes_local)

    return jax.jit(fn)


def pack_segment_codes(records, pad_to: Optional[int] = None) -> np.ndarray:
    """[n, L] int8 batch for sharded_histogram_build: per record, segment
    slices joined by one -1 separator, right-padded with -1."""
    rows = []
    for rec in records:
        chunks = []
        for s, e in rec.segments:
            if chunks:
                chunks.append(np.array([-1], dtype=np.int8))
            chunks.append(rec.codes[s:e + 1].astype(np.int8))
        rows.append(np.concatenate(chunks) if chunks
                    else np.zeros(0, dtype=np.int8))
    L = max((len(r) for r in rows), default=1)
    if pad_to is not None:
        L = max(L, pad_to)
    out = np.full((len(rows), max(L, 1)), -1, dtype=np.int8)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def device_build_counts(records, k: int, dtype_max: int,
                        mesh=None, axis: str = "data"):
    """Host wrapper: records -> (counts [n, 4^k] int32 saturated
    pseudocounted, one_mers [n, 4] int64), built on the device mesh.
    Rows are padded to the mesh size; memory is bounded by chunking over
    row blocks."""
    import jax.numpy as jnp

    if mesh is None:
        mesh = make_mesh(axis=axis)
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    n = len(records)
    if n == 0:
        return (np.zeros((0, 4**k), np.int32), np.zeros((0, 4), np.int64))
    codes = pack_segment_codes(records)
    build = sharded_histogram_build(mesh, k, dtype_max, axis=axis)
    # block rows so [block, L] stays modest; blocks padded to mesh multiples
    per_dev_rows = max(1, (1 << 26) // max(codes.shape[1], 1) // ndev)
    block = per_dev_rows * ndev
    outs_c, outs_o = [], []
    for s in range(0, n, block):
        chunk = codes[s:s + block]
        pad = (-len(chunk)) % ndev
        if pad:
            chunk = np.concatenate(
                [chunk, np.full((pad, chunk.shape[1]), -1, np.int8)])
        c, o = build(jnp.asarray(chunk))
        outs_c.append(np.asarray(c)[:len(codes[s:s + block])])
        outs_o.append(np.asarray(o)[:len(codes[s:s + block])])
    return np.concatenate(outs_c), np.concatenate(outs_o).astype(np.int64)
