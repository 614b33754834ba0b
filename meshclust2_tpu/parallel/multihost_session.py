"""Device-session programs over the process-global mesh.

Per-window MultihostScorer dispatch is the latency-bound pattern the
single-device session exists to avoid.  This module builds the SAME DeviceSession machinery with the store sharded over
the global mesh: counts P(axis, None), per-row metadata P(axis), loop state
replicated.  XLA partitions the combined accumulate+update program and
inserts the collectives; every process dispatches the identical program in
lockstep (the host control flow is deterministic and all fetched values are
replicated), so clustering decisions are replicated and process 0 alone
writes the CLSTR.

The reference's only parallelism is OpenMP fork-join on one node
(CRunner.cpp:407-422, Trainer.cpp:26-28); this is its replacement across
devices and hosts.
"""
from __future__ import annotations

import numpy as np


def build_multihost_session(meta, model, sim: float, mesh, gcounts, fetch,
                            self_dots, maxc: int, delta: int,
                            iterations: int):
    """A DeviceSession-shaped object whose combined program runs over the
    process-global mesh.  Raises DeviceLoopUnsupported outside the exact
    envelope (caller falls back to MultihostScorer per-window dispatch)."""
    import jax

    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.experimental import multihost_utils as mhu

    from ..cluster.bvec import BVec
    from ..cluster.device_loop import DeviceAccumulator
    from ..cluster.device_phase import DevicePhaseUpdater
    from ..cluster.device_session import DeviceCombined, DeviceStore

    axis = mesh.axis_names[0]
    nprocs = jax.process_count()
    rep = NamedSharding(mesh, P())

    def put_rep(arr):
        arr = np.asarray(arr)
        if nprocs == 1:
            return jax.device_put(jnp.asarray(arr), rep)
        return mhu.host_local_array_to_global_array(arr, mesh, P())

    def put_row(arr):
        arr = np.asarray(arr)
        if nprocs == 1:
            return jax.device_put(jnp.asarray(arr),
                                  NamedSharding(mesh, P(axis)))
        G = mesh.devices.size
        rows = len(arr) // G
        gis = [i for i, dv in enumerate(mesh.devices.flat)
               if dv.process_index == jax.process_index()]
        local = arr[min(gis) * rows:(max(gis) + 1) * rows]
        return mhu.host_local_array_to_global_array(local, mesh, P(axis))

    store = DeviceStore.from_global(meta, sim, mesh, axis, gcounts,
                                    self_dots, maxc, put_row, put_rep)
    acc = DeviceAccumulator(meta, model, sim, shared_counts=store.counts,
                            self_dots=self_dots, maxc=maxc, row_fetch=fetch)
    phase = DevicePhaseUpdater(meta, model, sim, store, delta=delta,
                               iterations=iterations)
    comb = DeviceCombined(acc, phase, put=put_rep, out_sharding=rep,
                          compile_patch=False)
    bv = BVec(meta.lengths, 1000)
    bv.insert_all(meta.lengths)
    bv.insert_finalize(meta.lengths)
    comb.ensure_ready(bv)

    class _Session:
        pass

    s = _Session()
    s.store = store
    s.accumulator = acc
    s.phase = phase
    s.combined = comb
    s.updater = None
    s.bv = bv
    return s
