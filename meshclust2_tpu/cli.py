"""meshclust2-compatible command-line driver.

Flag set and orchestration mirror the reference CLI (CRunner.cpp:243-477 for
flags, CRunner.cpp:51-127 run / 555-597 do_run for orchestration):

    meshclust2-tpu --id 0.9 [OPTIONS] *.fasta
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np

from .features import flags as F
from .io.clstr import write_clstr
from .io.fasta import read_fasta
from .kmer.counting import (
    PointSet,
    build_point_set,
    concat_point_sets,
    find_k,
    largest_pseudocount,
    select_datatype,
)
from .model.classifier import CompiledModel
from .model.weights import PredictorModel, load_weights
from .cluster.engine import MeanShiftEngine
from .utils.clock import Clock


MUT_SINGLE = 1
MUT_NON_SINGLE = 2
MUT_BOTH = MUT_SINGLE | MUT_NON_SINGLE
MUT_TRANSLOCATION = 4
MUT_REVERSION = 8
MUT_ATYPICAL = MUT_TRANSLOCATION | MUT_REVERSION

MUT_TYPES = {
    "all": MUT_BOTH | MUT_ATYPICAL,
    "both": MUT_BOTH,
    "snp": MUT_SINGLE,
    "single": MUT_SINGLE,
    "nonsingle-typical": MUT_NON_SINGLE,
    "nonsingle-all": MUT_NON_SINGLE | MUT_ATYPICAL,
    "all-but-reversion": MUT_BOTH | MUT_TRANSLOCATION,
    "all-but-translocation": MUT_BOTH | MUT_REVERSION,
}

FEAT_SETS = {
    "fast": F.PRED_FEAT_FAST,
    "slow": F.PRED_FEAT_FAST | F.PRED_FEAT_DIV,
    "extraslow": F.PRED_FEAT_ALL,
}

DATATYPES = {
    "8": "uint8_t", "uint8": "uint8_t", "uint8_t": "uint8_t",
    "16": "uint16_t", "uint16": "uint16_t", "uint16_t": "uint16_t",
    "32": "uint32_t", "uint32": "uint32_t", "uint32_t": "uint32_t",
    "64": "uint64_t", "uint64": "uint64_t", "uint64_t": "uint64_t",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="meshclust2-tpu",
        description="alignment-free mean-shift clustering of DNA sequences",
    )
    p.add_argument("files", nargs="*", help="FASTA input files")
    p.add_argument("--id", type=float, default=0.90, dest="identity")
    p.add_argument("-k", "--kmer", type=int, default=-1)
    p.add_argument("--dump", nargs="?", const="weights.txt", default=None)
    p.add_argument("-r", "--recover", default=None)
    p.add_argument("-l", "--list", dest="list_file", default=None)
    p.add_argument("--no-train-list", "--notrain-list", dest="notrain_list", default=None)
    p.add_argument("--mut-type", choices=sorted(MUT_TYPES), default="both")
    p.add_argument("--feat", "-f", choices=sorted(FEAT_SETS), default="fast")
    p.add_argument("--single-file", action="store_true")
    p.add_argument("-s", "--sample", type=int, default=2000)
    p.add_argument("--num-templates", type=int, default=300)
    p.add_argument("--min", "--min-feat", dest="min_feat", type=int, default=4)
    p.add_argument("--max", "--max-feat", dest="max_feat", type=int, default=4)
    p.add_argument("--min-id", type=float, default=0.35)
    p.add_argument("--datatype", choices=sorted(DATATYPES), default=None)
    p.add_argument("-t", "--threads", type=int, default=0, help="accepted for compatibility")
    p.add_argument("-o", "--output", default="output.clstr")
    p.add_argument("-d", "--delta", type=int, default=5)
    p.add_argument("-i", "--iter", "--iterations", dest="iterations", type=int, default=15)
    p.add_argument("-b", "--bias", type=float, default=0.0)
    p.add_argument(
        "--device",
        choices=["auto", "host", "gpu"],
        default="auto",
        help="scoring backend: float64 host oracle (auto, host) or the "
        "device programs on the GPU (gpu; fails without one)",
    )
    p.add_argument(
        "--multihost", action="store_true",
        help="multi-process data-parallel run over jax.distributed "
             "(MC2_NPROCS/MC2_PROC_ID/MC2_COORD env); requires --recover",
    )
    p.add_argument(
        "--checkpoint",
        default=None,
        metavar="FILE",
        help="write a clustering-state checkpoint after the accumulate "
        "phase and after every update iteration (the reference has no "
        "clustering-phase persistence; a crash there loses everything)",
    )
    p.add_argument(
        "--resume-cluster",
        default=None,
        metavar="FILE",
        help="resume clustering from a --checkpoint file (skips the "
        "accumulate phase; produces byte-identical output)",
    )
    p.add_argument(
        "--profile",
        nargs="?",
        const="/tmp/mc2_profile",
        default=None,
        metavar="DIR",
        help="capture a jax.profiler trace of the run into DIR (device "
        "and host spans beside the reference's Clock stamps, SURVEY §5; "
        "view with TensorBoard or xprof)",
    )
    return p


def load_sorted_points(
    train_files: List[str],
    notrain_files: List[str],
    k: int,
    datatype: str,
    single_file: bool,
    keep_seqs_train: bool = True,
    records_cache: Optional[dict] = None,
) -> tuple:
    """get_points for train + notrain files with the reference's sort-by-
    header-then-length (CRunner.cpp:504-544) and id assignment in final
    length order (CRunner.cpp:577-593).

    Returns (train_ps_sorted, all_ps_sorted)."""
    from .utils.progress import Progress

    n_files = len(train_files) + len(notrain_files)
    prog = Progress(n_files, f"Counting {k}-mers")  # CRunner.cpp:517-519

    def load(files, keep):
        sets = []
        for fpath in files:
            if records_cache is not None and fpath in records_cache:
                recs = records_cache[fpath]
            else:
                recs = read_fasta(fpath, single_file)
            if recs:
                sets.append(build_point_set(recs, k, datatype, keep_seqs=keep))
            prog.step()
        return sets

    train_sets = load(train_files, keep_seqs_train)
    train_ps = concat_point_sets(train_sets) if train_sets else None
    if train_ps is not None:
        train_ps = sort_points(train_ps)
    notrain_sets = load(notrain_files, False)
    prog.end()
    if notrain_sets:
        rest = concat_point_sets(notrain_sets)
        combined = concat_point_sets([train_ps, rest]) if train_ps is not None else rest
        combined = sort_points(combined)
    else:
        combined = train_ps
    if combined is not None:
        combined.ids = np.arange(combined.n, dtype=np.int64)
    return train_ps, combined


def sort_points(ps: PointSet) -> PointSet:
    """Sort by header, then by length — two sequential std::sorts
    (CRunner.cpp:538-539).  Uses the native std::sort permutation helper so
    equal-length tie order matches the reference's unstable introsort."""
    from .native import sort_perm, sort_perm_strings

    p1 = sort_perm_strings(ps.headers)
    # compose the two permutations so the big column arrays are gathered
    # once: the second (unstable-introsort) key runs over the header-sorted
    # length order, exactly as the sequential std::sorts would
    p2 = sort_perm(np.asarray(ps.lengths)[p1])
    return ps.subset(p1[p2])


def require_device() -> None:
    """`--device gpu` runs on the GPU backend, or on XLA:CPU when the
    environment pins `JAX_PLATFORMS=cpu` explicitly (tests and CPU
    rehearsals).  Anything else ends the run: no silent host fallback."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(
            f"error: --device gpu needs a GPU, but JAX's default backend "
            f"is {backend!r} (set JAX_PLATFORMS=cpu to run the device "
            "programs on XLA:CPU)")
    devs = jax.devices()
    print(f"device: platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}")


def _device_session(ps: PointSet, model: CompiledModel, sim: float, args):
    """DeviceSession, or None when MC2_NO_DEVICE_SESSION is set or the data
    is outside the exact-arithmetic envelope (try_create says which)."""
    if os.environ.get("MC2_NO_DEVICE_SESSION"):
        return None
    from .cluster.device_session import try_create

    return try_create(ps, model, sim, delta=args.delta,
                      iterations=args.iterations)


def make_scorer(ps: PointSet, model: CompiledModel, device: str,
                session=None):
    """Scorer selection.

    host: native C++ exact scorer (fast sequential path), falling back to
          the numpy float64 oracle.
    gpu:  hybrid — native for small latency-sensitive batches, device
          kernels (with exact rechecks) for large batches.
    auto: host; device offload stays opt-in (--device gpu).
    """
    from .cluster.engine import HostScorer
    from .native import NativeScorer

    native = NativeScorer.create(ps, model)
    host = native or HostScorer(ps, model)
    if device in ("host", "auto"):
        return host
    if session is not None:
        # a DeviceSession holds the only device state needed: whole phases
        # run on-device, and any guarded-abort host completion should use
        # the fast native scorer, NOT per-window device dispatches.  This
        # also avoids DeviceFeatureEngine's large float32 histogram upload
        # (the round-3 bench regression was redundant uploads).
        host.prefers_device_loop = True
        return host
    from .ops.device_features import DeviceScorer

    dev = DeviceScorer(ps, model, exact_recheck=True)

    class HybridScorer:
        """Route small batches to the native scorer (dispatch-latency
        bound), large batches to the device (bandwidth/FLOP bound)."""

        prefers_device_loop = True  # engine routes whole phases on-device

        def __init__(self, small, large, threshold=int(os.environ.get(
                "MC2_DEVICE_THRESHOLD", "16384"))):
            self.small = small
            self.large = large
            self.threshold = threshold

        def score(self, a_rows, b_rows):
            n = max(np.size(a_rows), np.size(b_rows))
            if n < self.threshold:
                return self.small.score(a_rows, b_rows)
            return self.large.score(a_rows, b_rows)

    return HybridScorer(host, dev)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.jaxconfig import ensure_compilation_cache

    ensure_compilation_cache()
    if args.multihost:
        from .parallel.multihost import run_multihost

        return run_multihost(args)
    if args.device == "gpu":
        # backend bring-up lands before any clock stamp
        require_device()
        # route the training pair tables (P4) through the device too
        # (train/device_tables.py)
        os.environ.setdefault("MC2_DEVICE_TRAIN", "1")
    clock = Clock()
    if args.threads > 0:
        # the reference caps OpenMP parallelism via omp_set_num_threads
        # (CRunner.cpp:407-422); ours lives in the native library
        os.environ["OMP_NUM_THREADS"] = str(args.threads)
        from .native import set_num_threads

        set_num_threads(args.threads)
    profiler_cm = None
    if args.profile:
        import jax.profiler

        profiler_cm = jax.profiler.trace(args.profile)
        profiler_cm.__enter__()
    try:
        return _main_impl(args, clock)
    finally:
        if profiler_cm is not None:
            profiler_cm.__exit__(None, None, None)
            print(f"profile trace written to {args.profile}")


def _main_impl(args, clock) -> int:

    train_files = list(args.files)
    if args.list_file:
        with open(args.list_file) as f:
            train_files += [l.strip() for l in f if l.strip()]
    notrain_files = []
    if args.notrain_list:
        with open(args.notrain_list) as f:
            notrain_files = [l.strip() for l in f if l.strip()]
    # de-dup like the reference's std::set normalization (CRunner.cpp:455-468)
    train_files = sorted(set(train_files))
    notrain_files = sorted(set(notrain_files) - set(train_files))
    if not train_files:
        build_parser().print_help()
        return 1

    recovered: Optional[PredictorModel] = None
    k = args.kmer
    similarity = args.identity
    datatype = DATATYPES[args.datatype] if args.datatype else None
    if args.recover:
        recovered = load_weights(args.recover)
        k = recovered.k
        similarity = recovered.id_cutoff
        datatype = recovered.datatype

    from .utils.progress import Progress

    all_files = train_files + notrain_files
    records_cache = {}
    prog = Progress(len(all_files), "Reading in sequences")  # CRunner.cpp:58
    for f in all_files:
        records_cache[f] = read_fasta(f, args.single_file)
        prog.step()
    prog.end()
    per_file_records = [records_cache[f] for f in all_files]

    if k == -1:
        try:
            k = find_k(per_file_records, len(train_files))
        except ValueError:
            # no usable sequences: keep the clean empty-output exit path
            print("No sequences found in input; writing empty output",
                  file=sys.stderr)
            write_clstr(args.output, [])
            clock.stamp("done")
            return 1
        print(f"Recommended K: {k}")

    if datatype is None:
        largest = 0
        for recs in per_file_records:
            largest = max(largest, largest_pseudocount(recs, k))
        print(f"Largest count: {largest}")
        datatype = select_datatype(largest)
    bits = {"uint8_t": 8, "uint16_t": 16, "uint32_t": 32, "uint64_t": 64}[datatype]
    print(f"Using {bits} bit histograms")  # CRunner.cpp:109-121

    train_ps, all_ps = load_sorted_points(
        train_files, notrain_files, k, datatype, args.single_file,
        records_cache=records_cache,
    )
    records_cache.clear()

    # Device bring-up BEFORE the read_in_points stamp (recover path): the
    # histogram store upload, program lowering/compilation and their forced
    # completion are the device analog of the reference's in-memory point
    # loading — the measured clustering window then contains execution
    # only.  Training runs build the session after training instead.
    device_session = None
    model: Optional[CompiledModel] = None
    if recovered is not None:
        model = CompiledModel(recovered.classifier, bias=args.bias)
        if all_ps is not None and all_ps.n and (
                args.device == "gpu"
                or os.environ.get("MC2_FORCE_DEVICE_SESSION")):
            # MC2_FORCE_DEVICE_SESSION exercises the session/combined
            # program under --device host (tests)
            device_session = _device_session(all_ps, model, similarity, args)
    clock.stamp("read_in_points")

    if all_ps is None or all_ps.n == 0:
        # the reference has no guard here and crashes; fail cleanly with an
        # empty (but valid) output instead
        print("No sequences found in input; writing empty output",
              file=sys.stderr)
        write_clstr(args.output, [])
        clock.stamp("done")
        return 1
    if recovered is None and (train_ps is None or train_ps.n == 0):
        print("No training sequences found", file=sys.stderr)
        return 1

    if recovered is not None:
        pass  # model built above (before the read_in_points stamp)
    else:
        from .train.predictor import train_predictor

        min_id = args.min_id
        if similarity < 0.6:
            min_id = 0.2  # CRunner.cpp:570-574
        print("Splitting data")  # Trainer.cpp:174
        pred_model = train_predictor(
            train_ps,
            k=k,
            identity=similarity,
            datatype=datatype,
            feat_flags=FEAT_SETS[args.feat],
            mut_type=MUT_TYPES[args.mut_type],
            min_feat=args.min_feat,
            max_feat=args.max_feat,
            min_id=min_id,
            n_samples=args.sample,
            n_templates=args.num_templates,
            clock=clock,
        )
        from .model.weights import save_weights

        save_weights(args.dump or "weights.txt", pred_model)
        if args.dump:
            return 0
        model = CompiledModel(pred_model.classifier, bias=args.bias)
        if all_ps is not None and all_ps.n and (
                args.device == "gpu"
                or os.environ.get("MC2_FORCE_DEVICE_SESSION")):
            device_session = _device_session(all_ps, model, similarity, args)

    # clustering runs on all points (train + notrain), sequences dropped
    all_ps.seqs = None
    scorer = make_scorer(all_ps, model, args.device,
                         session=device_session)
    engine = MeanShiftEngine(
        all_ps,
        model,
        similarity,
        scorer=scorer,
        delta=args.delta,
        iterations=args.iterations,
        device_session=device_session,
    )
    clusters = engine.run(clock=clock, checkpoint=args.checkpoint,
                          resume=args.resume_cluster)
    write_clstr(args.output, engine.to_output(clusters))
    clock.stamp("update")
    clock.stamp("done")
    if args.device == "gpu":
        import jax

        stats = jax.devices()[0].memory_stats()
        if stats is not None:
            print(f"device peak_bytes_in_use: {stats['peak_bytes_in_use']}")
    return 0


def _entry() -> None:  # console-script entry point
    sys.exit(main())


if __name__ == "__main__":
    _entry()
