"""fastcar — all-vs-query identity search/estimation.

Rebuild of the reference's second executable (FC_Runner.cpp): a GLM
classifier gates candidate (database, query) pairs inside a length window,
and an optional GLM regression head estimates percent identity for the
survivors.  Output is the reference's per-thread `<output>N` TSV format
(query  db  identity%); this implementation writes one file, `<output>0`.

Search scoring is batched: every (query, window-candidate) pair of a
db-chunk x query-chunk block is classified in one pass.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import List, Optional

import numpy as np

from .features import flags as F
from .io.fasta import iter_fasta, encode_sequence
from .kmer.counting import (
    PointSet,
    build_point_set,
    concat_point_sets,
    largest_pseudocount,
    select_datatype,
)
from .model.classifier import CompiledModel
from .model.weights import (
    PredictorModel,
    load_weights,
    save_weights,
    PRED_MODE_CLASS,
    PRED_MODE_REGR,
)
from .cli import MUT_TYPES, DATATYPES
from .cluster.engine import HostScorer, c_round
from .features import host as H

FEAT_SETS = {"fast": F.PRED_FEAT_FAST, "slow": F.PRED_FEAT_FAST | F.PRED_FEAT_DIV}
MODES = {"c": PRED_MODE_CLASS, "r": PRED_MODE_REGR,
         "rc": PRED_MODE_CLASS | PRED_MODE_REGR,
         "cr": PRED_MODE_CLASS | PRED_MODE_REGR}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fastcar-tpu",
                                description="all-vs-query identity search")
    p.add_argument("files", nargs="*", help="database FASTA files")
    p.add_argument("-q", "--query", action="append", default=[], required=False)
    p.add_argument("--id", type=float, default=-1.0, dest="identity")
    p.add_argument("-k", "--kmer", type=int, default=-1)
    p.add_argument("--datatype", choices=sorted(DATATYPES), default=None)
    p.add_argument("-c", "--chunk", type=int, default=10000)
    p.add_argument("--dump", default=None)
    p.add_argument("--no-format", "--noformat", dest="noformat", action="store_true")
    p.add_argument("-o", "--output", default="output.search")
    p.add_argument("-r", "--recover", default=None)
    p.add_argument("-f", "--feat", choices=sorted(FEAT_SETS), default="fast")
    p.add_argument("-m", "--mode", choices=sorted(MODES), default="rc")
    p.add_argument("-s", "--sample", type=int, default=300)
    p.add_argument("--mut-type", choices=sorted(MUT_TYPES), default="single")
    p.add_argument("-t", "--threads", type=int, default=0)
    return p


def format_header(hdr: str) -> str:
    """(FC_Runner.cpp:410-424): strip '>' and truncate after first space/tab
    (keeping the delimiter)."""
    b = 1 if hdr.startswith(">") else 0
    length = len(hdr)
    for i in range(b, len(hdr)):
        if hdr[i] in (" ", "\t"):
            length = i + 1
            break
    return hdr[b:length]


def bin_search(lengths: np.ndarray, length: int) -> int:
    """The reference's window lower-bound search with its quirks
    (FC_Runner.cpp:390-408)."""
    def rec(begin: int, last: int) -> int:
        if last < begin:
            return 0
        idx = begin + (last - begin) // 2
        l = int(lengths[idx])
        if l == length:
            while idx > 0 and int(lengths[idx - 1]) == length:
                idx -= 1
            return idx
        elif l > length:
            if begin == idx:
                return idx
            return rec(begin, idx - 1)
        else:
            return rec(idx + 1, last)

    n = len(lengths)
    return rec(0, n - 1) if n else 0


def load_chunks(files: List[str], k: int, datatype: str, chunk: int):
    """Stream records into PointSet chunks of ~chunk sequences."""
    buf = []
    for fpath in files:
        for header, seq in iter_fasta(fpath):
            buf.append(encode_sequence(header, seq))
            if len(buf) >= chunk:
                yield build_point_set(buf, k, datatype)
                buf = []
    if buf:
        yield build_point_set(buf, k, datatype)


def _device_search_batches(db, q_ps, model_c, model_r, a_arr, q_arr):
    """Device path for the all-vs-query grid (FC_Runner.cpp:426-471): the
    densest, most device-friendly workload in the project — zero sequential
    dependence, one [pairs] batch per block through the dd-f32 scoring
    kernels (cluster/device_update.DeviceUpdater).

    Decisions use the exact GLM-sum edges; regression values are dd
    (~1e-13 relative), with a float64 host recheck of any pair whose
    PRINTED value (the %g six-significant-digit output) could differ — so
    output files are identical to the host path.  Returns (keep, sim) or
    None when ineligible (MC2_FASTCAR_DEVICE unset, or outside the dd
    envelope)."""
    import os

    if not os.environ.get("MC2_FASTCAR_DEVICE"):
        return None
    from .cluster.device_loop import DeviceLoopUnsupported
    from .cluster.device_update import DeviceUpdater
    from .model import thresholds as TH

    q_off = db.n
    combined = concat_point_sets([db, q_ps])
    try:
        upd_c = DeviceUpdater(combined, model_c, 0.9) if model_c else None
        upd_r = DeviceUpdater(combined, model_r, 0.9) if model_r else None
    except DeviceLoopUnsupported as e:
        print(f"fastcar device path unavailable ({e}); using host",
              file=sys.stderr)
        return None
    host = HostScorer(combined, model_c) if model_c else None
    host_r = HostScorer(combined, model_r) if model_r else None
    b_arr = q_arr + q_off
    keep = np.ones(len(a_arr), dtype=bool)
    if upd_c is not None:
        s, _ = upd_c.score_sum_dist(a_arr, b_arr)
        edge = TH.positive_edge(model_c.bias)
        keep = s >= edge
        thr = np.maximum(8 * upd_c.last_serr,
                         upd_c.margin * max(abs(edge), 1.0))
        unc = np.abs(s - edge) <= thr
        idx = np.nonzero(unc)[0]
        if len(idx):
            prob, _ = host.score(a_arr[idx], b_arr[idx])
            keep[idx] = c_round(prob) > 0
    sim = np.ones(len(a_arr))
    if upd_r is not None and keep.any():
        sel = np.nonzero(keep)[0]
        s_r, _ = upd_r.score_sum_dist(a_arr[sel], b_arr[sel])
        vals = np.clip(s_r, 0.0, 1.0)
        # recheck pairs whose printed %g value is sensitive at the dd
        # error scale (term-magnitude based, see _band_decide), plus the
        # print/clip boundaries around 0
        eps = 8 * np.maximum(upd_r.last_serr, 1e-13)
        lowp = np.array([f"{100 * v:g}" for v in np.clip(s_r - eps, 0, 1)])
        highp = np.array([f"{100 * v:g}" for v in np.clip(s_r + eps, 0, 1)])
        unc = (lowp != highp) | (np.abs(s_r) <= eps) | \
            (np.abs(s_r - 1.0) <= eps)
        idx = np.nonzero(unc)[0]
        if len(idx):
            from .features import host as HH

            sub = sel[idx]
            CH = HostScorer.CHUNK
            for st in range(0, len(sub), CH):
                en = min(len(sub), st + CH)
                vals[idx[st:en]] = model_r.regression_value(
                    H.side_from_pointset(combined, a_arr[sub[st:en]]),
                    H.side_from_pointset(combined, b_arr[sub[st:en]]),
                )
        sim = np.zeros(len(a_arr))
        sim[sel] = vals
    return keep, sim


def search(
    db_ps: PointSet,
    q_ps: PointSet,
    model_c: Optional[CompiledModel],
    model_r: Optional[CompiledModel],
    similarity: float,
    out,
    delim: str,
    do_format: bool,
) -> int:
    """One db-chunk x query-chunk block (FC_Runner.cpp:426-471), batched."""
    from .native import sort_perm

    order = sort_perm(db_ps.lengths.astype(np.uint64))
    db = db_ps.subset(order)
    # per-query windows: quirky bin_search for the start (reference
    # semantics), one vectorized searchsorted for the ends (db.lengths is
    # ascending, so the reference's linear `while lengths[end] <= end_length`
    # walk lands on the same index)
    q_lens = q_ps.lengths
    end_lengths = (q_lens / similarity).astype(np.int64)
    starts = np.array(
        [bin_search(db.lengths, int(l * similarity)) for l in q_lens],
        dtype=np.int64,
    )
    ends = np.maximum(
        starts, np.searchsorted(db.lengths, end_lengths, side="right")
    )
    per_q = ends - starts
    total = int(per_q.sum())
    if total == 0:
        return 0
    q_arr = np.repeat(np.arange(q_ps.n, dtype=np.int64), per_q)
    a_arr = np.repeat(starts, per_q) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.cumsum(per_q) - per_q, per_q)
    )
    # one combined point set (db rows first, queries after) lets the fused
    # native scorer stream both the classifier gate and the regression head;
    # the numpy fallback goes through the chunked HostScorer instead of
    # materializing [P, 4^k] float64 sides for the whole block
    from .kmer.counting import concat_point_sets
    from .native import NativeScorer

    device = _device_search_batches(db, q_ps, model_c, model_r,
                                    a_arr, q_arr)
    if device is not None:
        keep, sim = device
        n_pos = 0
        for i in np.nonzero(keep)[0]:
            n_pos += 1
            s = sim[i]
            if s > 0:
                qh = q_ps.headers[int(q_arr[i])]
                dh = db.headers[int(a_arr[i])]
                if do_format:
                    qh, dh = format_header(qh), format_header(dh)
                out.write(f"{qh}{delim}{dh}{delim}{100 * s:g}\n")
        return n_pos

    native_ok = (model_c is None or NativeScorer.supports(model_c)) and (
        model_r is None or NativeScorer.supports(model_r)
    )
    combined = concat_point_sets([db, q_ps]) if native_ok else None
    q_off = db.n
    keep = np.ones(len(a_arr), dtype=bool)
    if model_c is not None:
        if native_ok:
            ns = NativeScorer.create(combined, model_c)
            prob, _ = ns.score(a_arr, q_arr + q_off)
        else:
            prob = np.empty(len(a_arr))
            CH = HostScorer.CHUNK
            for s in range(0, len(a_arr), CH):
                e = min(len(a_arr), s + CH)
                p, _ = model_c.score(
                    H.side_from_pointset(db, a_arr[s:e]),
                    H.side_from_pointset(q_ps, q_arr[s:e]),
                )
                prob[s:e] = p
        keep = c_round(prob) > 0
    sim = np.ones(len(a_arr))
    if model_r is not None and keep.any():
        sel = np.nonzero(keep)[0]
        if native_ok:
            ns_r = NativeScorer.create(combined, model_r)
            sums, _ = ns_r.score(a_arr[sel], q_arr[sel] + q_off, raw_sum=True)
            sim_sel = np.clip(sums, 0.0, 1.0)
        else:
            sim_sel = np.empty(len(sel))
            CH = HostScorer.CHUNK
            for s in range(0, len(sel), CH):
                e = min(len(sel), s + CH)
                sim_sel[s:e] = model_r.regression_value(
                    H.side_from_pointset(db, a_arr[sel[s:e]]),
                    H.side_from_pointset(q_ps, q_arr[sel[s:e]]),
                )
        sim = np.zeros(len(a_arr))
        sim[sel] = sim_sel
    n_pos = 0
    for i in np.nonzero(keep)[0]:
        n_pos += 1
        s = sim[i]
        if s > 0:
            qh = q_ps.headers[int(q_arr[i])]
            dh = db.headers[int(a_arr[i])]
            if do_format:
                qh, dh = format_header(qh), format_header(dh)
            out.write(f"{qh}{delim}{dh}{delim}{100 * s:g}\n")
    return n_pos


def mem_used(prefix: str) -> None:
    """VmSize print, matching the reference's observability surface
    (FC_Runner.cpp:43-58): ``<prefix>: used memory: <kB> KB``."""
    result = -1
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmSize:"):
                    result = int(line.split()[1])
                    break
    except OSError:
        pass
    print(f"{prefix}: used memory: {result} KB")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.jaxconfig import ensure_compilation_cache

    ensure_compilation_cache()
    if not args.files or not args.query:
        build_parser().print_help()
        return 1
    similarity = args.identity
    mode = MODES[args.mode]

    recovered: Optional[PredictorModel] = None
    k = args.kmer
    datatype = DATATYPES[args.datatype] if args.datatype else None
    if args.recover:
        recovered = load_weights(args.recover)
        k = recovered.k
        datatype = recovered.datatype
        similarity = recovered.id_cutoff
        mode = recovered.mode

    # The first <=10000 sequences serve both the k/datatype scan AND the
    # training-template pool — the reference caps the pool at 10k regardless
    # of flags (FC_Runner.cpp:106-125: `cap = 10000`; only --recover skips
    # the read and clears the pool).
    sample_records = []
    if not args.recover:
        count = 0
        for fpath in args.files:
            for header, seq in iter_fasta(fpath):
                sample_records.append(encode_sequence(header, seq))
                count += 1
                if count >= 10000:
                    break
            if count >= 10000:
                break
    if k == -1:
        if not sample_records or all(r.total_size == 0 for r in sample_records):
            print("fastcar: no sequences found in the database input",
                  file=sys.stderr)
            return 1
        total = sum(r.total_size for r in sample_records)
        avg = total / max(1, len(sample_records))
        k = max(int(math.ceil(math.log(avg) / math.log(4)) - 1), 2)
    print(f"K: {k}")
    if datatype is None:
        largest = largest_pseudocount(sample_records, k)
        datatype = select_datatype(largest)
    print(f"Using {datatype} histograms")

    mem_used("before do_run")  # FC_Runner.cpp:480
    if recovered is not None:
        model = recovered
    else:
        if similarity < 0 and (mode & PRED_MODE_CLASS):
            print("Classification specified, but no identity score given (--id)")
            return 1
        if similarity < 0:
            similarity = 0.9
        if not sample_records:
            print("fastcar: no sequences found in the database input",
                  file=sys.stderr)
            return 1
        # template selection over the <=10k pool: unstable std::sort by RAW
        # length, C-round()ed stride to ~sample templates
        # (FC_Runner.cpp:487-507)
        from .native import sort_perm

        raw_lens = np.array([r.total_size for r in sample_records],
                            dtype=np.uint64)
        recs = [sample_records[j] for j in sort_perm(raw_lens)]
        print(f"sample_size: {args.sample}")  # FC_Runner.cpp:491
        increment = max(1.0, len(recs) / args.sample)
        idxs = []
        i = 0.0
        while math.floor(i + 0.5) < len(recs):  # C round(), positive domain
            idxs.append(int(math.floor(i + 0.5)))
            i += increment
        tmpl_ps = build_point_set([recs[j] for j in idxs], k, datatype, keep_seqs=True)
        mem_used("after selection")  # FC_Runner.cpp:510
        print(f"TRpoints.size(): {tmpl_ps.n}")  # FC_Runner.cpp:512
        from .train.predictor import train_predictor

        mem_used("before predictor training")  # FC_Runner.cpp:539
        model = train_predictor(
            tmpl_ps,
            k=k,
            identity=similarity,
            datatype=datatype,
            feat_flags=FEAT_SETS[args.feat],
            mut_type=MUT_TYPES[args.mut_type],
            min_feat=4,
            max_feat=5,
            n_samples=10,
            n_templates=args.sample,
            mode=mode,
        )
        if args.dump:
            save_weights(args.dump, model)
            return 0
        save_weights("weights.txt", model)

    model_c = CompiledModel(model.classifier) if model.classifier else None
    model_r = CompiledModel(model.regressor) if model.regressor else None

    delim = "!" if args.noformat else "\t"
    n_pos = 0
    # the reference opens one `<output>N` ofstream per OpenMP thread
    # upfront (FC_Runner.cpp:556-560) and each thread appends its own
    # matches; WHICH file a match lands in is scheduler-dependent there.
    # This implementation creates the same file set for -t N but writes
    # all matches (deterministically) to `<output>0`.
    for t in range(1, max(args.threads, 1)):
        open(f"{args.output}{t}", "w").close()
    mem_used("before loop")  # FC_Runner.cpp:571
    with open(f"{args.output}0", "w") as out:
        for q_ps in load_chunks(args.query, k, datatype, args.chunk):
            for db_ps in load_chunks(args.files, k, datatype, args.chunk):
                n_pos += search(
                    db_ps, q_ps, model_c, model_r,
                    similarity if similarity > 0 else model.id_cutoff,
                    out, delim, not args.noformat,
                )
            mem_used("mid loop")  # FC_Runner.cpp:602
    mem_used("after loop")  # FC_Runner.cpp:604
    print(f"# of predicted positive: {n_pos}")
    return 0


def _entry() -> None:  # console-script entry point
    sys.exit(main())


if __name__ == "__main__":
    _entry()
