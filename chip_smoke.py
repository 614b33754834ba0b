#!/usr/bin/env python
"""GPU smoke run: the recover-path clustering end to end on the card.

    python chip_smoke.py                 # every phase, one GPU
    python chip_smoke.py --four          # only the sharded path, four GPUs
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse   # XLA:CPU, small sizes

Phases on one card:
  1  device and card: JAX's platform, device kind and count; nvidia-smi's
     name and power limit; the native library's SIMD level.  Fails unless
     the platform is gpu.
  2  compile only: the DeviceSession of the pool, and the combined
     program's compiled.memory_analysis().
  3  kernels at real widths against int64/float64 oracles (emd_rowsum and
     the blocked-matmul form it was chosen over, double-float ops under
     jit, DeviceScorer against HostScorer), their timings, and the device
     cost constants (accumulate us/step and ns/pair, update-phase seconds
     per iteration at the 131,072-row bucket).
  4  reference parity: med2000 through the CLI with --device gpu, against
     the reference CLSTR and byte-for-byte against --device host.
  5  the main path: the generated pool (bench.py's generator, 100k
     sequences in 2,000 families) with --device gpu and --device host.
  6  a full training run on small.fasta, gpu against host.
  7  fastcar's device path against its host path.

This process never imports JAX.  Every phase that needs the card runs in a
child process of its own, one at a time, and every host-only child runs
with JAX_PLATFORMS=cpu, so one process at a time holds the card.  The last
line of the output is one JSON object, {"ok": ..., "device": {...}}; a
failed phase makes it false and the exit code 1.  Without a GPU, or outside
a checkout of the repository, the script exits non-zero and prints no
result line.  --rehearse runs every phase on XLA:CPU at small sizes to
check the plumbing, and prints no result line either.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from collections import Counter

REPO = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(REPO, "tests", "fixtures")
NO_DEVICE = 3
ALL_PHASES = (1, 2, 3, 4, 5, 6, 7)
CHILD_TIMEOUT = 900

# full widths (the driver's run) and the CPU rehearsal's small ones
FULL = dict(n_seqs=100_000, n_templates=2_000, wc=2048, widths=(1024, 4096),
            batch=2048, scorer_pairs=3000, dd_n=1 << 20, reps=20)
REHEARSAL = dict(n_seqs=2_000, n_templates=40, wc=128, widths=(64, 256),
                 batch=128, scorer_pairs=300, dd_n=1 << 12, reps=3)


class PhaseError(RuntimeError):
    pass


def say(*a):
    print(*a, flush=True)


# -- children -----------------------------------------------------------------

def child_env(gpu: bool) -> dict:
    """Environment of a child: the card for gpu children (with the device
    programs' phase timings on), XLA:CPU for host-only ones."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if gpu:
        env["MC2_DEVICE_PROF"] = "1"
    else:
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("MC2_DEVICE_PROF", None)
    return env


def run_child(cmd, log: str, gpu: bool, cwd: str = REPO, extra_env=None):
    """Run one child to completion; returns (output, wall seconds).  The
    wall clock spans the whole invocation, process start included."""
    env = child_env(gpu)
    env.update(extra_env or {})
    t0 = time.perf_counter()
    with open(log, "w") as f:
        p = subprocess.run(cmd, cwd=cwd, env=env, stdout=f,
                           stderr=subprocess.STDOUT, timeout=CHILD_TIMEOUT)
    wall = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    if p.returncode != 0:
        raise PhaseError(f"{' '.join(cmd[1:4])}... exited {p.returncode}; "
                         f"log {log}:\n{text[-3000:]}")
    return text, wall


def cli(args, log, gpu, cwd=REPO, extra_env=None):
    return run_child([sys.executable, "-m", "meshclust2_tpu.cli", *args],
                     log, gpu, cwd=cwd, extra_env=extra_env)


# -- CLSTR comparison (tests/test_parity_2000.py's center signature) ----------

def center_signature(path: str) -> Counter:
    from meshclust2_tpu.io.clstr import parse_clstr

    return Counter(
        (frozenset(m["header"] for m in c),
         tuple(sorted(m["header"] for m in c if m["center"])))
        for c in parse_clstr(path))


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# -- log parsing ----------------------------------------------------------------

def window_seconds(text: str) -> float:
    ts = {m.group(1): float(m.group(2)) for m in
          re.finditer(r"timestamp (\S+) ([0-9.eE+-]+)", text)}
    return ts["done"] - ts["read_in_points"]


def device_line(text: str) -> dict:
    m = re.search(r"device: platform=(\S+) kind=(.+) count=(\d+)", text)
    if m is None:
        raise PhaseError("the gpu run printed no device line")
    return {"platform": m.group(1), "kind": m.group(2).strip(),
            "count": int(m.group(3))}


def report_device_run(text: str) -> None:
    """Print what a `--device gpu` run's log says about its device work."""
    m = re.search(r"device session: store\+updater ([0-9.]+)s", text)
    store = float(m.group(1)) if m else None
    m = re.search(r"device combined ready: upload-dispatch ([0-9.]+)s, "
                  r"trace\+lower ([0-9.]+)s, compile ([0-9.]+)s, "
                  r"arg-force ([0-9.]+)s", text)
    if m:
        up = float(m.group(1)) + float(m.group(4)) + (store or 0.0)
        say(f"  set-up: trace+lower {m.group(2)} s, compile {m.group(3)} s, "
            f"upload {up} s (store+updater {store} s, upload-dispatch "
            f"{m.group(1)} s, arg-force {m.group(4)} s)")
    steps = [int(x) for x in re.findall(r"device accumulate: (\d+) steps",
                                        text)]
    pairs = [int(x) for x in re.findall(r"steps, \d+ windows, (\d+) pairs",
                                        text)]
    execs = re.findall(r"device combined: execute ([0-9.]+)s", text)
    say(f"  accumulate: {sum(steps)} steps, {sum(pairs)} pairs in "
        f"{len(steps)} dispatches (execute s: {', '.join(execs) or '-'})")
    causes = Counter(re.findall(r"margin abort \(stage (\d+), cause (\d+)\)",
                                text))
    say(f"  margin aborts: {sum(causes.values())} "
        + (", ".join(f"stage {s} cause {c}: {k}"
                     for (s, c), k in sorted(causes.items())) or ""))
    m = re.search(r"completed after (\d+) margin-abort resumes and (\d+) "
                  r"segment relaunches", text)
    say(f"  resumes: {m.group(1) if m else 0}, segment relaunches: "
        f"{m.group(2) if m else 0}")
    say(f"  host finished the tail: "
        f"{'yes' if 'host finishes the tail' in text else 'no'}")
    m = re.search(r"device update phase: ([0-9.]+)s, (\d+) iterations, "
                  r"(\d+) pairs", text)
    if m:
        say(f"  update phase on device: {m.group(2)} iterations, "
            f"{m.group(3)} pairs")
    for line in re.findall(r"device update phase: guarded abort.*", text):
        say(f"  {line}")
    for line in re.findall(r".*(?:unavailable|no device implementation).*",
                           text):
        say(f"  {line.strip()}")
    m = re.search(r"device peak_bytes_in_use: (\d+)", text)
    say(f"  peak_bytes_in_use: {m.group(1) if m else 'not reported'}")


# -- phases run by this process ---------------------------------------------------

def phase_card() -> None:
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        lines = p.stdout.strip().splitlines() if p.returncode == 0 else []
    except (OSError, subprocess.TimeoutExpired):
        lines = []
    for line in lines or ["not available"]:
        say(f"nvidia-smi: {line}")
    from meshclust2_tpu.native import simd_level

    say(f"native library: {simd_level()}")


def phase_parity(work: str, fasta: str, weights: str, ref: str) -> None:
    """`--device gpu` against the reference CLSTR (membership and centers)
    and byte-for-byte against `--device host`."""
    os.makedirs(work, exist_ok=True)
    gpu_out = os.path.join(work, "gpu.clstr")
    host_out = os.path.join(work, "host.clstr")
    text, wall = cli(["--recover", weights, "--output", gpu_out,
                      "--device", "gpu", fasta],
                     os.path.join(work, "gpu.log"), gpu=True)
    say(f"  gpu run: window {window_seconds(text)} s, invocation {wall} s")
    report_device_run(text)
    _, hwall = cli(["--recover", weights, "--output", host_out,
                    "--device", "host", fasta],
                   os.path.join(work, "host.log"), gpu=False)
    say(f"  host run: invocation {hwall} s")
    got, want = center_signature(gpu_out), center_signature(ref)
    say(f"  {sum(got.values())} clusters; reference {sum(want.values())}")
    if got != want:
        raise PhaseError("gpu CLSTR differs from the reference in "
                         "membership or centers")
    if not same_bytes(gpu_out, host_out):
        raise PhaseError("gpu CLSTR is not byte-identical to the host run")
    say("  CLSTR matches the reference (membership, centers) and is "
        "byte-identical to --device host")


def phase_main_path(work: str, pool: str, weights: str) -> None:
    os.makedirs(work, exist_ok=True)
    gpu_out = os.path.join(work, "gpu.clstr")
    host_out = os.path.join(work, "host.clstr")
    text, wall = cli(["--recover", weights, "--output", gpu_out,
                      "--device", "gpu", pool],
                     os.path.join(work, "gpu.log"), gpu=True)
    say(f"  gpu run: clustering window {window_seconds(text)} s, whole "
        f"invocation {wall} s")
    report_device_run(text)
    htext, hwall = cli(["--recover", weights, "--output", host_out,
                        "--device", "host", pool],
                       os.path.join(work, "host.log"), gpu=False)
    say(f"  host run (native): clustering window {window_seconds(htext)} s, "
        f"whole invocation {hwall} s")
    if not same_bytes(gpu_out, host_out):
        raise PhaseError("gpu CLSTR is not byte-identical to the host run")
    say("  CLSTR byte-identical to --device host")


def phase_training(work: str) -> None:
    """A full training run (no --recover) with the device pair tables, then
    clustering; CLSTR and the selected model must equal the host run's."""
    import numpy as np

    from meshclust2_tpu.model.weights import load_weights

    small = os.path.join(FIX, "small.fasta")
    outs = {}
    for side in ("gpu", "host"):
        d = os.path.join(work, side)
        os.makedirs(d, exist_ok=True)
        text, wall = cli(["--id", "0.9", "--kmer", "5", "--mut-type",
                          "single", "--output", "out.clstr", "--device",
                          side, small], os.path.join(d, "run.log"),
                         gpu=(side == "gpu"), cwd=d)
        say(f"  {side} run: invocation {wall} s")
        if side == "gpu" and "device training tables unavailable" in text:
            raise PhaseError("the gpu run built its pair tables on the host")
        outs[side] = (os.path.join(d, "out.clstr"),
                      load_weights(os.path.join(d, "weights.txt")).classifier)
    (gc, gm), (hc, hm) = outs["gpu"], outs["host"]
    if (gm.combos, gm.singles) != (hm.combos, hm.singles):
        raise PhaseError("gpu training selected other features than host")
    if not (np.array_equal(np.asarray(gm.mins), np.asarray(hm.mins))
            and np.array_equal(np.asarray(gm.maxs), np.asarray(hm.maxs))):
        raise PhaseError("gpu normalization bounds differ from host")
    gw, hw = np.asarray(gm.weights), np.asarray(hm.weights)
    rel = float(np.max(np.abs(gw - hw) / np.maximum(np.abs(hw), 1e-300)))
    say(f"  selections equal; weights max relative difference {rel} "
        "(tolerance 1e-7)")
    if not np.allclose(gw, hw, rtol=1e-7, atol=1e-9):
        raise PhaseError("gpu weights differ from host beyond 1e-7")
    if not same_bytes(gc, hc):
        raise PhaseError("gpu CLSTR is not byte-identical to the host run")
    say("  CLSTR byte-identical to --device host")


def phase_fastcar(work: str) -> None:
    """fastcar's device search (MC2_FASTCAR_DEVICE=1) against its host
    search, on tests/test_fastcar_device.py's fixture."""
    os.makedirs(work, exist_ok=True)
    recs, cur = [], None
    with open(os.path.join(FIX, "med2000.fasta")) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                cur = [line, []]
                recs.append(cur)
            elif line and cur:
                cur[1].append(line)
    db, q = os.path.join(work, "db.fasta"), os.path.join(work, "q.fasta")
    for path, part in ((db, recs[:250]), (q, recs[250:280])):
        with open(path, "w") as f:
            for h, s in part:
                f.write(h + "\n" + "\n".join(s) + "\n")
    weights = os.path.join(work, "fc_weights.txt")
    fc = [sys.executable, "-m", "meshclust2_tpu.fastcar", db, "-q", q,
          "--id", "0.9", "-m", "rc"]
    run_child(fc + ["--mut-type", "single", "--dump", weights, "-o",
                    os.path.join(work, "ignored.search")],
              os.path.join(work, "train.log"), gpu=False, cwd=work)
    _, hwall = run_child(fc + ["--recover", weights, "-o",
                               os.path.join(work, "host.search")],
                         os.path.join(work, "host.log"), gpu=False, cwd=work)
    text, wall = run_child(fc + ["--recover", weights, "-o",
                                 os.path.join(work, "dev.search")],
                           os.path.join(work, "dev.log"), gpu=True, cwd=work,
                           extra_env={"MC2_FASTCAR_DEVICE": "1"})
    say(f"  device run: invocation {wall} s; host run {hwall} s")
    if "fastcar device path unavailable" in text:
        raise PhaseError("fastcar fell back to the host path")
    host, dev = (os.path.join(work, n + ".search0") for n in ("host", "dev"))
    with open(host) as f:
        n = len(f.read().splitlines())
    if n <= 20:
        raise PhaseError(f"the search found only {n} matches")
    if not same_bytes(host, dev):
        raise PhaseError("device output.search differs from the host's")
    say(f"  {n} matches; output byte-identical to the host path")


def phase_four(work: str, pool: str, weights: str, rehearse: bool) -> dict:
    """One process, --multihost with MC2_NPROCS unset, over every local
    card, against the host oracle.  Returns the device line."""
    os.makedirs(work, exist_ok=True)
    mh_out = os.path.join(work, "multihost.clstr")
    host_out = os.path.join(work, "host.clstr")
    _, hwall = cli(["--recover", weights, "--output", host_out,
                    "--device", "host", pool],
                   os.path.join(work, "host.log"), gpu=False)
    say(f"  host oracle: invocation {hwall} s")
    extra = {"MC2_NPROCS": "1"}
    if rehearse:
        extra["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                              " --xla_force_host_platform_device_count=4")
    text, wall = cli(["--multihost", "--device", "gpu", "--recover", weights,
                      "--output", mh_out, pool],
                     os.path.join(work, "multihost.log"), gpu=True,
                     extra_env=extra)
    dev = device_line(text)
    say(f"  multihost run: {dev['count']} {dev['platform']} devices "
        f"({dev['kind']}), clustering window {window_seconds(text)} s, "
        f"invocation {wall} s")
    m = re.search(r"multihost: .*counts \((\d+), (\d+)\) over (\d+) "
                  r"devices, (\d+) local shards of (\d+) rows", text)
    if m is None:
        raise PhaseError("the multihost run printed no sharding line")
    rows, ndev, nshard, srows = (int(m.group(i)) for i in (1, 3, 4, 5))
    say(f"  counts [{rows}, {m.group(2)}] over {ndev} devices, {nshard} "
        f"shards of {srows} rows")
    if dev["count"] != 4 or ndev != 4 or nshard != 4 or srows * 4 != rows:
        raise PhaseError("the counts array is not sharded over 4 devices")
    report_device_run(text)
    if not same_bytes(mh_out, host_out):
        raise PhaseError("multihost CLSTR is not byte-identical to the host "
                         "oracle")
    say("  CLSTR byte-identical to the host oracle")
    return dev


# -- the card child: phases 1-3 ----------------------------------------------------

def median_seconds(fn, reps: int) -> float:
    """Median wall time of fn() over reps calls after one warm-up; fn must
    return only once its device work has finished."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def kernels_child(args) -> int:
    import jax

    devs = jax.devices()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    say(f"JAX: platform={dev['platform']} device_kind={dev['kind']} "
        f"count={dev['count']} (jax {jax.__version__})")
    out = {"device": dev, "phases": {}}
    result = os.path.join(args.work, "kernels.json")
    if dev["platform"] != "gpu" and not args.rehearse:
        with open(result, "w") as f:
            json.dump(out, f)
        return NO_DEVICE
    jax.config.update("jax_enable_x64", True)
    sz = REHEARSAL if args.rehearse else FULL
    phases = {int(x) for x in args.phases.split(",")}
    import bench

    pool = os.path.join(args.work, "pool.fasta")
    if phases & {2, 3, 5}:
        t0 = time.perf_counter()
        bench.write_pool(pool, sz["n_seqs"], sz["n_templates"], args.seed)
        say(f"pool: {sz['n_seqs']} sequences in {sz['n_templates']} "
            f"families, seed {args.seed}, written in "
            f"{time.perf_counter() - t0} s")
    ctx = {}
    for n, fn in ((2, compile_session), (3, kernel_checks)):
        if n not in phases:
            continue
        say(f"== phase {n}")
        try:
            fn(args, sz, pool, ctx)
            out["phases"][n] = True
            say(f"phase {n}: ok")
        except Exception:  # noqa: BLE001 - reported, fails the run
            traceback.print_exc(file=sys.stdout)
            out["phases"][n] = False
            say(f"phase {n}: FAILED")
    with open(result, "w") as f:
        json.dump(out, f)
    return 0


def compile_session(args, sz, pool, ctx) -> None:
    """Phase 2: the DeviceSession for the pool, built as the CLI builds it
    (store upload, combined program trace+lower+compile, forced uploads)."""
    import jax

    from meshclust2_tpu.cli import load_sorted_points
    from meshclust2_tpu.cluster.device_session import DeviceSession
    from meshclust2_tpu.model.classifier import CompiledModel
    from meshclust2_tpu.model.weights import load_weights

    pred = load_weights(os.path.join(FIX, "bench10k_weights.txt"))
    _, ps = load_sorted_points([pool], [], pred.k, pred.datatype, False,
                               keep_seqs_train=False)
    ps.seqs = None
    model = CompiledModel(pred.classifier)
    t0 = time.perf_counter()
    sess = DeviceSession(ps, model, pred.id_cutoff)
    say(f"  DeviceSession: {ps.n} rows x {ps.dim} ({ps.counts.dtype}), "
        f"built in {time.perf_counter() - t0} s")
    if sess.combined is None:
        raise PhaseError("no combined program for the pool")
    ma = sess.combined._ready[2].memory_analysis()
    for name in ("argument_size_in_bytes", "output_size_in_bytes",
                 "alias_size_in_bytes", "temp_size_in_bytes",
                 "generated_code_size_in_bytes"):
        say(f"  memory_analysis {name}: {getattr(ma, name, 'n/a')}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"  bytes_in_use after set-up: {stats.get('bytes_in_use', 'n/a')} "
        f"of bytes_limit {stats.get('bytes_limit', 'n/a')}")
    ctx.update(ps=ps, model=model, sim=pred.id_cutoff, sess=sess)


def kernel_checks(args, sz, pool, ctx) -> None:
    """Phase 3: kernel exactness and timings at real widths, then the device
    cost constants on the pool's session."""
    failures = []
    check_emd(sz, args.seed, failures)
    check_dd(sz, args.seed, failures)
    check_scorer(sz, args.seed, failures, args.work)
    if "sess" not in ctx:
        compile_session(args, sz, pool, ctx)
    measure_costs(ctx)
    if failures:
        raise PhaseError("; ".join(failures))


def emd_blocked_matmul(jax, jnp, diff_i32, maxc: int):
    """The EMD prefix as D/128 [WC,128]x[128,128] triangular matmuls with a
    carry between blocks: the form emd_rowsum's cumsum was chosen over,
    kept here to time the two.  DEFAULT precision (TF32 on the GPU, exact
    for |diff| <= 2048) while maxc <= 256, HIGHEST above."""
    import numpy as np

    wc, d = diff_i32.shape
    blk = 128 if d % 128 == 0 else d
    tri = np.triu(np.ones((blk, blk), np.float32))
    diff = diff_i32.astype(jnp.float32)
    prec = (jax.lax.Precision.DEFAULT if maxc <= 256
            else jax.lax.Precision.HIGHEST)
    emd = np.zeros((wc,), np.int64)
    carry = np.zeros((wc, 1), np.float32)
    for b in range(d // blk):
        pref = jnp.matmul(diff[:, b * blk:(b + 1) * blk], tri,
                          precision=prec) + carry
        emd = emd + jnp.abs(pref).astype(jnp.int32).sum(
            axis=1, dtype=jnp.int32).astype(jnp.int64)
        carry = pref[:, -1:]
    return emd


def check_emd(sz, seed, failures) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from meshclust2_tpu.cluster.device_loop import emd_rowsum

    rng = np.random.default_rng(seed)
    wc = sz["wc"]
    for d in sz["widths"]:
        for maxc in (255, 4095):
            prec = "DEFAULT" if maxc <= 256 else "HIGHEST"
            blk = rng.integers(0, maxc + 1, (wc, d), dtype=np.int32)
            cen = rng.integers(0, maxc + 1, d, dtype=np.int32)
            diff = blk - cen[None, :]
            want = np.abs(np.cumsum(diff.astype(np.int64), axis=1)).sum(1)
            forms = (("emd_rowsum (cumsum)", jax.jit(
                         lambda x: emd_rowsum(jnp, x))),
                     (f"blocked matmul ({prec})", jax.jit(
                         lambda x, maxc=maxc: emd_blocked_matmul(
                             jax, jnp, x, maxc))))
            x = jnp.asarray(diff)
            parts = []
            for name, f in forms:
                exact = bool(np.array_equal(np.asarray(f(x)), want))
                t = median_seconds(lambda f=f: f(x).block_until_ready(),
                                   sz["reps"])
                parts.append(f"{name} {'bit-exact' if exact else 'WRONG'} "
                             f"{t * 1e6} us")
                if not exact:
                    failures.append(f"{name} D={d} maxc={maxc}")
            say(f"  EMD prefix WC={wc} D={d} maxc={maxc}: "
                + "; ".join(parts) + " (tolerance 0 vs the int64 oracle)")


def check_dd(sz, seed, failures) -> None:
    import jax
    import numpy as np

    from meshclust2_tpu.ops import ddf32 as DD

    rng = np.random.default_rng(seed + 1)
    n = sz["dd_n"]
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
         ).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
         ).astype(np.float32)
    p, e = jax.jit(DD.two_prod)(a, b)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    exact = bool(np.array_equal(got, a.astype(np.float64) *
                                b.astype(np.float64)))
    say(f"  two_prod under jit on {n} random f32 pairs: "
        f"{'error-free (p + e == a * b exactly)' if exact else 'NOT EXACT'}"
        " (tolerance 0)")
    if not exact:
        failures.append("two_prod")
    x64 = rng.uniform(0.5, 2.0, n) * 2.0 ** rng.integers(-20, 20, n)
    y64 = rng.uniform(0.5, 2.0, n) * 2.0 ** rng.integers(-20, 20, n)
    x, y = DD.split_f64(x64), DD.split_f64(y64)
    bound = 2.0 ** -44
    ops = (("mul", lambda x, y: DD.dd_mul(x, y), x64 * y64),
           ("div", lambda x, y: DD.dd_div(x, y), x64 / y64),
           ("sqrt", lambda x, y: DD.dd_sqrt(x), np.sqrt(x64)))
    for name, fn, want in ops:
        r = jax.jit(fn)(x, y)
        rel = float(np.max(np.abs(DD.dd_to_f64(r) - want) / np.abs(want)))
        say(f"  dd_{name} under jit: max relative error {rel} (bound "
            f"{bound})")
        if not rel <= bound:
            failures.append(f"dd_{name}")


def check_scorer(sz, seed, failures, work) -> None:
    import numpy as np

    import bench
    from meshclust2_tpu.cli import load_sorted_points
    from meshclust2_tpu.cluster.engine import HostScorer
    from meshclust2_tpu.io.fasta import read_fasta
    from meshclust2_tpu.kmer.counting import build_point_set
    from meshclust2_tpu.model.classifier import CompiledModel
    from meshclust2_tpu.model.weights import load_weights
    from meshclust2_tpu.ops.device_features import DeviceScorer

    pred = load_weights(os.path.join(FIX, "med2000_weights.txt"))
    model = CompiledModel(pred.classifier)
    ps, _ = load_sorted_points([os.path.join(FIX, "med2000.fasta")], [],
                               pred.k, pred.datatype, False,
                               keep_seqs_train=False)
    rng = np.random.default_rng(seed + 2)
    m = sz["scorer_pairs"]
    a, b = rng.integers(0, ps.n, m), rng.integers(0, ps.n, m)
    hp, hd = HostScorer(ps, model).score(a, b)
    dp, dd = DeviceScorer(ps, model).score(a, b)
    dec = bool(np.array_equal(np.floor(hp + .5), np.floor(dp + .5)))
    arg = int(np.argmax(dd)) == int(np.argmax(hd)) and \
        dd[np.argmax(dd)] == hd[np.argmax(hd)]
    close = bool(np.allclose(hd, dd, rtol=5e-4, atol=1e-6))
    say(f"  DeviceScorer vs HostScorer on {m} med2000 pairs: rounded "
        f"decisions {'exact' if dec else 'DIFFER'}, argmax and its value "
        f"{'exact' if arg else 'DIFFER'}, values "
        f"{'within' if close else 'OUTSIDE'} rtol 5e-4 / atol 1e-6")
    if not (dec and arg and close):
        failures.append("DeviceScorer decisions")

    # timings on u8 stores at the widths the clustering uses
    path = os.path.join(work, "scorer.fasta")
    n_rows = 2 * sz["batch"]
    bench.write_pool(path, n_rows, max(n_rows // 64, 1), seed)
    recs = read_fasta(path)
    B = sz["batch"]
    for k in (5, 6) if sz is FULL else (3, 4):
        sps = build_point_set(recs, k, "uint8_t")
        scorer = DeviceScorer(sps, model)
        win = (np.arange(B), np.zeros(B, np.int64))
        mixed = (rng.integers(0, sps.n, B), rng.integers(0, sps.n, B))
        t = {name: median_seconds(lambda ab=ab: scorer.score(*ab),
                                  sz["reps"])
             for name, ab in (("window", win), ("mixed", mixed))}
        say(f"  DeviceScorer.score B={B} D={sps.dim} u8: center-vs-window "
            f"{t['window'] * 1e3} ms, mixed {t['mixed'] * 1e3} ms")


def measure_costs(ctx) -> None:
    """The device cost model's constants on the pool's session:
    accumulate us/step and ns/pair from launches of the combined program
    with its update phase switched off (a fresh run, a run from a
    host-resolved midpoint, and a one-step completion launch whose time is
    the per-launch overhead both others pay), and update-phase seconds per
    iteration from a completion launch that runs only the phase."""
    import numpy as np

    from meshclust2_tpu.cluster.bvec import BVec
    from meshclust2_tpu.cluster.device_loop import ResumeState
    from meshclust2_tpu.cluster.engine import MeanShiftEngine
    from meshclust2_tpu.native import NativeScorer

    ps, model, sim, sess = ctx["ps"], ctx["model"], ctx["sim"], ctx["sess"]
    comb, acc = sess.combined, sess.accumulator

    def fresh_bv():
        bv = BVec(ps.lengths, 1000)
        bv.insert_all(ps.lengths)
        bv.insert_finalize(ps.lengths)
        return bv

    eng = MeanShiftEngine(ps, model, sim,
                          scorer=NativeScorer.create(ps, model))
    t0 = time.perf_counter()
    host_acc = [(c.center_row, list(c.members))
                for c in eng.accumulate_all(fresh_bv())]
    say(f"  host native accumulate: {len(host_acc)} clusters in "
        f"{time.perf_counter() - t0} s")

    no_phase = {"ph_seg": np.int32(0)}
    for _ in range(2):           # the first launch warms the executable
        raw, state, _ = comb.run(sess.bv, carry=dict(no_phase))
    obs = [(acc.last_steps, acc.last_pairs, comb.last_exec_seconds)]
    say(f"  accumulate launch from the start: {obs[0][0]} steps, "
        f"{obs[0][1]} pairs, {obs[0][2]} s "
        + ("(completed; equals the host accumulate: "
           f"{raw == host_acc})" if state is None
           else f"(margin abort at stage {state.stage})"))
    if state is None and raw != host_acc:
        raise PhaseError("device accumulate differs from the host's")
    # per-launch overhead: the host's final state as a completion carry,
    # one loop step, no pairs, no phase
    done_carry = acc.make_carry(host_acc[:-1], list(host_acc[-1][1]),
                                host_acc[-1][0], np.zeros(0, np.int64))
    for _ in range(2):
        comb.run(sess.bv, carry={**done_carry, **no_phase})
    t_launch = comb.last_exec_seconds
    say(f"  one-step launch (overhead): {acc.last_steps} steps, "
        f"{t_launch} s")
    bv = fresh_bv()
    first = bv.pop()
    st0 = ResumeState(stage=1, clusters_done=[], current_rows=[first],
                      last_row=first, bv=bv)
    done, cur, last, bv2 = eng._resolve_steps_native(st0, obs[0][0] // 2)
    if last is not None:
        alive = np.concatenate([b for b in bv2.bins]) if bv2.size() \
            else np.zeros(0, np.int64)
        carry = acc.make_carry([(c.center_row, c.members) for c in done],
                               cur, last, alive)
        comb.run(bv2, carry={**carry, **no_phase})
        obs.append((acc.last_steps, acc.last_pairs, comb.last_exec_seconds))
        say(f"  accumulate launch from a host-resolved midpoint "
            f"({len(done)} clusters done): {obs[1][0]} steps, {obs[1][1]} "
            f"pairs, {obs[1][2]} s")
        A = np.array([[s, p] for s, p, _ in obs], np.float64)
        y = (np.array([t for _, _, t in obs], np.float64) - t_launch) * 1e6
        try:
            step_us, pair_us = np.linalg.solve(A, y)
            say(f"  accumulate cost model: {step_us} us/step + "
                f"{pair_us * 1e3} ns/pair")
        except np.linalg.LinAlgError:
            say("  accumulate cost model: not resolved (singular)")

    # update phase alone: the same completion carry with the phase on; the
    # program closes the last cluster and runs the whole in-program phase
    for _ in range(2):
        _, _, phres = comb.run(sess.bv, carry=dict(done_carry))
    if phres is None:
        say("  update phase: not run in-program (slot bucket or segment "
            "limit)")
        return
    secs = comb.last_exec_seconds - t_launch
    say(f"  update phase in-program: {phres.it} iterations, {phres.pairs} "
        f"pairs, abort {phres.abort}, {secs} s beyond the launch overhead "
        f"at the {sess.phase.NB}-row bucket -> {secs / max(phres.it, 1)} "
        "s/iteration")
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    say(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'n/a')}")


# -- driver ---------------------------------------------------------------------------

def run_phase(n: int, name: str, fn, results: dict) -> None:
    say(f"== phase {n}: {name}")
    try:
        fn()
        results[n] = True
        say(f"phase {n}: ok")
    except Exception:  # noqa: BLE001 - reported, fails the run
        traceback.print_exc(file=sys.stdout)
        results[n] = False
        say(f"phase {n}: FAILED")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path over four GPUs and its "
                    "comparison with the host oracle")
    ap.add_argument("--rehearse", action="store_true",
                    help="run on XLA:CPU at small sizes (set "
                    "JAX_PLATFORMS=cpu); prints no result line")
    ap.add_argument("--phases", default=",".join(map(str, ALL_PHASES)),
                    help="comma-separated phases to run (1 always runs)")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed of the generated data (default: bench.py's)")
    ap.add_argument("--work", default=os.path.join(REPO, ".smoke"),
                    help="scratch directory (emptied first)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "meshclust2_tpu")):
        print("chip_smoke.py: meshclust2_tpu not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import bench

    if args.seed is None:
        args.seed = bench.SEED
    if args.child == "kernels":
        return kernels_child(args)
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    sz = REHEARSAL if args.rehearse else FULL
    weights = os.path.join(FIX, "bench10k_weights.txt")
    pool = os.path.join(args.work, "pool.fasta")
    results = {}
    if args.four:
        t0 = time.perf_counter()
        bench.write_pool(pool, sz["n_seqs"], sz["n_templates"], args.seed)
        say(f"pool: {sz['n_seqs']} sequences, seed {args.seed}, written in "
            f"{time.perf_counter() - t0} s")
        phase_card()
        dev = {}
        run_phase(1, "sharded path over four devices",
                  lambda: dev.update(phase_four(
                      os.path.join(args.work, "four"), pool, weights,
                      args.rehearse)), results)
        return finish(results, dev, args.rehearse)

    phases = {int(x) for x in args.phases.split(",")} | {1}
    say("== phase 1: device and card")
    phase_card()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", "kernels",
         "--work", args.work, "--seed", str(args.seed),
         "--phases", ",".join(map(str, sorted(phases)))]
        + (["--rehearse"] if args.rehearse else []),
        cwd=REPO, env=child_env(gpu=True), timeout=CHILD_TIMEOUT)
    try:
        with open(os.path.join(args.work, "kernels.json")) as f:
            info = json.load(f)
    except OSError:
        print(f"chip_smoke.py: the device child exited {child.returncode} "
              "without a result", file=sys.stderr)
        return child.returncode or 1
    dev = info["device"]
    if child.returncode == NO_DEVICE:
        print(f"chip_smoke.py: JAX found no GPU (platform "
              f"{dev['platform']}); nothing to measure", file=sys.stderr)
        return NO_DEVICE
    results[1] = child.returncode == 0
    say(f"phase 1: {'ok' if results[1] else 'FAILED'}")
    for n, ok in info["phases"].items():
        results[int(n)] = ok
    if 4 in phases:
        run_phase(4, "reference parity (med2000)", lambda: phase_parity(
            os.path.join(args.work, "parity"),
            os.path.join(FIX, "med2000.fasta"),
            os.path.join(FIX, "med2000_weights.txt"),
            os.path.join(FIX, "med2000_ref.clstr")), results)
    if 5 in phases:
        run_phase(5, f"main path ({sz['n_seqs']} sequences)",
                  lambda: phase_main_path(os.path.join(args.work, "main"),
                                          pool, weights), results)
    if 6 in phases:
        run_phase(6, "full training run (small.fasta)", lambda:
                  phase_training(os.path.join(args.work, "train")), results)
    if 7 in phases:
        run_phase(7, "fastcar device path", lambda:
                  phase_fastcar(os.path.join(args.work, "fastcar")), results)
    return finish(results, dev, args.rehearse)


def finish(results: dict, dev: dict, rehearse: bool) -> int:
    ok = bool(results) and all(results.values())
    say("phases: " + ", ".join(f"{n} {'ok' if v else 'FAILED'}"
                               for n, v in sorted(results.items())))
    if "jax" in sys.modules:
        raise RuntimeError("the smoke's parent process imported JAX")
    if rehearse:
        say(f"rehearsal {'passed' if ok else 'FAILED'} (no result line)")
        return 0 if ok else 1
    say(json.dumps({"ok": ok, "device": {
        "platform": dev.get("platform"), "kind": dev.get("kind"),
        "count": dev.get("count")}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
