#!/usr/bin/env python
"""Benchmark: sequences/sec clustered at --id 0.9 (recover path), ours vs the
reference C++ binary on the same machine/dataset.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "seqs/s", "vs_baseline": R}

Methodology (BASELINE.md): seqs/sec = N / (t_done - t_read_in_points), i.e.
training excluded (both sides load a shared weights.txt via --recover), FASTA
parse + k-mer counting excluded, clustering included.  The reference is built
from /root/reference sources (copied to BENCH_DIR, patched for a missing
<limits> include) and run with all cores.

Ours is measured on BOTH paths and the device is part of the metric name:
  - host: the native AVX-512 scorer (CPU), run with JAX_PLATFORMS=cpu;
  - gpu:  the device-session programs (cluster/device_session.py) on the
    GPU, each run in its own process, one at a time, so one process holds
    the card; backend bring-up and compilation happen before the
    read_in_points stamp so the measured window is clustering only.
The headline metric is the GPU path (BENCH_DEVICE overrides: host / gpu /
both).  A GPU run that fails fails the bench; it never headlines the host.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.join(REPO, ".bench")
REF_SRC = "/root/reference"
N_SEQS = int(os.environ.get("BENCH_N_SEQS", "10000"))
N_TEMPLATES = int(os.environ.get("BENCH_N_TEMPLATES", "200"))
SEED = 424242


def log(*a):
    print(*a, file=sys.stderr)


def write_pool(path: str, n_seqs: int, n_templates: int,
               seed: int = SEED) -> None:
    """Synthetic pool: n_templates random 800-1,500 bp templates, each with
    n_seqs // n_templates mutated copies (1-12% substitution+deletion)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    per = n_seqs // n_templates
    with open(path, "w") as f:
        for t in range(n_templates):
            tl = int(rng.integers(800, 1500))
            tmpl = rng.integers(0, 4, tl)
            for j in range(per):
                rate = rng.uniform(0.01, 0.12)
                r = rng.random(tl)
                keep = r >= rate * 0.3
                sub = r < rate * 0.7
                seq = np.where(sub, rng.integers(0, 4, tl), tmpl)[keep]
                s = bases[seq].tobytes().decode()
                f.write(f">seq{t}_{j} template_{t}\n")
                for i in range(0, len(s), 70):
                    f.write(s[i : i + 70] + "\n")


def ensure_dataset(path: str) -> None:
    if os.path.exists(path):
        return
    write_pool(path, N_SEQS, N_TEMPLATES)
    log(f"dataset: {path} ({N_SEQS} seqs)")


def ensure_reference_binary() -> str | None:
    exe = os.path.join(BENCH_DIR, "refbin", "meshclust2")
    if os.path.exists(exe):
        return exe
    try:
        src = os.path.join(BENCH_DIR, "refsrc")
        if not os.path.exists(src):
            shutil.copytree(REF_SRC, src)
            bvec = os.path.join(src, "src/cluster/bvec.cpp")
            with open(bvec) as f:
                txt = f.read()
            if "#include <limits>" not in txt:
                txt = txt.replace(
                    "#include <algorithm>", "#include <algorithm>\n#include <limits>"
                )
                with open(bvec, "w") as f:
                    f.write(txt)
            # The release build (-O3/-O2, with or without -march=native)
            # segfaults after read_in_points on >~10k-sequence pools — a
            # latent UB bug in the upstream bvec/accumulate path.  Compiling
            # with -DDEBUG (which only adds progress prints in accumulate)
            # perturbs codegen enough to run reliably, so the baseline is
            # measured with that build.
            cml = os.path.join(src, "CMakeLists.txt")
            with open(cml) as f:
                txt = f.read()
            txt = txt.replace(
                '-fopenmp -g -O3 -march=native -std=c++11',
                '-fopenmp -g -O3 -march=native -std=c++11 -DDEBUG',
            )
            with open(cml, "w") as f:
                f.write(txt)
        bld = os.path.join(BENCH_DIR, "refbuild")
        os.makedirs(bld, exist_ok=True)
        subprocess.run(["cmake", src], cwd=bld, check=True, capture_output=True)
        subprocess.run(["make", "-j", str(os.cpu_count() or 2)], cwd=bld,
                       check=True, capture_output=True)
        os.makedirs(os.path.dirname(exe), exist_ok=True)
        shutil.copy(os.path.join(src, "bin", "meshclust2"), exe)
        return exe
    except Exception as e:  # build failure -> no baseline available
        log("reference build failed:", e)
        return None


def ensure_weights(fasta: str, weights: str) -> None:
    if os.path.exists(weights):
        return
    log("training classifier for shared weights ...")
    # a host-only child: this process never opens the card
    subprocess.run(
        [sys.executable, "-m", "meshclust2_tpu.cli", "--id", "0.9",
         "--kmer", "5", "--mut-type", "single", "--dump", weights,
         "--device", "host", fasta],
        check=True, cwd=BENCH_DIR, capture_output=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": REPO + os.pathsep + os.environ.get(
                 "PYTHONPATH", "")})


def parse_timestamps(text: str) -> dict:
    out = {}
    for m in re.finditer(r"timestamp (\S+) ([0-9.eE+-]+)", text):
        out[m.group(1)] = float(m.group(2))
    return out


def run_reference(exe: str, fasta: str, weights: str, retries: int = 5) -> float | None:
    """The upstream binary segfaults nondeterministically on large pools
    (ASLR-dependent out-of-bounds read in its candidate-window path), so
    retry a few times and take the first clean run."""
    out = os.path.join(BENCH_DIR, f"ref_out_{N_SEQS}.clstr")
    for attempt in range(retries):
        try:
            p = subprocess.run(
                [exe, "--recover", weights, "--output", out, fasta],
                capture_output=True, text=True, timeout=3 * 3600, cwd=BENCH_DIR,
            )
            ts = parse_timestamps(p.stdout)
            if "done" in ts and "read_in_points" in ts:
                return N_SEQS / (ts["done"] - ts["read_in_points"])
            log(f"reference attempt {attempt}: rc={p.returncode} (upstream "
                "crash); retrying")
        except Exception as e:
            log("reference run failed:", e)
    return None


LAST_BREAKDOWN: dict | None = None


def parse_phase_breakdown(text: str, ts: dict) -> dict:
    """Device-path phase split from the MC2_DEVICE_PROF lines + timestamps."""
    out = {}
    m = re.search(r"device session: store\+updater ([0-9.]+)s, accumulate "
                  r"ready ([0-9.]+)s, phase ready ([0-9.]+)s, force "
                  r"([0-9.]+)s", text)
    if m:
        out["bringup_store_s"] = float(m.group(1))
        out["bringup_accumulate_compile_s"] = float(m.group(2))
        out["bringup_phase_compile_s"] = float(m.group(3))
        out["bringup_upload_force_s"] = float(m.group(4))
    m = re.search(r"device combined ready: upload-dispatch ([0-9.]+)s, "
                  r"trace\+lower ([0-9.]+)s, compile ([0-9.]+)s, "
                  r"arg-force ([0-9.]+)s", text)
    if m:
        out["bringup_lower_s"] = float(m.group(2))
        out["bringup_compile_s"] = float(m.group(3))
        out["bringup_upload_force_s"] = float(m.group(4))
    ex = [float(x) for x in
          re.findall(r"device combined: execute ([0-9.]+)s", text)]
    if ex:
        out["combined_execute_s"] = round(sum(ex), 3)
        out["combined_dispatches"] = len(ex)
    m = re.search(r"device accumulate: (\d+) steps, (\d+) windows", text)
    if m:
        out["accumulate_steps"] = int(m.group(1))
    m = re.search(r"device update phase: ([0-9.]+)s, (\d+) iterations, "
                  r"(\d+) pairs", text)
    if m:
        out["update_execute_s"] = float(m.group(1))
        out["update_iterations"] = int(m.group(2))
        out["update_pairs"] = int(m.group(3))
    if "done" in ts and "read_in_points" in ts:
        out["clustering_window_s"] = round(ts["done"] - ts["read_in_points"], 3)
    return out


LAST_DEVICE: dict | None = None


def run_ours(fasta: str, weights: str, device: str,
             timeout: int = 3600) -> float | None:
    """One clustering run in its own process (the only one on the card);
    the host run stays off the GPU.  Returns seqs/s or None."""
    global LAST_BREAKDOWN, LAST_DEVICE
    out = os.path.join(BENCH_DIR, f"ours_out_{device}_{N_SEQS}.clstr")
    env = dict(os.environ)
    env.setdefault("MC2_DEVICE_PROF", "1")
    if device == "host":
        env["JAX_PLATFORMS"] = "cpu"
    try:
        p = subprocess.run(
            [sys.executable, "-m", "meshclust2_tpu.cli",
             "--recover", weights, "--output", out,
             "--device", device, fasta],
            capture_output=True, text=True, timeout=timeout,
            cwd=REPO, env=env,
        )
    except subprocess.TimeoutExpired:
        log(f"ours ({device}): timed out after {timeout}s")
        return None
    sys.stderr.write((p.stdout or "")[-1500:] + "\n")
    ts = parse_timestamps(p.stdout or "")
    if p.returncode == 0 and "done" in ts and "read_in_points" in ts:
        if device == "gpu":
            LAST_BREAKDOWN = parse_phase_breakdown(p.stdout or "", ts)
            m = re.search(r"device: platform=(\S+) kind=(.+) count=(\d+)",
                          p.stdout or "")
            if m:
                LAST_DEVICE = {"platform": m.group(1), "kind": m.group(2),
                               "count": int(m.group(3))}
        return N_SEQS / (ts["done"] - ts["read_in_points"])
    log(f"ours ({device}): rc={p.returncode} {(p.stderr or '')[-400:]}")
    return None


def main() -> int:
    os.makedirs(BENCH_DIR, exist_ok=True)
    fasta = os.path.join(BENCH_DIR, f"bench_{N_SEQS}.fasta")
    weights = os.path.join(BENCH_DIR, f"bench_{N_SEQS}_weights.txt")
    ensure_dataset(fasta)
    ensure_weights(fasta, weights)

    mode = os.environ.get("BENCH_DEVICE", "both")
    repeats = int(os.environ.get("BENCH_REPEATS", "2"))

    def measure(device, timeout):
        t0 = time.time()
        vals = [run_ours(fasta, weights, device, timeout=timeout)
                for _ in range(repeats)]
        vals = [v for v in vals if v]
        best = max(vals) if vals else None
        log(f"ours ({device}): {best and round(best, 1)} seqs/s "
            f"(wall {time.time()-t0:.0f}s, best of {repeats})")
        return best

    results = {}
    if mode in ("host", "both"):
        results["host"] = measure("host", timeout=3600)
    if mode in ("gpu", "both"):
        # generous per-run timeout: first run compiles the device program
        results["gpu"] = measure("gpu", timeout=1500)
        if results["gpu"] is None:
            log("the GPU runs failed")
            return 1
    device = "gpu" if "gpu" in results else "host"
    ours = results.get(device)
    if ours is None:
        log("no successful runs")
        return 1

    ref_rate = None
    exe = ensure_reference_binary()
    if exe:
        t0 = time.time()
        rates = [run_reference(exe, fasta, weights) for _ in range(repeats)]
        rates = [r for r in rates if r]
        ref_rate = max(rates) if rates else None
        log(f"reference: {ref_rate and round(ref_rate,1)} seqs/s (wall {time.time()-t0:.0f}s, best of {repeats})")

    vs = (ours / ref_rate) if ref_rate else None
    extra = {f"{d}_seqs_per_sec": round(v, 2)
             for d, v in results.items() if v and d != device}
    if ref_rate is None and exe:
        # the reference crashes on every attempt at this scale (latent UB,
        # see ensure_reference_binary); report the ratio against its best
        # measured rate anywhere (2,325 seqs/s at 10k, BASELINE.md) so the
        # number is still comparable
        extra["vs_reference_best_measured"] = round(ours / 2325.0, 3)
        extra["note"] = ("reference binary crashes at this scale; ratio is "
                         "vs its best measured rate (2325/s at 10k)")
    if device == "gpu" and LAST_BREAKDOWN:
        extra["gpu_phase_breakdown"] = LAST_BREAKDOWN
    if device == "gpu" and LAST_DEVICE:
        extra["device"] = LAST_DEVICE
    print(json.dumps({
        "metric": f"seqs_per_sec_cluster_{N_SEQS}_id0.9_recover_{device}",
        "value": round(ours, 2),
        "unit": "seqs/s",
        "vs_baseline": round(vs, 3) if vs else None,
        **extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
