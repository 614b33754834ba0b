"""Multi-process skeleton (parallel/multihost.py): the same CLSTR must come
out of 1 and 2 processes (VERDICT r2 next-step 6; reference analog is
--threads scaling, CRunner.cpp:407-422).

Each process is a real OS process with its own jax.distributed runtime on
the CPU backend (4 virtual devices per process -> an 8-device global mesh).
"""
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count={per_proc}"
import jax
jax.config.update("jax_platforms", "cpu")
from meshclust2_tpu.cli import main
rc = main([
    "--multihost",
    "--recover", {weights!r},
    "--output", {out!r},
    {fasta!r},
])
sys.exit(rc)
"""


def _launch(nprocs, per_proc, weights, fasta, out, port):
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update({
            "MC2_NPROCS": str(nprocs),
            "MC2_PROC_ID": str(pid),
            "MC2_COORD": f"localhost:{port}",
            "MC2_DEVICE_PROF": "1",
        })
        code = _WORKER.format(repo=_REPO, per_proc=per_proc,
                              weights=weights, fasta=fasta,
                              out=out if pid == 0 else out + f".p{pid}")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=_REPO))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{se[-2500:]}"
    return outs


@pytest.mark.slow
def test_multihost_2proc_matches_1proc(fixtures_dir, tmp_path):
    weights = os.path.join(fixtures_dir, "small_ref_weights.txt")
    fasta = os.path.join(fixtures_dir, "small.fasta")
    out1 = str(tmp_path / "mh1.clstr")
    out2 = str(tmp_path / "mh2.clstr")
    _launch(1, 8, weights, fasta, out1, port=19731)
    outs2 = _launch(2, 4, weights, fasta, out2, port=19732)
    assert open(out1).read() == open(out2).read()
    # the multi-process run must go through the device-session combined
    # program (GSPMD over the global mesh), not the per-window
    # MultihostScorer dispatch (VERDICT r4 next-step 5)
    for so, _se in outs2:
        assert "device combined: execute" in so, \
            "2-proc run did not use the device-session programs"

    # and the multihost output equals the standard single-process host path
    from meshclust2_tpu.cli import main

    ref = str(tmp_path / "host.clstr")
    rc = main(["--recover", weights, "--output", ref, "--device", "host",
               fasta])
    assert rc == 0
    assert open(out1).read() == open(ref).read()


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"MC2_NPROCS": "1"}, None),
    ({"MC2_NPROCS": "2", "MC2_PROC_ID": "1", "MC2_COORD": "localhost:1234"},
     {"coordinator_address": "localhost:1234", "num_processes": 2,
      "process_id": 1, "local_device_ids": [1]}),
    ({"MC2_NPROCS": "2", "MC2_PROC_ID": "0", "MC2_COORD": "host0:1234"},
     {"coordinator_address": "host0:1234", "num_processes": 2,
      "process_id": 0}),
])
def test_distributed_args(env, want):
    """One process drives every local device; processes that share a host
    (localhost coordinator) each open only the card of their process id,
    and processes on other hosts see all of theirs."""
    from meshclust2_tpu.parallel.multihost import distributed_args

    assert distributed_args(env) == want
