"""Device-resident accumulate loop (cluster/device_loop.py) parity.

Runs the on-device while_loop program on the CPU backend and checks exact
CLSTR equality (member order included) against the proven host path, plus
the guarded-abort -> host-resume machinery under forced margins.
"""
import os

import numpy as np
import pytest

from meshclust2_tpu.io.clstr import parse_clstr


def _run_cli(fixtures_dir, tmp_path, name, env=None, fasta="small.fasta",
             weights="small_ref_weights.txt"):
    from meshclust2_tpu.cli import main

    out = tmp_path / name
    saved = {}
    env = env or {}
    for k, v in env.items():
        saved[k] = os.environ.get(k)
        os.environ[k] = v
    try:
        rc = main([
            "--recover", os.path.join(fixtures_dir, weights),
            "--output", str(out),
            "--device", "host",
            os.path.join(fixtures_dir, fasta),
        ])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert rc == 0
    return parse_clstr(str(out))


def _exact(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert [m["header"] for m in ca] == [m["header"] for m in cb]
        assert [m["center"] for m in ca] == [m["center"] for m in cb]


def test_device_loop_small_parity(fixtures_dir, tmp_path):
    host = _run_cli(fixtures_dir, tmp_path, "host.clstr",
                    env={"MC2_NO_DEVICE_LOOP": "1"})
    dev = _run_cli(fixtures_dir, tmp_path, "dev.clstr",
                   env={"MC2_DEVICE_LOOP": "1", "MC2_DEVICE_STRICT": "1"})
    _exact(host, dev)


def test_device_loop_abort_resume_everywhere(fixtures_dir, tmp_path, capsys):
    """A giant margin makes the very first decision uncertain: the device
    must abort cleanly and the host continuation must reproduce the exact
    output."""
    host = _run_cli(fixtures_dir, tmp_path, "host.clstr",
                    env={"MC2_NO_DEVICE_LOOP": "1"})
    dev = _run_cli(fixtures_dir, tmp_path, "dev.clstr",
                   env={"MC2_DEVICE_LOOP": "1", "MC2_DD_MARGIN": "1e9"})
    _exact(host, dev)


@pytest.mark.parametrize("margin", ["3e-3", "2e-2"])
def test_device_loop_midrun_abort(fixtures_dir, tmp_path, margin):
    """Moderate margins abort somewhere mid-run; the stitched
    device-then-host output must still be exact."""
    host = _run_cli(fixtures_dir, tmp_path, "host.clstr",
                    env={"MC2_NO_DEVICE_LOOP": "1"})
    dev = _run_cli(fixtures_dir, tmp_path, "dev.clstr",
                   env={"MC2_DEVICE_LOOP": "1", "MC2_DD_MARGIN": margin})
    _exact(host, dev)


@pytest.mark.slow
def test_device_loop_med2000_parity(fixtures_dir, tmp_path):
    host = _run_cli(fixtures_dir, tmp_path, "host.clstr",
                    env={"MC2_NO_DEVICE_LOOP": "1"},
                    fasta="med2000.fasta", weights="med2000_weights.txt")
    dev = _run_cli(fixtures_dir, tmp_path, "dev.clstr",
                   env={"MC2_DEVICE_LOOP": "1", "MC2_DEVICE_STRICT": "1"},
                   fasta="med2000.fasta", weights="med2000_weights.txt")
    _exact(host, dev)


def test_ddf32_jit_exactness():
    """Canary for backend fast-math rewrites: the dd pipeline must keep
    ~2^-45 accuracy UNDER JIT (XLA:CPU once contracted a rematerialized
    product into `p + e`, collapsing dd to f32; see ddf32._harden)."""
    import jax
    import numpy as np

    from meshclust2_tpu.ops import ddf32 as DD

    jax.config.update("jax_enable_x64", True)   # two_prod widens to f64
    rng = np.random.default_rng(1)
    c64 = rng.random(4096)
    C = DD.dd(*DD.split_f64(c64))
    w = 0.211728345557612
    wd = DD.split_f64(np.float64(w))

    def chain(ch, cl):
        x = DD.dd_mul((ch, cl), (np.float32(wd[0]), np.float32(wd[1])))
        y = DD.dd_div(x, DD.dd_sqrt((ch, cl)))
        return DD.dd_add(x, y)

    rh, rl = jax.jit(chain)(*C)
    got = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
    want = w * c64 + w * c64 / np.sqrt(c64)
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() < 1e-12, rel.max()


@pytest.mark.parametrize("d", [64, 1024])
@pytest.mark.parametrize("maxc", [256, 4095])
def test_emd_rowsum_exact(d, maxc):
    """The EMD prefix statistic equals the int64 oracle bit for bit, for
    uint8-range counts and for wider ones (int32 prefixes, int64 total)."""
    import jax
    import jax.numpy as jnp

    from meshclust2_tpu.cluster.device_loop import emd_rowsum

    jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(d + maxc)
    wc = 256
    blk = rng.integers(0, maxc + 1, (wc, d), dtype=np.int32)
    cen = rng.integers(0, maxc + 1, d, dtype=np.int32)
    diff = blk - cen[None, :]
    got = np.asarray(jax.jit(lambda x: emd_rowsum(jnp, x))(jnp.asarray(diff)))
    want = np.abs(np.cumsum(diff.astype(np.int64), axis=1)).sum(axis=1)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_check_cb_cpu_keeps_4gib():
    """XLA:CPU reports no memory stats: the update-phase accumulator guard
    stays at 4 GiB there; a device without stats that is not the CPU is an
    error, and one with stats gets a share of its allocator limit."""
    from types import SimpleNamespace

    from meshclust2_tpu.cluster.device_loop import DeviceLoopUnsupported
    from meshclust2_tpu.cluster.device_phase import (
        ACC_MEMORY_FRACTION, DevicePhaseUpdater, accumulator_budget_bytes)

    assert accumulator_budget_bytes() == 4 << 30
    fake = SimpleNamespace(sum32=True, d=1024)
    DevicePhaseUpdater._check_cb(fake, (4 << 30) // (4 * 1024))
    with pytest.raises(DeviceLoopUnsupported):
        DevicePhaseUpdater._check_cb(fake, (4 << 30) // (4 * 1024) + 1)
    fake64 = SimpleNamespace(sum32=False, d=1024)
    with pytest.raises(DeviceLoopUnsupported):
        DevicePhaseUpdater._check_cb(fake64, (4 << 30) // (4 * 1024))

    class Dev:
        platform, device_kind = "gpu", "test card"

        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    with pytest.raises(RuntimeError, match="no memory stats"):
        accumulator_budget_bytes(Dev(None))
    assert accumulator_budget_bytes(Dev({"bytes_limit": 1 << 36})) == \
        int((1 << 36) * ACC_MEMORY_FRACTION)
