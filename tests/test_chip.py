"""Checks that need an NVIDIA GPU, as thin wrappers around chip_smoke.py's
phases (`python chip_smoke.py` runs them all; `-m chip` selects these).

Whether a GPU is present is decided inside a fixture, in a child process
that is not pinned to the CPU; without one every chip test skips.  The CPU
rehearsal of the parity phase at the end runs everywhere: it checks the
script's plumbing with the device programs on XLA:CPU, not the card.
"""
import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402


def _card_env():
    return {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}


@pytest.fixture(scope="module")
def gpu():
    p = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=_card_env(), capture_output=True, text=True, timeout=300)
    if p.returncode != 0 or p.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("needs an NVIDIA GPU (JAX's default backend is not gpu)")


def _smoke(phases, tmp_path):
    p = subprocess.run(
        [sys.executable, os.path.join(_REPO, "chip_smoke.py"), "--phases",
         phases, "--work", str(tmp_path / "smoke")],
        env=_card_env(), capture_output=True, text=True, timeout=1500,
        cwd=_REPO)
    last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]
    result = json.loads(last)
    assert result["ok"] and result["device"]["platform"] == "gpu"


@pytest.mark.chip
@pytest.mark.parametrize("phases", ["1,2", "1,3", "1,4", "1,5", "1,6", "1,7"],
                         ids=["compile", "kernels", "parity", "main_path",
                              "training", "fastcar"])
def test_smoke_phase_on_chip(gpu, phases, tmp_path):
    _smoke(phases, tmp_path)


def test_parity_phase_rehearsal(fixtures_dir, tmp_path):
    """chip_smoke's parity phase on small.fasta under JAX_PLATFORMS=cpu (set
    by conftest): `--device gpu` runs the device programs on XLA:CPU, and
    its CLSTR must match the reference and the host run byte for byte."""
    assert os.environ.get("JAX_PLATFORMS") == "cpu"
    chip_smoke.phase_parity(
        str(tmp_path / "parity"),
        os.path.join(fixtures_dir, "small.fasta"),
        os.path.join(fixtures_dir, "small_ref_weights.txt"),
        os.path.join(fixtures_dir, "small_ref.clstr"))
