"""CLI flag coverage: --list / --no-train-list / --single-file / --bias /
--datatype / --delta / --iterations behave like the reference's option
handling (CRunner.cpp:243-477)."""
import os

import numpy as np
import pytest

from meshclust2_tpu.cli import main, build_parser
from meshclust2_tpu.io.clstr import parse_clstr


@pytest.fixture(scope="module")
def small(fixtures_dir):
    return os.path.join(fixtures_dir, "small.fasta")


@pytest.fixture(scope="module")
def weights(fixtures_dir):
    return os.path.join(fixtures_dir, "small_ref_weights.txt")


def test_list_flag(small, weights, tmp_path):
    lst = tmp_path / "files.txt"
    lst.write_text(small + "\n")
    out = tmp_path / "o.clstr"
    rc = main(["--recover", weights, "--list", str(lst),
               "--output", str(out), "--device", "host"])
    assert rc == 0
    assert len(parse_clstr(str(out))) == 20


def test_no_train_list(small, weights, tmp_path, fixtures_dir):
    """notrain files join the pool but are excluded from training; on the
    recover path they simply cluster together with the train files."""
    # split the fixture into train + notrain halves
    recs = open(small).read().split(">")
    recs = [">" + r for r in recs if r.strip()]
    train = tmp_path / "train.fasta"
    no = tmp_path / "no.fasta"
    train.write_text("".join(recs[:100]))
    no.write_text("".join(recs[100:]))
    lst = tmp_path / "no.txt"
    lst.write_text(str(no) + "\n")
    out = tmp_path / "o.clstr"
    rc = main(["--recover", weights, "--no-train-list", str(lst),
               "--output", str(out), "--device", "host", str(train)])
    assert rc == 0
    clusters = parse_clstr(str(out))
    n_members = sum(len(c) for c in clusters)
    assert n_members == 200  # all sequences clustered


def test_bias_flag(small, weights, tmp_path):
    """A large negative bias forces every probability below the rounding
    threshold -> every sequence becomes its own cluster."""
    out = tmp_path / "o.clstr"
    rc = main(["--recover", weights, "--bias", "-1.0",
               "--output", str(out), "--device", "host", small])
    assert rc == 0
    assert len(parse_clstr(str(out))) == 200


def test_datatype_flag(small, weights, tmp_path):
    out = tmp_path / "o.clstr"
    rc = main(["--recover", weights, "--datatype", "16",
               "--output", str(out), "--device", "host", small])
    assert rc == 0
    # recover path: datatype from the weights file wins (uint8_t), run still
    # completes with identical structure
    assert len(parse_clstr(str(out))) == 20


def test_single_file_mode(tmp_path, fixtures_dir):
    """--single-file joins records per file; clustering then sees one
    sequence per file."""
    recs = open(os.path.join(fixtures_dir, "small.fasta")).read().split(">")
    recs = [">" + r for r in recs if r.strip()]
    f1 = tmp_path / "a.fasta"
    f2 = tmp_path / "b.fasta"
    f1.write_text("".join(recs[:4]))
    f2.write_text("".join(recs[4:8]))
    out = tmp_path / "o.clstr"
    rc = main([
        "--recover", os.path.join(fixtures_dir, "small_ref_weights.txt"),
        "--single-file", "--output", str(out), "--device", "host",
        str(f1), str(f2),
    ])
    assert rc == 0
    clusters = parse_clstr(str(out))
    assert sum(len(c) for c in clusters) == 2  # one joined record per file


def test_iterations_delta_flags(small, weights, tmp_path):
    out = tmp_path / "o.clstr"
    rc = main(["--recover", weights, "--iterations", "1", "--delta", "1",
               "--output", str(out), "--device", "host", small])
    assert rc == 0
    assert len(parse_clstr(str(out))) >= 20


def test_parser_defaults():
    args = build_parser().parse_args(["x.fasta"])
    assert args.identity == 0.90
    assert args.kmer == -1
    assert args.sample == 2000
    assert args.num_templates == 300
    assert args.min_feat == 4 and args.max_feat == 4
    assert args.min_id == 0.35
    assert args.delta == 5 and args.iterations == 15
    assert args.output == "output.clstr"
    assert args.feat == "fast" and args.mut_type == "both"


def test_threads_and_profile_flags():
    from meshclust2_tpu.cli import build_parser

    a = build_parser().parse_args(["--threads", "2", "x.fasta"])
    assert a.threads == 2 and a.profile is None
    a = build_parser().parse_args(["x.fasta", "--profile"])
    assert a.profile == "/tmp/mc2_profile"
    a = build_parser().parse_args(["--profile", "/tmp/t", "x.fasta"])
    assert a.profile == "/tmp/t"


def test_native_set_num_threads_noop_safe():
    from meshclust2_tpu.native import set_num_threads

    set_num_threads(1)  # must not raise regardless of native availability
    set_num_threads(0)


def test_empty_input_clean_exit(tmp_path, fixtures_dir):
    import os

    from meshclust2_tpu.cli import main

    empty = tmp_path / "empty.fasta"
    empty.write_text("")
    out = tmp_path / "out.clstr"
    rc = main(["--recover", os.path.join(fixtures_dir, "small_ref_weights.txt"),
               "--output", str(out), "--device", "host", str(empty)])
    assert rc == 1
    assert out.read_text() == ""


def test_single_sequence_clusters(tmp_path, fixtures_dir):
    import os

    from meshclust2_tpu.cli import main

    one = tmp_path / "one.fasta"
    one.write_text(">a\nACGTACGTACGTACGTACGTACGTACGTACGT\n")
    out = tmp_path / "out.clstr"
    rc = main(["--recover", os.path.join(fixtures_dir, "small_ref_weights.txt"),
               "--output", str(out), "--device", "host", str(one)])
    assert rc == 0
    assert ">Cluster 0" in out.read_text()
    assert "*" in out.read_text()


def test_delta_sweep_monotone_merging(small, weights, tmp_path):
    """BASELINE config 5: --delta neighborhood sweep.  A larger delta widens
    the merge neighborhood, so cluster counts must be non-increasing, and
    every sweep keeps template purity."""
    counts = []
    for delta in (1, 5, 20):
        out = tmp_path / f"d{delta}.clstr"
        rc = main(["--recover", weights, "--delta", str(delta),
                   "--output", str(out), "--device", "host", small])
        assert rc == 0
        clusters = parse_clstr(str(out))
        for c in clusters:
            templates = {m["header"].split("template_")[1] for m in c}
            assert len(templates) == 1
        counts.append(len(clusters))
    assert counts[0] >= counts[1] >= counts[2]


def test_min_max_feat_sweep(fixtures_dir, tmp_path):
    """BASELINE config 3: --min-feat/--max-feat sweep on the training path
    (2..2 and 4..6 must both select within bounds and produce clean
    clusters)."""
    import pytest

    from meshclust2_tpu.model.weights import load_weights

    small = os.path.join(fixtures_dir, "small.fasta")
    for lo, hi in ((2, 2), (4, 6)):
        out = tmp_path / f"mm{lo}{hi}.clstr"
        w = tmp_path / f"w{lo}{hi}.txt"
        cwd = os.getcwd()
        os.chdir(tmp_path)
        try:
            rc = main(["--id", "0.9", "--kmer", "5", "--mut-type", "single",
                       "--min", str(lo), "--max", str(hi),
                       "--dump", str(w), "--device", "host", small])
        finally:
            os.chdir(cwd)
        assert rc == 0
        model = load_weights(str(w))
        assert lo <= len(model.classifier.combos) <= hi


def test_device_gpu_without_gpu_exits_nonzero(small, weights, tmp_path):
    """--device gpu with no GPU and without JAX_PLATFORMS=cpu pinned ends
    the run with one clear message; it never falls back to the host."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["CUDA_VISIBLE_DEVICES"] = ""      # hide any card from JAX
    out = tmp_path / "o.clstr"
    p = subprocess.run(
        [sys.executable, "-m", "meshclust2_tpu.cli", "--recover", weights,
         "--output", str(out), "--device", "gpu", small],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert p.returncode != 0
    assert "--device gpu needs a GPU" in p.stderr
    assert not out.exists()


def test_device_choices():
    """The device flag names the GPU and nothing else; the default stays on
    the host."""
    p = build_parser()
    (action,) = [a for a in p._actions if a.dest == "device"]
    assert action.choices == ["auto", "host", "gpu"]
    assert p.parse_args(["--device", "gpu"]).device == "gpu"
    assert p.parse_args([]).device == "auto"
