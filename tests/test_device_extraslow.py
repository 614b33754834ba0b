"""--feat extraslow device support (VERDICT r4 next-step 8): the blockwise
singles (hellinger, chi2, canberra, kulczynski1, sqchord, harmonic mean,
k-divergence, kl-conditional, mismatch, jaccard — Feature.cpp:378-457) must
run on-device with exact decisions, and the truly host-bound singles
(align, spearman, d2s/d2*, markov family) must fall back LOUDLY with the
offending feature named."""
import os

import numpy as np
import pytest

from meshclust2_tpu.features import flags as F
from meshclust2_tpu.features import host as H
from meshclust2_tpu.io.clstr import parse_clstr
from meshclust2_tpu.model.weights import (
    ModelBlock, PredictorModel, save_weights,
)


BLOCK_SINGLES = [F.FEAT_HELLINGER, F.FEAT_CHI_SQUARED, F.FEAT_CANBERRA,
                 F.FEAT_KULCZYNSKI1, F.FEAT_SQCHORD, F.FEAT_HARMONIC_MEAN,
                 F.FEAT_K_DIV, F.FEAT_KL_COND, F.FEAT_MISMATCH,
                 F.FEAT_JACCARD]


def test_block_singles_error_bounds():
    """Device f32 blockwise singles vs the host f64 oracles on random
    count blocks: |device - host| must stay inside the claimed absolute
    error bounds, and the bounds must be small enough to be useful."""
    import jax
    import jax.numpy as jnp

    from meshclust2_tpu.cluster.device_loop import block_singles_stats

    rng = np.random.default_rng(3)
    W, D = 64, 1024
    A = rng.integers(1, 60, (W, D)).astype(np.int32)
    B = rng.integers(1, 60, (W, D)).astype(np.int32)
    # near-identical rows exercise the cancellation-sensitive formulas
    B[:8] = A[:8]
    B[:8, :10] += 1
    magA = A.sum(axis=1).astype(np.int32)
    magB = B.sum(axis=1).astype(np.int32)

    out = jax.jit(lambda a, b, ma, mb: block_singles_stats(
        jnp, a, b, ma, mb, D, tuple(BLOCK_SINGLES)))(A, B, magA, magB)

    class Side:
        pass

    def side(C, mag):
        s = Side()
        s.counts = C.astype(np.float64)
        s.mags = mag.astype(np.float64)
        s.dim = D
        s.k = 5
        return s

    a, b = side(A, magA), side(B, magB)
    refs = {
        F.FEAT_HELLINGER: H.hellinger(a, b),
        F.FEAT_CHI_SQUARED: H.chi_squared(a, b),
        F.FEAT_CANBERRA: H.canberra(a, b),
        F.FEAT_KULCZYNSKI1: H.kulczynski1(a, b),
        F.FEAT_SQCHORD: H.squaredchord(a, b),
        F.FEAT_HARMONIC_MEAN: H.harmonic_mean(a, b),
        F.FEAT_K_DIV: H.k_divergence(a, b),
        F.FEAT_KL_COND: H.kl_conditional(a, b),
        F.FEAT_MISMATCH: H.mismatch(a, b),
        F.FEAT_JACCARD: H.jaccard(a, b),
    }
    for flag in BLOCK_SINGLES:
        v, e = (np.asarray(x) for x in out[flag])
        name = F.FEAT_NAMES[flag]
        diff = np.abs(v.astype(np.float64) - refs[flag])
        assert (diff <= e + 1e-12).all(), \
            f"{name}: max |dev-host| {diff.max():.3e} > bound {e.max():.3e}"
        scale = np.abs(refs[flag]).max() + 1.0
        assert e.max() < 1e-3 * scale + 1e-4, \
            f"{name}: bound {e.max():.3e} too loose for scale {scale:.3e}"
        if flag in (F.FEAT_MISMATCH, F.FEAT_JACCARD):
            assert (diff == 0).all(), f"{name} must be exact"


def _extraslow_model(ps, sim=0.9):
    """A classifier whose combos use the blockwise extraslow singles."""
    rng = np.random.default_rng(0)
    singles = [F.FEAT_INTERSECTION, F.FEAT_HELLINGER, F.FEAT_CHI_SQUARED,
               F.FEAT_KL_COND, F.FEAT_MISMATCH]
    n = ps.n
    a_rows = rng.integers(0, n, 600)
    b_rows = rng.integers(0, n, 600)
    keep = a_rows != b_rows
    a_rows, b_rows = a_rows[keep], b_rows[keep]
    A = H.side_from_pointset(ps, a_rows)
    B = H.side_from_pointset(ps, b_rows)
    raw = H.compute_singles(singles, A, B)
    mins = raw.min(axis=0)
    maxs = raw.max(axis=0)
    span = np.where(maxs > mins, maxs - mins, 1.0)
    normed = (raw - mins) / span
    is_sim = np.array([bool(F.FEAT_IS_SIM[s]) for s in singles])
    normed = np.where(is_sim[None, :], normed, 1.0 - normed)
    lab_a = np.array([ps.headers[r].split("_")[0] for r in a_rows])
    lab_b = np.array([ps.headers[r].split("_")[0] for r in b_rows])
    y = np.where(lab_a == lab_b, 1.0, -1.0)
    combos = [
        ("xy", F.FEAT_INTERSECTION),
        ("xy", F.FEAT_HELLINGER | F.FEAT_CHI_SQUARED),
        ("xy", F.FEAT_KL_COND | F.FEAT_MISMATCH),
    ]
    cols = [
        normed[:, 0],
        normed[:, 1] * normed[:, 2],
        normed[:, 3] * normed[:, 4],
    ]
    X = np.column_stack([np.ones(len(y))] + cols)
    w, *_ = np.linalg.lstsq(X, y * 4.0, rcond=None)
    block = ModelBlock(combos=combos, weights=w, singles=singles,
                       mins=mins, maxs=maxs)
    return PredictorModel(k=ps.k, mode=1, max_features=4, id_cutoff=sim,
                          datatype="uint8_t",
                          feature_set=int(np.bitwise_or.reduce(singles)),
                          classifier=block)


@pytest.fixture(scope="module")
def extraslow_weights(fixtures_dir, tmp_path_factory):
    from meshclust2_tpu.cli import load_sorted_points

    _, ps = load_sorted_points(
        [os.path.join(fixtures_dir, "small.fasta")], [], 5, "uint8_t",
        False, keep_seqs_train=False)
    model = _extraslow_model(ps)
    path = str(tmp_path_factory.mktemp("xslow") / "xslow_weights.txt")
    save_weights(path, model)
    return path


def _run(fixtures_dir, tmp_path, name, weights, env):
    from meshclust2_tpu.cli import main

    out = tmp_path / name
    saved = {}
    for k, v in env.items():
        saved[k] = os.environ.get(k)
        os.environ[k] = v
    try:
        rc = main(["--recover", weights, "--output", str(out),
                   "--device", env.pop("_DEV", "host"),
                   os.path.join(fixtures_dir, "small.fasta")])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert rc == 0
    return parse_clstr(str(out))


def test_extraslow_device_parity(fixtures_dir, tmp_path, extraslow_weights,
                                 capsys):
    host = _run(fixtures_dir, tmp_path, "host.clstr", extraslow_weights,
                {"MC2_NO_DEVICE_LOOP": "1", "MC2_NO_DEVICE_SESSION": "1"})
    dev = _run(fixtures_dir, tmp_path, "dev.clstr", extraslow_weights,
               {"_DEV": "gpu"})
    out = capsys.readouterr().out
    assert "device session unavailable" not in out
    assert "no device implementation" not in out
    assert len(host) == len(dev)
    for ca, cb in zip(host, dev):
        assert [m["header"] for m in ca] == [m["header"] for m in cb]
        assert [m["center"] for m in ca] == [m["center"] for m in cb]


def test_host_bound_feature_falls_back_loudly(fixtures_dir, tmp_path,
                                              capsys):
    """A model using a feature with no device implementation (spearman)
    must print a one-line fallback NAMING the feature, then cluster
    correctly on the host paths."""
    from meshclust2_tpu.cli import load_sorted_points

    _, ps = load_sorted_points(
        [os.path.join(fixtures_dir, "small.fasta")], [], 5, "uint8_t",
        False, keep_seqs_train=False)
    model = _extraslow_model(ps)
    model.classifier.singles[-1] = F.FEAT_SPEARMAN
    model.classifier.combos[-1] = ("xy", F.FEAT_KL_COND | F.FEAT_SPEARMAN)
    weights = str(tmp_path / "spear_weights.txt")
    save_weights(weights, model)
    host = _run(fixtures_dir, tmp_path, "host.clstr", weights,
                {"MC2_NO_DEVICE_LOOP": "1", "MC2_NO_DEVICE_SESSION": "1"})
    dev = _run(fixtures_dir, tmp_path, "dev.clstr", weights,
               {"_DEV": "gpu"})
    out = capsys.readouterr().out
    assert "spearman" in out and "no device implementation" in out
    assert len(host) == len(dev)
    for ca, cb in zip(host, dev):
        assert [m["header"] for m in ca] == [m["header"] for m in cb]
