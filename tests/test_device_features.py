"""Device feature kernels vs the float64 host oracle, and device-scored
clustering parity."""
import os

import numpy as np
import pytest

from meshclust2_tpu.features import flags as F
from meshclust2_tpu.features import host as H
from meshclust2_tpu.io.fasta import read_fasta
from meshclust2_tpu.kmer.counting import build_point_set
from meshclust2_tpu.ops.device_features import DeviceFeatureEngine

ALL_DEVICE_FLAGS = [
    F.FEAT_HELLINGER, F.FEAT_MANHATTAN, F.FEAT_EUCLIDEAN, F.FEAT_CHI_SQUARED,
    F.FEAT_NORMALIZED_VECTORS, F.FEAT_HARMONIC_MEAN, F.FEAT_JEFFEREY_DIV,
    F.FEAT_K_DIV, F.FEAT_PEARSON_COEFF, F.FEAT_SQCHORD, F.FEAT_KL_COND,
    F.FEAT_MARKOV, F.FEAT_INTERSECTION, F.FEAT_RRE_K_R, F.FEAT_D2z,
    F.FEAT_SIM_MM, F.FEAT_EUCLIDEAN_Z, F.FEAT_EMD, F.FEAT_SPEARMAN,
    F.FEAT_JACCARD, F.FEAT_LENGTHD, F.FEAT_D2s, F.FEAT_MISMATCH,
    F.FEAT_CANBERRA, F.FEAT_KULCZYNSKI1, F.FEAT_KULCZYNSKI2, F.FEAT_SIMRATIO,
    F.FEAT_JENSEN_SHANNON, F.FEAT_D2_star, F.FEAT_N2R, F.FEAT_N2RC,
    F.FEAT_N2RRC,
]


@pytest.fixture(scope="module")
def pair_ps(fixtures_dir):
    recs = read_fasta(os.path.join(fixtures_dir, "pairs.fasta"))
    return build_point_set(recs, 4, "uint16_t")


def test_device_matches_host_oracle(pair_ps):
    ps = pair_ps
    eng = DeviceFeatureEngine(ps, ALL_DEVICE_FLAGS)
    a_rows = np.array([0, 2, 4, 6, 1, 3])
    b_rows = np.array([1, 3, 5, 7, 0, 2])
    got = eng.singles_batch(a_rows, b_rows)
    A = H.side_from_pointset(ps, a_rows)
    B = H.side_from_pointset(ps, b_rows)
    want = H.compute_singles(ALL_DEVICE_FLAGS, A, B)
    # transcendental-heavy formulas accumulate more float32 error (the exact
    # decision path rechecks borderline cases in float64, so fast-path
    # tolerance is what matters here)
    loose = {F.FEAT_D2_star, F.FEAT_D2s, F.FEAT_SIM_MM, F.FEAT_MARKOV,
             F.FEAT_RRE_K_R, F.FEAT_KL_COND}
    for j, flag in enumerate(ALL_DEVICE_FLAGS):
        rtol = 5e-3 if flag in loose else 5e-4
        np.testing.assert_allclose(
            got[:, j], want[:, j], rtol=rtol, atol=5e-5,
            err_msg=F.FEAT_NAMES[flag],
        )


def test_afd_device(fixtures_dir):
    recs = read_fasta(os.path.join(fixtures_dir, "pairs.fasta"))
    ps = build_point_set(recs, 2, "uint16_t")
    eng = DeviceFeatureEngine(ps, [F.FEAT_AFD])
    a = np.array([0, 2])
    b = np.array([1, 3])
    got = eng.singles_batch(a, b)
    want = H.compute_singles([F.FEAT_AFD], H.side_from_pointset(ps, a), H.side_from_pointset(ps, b))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)


def test_device_scored_cluster_parity(fixtures_dir, tmp_path):
    """Full clustering with the device scorer must match the reference CLSTR
    exactly (margin rechecks make the fast path decision-identical)."""
    from meshclust2_tpu.cli import main
    from meshclust2_tpu.io.clstr import parse_clstr
    from tests.test_cluster_parity import cluster_signature

    out = tmp_path / "out_dev.clstr"
    rc = main(
        [
            "--recover", os.path.join(fixtures_dir, "small_ref_weights.txt"),
            "--output", str(out),
            "--device", "gpu",
            os.path.join(fixtures_dir, "small.fasta"),
        ]
    )
    assert rc == 0
    ref = parse_clstr(os.path.join(fixtures_dir, "small_ref.clstr"))
    got = parse_clstr(str(out))
    assert cluster_signature(got) == cluster_signature(ref)


def test_hybrid_scorer_routing(fixtures_dir, monkeypatch):
    """--device gpu builds a HybridScorer: small batches go to the native
    scorer, large ones to the device scorer (threshold via env)."""
    import os

    import numpy as np

    from meshclust2_tpu.cli import load_sorted_points, make_scorer
    from meshclust2_tpu.model.classifier import CompiledModel
    from meshclust2_tpu.model.weights import load_weights

    monkeypatch.setenv("MC2_DEVICE_THRESHOLD", "64")
    w = load_weights(os.path.join(fixtures_dir, "small_ref_weights.txt"))
    _, ps = load_sorted_points(
        [os.path.join(fixtures_dir, "small.fasta")], [], w.k, w.datatype, False
    )
    model = CompiledModel(w.classifier)
    hybrid = make_scorer(ps, model, "gpu")
    host = make_scorer(ps, model, "host")

    calls = {"small": 0, "large": 0}
    small_score = hybrid.small.score
    large_score = hybrid.large.score
    hybrid.small.score = lambda a, b, **kw: (calls.__setitem__("small", calls["small"] + 1), small_score(a, b, **kw))[1]
    hybrid.large.score = lambda a, b: (calls.__setitem__("large", calls["large"] + 1), large_score(a, b))[1]

    a_small = np.arange(8)
    b_small = np.zeros(8, dtype=np.int64)
    p1, d1 = hybrid.score(a_small, b_small)
    assert calls == {"small": 1, "large": 0}

    a_large = np.arange(ps.n)
    b_large = np.zeros(ps.n, dtype=np.int64)
    p2, d2 = hybrid.score(a_large, b_large)
    assert calls == {"small": 1, "large": 1}

    # decisions equal the host scorer on both routes
    ph, dh = host.score(a_large, b_large)
    np.testing.assert_array_equal(np.floor(p2 + 0.5), np.floor(ph + 0.5))
    assert int(np.argmax(d2)) == int(np.argmax(dh))
