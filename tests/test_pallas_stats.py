"""DeviceScorer on the center-vs-window shape vs the float64 oracle.

The shape once had its own fused-statistics kernel; it now runs the same
plain XLA singles path as every other batch (ops/device_features.py)."""
import os

import numpy as np

from meshclust2_tpu.features import flags as F
from meshclust2_tpu.io.fasta import read_fasta
from meshclust2_tpu.kmer.counting import build_point_set


def test_device_scorer_fused_path_matches_host(fixtures_dir):
    """A center-vs-window batch (one center against every row, the shape
    the accumulate phase scores) through DeviceScorer's plain XLA path:
    rounded decisions and the dist argmax must match the float64 host
    oracle, values to f32 tolerance."""
    from meshclust2_tpu.cluster.engine import HostScorer
    from meshclust2_tpu.model.classifier import CompiledModel
    from meshclust2_tpu.model.weights import ModelBlock
    from meshclust2_tpu.ops.device_features import DeviceScorer

    recs = read_fasta(os.path.join(fixtures_dir, "pairs.fasta"))
    ps = build_point_set(recs, 4, "uint16_t")
    singles = [F.FEAT_MANHATTAN, F.FEAT_INTERSECTION, F.FEAT_EUCLIDEAN,
               F.FEAT_KULCZYNSKI2]
    block = ModelBlock(
        combos=[("xy", F.FEAT_MANHATTAN | F.FEAT_INTERSECTION),
                ("x2y2", F.FEAT_EUCLIDEAN | F.FEAT_KULCZYNSKI2)],
        weights=np.array([-1.0, 2.2, 1.1]),
        singles=singles,
        mins=np.array([0.0, 0.2, 0.0, 100.0]),
        maxs=np.array([5000.0, 1.0, 600.0, 50000.0]),
    )
    model = CompiledModel(block)
    dev = DeviceScorer(ps, model)
    host = HostScorer(ps, model)

    a = np.arange(ps.n)
    b = np.zeros(ps.n, dtype=np.int64)  # one center for the whole window
    p_dev, d_dev = dev.score(a, b)
    p_host, d_host = host.score(a, b)
    np.testing.assert_array_equal(np.floor(p_dev + 0.5), np.floor(p_host + 0.5))
    assert int(np.argmax(d_dev)) == int(np.argmax(d_host))
    np.testing.assert_allclose(d_dev, d_host, rtol=1e-6)
