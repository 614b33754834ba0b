"""--feat slow device support: the log-divergence singles (jefferey,
jensen-shannon — PRED_FEAT_DIV, CRunner.cpp:366-378) must run on-device
with exact decisions (f32 values + error bounds + margin aborts), so a
slow-features model clusters identically through the device session and
the host oracle."""
import os

import numpy as np
import pytest

from meshclust2_tpu.features import flags as F
from meshclust2_tpu.features import host as H
from meshclust2_tpu.io.clstr import parse_clstr
from meshclust2_tpu.model.weights import (
    ModelBlock, PredictorModel, save_weights,
)


def _slow_model(ps, sim=0.9):
    """A small classifier whose combos USE the log features, fitted on
    labeled template pairs so decisions are non-trivial."""
    rng = np.random.default_rng(0)
    singles = [F.FEAT_MANHATTAN, F.FEAT_INTERSECTION,
               F.FEAT_JEFFEREY_DIV, F.FEAT_JENSEN_SHANNON]
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
    # label: same template (headers look like "seqT_J template_T")
    lab_a = np.array([ps.headers[r].split("_")[0] for r in a_rows])
    lab_b = np.array([ps.headers[r].split("_")[0] for r in b_rows])
    y = np.where(lab_a == lab_b, 1.0, -1.0)
    combos = [
        ("xy", F.FEAT_INTERSECTION),
        ("xy", F.FEAT_JEFFEREY_DIV | F.FEAT_MANHATTAN),
        ("x2y2", F.FEAT_JENSEN_SHANNON),
    ]
    cols = [
        normed[:, 1],
        normed[:, 2] * normed[:, 0],
        normed[:, 3] ** 2,
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
def slow_weights(fixtures_dir, tmp_path_factory):
    from meshclust2_tpu.cli import load_sorted_points

    _, ps = load_sorted_points(
        [os.path.join(fixtures_dir, "small.fasta")], [], 5, "uint8_t",
        False, keep_seqs_train=False)
    model = _slow_model(ps)
    path = str(tmp_path_factory.mktemp("slow") / "slow_weights.txt")
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


def test_log_div_stats_error_bounds():
    """Device f32 jefferey/jensen vs the host f64 formulas on random
    blocks: |device - host| must stay inside the claimed bounds."""
    import jax
    import jax.numpy as jnp

    from meshclust2_tpu.cluster.device_loop import log_div_stats

    rng = np.random.default_rng(1)
    W, D = 64, 1024
    A = rng.integers(1, 40, (W, D)).astype(np.int32)
    B = rng.integers(1, 40, (W, D)).astype(np.int32)
    # a few near-identical rows (small divergences, relative errors matter)
    B[:8] = A[:8]
    B[:8, :10] += 1
    magA = A.sum(axis=1).astype(np.int32)
    magB = B.sum(axis=1).astype(np.int32)

    jd, js, jde, jse = (np.asarray(x) for x in jax.jit(
        lambda a, b, ma, mb: log_div_stats(jnp, a, b, ma, mb, True, True)
    )(A, B, magA, magB))

    pp = A.astype(np.float64) / magA[:, None]
    pq = B.astype(np.float64) / magB[:, None]
    jd_ref = ((pp - pq) * np.log(pp / pq)).sum(axis=1)
    avg = 0.5 * (pp + pq)
    js_ref = (pp * np.log(pp / avg) + pq * np.log(pq / avg)).sum(axis=1) / 2
    assert (np.abs(jd - jd_ref) <= jde).all()
    assert (np.abs(js - js_ref) <= jse).all()
    # and the bounds are tight enough to be useful (<< typical values)
    assert jde.max() < 1e-2 and jse.max() < 1e-3


def test_slow_feats_device_parity(fixtures_dir, tmp_path, slow_weights,
                                  capsys):
    host = _run(fixtures_dir, tmp_path, "host.clstr", slow_weights,
                {"MC2_NO_DEVICE_LOOP": "1", "MC2_NO_DEVICE_SESSION": "1"})
    dev = _run(fixtures_dir, tmp_path, "dev.clstr", slow_weights,
               {"_DEV": "gpu"})
    out = capsys.readouterr().out
    assert "device session unavailable" not in out
    assert "not dd-derivable" not in out
    assert len(host) == len(dev)
    for ca, cb in zip(host, dev):
        assert [m["header"] for m in ca] == [m["header"] for m in cb]
        assert [m["center"] for m in ca] == [m["center"] for m in cb]


def test_slow_feats_device_parity_forced_margin(fixtures_dir, tmp_path,
                                                slow_weights):
    """Large margins force abort/resume through the log-feature path."""
    host = _run(fixtures_dir, tmp_path, "host2.clstr", slow_weights,
                {"MC2_NO_DEVICE_LOOP": "1", "MC2_NO_DEVICE_SESSION": "1"})
    dev = _run(fixtures_dir, tmp_path, "dev2.clstr", slow_weights,
               {"_DEV": "gpu", "MC2_DD_MARGIN": "3e-3"})
    assert len(host) == len(dev)
    for ca, cb in zip(host, dev):
        assert [m["header"] for m in ca] == [m["header"] for m in cb]
        assert [m["center"] for m in ca] == [m["center"] for m in cb]
