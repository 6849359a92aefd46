"""End-to-end golden test on the reference demo dataset.

The reference's own diagnostics tolerate hardware drift
(/root/reference/demo/README.md:15, run_diagnostics.py always exits 0), and
cross-framework RNG streams differ, so we check *converged structure* rather
than float equality: after optimally permuting columns (Hungarian matching),
the trained Q must correlate strongly with the expected Q, and the final
log-likelihood must be in the same range as the expected outputs'.
"""
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from neural_admixture_tpu.io.packed import pack_with_padding
from neural_admixture_tpu.io.snp_reader import read_data
from neural_admixture_tpu.ops.loglikelihood import loglikelihood
from neural_admixture_tpu.ops.rsvd import rsvd
from neural_admixture_tpu.train.engine import NeuralAdmixtureTrainer, TrainConfig
from neural_admixture_tpu.train.init import init_p_unsupervised
from tests.conftest import DEMO_BED, DEMO_P_EXPECTED, DEMO_Q_EXPECTED


def best_permutation(Q, Q_ref):
    """Match our columns to reference columns by correlation (Hungarian)."""
    K = Q.shape[1]
    corr = np.zeros((K, K))
    for i in range(K):
        for j in range(K):
            corr[i, j] = np.corrcoef(Q[:, i], Q_ref[:, j])[0, 1]
    rows, cols = linear_sum_assignment(-np.nan_to_num(corr))
    perm = np.empty(K, dtype=int)
    perm[cols] = rows
    return perm, corr[rows, cols]


@pytest.fixture(scope="module")
def demo_run():
    data, pops, N, M = read_data(DEMO_BED)
    packed, _ = pack_with_padding(data)
    V = rsvd(packed, N, M, k=8, seed=42)
    P_init = init_p_unsupervised(packed, V, N, M, [7], seed=42)
    cfg = TrainConfig(epochs=5, batch_size=800, learning_rate=20e-4, seed=42,
                      hidden_size=1024, ks=[7], progress=False)
    trainer = NeuralAdmixtureTrainer(cfg)
    Qs, Ps, params = trainer.launch_training(P_init, packed, V, M, N)
    return data, Qs[0], Ps[0]


def test_demo_shapes_and_ranges(demo_run):
    data, Q, P = demo_run
    assert Q.shape == (105, 7)
    assert P.shape == (8451, 7)
    np.testing.assert_allclose(Q.sum(axis=1), 1.0, rtol=1e-4)
    assert P.min() >= 0.0 and P.max() <= 1.0


def test_demo_structure_matches_expected(demo_run):
    data, Q, P = demo_run
    Q_ref = np.genfromtxt(DEMO_Q_EXPECTED)
    P_ref = np.genfromtxt(DEMO_P_EXPECTED)

    # Gates pinned to measured headroom (CPU XLA path; chip_smoke.py
    # applies the same gates on the GPU): matched Q correlations
    # [.957 .988 .938 .989 .940 .033 .911] mean .8222 -- six of the seven
    # components >= 0.911; the seventh is a minor component the two
    # implementations split differently at 5 epochs. Matched P
    # correlations [.999 .987 1.0 1.0 .894 1.0 .936] mean .9735.
    perm, matched_corr = best_permutation(Q, Q_ref)
    assert np.mean(matched_corr) > 0.78, matched_corr
    assert np.sort(matched_corr)[1] > 0.85, matched_corr  # 6 of 7 strong

    p_corr = [np.corrcoef(P[:, perm[j]], P_ref[:, j])[0, 1] for j in range(7)]
    assert np.mean(p_corr) > 0.93, p_corr
    assert np.min(p_corr) > 0.80, p_corr


def test_demo_loglikelihood_comparable(demo_run):
    data, Q, P = demo_run
    Q_ref = np.genfromtxt(DEMO_Q_EXPECTED)
    P_ref = np.genfromtxt(DEMO_P_EXPECTED)
    ll_ours = loglikelihood(data, P.astype(np.float64), Q.astype(np.float64), 7)
    ll_ref = loglikelihood(data, P_ref, Q_ref, 7)
    # Our 5-epoch fit must BEAT the reference's 5-epoch golden outputs
    # outright (measured: -322,269 vs -326,814, i.e. 4.5k of headroom; the
    # pre-round-4 gate allowed a 2% shortfall, ~6.5k BELOW the golden).
    assert ll_ours > ll_ref, (ll_ours, ll_ref)
