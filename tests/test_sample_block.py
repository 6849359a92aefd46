"""Block-granular batch sampling (TrainConfig.sample_block > 1).

Correctness pins:
  * with a single batch covering every sample, the loss is a plain sum over
    rows, so training is invariant to the sampling order -- block mode must
    reproduce the classic per-row-shuffle run (incl. the Q row unshuffle
    and supervised pops alignment through the resident pre-shuffle);
  * the XLA and fused engines must agree under block sampling (same seed
    -> same pre-shuffle and block permutation -> identical math);
  * multi-batch block runs stay finite and produce valid simplex Q.
"""
import numpy as np
import pytest

from neural_admixture_tpu.io.packed import pack_with_padding
from neural_admixture_tpu.train.engine import (NeuralAdmixtureTrainer,
                                               TrainConfig)


def _mk_data(seed=3, N=37, M=500, D=4, ks=(3,), supervised=False):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4, size=(N, M)).astype(np.uint8)
    V = rng.normal(size=(D, M)).astype(np.float32) * 0.1
    P_init = rng.uniform(0.2, 0.8, size=(sum(ks), M)).astype(np.float32)
    pops = rng.integers(0, min(ks), size=N) if supervised else None
    return G, V, P_init, pops


def _run(G, V, P_init, ks, blk, use_pallas, batch, epochs=2, pops=None):
    cfg = TrainConfig(epochs=epochs, batch_size=batch, learning_rate=1e-2,
                      seed=0, hidden_size=32, ks=list(ks), progress=False,
                      use_pallas=use_pallas, interpret=use_pallas,
                      sample_block=blk)
    packed, _ = pack_with_padding(G)
    tr = NeuralAdmixtureTrainer(cfg)
    return tr.launch_training(P_init.copy(), packed, V, G.shape[1],
                              G.shape[0], pops=pops)


@pytest.mark.parametrize("supervised", [False, True])
def test_single_batch_blocks_match_row_shuffle(supervised):
    G, V, P_init, pops = _mk_data(supervised=supervised)
    Qs_1, Ps_1, _ = _run(G, V, P_init, [3], 1, False, batch=64, pops=pops)
    Qs_b, Ps_b, _ = _run(G, V, P_init, [3], 4, False, batch=64, pops=pops)
    for q1, qb in zip(Qs_1, Qs_b):
        np.testing.assert_allclose(qb, q1, rtol=2e-4, atol=2e-5)
    for p1, pb in zip(Ps_1, Ps_b):
        np.testing.assert_allclose(pb, p1, rtol=2e-4, atol=2e-5)


def test_block_sampling_pallas_matches_xla():
    G, V, P_init, _ = _mk_data(N=41, M=700)
    Qs_x, Ps_x, _ = _run(G, V, P_init, [3], 8, False, batch=16)
    Qs_p, Ps_p, _ = _run(G, V, P_init, [3], 8, True, batch=16)
    for qx, qp_ in zip(Qs_x, Qs_p):
        np.testing.assert_allclose(qp_, qx, rtol=5e-3, atol=5e-4)
    for px, pp in zip(Ps_x, Ps_p):
        np.testing.assert_allclose(pp, px, rtol=5e-3, atol=5e-4)


def test_multibatch_block_run_is_valid():
    G, V, P_init, _ = _mk_data(N=70, M=400, ks=(2, 3))
    Qs, Ps, _ = _run(G, V, P_init, [2, 3], 4, False, batch=24)
    for q in Qs:
        assert q.shape[0] == 70
        assert np.all(np.isfinite(q))
        np.testing.assert_allclose(q.sum(axis=1), 1.0, rtol=1e-4)
    for p in Ps:
        assert np.isfinite(p).all() and p.min() >= 0 and p.max() <= 1


def test_shard_row_order_is_blockwise_permutation():
    """Per-process pre-shuffle: a permutation of [0, N) that moves no row
    across process-block boundaries (rows cannot leave their host)."""
    from neural_admixture_tpu.train.engine import shard_row_order
    order = shard_row_order(105, 7, 2, 64)
    assert sorted(order) == list(range(105))
    assert set(order[:64]) == set(range(64))
    assert set(order[64:]) == set(range(64, 105))
    # deterministic per (seed, process): same seed -> same map
    np.testing.assert_array_equal(order,
                                  shard_row_order(105, 7, 2, 64))
    # tail process owning only padding contributes nothing
    assert len(shard_row_order(10, 0, 4, 8)) == 10


def test_emulated_shard_preshuffle_single_batch_invariance(monkeypatch):
    """With one batch covering every sample the loss is a plain row sum,
    so training is invariant to the resident layout: the emulated
    per-process pre-shuffle (NA_TPU_EMULATE_PROC_SHARDS, the layout a
    2-process run uses) must reproduce the per-row-shuffle run, pinning
    the Q/pops un-shuffle through shard_row_order."""
    G, V, P_init, pops = _mk_data(supervised=True)
    Qs_1, Ps_1, _ = _run(G, V, P_init, [3], 1, False, batch=64, pops=pops)
    monkeypatch.setenv("NA_TPU_EMULATE_PROC_SHARDS", "2,2")
    Qs_e, Ps_e, _ = _run(G, V, P_init, [3], 4, False, batch=64, pops=pops)
    for q1, qe in zip(Qs_1, Qs_e):
        np.testing.assert_allclose(qe, q1, rtol=2e-4, atol=2e-5)
    for p1, pe in zip(Ps_1, Ps_e):
        np.testing.assert_allclose(pe, p1, rtol=2e-4, atol=2e-5)


def test_block_geometry_invariants():
    """Resident rows must tile into exactly nb-1 full batches plus one
    remainder batch of whole aligned blocks, the step count must equal
    ceil(N/b_round), and padding must cost less than one alignment
    quantum (the reference's short-final-batch DataLoader semantics)."""
    import numpy as np

    from neural_admixture_tpu.train.engine import block_geometry

    class _M:  # minimal mesh stand-in
        def __init__(self, d):
            self.shape = {"data": d, "snp": 1}

    for N, bs, pallas, d_sz, blk in [(4096, 800, True, 1, 16),
                                     (4096, 800, True, 8, 16),
                                     (105, 800, False, 1, 16),
                                     (37, 16, False, 8, 4),
                                     (100_000, 800, True, 4, 64)]:
        mesh = _M(d_sz) if d_sz > 1 else None
        b_round, nb, b_rem, rows = block_geometry(N, bs, pallas, mesh, blk)
        q = int(np.lcm(8 if pallas else 1, d_sz * blk))
        assert rows == (nb - 1) * b_round + b_rem
        assert b_round % q == 0 and b_rem % q == 0
        assert 0 < b_rem <= b_round
        assert rows >= N and rows - N < q
        assert nb == -(-N // b_round)
    # the bench workload: padding shrinks from 704 rows to 0
    b_round, nb, b_rem, rows = block_geometry(4096, 800, True, None, 16)
    assert (b_round, nb, b_rem, rows) == (800, 6, 96, 4096)
