"""End-to-end engine runs on a (data, snp) mesh, including the fused op
(its kernels in the Pallas interpreter on the virtual CPU mesh).

The sharded-step math is grad-exactness-tested in test_sharded_step; this
covers what that cannot: the full engine path (epoch scan + Adam + P clamp
+ checkpointless multi-epoch loop + sharded Q inference pass) executing on
a mesh must reproduce the single-device result, and the auto mesh policy
must resolve shapes users never specify.
"""
import numpy as np
import pytest

from tests.conftest import assert_trajectory_close
from neural_admixture_tpu.io.packed import pack_with_padding
from neural_admixture_tpu.train.engine import (NeuralAdmixtureTrainer,
                                               TrainConfig)

def _run(G, V, P_init, ks, mesh_shape, use_pallas, pops=None):
    cfg = TrainConfig(epochs=2, batch_size=16, learning_rate=1e-2, seed=0,
                      hidden_size=32, ks=ks, progress=False,
                      use_pallas=use_pallas, interpret=use_pallas,
                      mesh_shape=mesh_shape)
    # The fused op shards whole SNP tiles: m_pad must divide by n_snp x
    # TILE_SNPS (the quantum _pick_mesh enforces).
    packed, _ = pack_with_padding(G, lane_multiple=2048 * mesh_shape[1])
    tr = NeuralAdmixtureTrainer(cfg)
    return tr.launch_training(P_init.copy(), packed, V, G.shape[1],
                              G.shape[0], pops=pops)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_pallas_mesh_engine_matches_single_device(mesh_shape):
    rng = np.random.default_rng(1)
    N, M, D, ks = 22, 4000, 4, [3]
    G = rng.integers(0, 4, size=(N, M)).astype(np.uint8)
    V = rng.normal(size=(D, M)).astype(np.float32) * 0.1
    P_init = rng.uniform(0.2, 0.8, size=(sum(ks), M)).astype(np.float32)

    Qs_1, Ps_1, _ = _run(G, V, P_init, ks, (1, 1), use_pallas=False)
    Qs_m, Ps_m, _ = _run(G, V, P_init, ks, mesh_shape, use_pallas=True)

    for q1, qm in zip(Qs_1, Qs_m):
        assert_trajectory_close(qm, q1, lr=1e-2)
    for p1, pm in zip(Ps_1, Ps_m):
        assert_trajectory_close(pm, p1, lr=1e-2)


def test_auto_mesh_policy_engages_snp_axis_under_pressure(monkeypatch):
    """With a tiny memory budget the auto policy must move devices to the
    snp axis (and the run still work end-to-end); with the default budget
    small problems stay pure-DP."""
    rng = np.random.default_rng(2)
    N, M, D, ks = 17, 4000, 4, [3]
    G = rng.integers(0, 4, size=(N, M)).astype(np.uint8)
    V = rng.normal(size=(D, M)).astype(np.float32) * 0.1
    P_init = rng.uniform(0.2, 0.8, size=(sum(ks), M)).astype(np.float32)

    cfg = TrainConfig(epochs=1, batch_size=8, seed=0, hidden_size=16, ks=ks,
                      progress=False, use_pallas=False, mesh_shape=None)
    tr = NeuralAdmixtureTrainer(cfg)
    assert tr._auto_snp_axis(n_dev=8, m_pad=4096, snp_quantum=4) == 1

    # ~0 budget: every factor of 2 the divisibility rules allow goes to snp.
    monkeypatch.setenv("NA_TPU_HBM_BUDGET_GB", "0.00001")
    assert tr._auto_snp_axis(n_dev=8, m_pad=4096 * 8, snp_quantum=2048) == 8
    assert tr._auto_snp_axis(n_dev=8, m_pad=4096 * 2, snp_quantum=2048) == 4
    packed, _ = pack_with_padding(G, lane_multiple=4096)
    Qs, Ps, _ = tr.launch_training(P_init.copy(), packed, V, M, N)
    assert tr._mesh_shape[1] > 1, "snp axis not engaged by the auto policy"
    assert np.all(np.isfinite(Qs[0])) and np.all(np.isfinite(Ps[0]))


def test_auto_mesh_budget_follows_device_capacity(monkeypatch):
    """Without NA_TPU_HBM_BUDGET_GB the auto-mesh budget is half the device
    capacity (utils.hbm), so a smaller card engages the snp axis sooner."""
    monkeypatch.delenv("NA_TPU_HBM_BUDGET_GB", raising=False)
    cfg = TrainConfig(epochs=1, batch_size=800, ks=list(range(2, 11)),
                      progress=False, use_pallas=False)
    tr = NeuralAdmixtureTrainer(cfg)
    m_pad = 1 << 24  # 16.8M SNPs: ~24 GiB of V/P/Adam state + batch scratch
    monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", "80")
    assert tr._auto_snp_axis(n_dev=4, m_pad=m_pad, snp_quantum=512) == 1
    monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", "32")
    assert tr._auto_snp_axis(n_dev=4, m_pad=m_pad, snp_quantum=512) == 2
