"""The fused training path must match the XLA path numerically.

Runs the full engine twice on tiny data (the fused op's kernels in the
Pallas interpreter on CPU) and compares trained Q and P. Identical RNG
streams mean the only difference is the kernel implementation, so results
should agree to float tolerance.
"""
import numpy as np
import pytest

from neural_admixture_tpu.io.packed import pack_with_padding
from neural_admixture_tpu.train.engine import NeuralAdmixtureTrainer, TrainConfig


def _run(use_pallas, G, V, P_init, ks, pops=None):
    cfg = TrainConfig(epochs=2, batch_size=16, learning_rate=1e-2, seed=0,
                      hidden_size=32, ks=ks, progress=False,
                      use_pallas=use_pallas, interpret=use_pallas)
    packed, _ = pack_with_padding(G)
    tr = NeuralAdmixtureTrainer(cfg)
    return tr.launch_training(P_init.copy(), packed, V, G.shape[1],
                              G.shape[0], pops=pops)


@pytest.mark.parametrize("ks,supervised", [([3], False), ([2, 3], False),
                                           ([3], True)])
def test_pallas_and_xla_paths_agree(ks, supervised):
    rng = np.random.default_rng(0)
    N, M, D = 24, 300, 4
    G = rng.integers(0, 4, size=(N, M)).astype(np.uint8)
    V = rng.normal(size=(D, M)).astype(np.float32) * 0.1
    P_init = rng.uniform(0.2, 0.8, size=(sum(ks), M)).astype(np.float32)
    pops = rng.integers(0, min(ks), size=N) if supervised else None

    Qs_x, Ps_x, params_x = _run(False, G, V, P_init, ks, pops)
    Qs_p, Ps_p, params_p = _run(True, G, V, P_init, ks, pops)

    for qx, qp_ in zip(Qs_x, Qs_p):
        np.testing.assert_allclose(qp_, qx, rtol=5e-3, atol=5e-4)
    for px, pp in zip(Ps_x, Ps_p):
        np.testing.assert_allclose(pp, px, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(np.asarray(params_p["V"]),
                               np.asarray(params_x["V"]),
                               rtol=5e-3, atol=5e-4)
