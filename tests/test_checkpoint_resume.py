"""Mid-training checkpoint + resume: interrupted-and-resumed training must
reproduce the uninterrupted run exactly (same RNG stream, params, moments)."""
import numpy as np

from neural_admixture_tpu.io.packed import pack_with_padding
from neural_admixture_tpu.train.engine import NeuralAdmixtureTrainer, TrainConfig


def _data(seed=0, N=48, M=500, D=4):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4, size=(N, M)).astype(np.uint8)
    V = rng.normal(size=(D, M)).astype(np.float32) * 0.1
    P_init = rng.uniform(0.2, 0.8, size=(3, M)).astype(np.float32)
    packed, _ = pack_with_padding(G)
    return G, V, P_init, packed


def _cfg(tmp_path, epochs, **kw):
    return TrainConfig(epochs=epochs, batch_size=16, learning_rate=5e-3,
                       seed=0, hidden_size=32, ks=[3], progress=False,
                       checkpoint_path=str(tmp_path / "ck.npz"), **kw)


def test_resume_reproduces_uninterrupted_run(tmp_path):
    G, V, P_init, packed = _data()
    N, M = G.shape

    # Uninterrupted: 6 epochs.
    tr = NeuralAdmixtureTrainer(_cfg(tmp_path / "a", 6))
    (tmp_path / "a").mkdir()
    Qs_full, Ps_full, _ = tr.launch_training(P_init.copy(), packed, V, M, N)

    # Interrupted: 3 epochs with checkpointing, then resume to 6.
    (tmp_path / "b").mkdir()
    cfg1 = _cfg(tmp_path / "b", 3, checkpoint_every=3)
    NeuralAdmixtureTrainer(cfg1).launch_training(P_init.copy(), packed, V, M, N)
    cfg2 = _cfg(tmp_path / "b", 6, checkpoint_every=3, resume=True)
    Qs_res, Ps_res, _ = NeuralAdmixtureTrainer(cfg2).launch_training(
        P_init.copy(), packed, V, M, N)

    np.testing.assert_allclose(Qs_res[0], Qs_full[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Ps_res[0], Ps_full[0], rtol=1e-5, atol=1e-6)


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    G, V, P_init, packed = _data()
    N, M = G.shape
    cfg = _cfg(tmp_path, 2, resume=True)
    Qs, Ps, _ = NeuralAdmixtureTrainer(cfg).launch_training(
        P_init.copy(), packed, V, M, N)
    assert Qs[0].shape == (N, 3)


def test_resume_rejects_changed_hyperparameters(tmp_path):
    """Resuming with any changed hyperparameter must raise before touching
    devices (a silent mismatch trains wrong or fails late on device)."""
    import pytest
    G, V, P_init, packed = _data()
    N, M = G.shape
    cfg1 = _cfg(tmp_path, 2, checkpoint_every=2)
    NeuralAdmixtureTrainer(cfg1).launch_training(P_init.copy(), packed, V, M, N)

    for change in ({"batch_size": 24}, {"hidden_size": 64}, {"seed": 7},
                   {"ks": [4]}):
        cfg2 = _cfg(tmp_path, 4, checkpoint_every=2, resume=True)
        for k, v in change.items():
            setattr(cfg2, k, v)
        p2 = P_init.copy()
        if "ks" in change:
            p2 = np.concatenate([P_init, P_init[:1]], axis=0)
        with pytest.raises(ValueError, match="hyperparameters"):
            NeuralAdmixtureTrainer(cfg2).launch_training(p2, packed, V, M, N)


def test_resume_across_mesh_shapes(tmp_path):
    """A checkpoint trained on one mesh must resume on a different mesh
    (pod preemption rarely returns the same slice shape): leaves are
    layout-free host numpy and reshard on load. Equivalent-but-not-bitwise
    to the uninterrupted run -- the (2, 2) legs accumulate gradients
    through psums (tolerance class of tests/test_sharded_step.py)."""
    G, V, P_init, packed = _data()
    N, M = G.shape

    (tmp_path / "a").mkdir()
    tr = NeuralAdmixtureTrainer(_cfg(tmp_path / "a", 6, mesh_shape=(1, 1)))
    Qs_full, Ps_full, _ = tr.launch_training(P_init.copy(), packed, V, M, N)

    # 3 epochs on a single device, then resume epochs 3-6 on a (2, 2) mesh.
    (tmp_path / "b").mkdir()
    cfg1 = _cfg(tmp_path / "b", 3, checkpoint_every=3, mesh_shape=(1, 1))
    NeuralAdmixtureTrainer(cfg1).launch_training(P_init.copy(), packed, V, M, N)
    cfg2 = _cfg(tmp_path / "b", 6, checkpoint_every=3, resume=True,
                mesh_shape=(2, 2))
    Qs_res, Ps_res, _ = NeuralAdmixtureTrainer(cfg2).launch_training(
        P_init.copy(), packed, V, M, N)

    np.testing.assert_allclose(Qs_res[0], Qs_full[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(Ps_res[0], Ps_full[0], rtol=1e-4, atol=1e-5)


def test_resume_across_step_paths(tmp_path):
    """Both steps keep parameters in SNP order, so a checkpoint written on
    the XLA path resumes on the fused op (interpret mode) and continues the
    uninterrupted XLA run's trajectory."""
    from tests.conftest import assert_trajectory_close
    G, V, P_init, packed = _data()
    N, M = G.shape
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    Qs_full, Ps_full, _ = NeuralAdmixtureTrainer(
        _cfg(tmp_path / "a", 4, use_pallas=False)).launch_training(
        P_init.copy(), packed, V, M, N)
    cfg1 = _cfg(tmp_path / "b", 2, checkpoint_every=2, use_pallas=False)
    NeuralAdmixtureTrainer(cfg1).launch_training(P_init.copy(), packed, V, M, N)
    cfg2 = _cfg(tmp_path / "b", 4, checkpoint_every=2, resume=True,
                use_pallas=True, interpret=True)
    Qs_res, Ps_res, _ = NeuralAdmixtureTrainer(cfg2).launch_training(
        P_init.copy(), packed, V, M, N)
    assert_trajectory_close(Qs_res[0], Qs_full[0], lr=5e-3)
    assert_trajectory_close(Ps_res[0], Ps_full[0], lr=5e-3)
