"""Host-streaming (out-of-core) training path (engine.make_stream_epoch_fn).

The streamed epoch keeps the packed genotypes in host memory and assembles
each batch on host; it must sample the exact batches the resident epoch
samples (same key stream, same _batch_plan geometry) and produce the same
trained state -- only the batch SOURCE differs. Also covers the trainer's
auto-stream policy (resident estimate over capacity -> stream) and
checkpoint/resume under streaming.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from neural_admixture_tpu.io.packed import pack_with_padding
from neural_admixture_tpu.models import qp
from neural_admixture_tpu.ops import pack as pk
from neural_admixture_tpu.train.engine import (NeuralAdmixtureTrainer,
                                               TrainConfig, block_geometry,
                                               make_epoch_fn,
                                               make_stream_epoch_fn)

N, M, K, B, E = 61, 512, 3, 24, 3


def _setup(use_pallas, blk, seed=0, missing=False):
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 4 if missing else 3, size=(N, M), dtype=np.uint8)
    packed, m_pad = pack_with_padding(geno)
    data = pk.packed_view_u32(packed) if use_pallas else packed
    if blk > 1:
        _, _, _, n_rows = block_geometry(N, B, use_pallas, None, blk)
        if n_rows != N:
            data = np.concatenate(
                [data, np.zeros((n_rows - N, data.shape[1]), data.dtype)],
                axis=0)
    else:
        n_rows = N
    V = rng.normal(size=(m_pad, 8)).astype(np.float32) * 0.1
    P0 = rng.uniform(0.2, 0.8, size=(K, m_pad)).astype(np.float32)
    params = qp.init_params(jax.random.PRNGKey(1), jnp.asarray(V),
                            jnp.asarray(P0), 32, [K])
    tx = optax.adam(1e-3, b1=0.9, b2=0.95, eps=1e-8)
    col_mask = jnp.asarray((np.arange(m_pad) < M).astype(np.float32))
    return tx, params, data, col_mask, n_rows


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("blk", [1, 8])
def test_stream_epoch_matches_resident(use_pallas, blk):
    """E streamed epochs == E resident epochs on identical keys/data."""
    tx, params, data_host, col_mask, n_rows = _setup(use_pallas, blk)
    pops_host = np.zeros((N,), np.int32)
    kw = dict(use_pallas=use_pallas, params_template=params,
              sample_block=blk, n_rows=n_rows, interpret=use_pallas)
    resident_logged = make_epoch_fn(tx, N, B, False, 0.0, **kw,
                                    compute_loss=True)
    resident_fast = make_epoch_fn(tx, N, B, False, 0.0, **kw,
                                  compute_loss=False)
    stream_logged = make_stream_epoch_fn(tx, N, B, False, 0.0, **kw,
                                         compute_loss=True)
    stream_fast = make_stream_epoch_fn(tx, N, B, False, 0.0, **kw,
                                       compute_loss=False)

    keys = jax.random.split(jax.random.PRNGKey(7), E)
    data_dev = jnp.asarray(data_host)
    pops_dev = jnp.asarray(pops_host)
    p1, o1 = jax.tree.map(jnp.copy, params), tx.init(params)
    p2, o2 = jax.tree.map(jnp.copy, params), tx.init(params)
    for i in range(E):
        logged = i == 0
        rfn = resident_logged if logged else resident_fast
        sfn = stream_logged if logged else stream_fast
        p1, o1, l1 = rfn(p1, o1, data_dev, col_mask, pops_dev, keys[i])
        p2, o2, l2 = sfn(p2, o2, data_host, col_mask, pops_host, keys[i])
        if logged:
            np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for k1, k2 in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        if not use_pallas:
            # XLA path: the streamed program is the resident one minus the
            # in-scan gather -- measured BIT-exact.
            np.testing.assert_array_equal(np.asarray(k2), np.asarray(k1))
        else:
            # Fused path: ops around the kernels fuse differently in the
            # standalone step jit vs the scan body -- last-ulp per step
            # (same class of drift as grouped dispatch, CLAUDE.md).
            np.testing.assert_allclose(np.asarray(k2), np.asarray(k1),
                                       rtol=1e-6, atol=1e-7)


def _train(stream, tmp_path, monkeypatch, use_pallas=False, blk=8,
           epochs=4, resume_break=None, cap_env=None, batch=B):
    """Full launch_training run; returns (Qs, Ps, trainer)."""
    if cap_env is not None:
        monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", cap_env)
    rng = np.random.default_rng(3)
    geno = rng.integers(0, 3, size=(N, M), dtype=np.uint8)
    packed, m_pad = pack_with_padding(geno)
    V = (rng.normal(size=(8, M)) * 0.1).astype(np.float32)
    P0 = rng.uniform(0.2, 0.8, size=(K, M)).astype(np.float32)
    cfg = TrainConfig(epochs=epochs, batch_size=batch, learning_rate=1e-3,
                      seed=11, hidden_size=32, ks=[K], progress=False,
                      use_pallas=use_pallas, interpret=use_pallas,
                      mesh_shape=(1, 1), sample_block=blk, stream=stream)
    if resume_break is not None:
        cfg.checkpoint_every = resume_break
        cfg.checkpoint_path = str(tmp_path / f"ck_{stream}.npz")
    trainer = NeuralAdmixtureTrainer(cfg)
    if resume_break is not None:
        # First leg: train to the checkpoint boundary only.
        cfg.epochs = resume_break
        trainer.launch_training(P0.copy(), packed, V, M, N)
        cfg.epochs = epochs
        cfg.resume = True
    Qs, Ps, _ = trainer.launch_training(P0.copy(), packed, V, M, N)
    return Qs, Ps, trainer


@pytest.mark.parametrize("use_pallas", [False, True])
def test_stream_trainer_matches_resident(use_pallas, tmp_path, monkeypatch):
    Q1, P1, t1 = _train(False, tmp_path, monkeypatch, use_pallas)
    Q2, P2, t2 = _train(True, tmp_path, monkeypatch, use_pallas)
    assert not t1._streamed and t2._streamed
    np.testing.assert_allclose(Q2[0], Q1[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(P2[0], P1[0], rtol=1e-5, atol=1e-6)


def test_auto_stream_policy(tmp_path, monkeypatch):
    """cfg.stream=None streams iff the resident estimate exceeds capacity
    while the streaming one (no resident genotypes in HBM) fits."""
    _, _, t_fit = _train(None, tmp_path, monkeypatch, epochs=1)
    assert not t_fit._streamed  # default 16 GiB capacity: resident fits

    # A workload whose packed resident bytes dominate: capacity set BETWEEN
    # the engine's streaming footprint (batch transient + SNP-plane state)
    # and the resident one (+ packed rows) so only streaming fits.
    n2, b2, m_pad = 4096, 512, 2048
    rng = np.random.default_rng(4)
    geno = rng.integers(0, 3, size=(n2, M), dtype=np.uint8)
    packed, mp = pack_with_padding(geno)
    assert mp == m_pad
    plane = m_pad * (8 + K) * 12
    batch_bytes = b2 * m_pad // 4 + b2 * m_pad * 4  # packed + f32 transient
    data_bytes = n2 * m_pad // 4
    cap = (batch_bytes + plane + data_bytes / 2) / 0.9 / 2**30
    monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", repr(cap))
    V = (rng.normal(size=(8, M)) * 0.1).astype(np.float32)
    P0 = rng.uniform(0.2, 0.8, size=(K, M)).astype(np.float32)
    cfg = TrainConfig(epochs=1, batch_size=b2, learning_rate=1e-3, seed=11,
                      hidden_size=32, ks=[K], progress=False,
                      use_pallas=False, mesh_shape=(1, 1), sample_block=8,
                      stream=None)
    trainer = NeuralAdmixtureTrainer(cfg)
    Qs, _, _ = trainer.launch_training(P0, packed, V, M, n2)
    assert trainer._streamed
    assert np.all(np.isfinite(Qs[0]))


def test_stream_checkpoint_resume(tmp_path, monkeypatch):
    Q1, P1, _ = _train(True, tmp_path, monkeypatch, epochs=4)
    Q2, P2, _ = _train(True, tmp_path, monkeypatch, epochs=4, resume_break=2)
    np.testing.assert_allclose(Q2[0], Q1[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(P2[0], P1[0], rtol=1e-6, atol=1e-7)


def test_stream_supervised(tmp_path, monkeypatch):
    """Supervised CE term under streaming: host-sliced labels must match
    the resident device-gathered ones."""
    rng = np.random.default_rng(5)
    geno = rng.integers(0, 3, size=(N, M), dtype=np.uint8)
    packed, m_pad = pack_with_padding(geno)
    V = (rng.normal(size=(8, M)) * 0.1).astype(np.float32)
    P0 = rng.uniform(0.2, 0.8, size=(K, M)).astype(np.float32)
    pops = rng.integers(0, K, size=(N,)).astype(np.int64)

    def run(stream):
        cfg = TrainConfig(epochs=2, batch_size=B, learning_rate=1e-3,
                          seed=11, hidden_size=32, ks=[K], progress=False,
                          use_pallas=False, mesh_shape=(1, 1),
                          sample_block=8, stream=stream)
        return NeuralAdmixtureTrainer(cfg).launch_training(
            P0.copy(), packed, V, M, N, pops=pops)

    Q1, P1, _ = run(False)
    Q2, P2, _ = run(True)
    np.testing.assert_allclose(Q2[0], Q1[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(P2[0], P1[0], rtol=1e-5, atol=1e-6)


def test_rsvd_stream_matches_resident():
    """Out-of-core RSVD (host-resident packed, per-block GEMM transfers)
    must reproduce the device-resident result: same block order, same f32
    accumulation, only the transfer granularity differs."""
    from neural_admixture_tpu.ops.rsvd import rsvd
    rng = np.random.default_rng(9)
    geno = rng.integers(0, 4, size=(200, 700), dtype=np.uint8)  # raw codes
    packed, _ = pack_with_padding(geno)
    V1 = rsvd(packed, 200, 700, k=4, seed=3, block_rows=64, stream=False)
    V2 = rsvd(packed, 200, 700, k=4, seed=3, block_rows=64, stream=True)
    np.testing.assert_allclose(V2, V1, rtol=1e-5, atol=1e-6)


def test_project_pca_stream_matches_resident():
    from neural_admixture_tpu.train.init import project_pca
    rng = np.random.default_rng(10)
    geno = rng.integers(0, 4, size=(150, 600), dtype=np.uint8)
    packed, _ = pack_with_padding(geno)
    V = (rng.normal(size=(8, 600)) * 0.1).astype(np.float32)
    X1 = np.asarray(project_pca(packed, V, 150, block_rows=64, stream=False))
    X2 = np.asarray(project_pca(packed, V, 150, block_rows=64, stream=True))
    np.testing.assert_allclose(X2, X1, rtol=1e-5, atol=1e-6)


def test_should_stream_host(monkeypatch):
    from neural_admixture_tpu.utils.hbm import should_stream_host
    monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", "1")
    assert not should_stream_host(int(0.5 * 2**30))
    assert should_stream_host(int(0.95 * 2**30))


@pytest.mark.parametrize("use_pallas,mesh", [(False, (2, 2)),
                                             (True, (2, 2))])
def test_stream_trainer_mesh(use_pallas, mesh, tmp_path, monkeypatch):
    """Streaming over a single-host mesh: batches device_put straight into
    the P(data, snp) sharding, shard_map step -- must match the resident
    mesh run."""
    rng = np.random.default_rng(6)
    geno = rng.integers(0, 3, size=(N, M), dtype=np.uint8)
    packed, _ = pack_with_padding(geno)
    V = (rng.normal(size=(8, M)) * 0.1).astype(np.float32)
    P0 = rng.uniform(0.2, 0.8, size=(K, M)).astype(np.float32)

    def run(stream):
        cfg = TrainConfig(epochs=2, batch_size=B, learning_rate=1e-3,
                          seed=11, hidden_size=32, ks=[K], progress=False,
                          use_pallas=use_pallas, interpret=use_pallas,
                          mesh_shape=mesh, sample_block=8, stream=stream)
        t = NeuralAdmixtureTrainer(cfg)
        Qs, Ps, _ = t.launch_training(P0.copy(), packed, V, M, N)
        return Qs, Ps, t

    Q1, P1, t1 = run(False)
    Q2, P2, t2 = run(True)
    assert not t1._streamed and t2._streamed
    np.testing.assert_allclose(Q2[0], Q1[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(P2[0], P1[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_stratified_stream_matches_resident_epoch(use_pallas):
    """Host-partition-stratified sampling (the multi-host out-of-core
    policy, engine._stratified_plan): the streamed epoch and the resident
    epoch built with the same ``stratified=ep`` must sample identical
    per-partition batches and produce the same trained state."""
    blk, ep, B_s = 8, 2, 32
    tx, params, data_host, col_mask, n_rows = _setup(use_pallas, blk)
    assert n_rows % (blk * ep) == 0
    pops_host = np.zeros((N,), np.int32)
    kw = dict(use_pallas=use_pallas, params_template=params,
              sample_block=blk, n_rows=n_rows, stratified=ep,
              interpret=use_pallas)
    resident = make_epoch_fn(tx, N, B_s, False, 0.0, **kw, compute_loss=True)
    streamed = make_stream_epoch_fn(tx, N, B_s, False, 0.0, **kw,
                                    compute_loss=True)
    keys = jax.random.split(jax.random.PRNGKey(17), E)
    data_dev = jnp.asarray(data_host)
    pops_dev = jnp.asarray(pops_host)
    p1, o1 = jax.tree.map(jnp.copy, params), tx.init(params)
    p2, o2 = jax.tree.map(jnp.copy, params), tx.init(params)
    for i in range(E):
        p1, o1, l1 = resident(p1, o1, data_dev, col_mask, pops_dev, keys[i])
        p2, o2, l2 = streamed(p2, o2, data_host, col_mask, pops_host, keys[i])
        np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for k1, k2 in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        if not use_pallas:
            np.testing.assert_array_equal(np.asarray(k2), np.asarray(k1))
        else:
            np.testing.assert_allclose(np.asarray(k2), np.asarray(k1),
                                       rtol=1e-6, atol=1e-7)


def test_stratified_covers_every_row_once():
    """Every real resident row appears exactly once per stratified epoch
    (full batches + remainder), and partition p's picks occupy exactly its
    own batch columns [p*F_p, (p+1)*F_p) -- the property that lets a
    streamed host assemble its shard from local rows only."""
    from neural_admixture_tpu.train.engine import (_batch_plan,
                                                   _stratified_plan)
    blk, ep, B_s = 8, 2, 32
    n_rows = block_geometry(N, B_s, False, None, blk)[3]
    b_round, nb, b_rem = _batch_plan(N, B_s, False, None, blk, n_rows)
    idx_full, idx_rem = _stratified_plan(jax.random.PRNGKey(3), ep, blk, N,
                                         n_rows, b_round, nb, b_rem)
    units = np.concatenate([np.asarray(idx_full).ravel(),
                            np.asarray(idx_rem)])
    # Whole blocks, each exactly once, covering the padded resident rows.
    assert sorted(units.tolist()) == list(range(n_rows // blk))
    upp = n_rows // (ep * blk)
    F_p = b_round // (blk * ep)
    for b in range(nb - 1):
        for p in range(ep):
            col = np.asarray(idx_full)[b, p * F_p:(p + 1) * F_p]
            assert np.all((col >= p * upp) & (col < (p + 1) * upp))


def test_stratified_per_row_and_supervised():
    """The stratified plan's per-row (sample_block=1) branch -- real local
    rows padded with sentinel N -- and the supervised CE term's label
    slicing through the stratified gather, streamed vs resident."""
    N_s, B_s, ep, E_s, K_s = 64, 32, 2, 2, 3
    rng = np.random.default_rng(21)
    geno = rng.integers(0, 3, size=(N_s, M), dtype=np.uint8)
    packed, m_pad = pack_with_padding(geno)
    V = rng.normal(size=(m_pad, 8)).astype(np.float32) * 0.1
    P0 = rng.uniform(0.2, 0.8, size=(K_s, m_pad)).astype(np.float32)
    params = qp.init_params(jax.random.PRNGKey(1), jnp.asarray(V),
                            jnp.asarray(P0), 32, [K_s])
    tx = optax.adam(1e-3, b1=0.9, b2=0.95, eps=1e-8)
    col_mask = jnp.asarray((np.arange(m_pad) < M).astype(np.float32))
    pops_host = rng.integers(0, K_s, size=(N_s,)).astype(np.int32)

    kw = dict(use_pallas=False, params_template=params, sample_block=1,
              n_rows=N_s, stratified=ep)
    resident = make_epoch_fn(tx, N_s, B_s, True, 7.0, **kw,
                             compute_loss=True)
    streamed = make_stream_epoch_fn(tx, N_s, B_s, True, 7.0, **kw,
                                    compute_loss=True)
    keys = jax.random.split(jax.random.PRNGKey(23), E_s)
    p1, o1 = jax.tree.map(jnp.copy, params), tx.init(params)
    p2, o2 = jax.tree.map(jnp.copy, params), tx.init(params)
    for i in range(E_s):
        p1, o1, l1 = resident(p1, o1, jnp.asarray(packed), col_mask,
                              jnp.asarray(pops_host), keys[i])
        p2, o2, l2 = streamed(p2, o2, packed, col_mask, pops_host, keys[i])
        np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for k1, k2 in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(k2), np.asarray(k1))


def test_stratified_trainer_emulated(tmp_path, monkeypatch):
    """Trainer-level A/B under the emulated 2-partition resident layout
    (NA_TPU_EMULATE_PROC_SHARDS) with NA_TPU_STRATIFIED=1: the streamed
    run must reproduce the resident run."""
    monkeypatch.setenv("NA_TPU_EMULATE_PROC_SHARDS", "2,1")
    monkeypatch.setenv("NA_TPU_STRATIFIED", "1")
    # batch=32: the stratified plan needs ep*blk | b_round; real multi-host
    # runs get this from host_sample_shard's ep | d_sz alignment, while the
    # emulated layout runs on a 1-device mesh.
    Q1, P1, t1 = _train(False, tmp_path, monkeypatch, blk=8, epochs=3,
                        batch=32)
    Q2, P2, t2 = _train(True, tmp_path, monkeypatch, blk=8, epochs=3,
                        batch=32)
    assert not t1._streamed and t2._streamed
    np.testing.assert_allclose(Q2[0], Q1[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(P2[0], P1[0], rtol=1e-5, atol=1e-6)


def test_hbm_capacity_env_validation(monkeypatch):
    """NA_TPU_HBM_CAPACITY_GB must be rejected loudly when non-numeric or
    non-positive instead of crashing deep inside an auto-stream decision
    (ADVICE r3)."""
    import pytest

    from neural_admixture_tpu.utils.hbm import hbm_capacity_bytes

    monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", "2")
    assert hbm_capacity_bytes() == 2 * 2**30
    monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", "sixteen")
    with pytest.raises(ValueError, match="NA_TPU_HBM_CAPACITY_GB"):
        hbm_capacity_bytes()
    monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", "0")
    with pytest.raises(ValueError, match="NA_TPU_HBM_CAPACITY_GB"):
        hbm_capacity_bytes()


@pytest.mark.parametrize("prefetch", ["0", "2"])
def test_stream_prefetch_levels_match_resident(prefetch, monkeypatch):
    """The double-buffer pipeline levels (0 = serial, 2 = gather +
    device_put on the worker) deliver identical batches in identical
    order, so exactness vs the resident epoch is level-independent (the
    default level 1 is covered by every other streaming test)."""
    monkeypatch.setenv("NA_TPU_STREAM_PREFETCH", prefetch)
    tx, params, data_host, col_mask, n_rows = _setup(False, 8)
    pops_host = np.zeros((N,), np.int32)
    kw = dict(use_pallas=False, params_template=params,
              sample_block=8, n_rows=n_rows)
    resident = make_epoch_fn(tx, N, B, False, 0.0, **kw, compute_loss=True)
    streamed = make_stream_epoch_fn(tx, N, B, False, 0.0, **kw,
                                    compute_loss=True)
    key = jax.random.PRNGKey(3)
    p1, o1, l1 = resident(jax.tree.map(jnp.copy, params), tx.init(params),
                          jnp.asarray(data_host), col_mask,
                          jnp.asarray(pops_host), key)
    p2, o2, l2 = streamed(jax.tree.map(jnp.copy, params), tx.init(params),
                          data_host, col_mask, pops_host, key)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for k1, k2 in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(k2), np.asarray(k1))
