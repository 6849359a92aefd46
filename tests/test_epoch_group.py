"""Grouped-epoch dispatch (engine.make_epoch_fn(epochs_per_call=E)).

E consecutive unlogged epochs run inside one jit (outer lax.scan over the
per-epoch keys) must produce BIT-IDENTICAL params/opt state to E separate
epoch_fn calls with the same keys -- the grouping only amortizes dispatch
latency, it must not change any math.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from neural_admixture_tpu.models import qp
from neural_admixture_tpu.io.packed import pack_with_padding
from neural_admixture_tpu.ops import pack as pk
from neural_admixture_tpu.train.engine import (NeuralAdmixtureTrainer,
                                               TrainConfig, block_geometry,
                                               make_epoch_fn)

N, M, K, B, BLK, E = 61, 512, 3, 24, 8, 4


def _setup(use_pallas):
    rng = np.random.default_rng(0)
    geno = rng.integers(0, 3, size=(N, M), dtype=np.uint8)
    packed, m_pad = pack_with_padding(geno)
    if use_pallas:
        data = pk.packed_view_u32(packed)
    else:
        data = packed
    _, _, _, n_rows = block_geometry(N, B, use_pallas, None, BLK)
    if n_rows != N:
        data = np.concatenate(
            [data, np.zeros((n_rows - N, data.shape[1]), data.dtype)], axis=0)
    V = rng.normal(size=(m_pad, 8)).astype(np.float32) * 0.1
    P0 = rng.uniform(0.2, 0.8, size=(K, m_pad)).astype(np.float32)
    params = qp.init_params(jax.random.PRNGKey(1), jnp.asarray(V),
                            jnp.asarray(P0), 32, [K])
    tx = optax.adam(1e-3, b1=0.9, b2=0.95, eps=1e-8)
    col_mask = jnp.asarray((np.arange(m_pad) < M).astype(np.float32))
    pops = jnp.zeros((N,), jnp.int32)
    return tx, params, jnp.asarray(data), col_mask, pops, n_rows


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", ["fast", "logged", "periods"])
def test_grouped_epochs_bit_exact(use_pallas, mode):
    """compute_loss=False ('fast'): E fast epochs in one dispatch.
    compute_loss=True ('logged'): one log period -- epoch 0 runs the
    logged program, epochs 1..E-1 the fast program, losses stacked (1,).
    'periods': E epochs as two periods of E//2 -- every period's first
    epoch logged, losses stacked (2,)."""
    tx, params, data, col_mask, pops, n_rows = _setup(use_pallas)
    mk = lambda cl, **kw: make_epoch_fn(  # noqa: E731
        tx, N, B, False, 0.0, use_pallas=use_pallas, params_template=params,
        compute_loss=cl, sample_block=BLK, n_rows=n_rows,
        interpret=use_pallas, **kw)
    single_fast = mk(False)
    single_logged = mk(True)
    period = E // 2 if mode == "periods" else E
    multi = mk(mode != "fast", epochs_per_call=E,
               period_len=period if mode != "fast" else 0)

    keys = jax.random.split(jax.random.PRNGKey(7), E)
    p1, o1 = jax.tree.map(jnp.copy, params), tx.init(params)
    losses1 = []
    for i in range(E):
        logged_i = mode != "fast" and i % period == 0
        fn = single_logged if logged_i else single_fast
        p1, o1, ls = fn(p1, o1, data, col_mask, pops, keys[i])
        if logged_i:
            losses1.append(float(ls))
    p2, o2 = jax.tree.map(jnp.copy, params), tx.init(params)
    p2, o2, loss2 = multi(p2, o2, data, col_mask, pops, keys)
    if mode == "fast":
        assert float(loss2) == 0.0
    else:
        # Later periods' losses see the amplified fused-path drift of the
        # params they are computed from (see check() below).
        np.testing.assert_allclose(np.asarray(loss2), np.asarray(losses1),
                                   rtol=1e-3 if use_pallas else 1e-6)

    # The XLA path comes out bit-exact. On the fused path the ops AROUND
    # the kernels (encoder/Adam) fuse differently under the outer scan;
    # the last-ulp seed differences then amplify through Adam's rsqrt over
    # E epochs. The gate below still catches structural bugs (wrong key
    # stream / epoch count diverge at O(1), not O(1e-3)).
    def check(a, b):
        a, b = np.asarray(a), np.asarray(b)
        if use_pallas:
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5)
        else:
            np.testing.assert_array_equal(a, b)

    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        check(a, b)
    for a, b in zip(jax.tree.leaves(o1), jax.tree.leaves(o2)):
        check(a, b)


@pytest.mark.parametrize("ckpt_every", [0, 3, 2])
def test_trainer_grouping_matches_ungrouped(tmp_path, monkeypatch,
                                            ckpt_every):
    """End-to-end trainer: NA_TPU_EPOCH_GROUP on vs off -> identical Q/P
    and identical checkpoint cadence (same key stream, same math; grouping
    only changes dispatch). ckpt_every=3 aligns with log_every (the
    boundary lands on a group edge); ckpt_every=2 puts boundaries strictly
    inside log periods, forcing the single-epoch fallback."""
    rng = np.random.default_rng(3)
    geno = rng.integers(0, 3, size=(N, M), dtype=np.uint8)
    packed, _ = pack_with_padding(geno)
    V = rng.normal(size=(8, M)).astype(np.float32) * 0.1
    P0 = rng.uniform(0.2, 0.8, size=(K, M)).astype(np.float32)

    def run(group, periods="1"):
        monkeypatch.setenv("NA_TPU_EPOCH_GROUP", group)
        monkeypatch.setenv("NA_TPU_EPOCH_GROUP_PERIODS", periods)
        ck = tmp_path / f"g{group}_p{periods}_ck{ckpt_every}.npz"
        cfg = TrainConfig(epochs=7, batch_size=B, ks=[K], seed=11,
                          hidden_size=32, log_every=3, progress=False,
                          use_pallas=False, sample_block=1, mesh_shape=(1, 1),
                          checkpoint_every=ckpt_every,
                          checkpoint_path=str(ck) if ckpt_every else None)
        tr = NeuralAdmixtureTrainer(cfg)
        Qs, Ps, _ = tr.launch_training(P0.copy(), packed, V.copy(), M, N)
        last_ckpt_epoch = None
        if ckpt_every:
            assert ck.exists()
            last_ckpt_epoch = int(np.load(ck)["epoch"])
        return Qs[0], Ps[0], last_ckpt_epoch

    q1, p1, ck1 = run("0")
    q2, p2, ck2 = run("1")
    q3, p3, ck3 = run("1", periods="2")
    np.testing.assert_array_equal(q1, q2)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(q1, q3)
    np.testing.assert_array_equal(p1, p3)
    assert ck1 == ck2 == ck3
    if ckpt_every:
        assert ck1 == (7 // ckpt_every) * ckpt_every


def test_trainer_grouping_sharded(monkeypatch):
    """Grouped dispatch under shard_map on a (2, 2) (data, snp) mesh: the
    logged + scanned-fast composite must compile and match the ungrouped
    loop bit-for-bit (XLA sharded path; the per-epoch collectives are
    identical, grouping only wraps them in an outer scan)."""
    rng = np.random.default_rng(5)
    geno = rng.integers(0, 3, size=(N, M), dtype=np.uint8)
    packed, _ = pack_with_padding(geno)
    V = rng.normal(size=(8, M)).astype(np.float32) * 0.1
    P0 = rng.uniform(0.2, 0.8, size=(K, M)).astype(np.float32)

    def run(group):
        monkeypatch.setenv("NA_TPU_EPOCH_GROUP", group)
        cfg = TrainConfig(epochs=6, batch_size=B, ks=[K], seed=2,
                          hidden_size=32, log_every=3, progress=False,
                          use_pallas=False, sample_block=BLK,
                          mesh_shape=(2, 2))
        tr = NeuralAdmixtureTrainer(cfg)
        Qs, Ps, _ = tr.launch_training(P0.copy(), packed, V.copy(), M, N)
        return Qs[0], Ps[0]

    q1, p1 = run("0")
    q2, p2 = run("1")
    np.testing.assert_array_equal(q1, q2)
    np.testing.assert_array_equal(p1, p2)
