"""The sharded (shard_map) loss/grad must match the single-device step
exactly -- data-parallel over samples, SNP-sharded V/P, on an 8-device
virtual CPU mesh (2 data x 4 snp and 4 data x 2 snp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neural_admixture_tpu.io.packed import pack_2bit_rows
from neural_admixture_tpu.models import qp
from neural_admixture_tpu.ops.loss import clamped_bce_sum, softmax_cross_entropy_sum
from neural_admixture_tpu.ops.pack import unpack_dosage_x
from neural_admixture_tpu.parallel.mesh import make_mesh
from neural_admixture_tpu.parallel.sharded_step import make_sharded_loss_and_grad


def _setup(B=16, m_pad=8192, K=4, D=4, H=16, supervised=False, seed=0):
    rng = np.random.default_rng(seed)
    M = m_pad - 100
    G = rng.integers(0, 4, size=(B, M)).astype(np.uint8)
    packed = jnp.asarray(pack_2bit_rows(G, m_pad=m_pad))
    V = rng.normal(size=(M, D)).astype(np.float32) * 0.1
    P_init = rng.uniform(0.2, 0.8, size=(K, M)).astype(np.float32)
    # Zero-padded to m_pad like the engine's parameters (the fused op relies
    # on padded P columns being 0; the XLA step masks them).
    params = qp.init_params(jax.random.PRNGKey(seed), V, P_init, H, [K],
                            m_pad=m_pad)
    col_mask = jnp.asarray((np.arange(m_pad) < M).astype(np.float32))
    row_w = jnp.asarray((rng.uniform(size=B) > 0.1).astype(np.float32))
    pops = jnp.asarray(rng.integers(0, K, size=B), dtype=jnp.int32)
    return params, packed, col_mask, row_w, pops


def _single_device_ref(params, xb, row_w, col_mask, pops, supervised, w):
    def loss_fn(p):
        X = unpack_dosage_x(xb)
        recs, qs = qp.forward_train(p, X)
        loss = sum(clamped_bce_sum(recs[hk], X, col_mask, row_w)
                   for hk in recs)
        if supervised:
            hk0 = sorted(qs.keys())[0]
            loss = loss + w * softmax_cross_entropy_sum(qs[hk0], pops, row_w)
        return loss
    return jax.value_and_grad(loss_fn)(params)


@pytest.mark.parametrize("mesh_shape,supervised,use_pallas", [
    ((2, 4), False, False), ((4, 2), False, False), ((8, 1), False, False),
    ((2, 4), True, False), ((2, 4), False, True), ((2, 2), True, True)])
def test_sharded_matches_single_device(mesh_shape, supervised, use_pallas):
    # The fused op steps through each device's rows 16 at a time.
    params, packed, col_mask, row_w, pops = _setup(
        B=32 if use_pallas else 16, supervised=supervised)
    w = 7.0
    mesh = make_mesh(*mesh_shape,
                     devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    fn = make_sharded_loss_and_grad(mesh, params, supervised, w,
                                    use_pallas=use_pallas,
                                    interpret=use_pallas)
    batch = packed
    if use_pallas:
        # The fused op reads the same rows as uint32 words (interpret mode).
        from neural_admixture_tpu.ops.pack import packed_view_u32
        batch = jnp.asarray(packed_view_u32(np.asarray(packed)))
    loss_s, grads_s = jax.jit(fn)(params, batch, row_w, col_mask, pops)
    loss_r, grads_r = _single_device_ref(params, packed, row_w, col_mask,
                                         pops, supervised, w)

    np.testing.assert_allclose(float(loss_s), float(loss_r), rtol=1e-5)
    flat_r = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_flatten_with_path(grads_r)[0]}
    for k, v in jax.tree_util.tree_flatten_with_path(grads_s)[0]:
        ks = jax.tree_util.keystr(k)
        np.testing.assert_allclose(np.asarray(v), np.asarray(flat_r[ks]),
                                   rtol=2e-4, atol=2e-3, err_msg=ks)


def test_q_exactly_replicated_across_snp_shards():
    """The supervised CE term divides by n_snp on the assumption that every
    snp shard computes a bitwise-identical Q (the psum'd Xp is replicated);
    any cross-shard drift (e.g. from a future approx-reciprocal or bf16
    change in the Xp path) would silently mis-weight the CE. Pin exact
    replication by exposing each snp shard's Q as a separate output row."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from neural_admixture_tpu.parallel.mesh import (DATA_AXIS, SNP_AXIS,
                                                    param_specs, shard_params)
    from neural_admixture_tpu.parallel.sharded_step import _psum_snp

    params, packed, col_mask, row_w, pops = _setup(B=16, m_pad=8192, K=4)
    mesh = make_mesh(2, 4, devices=jax.devices()[:8])
    params_s = shard_params(params, mesh)
    hk = sorted(params["heads"])[0]

    def per_device(params, xb):
        X = unpack_dosage_x(xb)
        Xp = _psum_snp(X @ params["V"])
        q = qp.encode_from_xp(params, Xp)[hk]
        return q[None]  # (1, B_loc, k): one row per snp shard globally

    fn = jax.jit(shard_map(
        per_device, mesh=mesh,
        in_specs=(param_specs(params), P(DATA_AXIS, SNP_AXIS)),
        out_specs=P(SNP_AXIS, DATA_AXIS, None),
        check_vma=False))
    q_shards = np.asarray(fn(params_s, packed))
    assert q_shards.shape[0] == 4
    for s in range(1, 4):
        np.testing.assert_array_equal(q_shards[s], q_shards[0])
