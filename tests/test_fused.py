"""The fused Triton op (ops.fused) against the plain XLA step.

The kernels run in the Pallas interpreter here; on the GPU the same
comparison at full width is phase 4 of chip_smoke.py. The reference is
models.qp + ops.loss (torch-matching BCE with the -100 log clamp, the
max(rec (1 - rec), 1e-12) backward and the boundary-inclusive clamp mask).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neural_admixture_tpu.io.packed import pack_2bit_rows
from neural_admixture_tpu.models import qp
from neural_admixture_tpu.ops import fused as F
from neural_admixture_tpu.ops.loss import clamped_bce_sum
from neural_admixture_tpu.ops.pack import packed_view_u32, unpack_dosage_x

ENC = ("rmsnorm", "common", "heads")


def _setup(B=16, M=1017, m_pad=1024, ks=(3,), missing=True, n_real=None,
           p_range=(0.05, 0.95), seed=0):
    """Packed batch with ragged M (m_pad - M padded SNPs) and, when
    ``n_real < B``, zero-weight padding rows."""
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4 if missing else 3, size=(B, M)).astype(np.uint8)
    packed = pack_2bit_rows(G, m_pad=m_pad)
    V = (rng.normal(size=(M, 8)) * 0.1).astype(np.float32)
    P0 = rng.uniform(*p_range, size=(sum(ks), M)).astype(np.float32)
    params = qp.init_params(jax.random.PRNGKey(seed), V, P0, 16, list(ks),
                            m_pad=m_pad)
    n_real = B if n_real is None else n_real
    rw = jnp.asarray((np.arange(B) < n_real).astype(np.float32))
    cm = jnp.asarray((np.arange(m_pad) < M).astype(np.float32))
    return params, packed, rw, cm


def _ref_loss(params, packed, rw, cm):
    X = unpack_dosage_x(jnp.asarray(packed))
    recs, _ = qp.forward_train(params, X)
    return sum(clamped_bce_sum(recs[hk], X, cm, rw) for hk in sorted(recs))


def _fused_loss(params, packed, rw, with_loss=True):
    op = F.make_fused_training_loss(sorted(params["heads"]),
                                    with_loss=with_loss, interpret=True)
    enc = {k: params[k] for k in ENC}
    return op(params["V"], enc, params["decoders"],
              jnp.asarray(packed_view_u32(packed)), rw)[0]


def _assert_trees_close(got, want, rtol=2e-4, atol=2e-4):
    flat = {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    for k, v in jax.tree_util.tree_flatten_with_path(got)[0]:
        name = jax.tree_util.keystr(k)
        w = np.asarray(flat[name])
        np.testing.assert_allclose(np.asarray(v), w, rtol=rtol,
                                   atol=atol * max(1.0, np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", [
    dict(),                                  # one head, ragged M, missing
    dict(n_real=11),                         # zero-weight padding rows
    dict(missing=False),                     # no code-3 genotypes
    dict(ks=(2, 3, 4)),                      # multi-head
    dict(ks=tuple(range(2, 11))),            # the K=2..10 sweep
    dict(p_range=(-0.2, 1.3)),               # raws outside [0, 1]: clamps
    dict(B=48, M=2048, m_pad=2048, seed=3),  # several row steps, exact M
], ids=["k3", "padded_rows", "no_missing", "multihead", "sweep", "clamped",
        "rows48"])
def test_step_matches_reference(case):
    params, packed, rw, cm = _setup(**case)
    lf, gf = jax.value_and_grad(_fused_loss)(params, packed, rw)
    lr, gr = jax.value_and_grad(_ref_loss)(params, packed, rw, cm)
    np.testing.assert_allclose(float(lf), float(lr), rtol=1e-5)
    _assert_trees_close(gf, gr)


@pytest.mark.parametrize("ks", [(3,), (2, 3)])
def test_loss_free_op_keeps_gradients(ks):
    """with_loss=False skips the BCE value (returns 0) and must leave every
    gradient unchanged."""
    params, packed, rw, _ = _setup(ks=ks, n_real=13)
    l0, g0 = jax.value_and_grad(_fused_loss)(params, packed, rw, False)
    l1, g1 = jax.value_and_grad(_fused_loss)(params, packed, rw, True)
    assert float(l0) == 0.0 and float(l1) > 0
    _assert_trees_close(g0, g1, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("missing", [True, False])
@pytest.mark.parametrize("m_pad", [512, 1536])
def test_xv_and_dv_match_reference(missing, m_pad):
    params, packed, _, _ = _setup(M=m_pad - 5, m_pad=m_pad, missing=missing)
    X = unpack_dosage_x(jnp.asarray(packed))
    u32 = jnp.asarray(packed_view_u32(packed))
    V = params["V"]
    np.testing.assert_allclose(np.asarray(F.xv(u32, V, interpret=True)),
                               np.asarray(X @ V), rtol=1e-5, atol=1e-5)
    dXp = jnp.asarray(np.random.default_rng(1).normal(size=(16, 8)),
                      jnp.float32)
    np.testing.assert_allclose(np.asarray(F.dv(u32, dXp, interpret=True)),
                               np.asarray(X.T @ dXp), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("value", [0.0, 1.0, -0.25, 1.25, 0.5, 1e-7])
def test_gradient_rule_at_clamp_boundaries(value):
    """One-hot q rows make raw equal a chosen P entry exactly: at 0 and 1
    the clamp passes the gradient (inclusive, like torch.clamp's backward),
    outside it blocks it, and the 1e-12 floor bounds the division."""
    B, m_pad, k = 16, 512, 2
    rng = np.random.default_rng(0)
    G = rng.integers(0, 4, size=(B, m_pad)).astype(np.uint8)
    packed = pack_2bit_rows(G, m_pad=m_pad)
    q = jnp.asarray(np.eye(k, dtype=np.float32)[np.arange(B) % k])
    P = jnp.asarray(np.where(rng.uniform(size=(k, m_pad)) < 0.5, value,
                             rng.uniform(0.1, 0.9, size=(k, m_pad))),
                    jnp.float32)
    rw = jnp.ones((B,), jnp.float32)
    X = unpack_dosage_x(jnp.asarray(packed))

    def ref(q, P):
        return clamped_bce_sum(q @ P, X, jnp.ones((m_pad,)), rw)

    lr = ref(q, P)
    dq_r, dp_r = jax.grad(ref, argnums=(0, 1))(q, P)
    loss, dqs, dps = F.heads(jnp.asarray(packed_view_u32(packed)), [q], [P],
                             rw, with_loss=True, interpret=True)
    np.testing.assert_allclose(float(loss), float(lr), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(dqs[0]), np.asarray(dq_r),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(dps[0]), np.asarray(dp_r),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape,dtype,err", [
    ((12, 32), jnp.uint32, ValueError),    # rows not a multiple of ROWS
    ((16, 48), jnp.uint32, ValueError),    # SNPs not whole tiles
    ((16, 128), jnp.uint8, TypeError),     # bytes, not words
])
def test_rejects_misaligned_batches(shape, dtype, err):
    with pytest.raises(err):
        F.xv(jnp.zeros(shape, dtype), jnp.zeros((16 * shape[1], 8)),
             interpret=True)
