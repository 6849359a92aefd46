"""The fused (xv-kernel) inference path must match the XLA encoder forward.

ops.fused.fused_infer_q computes Xp = X @ V straight from the 2-bit
packed words (no f32 X); it backs the engine's post-training Q pass, the
sharded Q pass, and the projective-inference CLI on the GPU. Here its
kernel runs in the Pallas interpreter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neural_admixture_tpu.io.packed import pack_with_padding
from neural_admixture_tpu.models import qp
from neural_admixture_tpu.ops import pack as pk


def _setup(seed=0, N=37, M=700, D=4, ks=(3, 5), missing=True):
    rng = np.random.default_rng(seed)
    hi = 4 if missing else 3
    G = rng.integers(0, hi, size=(N, M)).astype(np.uint8)
    packed, _ = pack_with_padding(G)
    m_pad = packed.shape[1] * 4
    V = rng.normal(size=(D, M)).astype(np.float32) * 0.1
    params = qp.init_params(jax.random.PRNGKey(seed), V.T, None, 32,
                            list(ks), m_pad=m_pad)
    return G, packed, params, m_pad


@pytest.mark.parametrize("missing", [True, False])
def test_fused_infer_matches_xla_encoder(missing):
    from neural_admixture_tpu.ops.fused import ROWS, fused_infer_q

    G, packed, params, m_pad = _setup(missing=missing)
    N = G.shape[0]
    # XLA reference: unpack to X, missing -> 0, encoder forward.
    X = np.where(G == 3, 0.0, G / 2.0).astype(np.float32)
    X = np.pad(X, ((0, 0), (0, m_pad - G.shape[1])))
    qs_ref = qp.forward_infer(params, jnp.asarray(X))

    # Rows padded to the kernel's row step.
    B = -(-N // ROWS) * ROWS
    u32 = np.pad(pk.packed_view_u32(packed), ((0, B - N), (0, 0)))
    qs = fused_infer_q(params, jnp.asarray(u32), interpret=True)
    for hk in qs_ref:
        np.testing.assert_allclose(np.asarray(qs[hk])[:N],
                                   np.asarray(qs_ref[hk]), rtol=2e-5,
                                   atol=2e-6)


def test_cli_infer_q_fused_matches_xla():
    """infer.infer_q: the fused path (interpret) and XLA give the same Q;
    on the CPU the platform choice is the XLA path."""
    from neural_admixture_tpu.infer import infer_q

    G, packed, params, _ = _setup(N=21, M=500, ks=(3,))
    qs_x = infer_q(params, packed, G.shape[0], [3], batch_size=8)
    qs_f = infer_q(params, packed, G.shape[0], [3], batch_size=8,
                   use_pallas=True, interpret=True)
    for a, b in zip(qs_x, qs_f):
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("mesh_shape,pallas", [((2, 2), False),
                                               ((4, 1), False),
                                               ((2, 2), True)])
def test_infer_q_mesh_matches_single_device(mesh_shape, pallas):
    """Sharded projective inference (infer --mesh DxS / --num_gpus N>1,
    a capability the reference rejects, src/inference.py:20-21) must
    reproduce the single-device Q on the virtual CPU mesh -- on the XLA
    path and through the fused xv kernel (interpret mode)."""
    from neural_admixture_tpu.infer import infer_q, infer_q_mesh

    G, packed, params, _ = _setup(N=30, M=512, ks=(3,))
    kw = dict(use_pallas=pallas, interpret=pallas)
    qs_1 = infer_q(params, packed, G.shape[0], [3], batch_size=16, **kw)
    qs_m = infer_q_mesh(params, packed, G.shape[0], [3], 16, mesh_shape,
                        **kw)
    for a, b in zip(qs_1, qs_m):
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-6)
