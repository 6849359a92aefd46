"""Final masked binomial log-likelihood of (Q, P) given genotypes.

Parity target: the reference's OpenMP evaluator
(/root/reference/neural_admixture/src/utils_c/utils.pyx:17-40):

    logl = sum over (i, j) with G[i,j] != 3 of
           g * log(rec) + (2 - g) * log1p(-rec),
    rec = clip(Q_i . P_j, eps, 1 - eps),  g = clip(G[i,j], eps, 2 - eps),
    eps = 1e-6, accumulated in float64.

Unlike the training loss, missing genotypes ARE masked here.

``loglikelihood`` is the host (NumPy, float64, blocked) implementation used
for the end-of-run report; ``loglikelihood_device`` is a jittable float32
version with per-block compensation, usable on the GPU for large matrices.
"""
import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-6


def loglikelihood(G: np.ndarray, P: np.ndarray, Q: np.ndarray, K: int,
                  eps: float = _EPS, block: int = 2048) -> float:
    """G: (N, M) uint8, P: (M, K) float, Q: (N, K) float -> scalar loglik."""
    G = np.asarray(G)
    P = np.asarray(P, np.float64)
    Q = np.asarray(Q, np.float64)
    if eps == _EPS:
        try:
            from ..native import bed_native
            if bed_native.available():
                return bed_native.loglikelihood(G, P, Q, eps)
        except ImportError:
            pass
    N, M = G.shape
    total = 0.0
    for i in range(0, N, block):
        g = G[i:i + block].astype(np.float64)
        rec = np.clip(Q[i:i + block] @ P.T, eps, 1.0 - eps)
        gc = np.clip(g, eps, 2.0 - eps)
        term = gc * np.log(rec) + (2.0 - gc) * np.log1p(-rec)
        total += float(np.sum(np.where(g == 3.0, 0.0, term)))
    return total


@jax.jit
def _loglik_block(g_u8, P, Q_blk, eps):
    g = g_u8.astype(jnp.float32)
    rec = jnp.clip(jnp.dot(Q_blk, P.T, precision=jax.lax.Precision.HIGHEST),
                   eps, 1.0 - eps)
    gc = jnp.clip(g, eps, 2.0 - eps)
    term = gc * jnp.log(rec) + (2.0 - gc) * jnp.log1p(-rec)
    return jnp.sum(jnp.where(g == 3.0, 0.0, term), dtype=jnp.float64
                   if jax.config.jax_enable_x64 else jnp.float32)


def loglikelihood_device(G, P, Q, K: int, eps: float = _EPS,
                         block: int = 4096) -> float:
    """Blocked on-device evaluation (f32 matmuls, per-block host accumulation
    in f64). G may be a device or host (N, M) uint8 array."""
    P = jnp.asarray(P, jnp.float32)
    Q = jnp.asarray(Q, jnp.float32)
    N = G.shape[0]
    total = 0.0
    for i in range(0, N, block):
        total += float(_loglik_block(jnp.asarray(G[i:i + block]), P,
                                     Q[i:i + block], eps))
    return total


def loglikelihood_packed(packed, M: int, P, Q, eps: float = _EPS,
                         block: int = 2048,
                         device_threshold: float = 2e10) -> float:
    """Evaluation fed from 2-bit packed rows: each row block is unpacked
    transiently, so the N x M uint8 matrix never materializes (biobank
    path).

    Below ``device_threshold`` N*M genotypes, blocks are unpacked on the
    host and reduced in float64 (bit-matching :func:`loglikelihood`); above
    it, blocks are unpacked and reduced on device in float32 with per-block
    float64 accumulation on host -- host f64 at that scale would take hours,
    and the per-block f32 error is O(1e-7) relative."""
    from ..io.packed import unpack_2bit_rows

    P = np.asarray(P, np.float64)
    Q = np.asarray(Q, np.float64)
    N = Q.shape[0]
    if N * M > device_threshold:
        from .pack import unpack_genotypes

        P32 = jnp.asarray(P, jnp.float32)
        Q32 = jnp.asarray(Q, jnp.float32)
        total = 0.0
        for i in range(0, N, block):
            g = unpack_genotypes(jnp.asarray(packed[i:i + block]))[:, :M]
            total += float(_loglik_block(g, P32, Q32[i:i + block], eps))
        return total
    total = 0.0
    for i in range(0, N, block):
        G_blk = unpack_2bit_rows(np.asarray(packed[i:i + block]), M)
        # The NumPy fallback holds several float64 (rows, M) temporaries:
        # keep its row blocks near 32M genotypes.
        total += loglikelihood(G_blk, P, Q[i:i + block], P.shape[1], eps=eps,
                               block=max(1, (1 << 25) // max(M, 1)))
    return total
