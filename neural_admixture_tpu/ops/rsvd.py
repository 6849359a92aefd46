"""Randomized SVD of the genotype matrix, on device.

Replaces the reference's host-side Cython RSVD
(/root/reference/neural_admixture/src/svd.py:39-84 with OpenMP GEMM kernels in
/root/reference/neural_admixture/src/utils_c/rsvd.pyx): same algorithm and
hyperparameters (Gaussian test matrix from np.random.default_rng(seed),
k' = max(k + oversampling, 20), 2 power iterations with QR
re-orthonormalization, dense SVD of B = Qt A, deterministic sign flip), but
the big mixed-dtype GEMMs A @ Omega and Qt @ A run on the device over
2-bit-packed row blocks, unpacked on the fly -- the N x M float matrix never
materializes.

Note the reference feeds *raw* genotype codes (missing = 3 included) into the
SVD; we reproduce that.
"""
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .pack import unpack_genotypes

_PREC = jax.lax.Precision.HIGHEST


def svd_flip(V: np.ndarray, U: np.ndarray) -> np.ndarray:
    """Sign-normalize rows of Vt using dominant entries of U's columns
    (same convention as /root/reference/neural_admixture/src/svd.py:16-37).

    Pure numpy, like the small host QR/SVD calls around it: the fixup is
    microseconds of work, and a jnp version would round-trip the (k', M)
    matrix to the device and trigger a per-dataset-shape XLA compile."""
    U = np.asarray(U)
    V = np.asarray(V)
    idx = np.argmax(np.abs(U), axis=0)
    signs = np.sign(U[idx, np.arange(U.shape[1])])
    return V * signs[:, None]


def _pad_rows(x: jnp.ndarray, n_pad: int) -> jnp.ndarray:
    if n_pad == x.shape[0]:
        return x
    pad = jnp.zeros((n_pad - x.shape[0],) + x.shape[1:], x.dtype)
    return jnp.concatenate([x, pad], axis=0)


@jax.jit
def _blk_a_omega(blk: jnp.ndarray, Omega: jnp.ndarray) -> jnp.ndarray:
    """One host-streamed row block of A @ Omega (out-of-core path)."""
    A = unpack_genotypes(blk).astype(jnp.float32)
    return jnp.dot(A, Omega, precision=_PREC)


@jax.jit
def _blk_qt_a(Qtb: jnp.ndarray, blk: jnp.ndarray) -> jnp.ndarray:
    """One host-streamed row block of Q^T @ A (out-of-core path)."""
    A = unpack_genotypes(blk).astype(jnp.float32)
    return jnp.dot(Qtb, A, precision=_PREC)


@partial(jax.jit, static_argnames=("block_rows",))
def _mul_A_omega(packed: jnp.ndarray, Omega: jnp.ndarray, block_rows: int):
    """(N, W) packed x (4W, k') -> (N_pad, k') = A @ Omega over row blocks."""
    n_pad = packed.shape[0]
    nb = n_pad // block_rows
    kp = Omega.shape[1]

    def body(i, Y):
        blk = jax.lax.dynamic_slice_in_dim(packed, i * block_rows, block_rows)
        A = unpack_genotypes(blk).astype(jnp.float32)
        Yb = jnp.dot(A, Omega, precision=_PREC)
        return jax.lax.dynamic_update_slice_in_dim(Y, Yb, i * block_rows, 0)

    return jax.lax.fori_loop(0, nb, body,
                             jnp.zeros((n_pad, kp), jnp.float32))


@partial(jax.jit, static_argnames=("block_rows",))
def _mul_Qt_A(Qt: jnp.ndarray, packed: jnp.ndarray, block_rows: int):
    """(k', N_pad) x (N, W) packed -> (k', 4W) = Qt @ A over row blocks."""
    n_pad = packed.shape[0]
    nb = n_pad // block_rows
    m_pad = packed.shape[1] * 4

    def body(i, B):
        blk = jax.lax.dynamic_slice_in_dim(packed, i * block_rows, block_rows)
        A = unpack_genotypes(blk).astype(jnp.float32)
        Qb = jax.lax.dynamic_slice_in_dim(Qt, i * block_rows, block_rows, axis=1)
        return B + jnp.dot(Qb, A, precision=_PREC)

    return jax.lax.fori_loop(0, nb, body,
                             jnp.zeros((Qt.shape[0], m_pad), jnp.float32))


def rsvd(packed, N: int, M: int, k: int = 8, seed: int = 42,
         oversampling: int = 10, power_iterations: int = 2,
         block_rows: int = 4096, rows: Optional[Tuple[int, int]] = None,
         stream: Optional[bool] = None) -> np.ndarray:
    """Randomized SVD of the packed genotype matrix. Returns Vt_k (k, M) f32.

    ``packed``: (n, W) uint8, 2-bit packed, sample-major (padding columns are
    genotype 0 and therefore contribute nothing to the factorization).

    ``rows``: multi-host mode -- ``packed`` holds only this process's sample
    rows [start, end) of the global N. The row-parallel GEMMs run on local
    rows; the tiny (N, k') sketch is all-gathered and the (k', M) partial
    products summed across hosts, so every process computes an identical V
    (same LAPACK calls on identical inputs) with no broadcast step.

    ``stream``: host-streaming (out-of-core) mode -- the packed matrix stays
    in host memory and each GEMM transfers one ``block_rows`` block at a
    time (~2 + 2*power_iterations passes over the data), for matrices whose
    packed bytes exceed device HBM. None = auto by size
    (utils.hbm.should_stream_host); same block order and f32 accumulation
    as the resident path.
    """
    from ..parallel.distributed import allsum_hosts, gather_ragged_rows
    from ..utils.hbm import should_stream_host

    start, end = rows if rows is not None else (0, N)
    n_local = end - start
    assert packed.shape[0] >= n_local, (packed.shape, rows)
    if stream is None:
        # Footprint if device-resident: packed rows + the (m_pad, k') Omega
        # and (n, k') sketch transients.
        kp = max(k + oversampling, 20)
        stream = should_stream_host(
            n_local * packed.shape[1]
            + (packed.shape[1] * 4 + n_local) * kp * 4)
    n_pad = ((n_local + block_rows - 1) // block_rows) * block_rows
    if stream:
        packed = np.asarray(packed[:n_local])
    else:
        # Pad on HOST, one device transfer: a device-side concat keeps the
        # unpadded copy live while allocating the padded one -- a ~2x HBM
        # transient the auto-stream estimate above does not budget for
        # (near-capacity matrices would OOM instead of streaming).
        src = np.asarray(packed[:n_local])
        if n_pad != n_local:
            src = np.concatenate(
                [src, np.zeros((n_pad - n_local,) + src.shape[1:],
                               src.dtype)], axis=0)
        packed = jnp.asarray(src)
    distributed = rows is not None

    k_prime = max(k + oversampling, 20)
    # Same host RNG stream as the reference's Omega (svd.py:44-49).
    rng = np.random.default_rng(seed)
    Omega_np = rng.standard_normal(size=(M, k_prime), dtype=np.float32)
    m_pad = packed.shape[1] * 4
    Omega = jnp.asarray(np.pad(Omega_np, ((0, m_pad - M), (0, 0))))

    # Large mixed-dtype GEMMs run on device over packed blocks; the small
    # (N x k') QR and (k' x M) SVD run on the host (LAPACK) -- they are
    # negligible FLOPs, and keeping them off-device avoids per-dataset-shape
    # XLA compiles of QR/SVD.
    def _blk(i):
        """Host row block [i, i+block_rows), zero-padded to a static shape
        (one trace; padding rows decode to genotype 0 and are cropped or
        multiplied by zero Q rows)."""
        blk = packed[i:i + block_rows]
        if blk.shape[0] < block_rows:
            blk = np.concatenate(
                [blk, np.zeros((block_rows - blk.shape[0], blk.shape[1]),
                               blk.dtype)], axis=0)
        return jnp.asarray(blk)

    def A_omega(Om):
        """Global Y = A @ Om (N, k'), identical on every host."""
        if stream:
            Y_local = np.empty((n_local, Om.shape[1]), np.float32)
            for i in range(0, n_local, block_rows):
                j = min(i + block_rows, n_local)
                Y_local[i:j] = np.asarray(_blk_a_omega(_blk(i), Om))[:j - i]
        else:
            Y_local = np.asarray(_mul_A_omega(packed, Om,
                                              block_rows))[:n_local]
        if not distributed:
            return Y_local
        return gather_ragged_rows(Y_local)

    def Qt_A(Q_full):
        """Global B = Q^T A (k', m_pad), identical on every host."""
        Q_local = Q_full[start:end]
        Qt_np = np.ascontiguousarray(
            np.pad(Q_local, ((0, n_pad - n_local), (0, 0))).T)
        if stream:
            B_part = np.zeros((Qt_np.shape[0], m_pad), np.float32)
            for i in range(0, n_local, block_rows):
                Qtb = jnp.asarray(
                    np.ascontiguousarray(Qt_np[:, i:i + block_rows]))
                B_part += np.asarray(_blk_qt_a(Qtb, _blk(i)))
        else:
            B_part = np.asarray(_mul_Qt_A(jnp.asarray(Qt_np), packed,
                                          block_rows))
        return allsum_hosts(B_part) if distributed else B_part

    Y = A_omega(Omega)
    for _ in range(power_iterations):
        Q_y, _ = np.linalg.qr(Y, mode="reduced")
        B_tmp = Qt_A(Q_y)                                       # (k', m_pad)
        Y = A_omega(jnp.asarray(np.ascontiguousarray(B_tmp.T)))

    Q, _ = np.linalg.qr(Y, mode="reduced")
    B = Qt_A(Q)                                                 # (k', m_pad)
    Ut, _St, Vt = np.linalg.svd(B[:, :M], full_matrices=False)
    Vt = svd_flip(Vt, Ut)
    return Vt[:k, :].astype(np.float32)
