"""On-device 2-bit genotype unpacking.

The resident genotype matrix is (N, W) uint8 with 4 genotypes per byte
(see neural_admixture_tpu.io.packed). These ops expand a packed batch to
dosage space on the fly inside the jitted train step of the XLA path, so the
uint8 N x M matrix never lives on the device -- the counterpart of the
reference's ``unpack2bit_gpu_to_gpu`` CUDA kernel (/root/reference/
neural_admixture/src/utils_c/pack2bit.cu:38-62), which re-materializes
uint8 batches each step. On the GPU the fused op (ops.fused) unpacks in
registers instead.
"""
import jax.numpy as jnp
import numpy as np


def unpack_genotypes(packed: jnp.ndarray) -> jnp.ndarray:
    """(…, W) uint8 -> (…, 4W) uint8 genotypes in {0,1,2,3}."""
    parts = [(packed >> (2 * j)) & jnp.uint8(3) for j in range(4)]
    g = jnp.stack(parts, axis=-1)
    return g.reshape(*packed.shape[:-1], packed.shape[-1] * 4)


def unpack_dosage_x(packed: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """(…, W) uint8 -> (…, 4W) dosage-scaled model input X.

    X = genotype / 2 with missing (3) imputed to 0.0, matching the reference
    forward pass (/root/reference/neural_admixture/model/neural_admixture.py:169-170):
    X = X.float()/2 ; X[X == 1.5] = 0.0.
    """
    g = unpack_genotypes(packed)
    x = g.astype(dtype) * dtype(0.5)
    return jnp.where(g == jnp.uint8(3), dtype(0.0), x)


def packed_view_u32(packed: np.ndarray) -> np.ndarray:
    """(N, W) uint8 2-bit rows -> (N, W//4) little-endian uint32 words, the
    fused op's input (ops.fused): word w holds SNPs 16w .. 16w+15."""
    assert packed.shape[-1] % 4 == 0
    return np.ascontiguousarray(packed).view("<u4")
