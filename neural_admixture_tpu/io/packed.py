"""Sample-major 2-bit packed genotype layout.

On device, the genotype matrix is kept 2-bit packed: shape
(N, ceil(M/4)) uint8, genotype j of a row stored at bits [2*(j%4), 2*(j%4)+1]
of byte j//4 (little-endian within the byte, matching PLINK's intra-byte
order). This is the analogue of the reference's CUDA pack2bit
residency scheme (/root/reference/neural_admixture/src/utils_c/pack2bit.cu:10-62,
packed residency set up at /root/reference/neural_admixture/model/train.py:120-126).

Padding columns (when M % 4 != 0, or when padding M up to a lane multiple)
hold genotype value 0; consumers mask padded columns out of losses.
"""
from typing import Tuple

import numpy as np


def packed_width(m: int) -> int:
    return (m + 3) // 4


def pack_2bit_rows(G: np.ndarray, m_pad: int = 0) -> np.ndarray:
    """Pack a (N, M) uint8 dosage matrix into (N, ceil(M_pad/4)) uint8.

    ``m_pad``: optionally pad the SNP axis up to this many columns (with
    genotype 0) before packing; 0 means pad only to the next multiple of 4.
    """
    G = np.ascontiguousarray(G, dtype=np.uint8)
    N, M = G.shape
    target = max(m_pad, M)
    target = ((target + 3) // 4) * 4
    if target != M:
        Gp = np.zeros((N, target), dtype=np.uint8)
        Gp[:, :M] = G
        G = Gp
    G4 = G.reshape(N, target // 4, 4)
    packed = (G4[:, :, 0]
              | (G4[:, :, 1] << 2)
              | (G4[:, :, 2] << 4)
              | (G4[:, :, 3] << 6))
    return packed.astype(np.uint8)


def unpack_2bit_rows(packed: np.ndarray, M: int) -> np.ndarray:
    """Inverse of :func:`pack_2bit_rows`: (N, W) uint8 -> (N, M) uint8."""
    packed = np.asarray(packed, dtype=np.uint8)
    N, W = packed.shape
    out = np.empty((N, W, 4), dtype=np.uint8)
    out[:, :, 0] = packed & 3
    out[:, :, 1] = (packed >> 2) & 3
    out[:, :, 2] = (packed >> 4) & 3
    out[:, :, 3] = (packed >> 6) & 3
    return out.reshape(N, W * 4)[:, :M]


def pack_with_padding(G: np.ndarray, lane_multiple: int = 2048) -> Tuple[np.ndarray, int]:
    """Pack G with the SNP axis padded to a multiple of ``lane_multiple``.

    The default of 2048 genotypes = 512 bytes = 128 uint32 words is a whole
    number of the fused op's SNP tiles (ops.fused.TILE_SNPS) and leaves room
    to split them over an snp mesh axis. Returns (packed, m_padded).
    """
    M = G.shape[1]
    m_padded = ((M + lane_multiple - 1) // lane_multiple) * lane_multiple
    return pack_2bit_rows(G, m_pad=m_padded), m_padded
