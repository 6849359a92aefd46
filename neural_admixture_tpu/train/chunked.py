"""Shared chunked-forward helper for full-data Q inference.

One implementation of the slice / zero-pad-last-block / forward / crop /
concatenate pattern used by the training engine's post-training Q pass and
by projective inference (the reference re-implements this via DataLoaders,
model/neural_admixture.py:368-383, src/inference.py:67-77).
"""
from typing import Callable, Dict, List

import jax
import jax.numpy as jnp
import numpy as np


def chunked_forward(fwd: Callable, data, N: int, batch: int,
                    put: Callable = None) -> Dict[str, np.ndarray]:
    """Run ``fwd(batch_block) -> {head: (B, k)}`` over all N samples.

    ``data`` may be a device array or a host numpy array of packed rows
    (samples on axis 0). Host arrays are sliced on the host so only
    one batch lives on device at a time (projective inference may process
    matrices larger than device memory); ``put`` controls their placement
    (default jnp.asarray; a sharded caller passes a device_put into its
    batch sharding so host chunks land pre-sharded, not
    single-device-then-resharded). ``batch`` is used exactly as given
    (callers align it to their mesh); the last block is zero-padded to it
    and cropped after.
    """
    B = batch
    on_host = isinstance(data, np.ndarray)
    put = put if put is not None else jnp.asarray
    chunks: Dict[str, List[np.ndarray]] = {}
    for i in range(0, N, B):
        n_real = min(B, N - i)
        pad = [(0, B - n_real)] + [(0, 0)] * (data.ndim - 1)
        if on_host:  # pad on host, before placement
            blk = put(np.pad(data[i:i + n_real], pad))
        else:
            blk = jnp.pad(jax.lax.slice_in_dim(data, i, i + n_real), pad)
        qs = fwd(blk)
        for hk, q in qs.items():
            # to_host: in a multi-process run the per-chunk q is sharded
            # over the data axis across hosts; all-gather it (tiny (B, k)).
            from ..parallel.distributed import to_host
            chunks.setdefault(hk, []).append(to_host(q)[:n_real])
    return {hk: np.concatenate(parts, axis=0) for hk, parts in chunks.items()}
