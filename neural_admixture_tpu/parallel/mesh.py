"""Device mesh and sharding layout.

The reference's only parallelism is single-node data-parallel DDP over NCCL
(/root/reference/neural_admixture/src/utils.py:81-95, DistributedSampler in
src/loaders.py:27). This design replaces that with a 2-D
``(data, snp)`` jax.sharding.Mesh:

  * samples (the N axis of the packed genotype matrix and each batch) are
    sharded over ``data`` -- classic DP;
  * the SNP axis M -- the model's huge dimension -- is sharded over ``snp``:
    V (M, D) by rows, each decoder P (k, M) by columns, and each batch's
    packed bytes by columns. X @ V partials are psum'd over ``snp``; BCE
    partial sums are psum'd over both axes. This is the new TP-like axis the
    reference lacks (SURVEY.md section 2.3), sized for biobank-scale M where
    P and V no longer fit (or no longer *should* sit) on one chip.

Encoder parameters (RMSNorm, common MLP, heads) are tiny and replicated.
XLA inserts the collectives from these shardings under jit.
"""
from typing import Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SNP_AXIS = "snp"


def make_mesh(n_data: Optional[int] = None, n_snp: int = 1,
              devices=None) -> Mesh:
    """Create a (data, snp) mesh over ``devices`` (default: all)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    total = devices.size
    if n_data is None:
        assert total % n_snp == 0, (total, n_snp)
        n_data = total // n_snp
    assert n_data * n_snp == total, \
        f"mesh {n_data}x{n_snp} != {total} devices"
    return Mesh(devices.reshape(n_data, n_snp), (DATA_AXIS, SNP_AXIS))


def param_specs(params: Dict) -> Dict:
    """PartitionSpec pytree for a qp params pytree."""
    specs = {
        "V": P(SNP_AXIS, None),
        "rmsnorm": {"weight": P()},
        "common": {"kernel": P(), "bias": P()},
        "heads": {hk: {"kernel": P(), "bias": P()}
                  for hk in params.get("heads", {})},
    }
    if "decoders" in params:
        specs["decoders"] = {hk: P(None, SNP_AXIS)
                             for hk in params["decoders"]}
    return specs


def global_put(x, sharding: NamedSharding):
    """device_put that also works when ``sharding`` spans multiple processes
    (jax.device_put requires every target device to be addressable). The
    host value ``x`` must be the FULL global array, identical on every
    process; each process materializes only its addressable shards."""
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def shard_params(params: Dict, mesh: Mesh) -> Dict:
    specs = param_specs(params)
    return jax.tree.map(
        lambda x, s: global_put(x, NamedSharding(mesh, s)),
        params, specs,
        is_leaf=lambda x: not isinstance(x, dict))
