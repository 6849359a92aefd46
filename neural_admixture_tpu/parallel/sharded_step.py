"""shard_map training step: data-parallel samples x SNP-sharded model.

This is the multi-chip expression of the engine's step (SURVEY.md section 2.3,
section 5 "long-context" row): the reference only has single-node DDP over
NCCL; here the huge M axis is genuinely sharded:

  per device (d, s) of the (data, snp) mesh:
    xb_loc  (B/d_sz, W/s_sz)   packed batch block
    V_loc   (M/s_sz, D)        rows of V            P(SNP, None)
    P_k_loc (k, M/s_sz)        columns of each P    P(None, SNP)
    encoder (RMSNorm, common MLP, heads)            replicated

  forward:
    Xp = psum_snp(X_loc @ V_loc)          -- one small (B_loc, D) collective
    Q  = encoder(Xp)                      -- replicated over snp
    bce_local = BCE(Q @ P_loc, X_loc)     -- no communication
    loss = psum(bce_local, (data, snp)) [+ psum_data(ce_local / s_sz)]

  backward (via jax.grad through the psums):
    dP_loc needs no cross-snp communication; dV_loc gets its cross-shard
    cotangent through the transpose of the psum; encoder grads come out
    replication-consistent. Verified against the single-device step in
    tests/test_sharded_step.py.

The per-shard compute is the same code as the single-device engine -- either
the XLA path or the fused op (ops.fused), which simply sees the local block
shapes. XLA lowers the psums to NCCL collectives on GPUs.
"""
from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..models import qp
from ..ops.loss import clamped_bce_sum, softmax_cross_entropy_sum
from ..ops.pack import unpack_dosage_x
from .mesh import DATA_AXIS, SNP_AXIS, param_specs


@jax.custom_vjp
def _psum_snp(x):
    """psum over the snp axis with the *mathematically correct* transpose.

    The global loss is a sum of per-shard local losses, each consuming the
    replicated psum result; the true cotangent of each shard's partial is
    therefore the psum of the per-shard cotangents -- NOT the local cotangent
    that plain AD-of-psum produces under shard_map. (Verified against the
    single-device step in tests/test_sharded_step.py.)
    """
    return jax.lax.psum(x, SNP_AXIS)


def _psum_snp_fwd(x):
    return jax.lax.psum(x, SNP_AXIS), None


def _psum_snp_bwd(_, g):
    return (jax.lax.psum(g, SNP_AXIS),)


_psum_snp.defvjp(_psum_snp_fwd, _psum_snp_bwd)


def _shard_loss_local(params, xb, row_weight, col_mask, pops_batch,
                      supervised: bool, supervised_loss_weight: float,
                      use_pallas: bool, n_snp: int, fused_op=None):
    """Local loss contribution of one device; global loss = psum of these."""
    if use_pallas:
        enc = {k: params[k] for k in ("rmsnorm", "common", "heads")}
        loss, qs = fused_op(params["V"], enc, params["decoders"], xb,
                            row_weight)
    else:
        X = unpack_dosage_x(xb)
        Xp = _psum_snp(qp.matmul(X, params["V"]))
        qs = qp.encode_from_xp(params, Xp)
        loss = jnp.asarray(0.0, jnp.float32)
        for hk in sorted(qs):
            loss = loss + clamped_bce_sum(
                qp.matmul(qs[hk], params["decoders"][hk]), X, col_mask,
                row_weight)
    if supervised:
        # Q is replicated over the snp axis; divide so the (data, snp) psum
        # counts each sample's CE exactly once.
        from ..train.engine import smallest_head
        ce = softmax_cross_entropy_sum(qs[smallest_head(qs)], pops_batch,
                                       row_weight)
        loss = loss + supervised_loss_weight * ce / n_snp
    return loss


def make_sharded_loss_and_grad(mesh, params_template: Dict, supervised: bool,
                               supervised_loss_weight: float,
                               use_pallas: bool, compute_loss: bool = True,
                               interpret: bool = False):
    """Build a (params, xb, row_w, col_mask, pops_b) -> (loss, grads) function
    executed under shard_map on ``mesh``. Input/output shardings:
      xb P(data, snp); row_w/pops_b P(data); col_mask P(snp);
      params/grads per parallel.mesh.param_specs; loss replicated.

    On the fused path ``compute_loss=False`` skips the BCE value (see
    ops.fused.make_fused_training_loss); padded SNP columns need no mask
    there (they all live in the last snp shard, whose local P padding is 0
    and stays 0).
    """
    n_snp = mesh.shape[SNP_AXIS]
    pspecs = param_specs(params_template)
    fused_op = None
    if use_pallas:
        from ..ops.fused import make_fused_training_loss
        fused_op = make_fused_training_loss(
            sorted(params_template["heads"]), snp_axis=SNP_AXIS,
            with_loss=compute_loss, interpret=interpret)
    local = partial(_shard_loss_local, supervised=supervised,
                    supervised_loss_weight=supervised_loss_weight,
                    use_pallas=use_pallas, n_snp=n_snp, fused_op=fused_op)

    def per_device(params, xb, row_weight, col_mask, pops_batch):
        # Differentiate the LOCAL loss only (under check_vma=False, psum
        # transposes to psum, so differentiating a psum'd loss would scale
        # every gradient by the device count). All cross-device accumulation
        # is explicit and auditable below.
        def local_loss(p):
            return local(p, xb, row_weight, col_mask, pops_batch)

        local_l, grads = jax.value_and_grad(local_loss)(params)
        loss = jax.lax.psum(local_l, (DATA_AXIS, SNP_AXIS))
        # Accumulate across the devices that share each parameter:
        #   V rows / P columns are replicated over `data` only (the cross-snp
        #   coupling of dV flows through _psum_snp's transpose);
        #   encoder parameters are replicated over both axes.
        grads = dict(grads)
        grads["V"] = jax.lax.psum(grads["V"], DATA_AXIS)
        grads["decoders"] = {hk: jax.lax.psum(v, DATA_AXIS)
                             for hk, v in grads["decoders"].items()}
        for name in ("rmsnorm", "common", "heads"):
            grads[name] = jax.tree.map(
                lambda v: jax.lax.psum(v, (DATA_AXIS, SNP_AXIS)), grads[name])
        return loss, grads

    return shard_map(
        per_device, mesh=mesh,
        in_specs=(pspecs, P(DATA_AXIS, SNP_AXIS), P(DATA_AXIS),
                  P(SNP_AXIS), P(DATA_AXIS)),
        out_specs=(P(), pspecs),
        check_vma=False,
    )


def infer_q_sharded(mesh, params, data_dev, N: int, use_pallas: bool,
                    batch: int = 1024, interpret: bool = False):
    """Full-data encoder pass with V SNP-sharded (inference needs only the
    psum of X @ V partials; everything after is replicated). ``data_dev``
    holds packed rows: uint32 words on the fused path, whose local X @ V
    partial runs through the xv kernel (no f32 X), else uint8 bytes."""
    def per_device(params, xb):
        if use_pallas:
            from ..ops.fused import xv
            Xp_loc = xv(xb, params["V"], interpret=interpret)
        else:
            Xp_loc = qp.matmul(unpack_dosage_x(xb), params["V"])
        Xp = jax.lax.psum(Xp_loc, SNP_AXIS)
        return qp.encode_from_xp(params, Xp)

    pspecs = param_specs(params)
    batch_spec = P(DATA_AXIS, SNP_AXIS)
    fwd = jax.jit(shard_map(
        per_device, mesh=mesh,
        in_specs=(pspecs, batch_spec),
        out_specs={hk: P(DATA_AXIS) for hk in params["heads"]},
        check_vma=False,
    ))

    from ..ops.fused import ROWS
    from ..train.chunked import chunked_forward

    d_sz = mesh.shape[DATA_AXIS]
    # Per-device row blocks must hit the fused op's row step.
    q = d_sz * ROWS if use_pallas else d_sz
    B = max(q, (min(N, batch) // q) * q)
    # Host-resident data (the out-of-core path): land each chunk directly
    # in the batch sharding instead of single-device-then-reshard.
    import numpy as np
    put = (partial(jax.device_put,
                   device=jax.sharding.NamedSharding(mesh, batch_spec))
           if isinstance(data_dev, np.ndarray) else None)
    return chunked_forward(lambda blk: fwd(params, blk), data_dev, N, B,
                           put=put)
