"""The training engine.

JAX counterpart of the reference's NeuralAdmixture engine
(/root/reference/neural_admixture/model/neural_admixture.py:232-530):
fixed-epoch Adam training of the Q_P autoencoder with summed BCE (plus an
optionally weighted CE term in supervised mode), P clamped to [0, 1] after
every step, followed by a full-data sequential Q inference pass.

Design differences from the reference (semantics preserved):
  * the whole epoch runs as one jitted ``lax.scan`` over shuffled fixed-size
    batches plus one statically-shaped short remainder batch (no DataLoader,
    no per-step dispatch; padding within the remainder is masked with zero
    row-weights);
  * batches are gathered from the 2-bit-packed resident genotype matrix and
    unpacked on the fly inside the step (no uint8 N x M matrix on device);
  * on the GPU, the M-plane work (X @ V, decode, BCE, their gradients) runs
    in the fused Pallas/Triton op over the packed uint32 words (ops.fused);
    on the CPU the plain XLA step (models.qp + ops.loss) runs instead;
  * optimizer is optax.adam(b1=0.9, b2=0.95, eps=1e-8) -- same update rule as
    the reference's torch.optim.Adam(betas=(0.9, 0.95))
    (/root/reference/neural_admixture/model/neural_admixture.py:187-204);
  * the supervised_loss_weight flag is actually honored (the reference parses
    it but never forwards it, entry.py:40 vs model/train.py:131).
"""
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Tuple  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models import qp
from ..parallel.mesh import DATA_AXIS, SNP_AXIS, make_mesh, shard_params
from ..ops import pack as pk
from ..ops.fused import ROWS, TILE_SNPS
from ..ops.loss import clamped_bce_sum, softmax_cross_entropy_sum
from ..ops.pack import unpack_dosage_x
from ..utils.logger import log, setup_logging
from ..utils.metrics import fst_table

INFER_BATCH = 1024


@dataclass
class TrainConfig:
    epochs: int = 250
    batch_size: int = 800
    learning_rate: float = 20e-4
    seed: int = 42
    hidden_size: int = 1024
    n_components: int = 8
    supervised_loss_weight: float = 100.0
    ks: List[int] = field(default_factory=lambda: [3])
    log_every: int = 5
    progress: bool = True
    # Fused op (True) or plain XLA step (False); None = by platform
    # (fused_op_for). ``interpret`` runs the fused op's kernels in the
    # Pallas interpreter -- CPU tests only, never chosen implicitly.
    use_pallas: Optional[bool] = None
    interpret: bool = False
    # Sampling granularity: batches draw random RUNS of `sample_block`
    # consecutive resident rows instead of single rows. 1 = classic per-row
    # shuffling. >1 turns the batch gather's per-row random reads into
    # `sample_block`x larger contiguous reads; the resident rows are
    # pre-shuffled once at load so blocks are random population mixtures.
    # Epoch semantics stay every-sample-exactly-once. LL impact measured in
    # tools/convergence_bench.py (NA_CONV_BLOCK); 16 is the CLI default.
    sample_block: int = 1
    # Device mesh (n_data, n_snp): None = auto (all devices data-parallel
    # when more than one device is visible; single-device path otherwise).
    mesh_shape: Optional[Tuple[int, int]] = None
    # Host-streaming (out-of-core) training: the packed genotypes stay in
    # host memory and each batch is assembled on host and transferred per
    # step (make_stream_epoch_fn) -- for datasets whose packed bytes exceed
    # device HBM on the available mesh. None = auto (stream only when the
    # resident estimate exceeds capacity but the streaming one fits);
    # True/False force. Works on one device, a single-host mesh (batches
    # land straight in the P(data, snp) sharding), or a multi-host mesh
    # (each host streams only its own row block, host-partition-stratified
    # sampling; see _stratified_plan) -- out-of-core past all hosts'
    # combined device memory.
    stream: Optional[bool] = None
    # Observability / resilience (absent in the reference, SURVEY.md section 5):
    profile_dir: Optional[str] = None    # jax.profiler trace of the epochs
    checkpoint_every: int = 0            # save resumable state every N epochs
    checkpoint_path: Optional[str] = None
    resume: bool = False                 # resume from checkpoint_path if present


def fused_op_for(platform: str) -> bool:
    """Kernel choice by platform alone: the fused Triton op (ops.fused) on
    'gpu', the plain XLA step on 'cpu'; any other platform is an error."""
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise ValueError(
        f"no training path for JAX platform {platform!r}: the fused op runs "
        "on NVIDIA GPUs ('gpu') and the plain XLA step on 'cpu'")


def _use_pallas(cfg: TrainConfig) -> bool:
    if cfg.use_pallas is not None:
        return cfg.use_pallas
    return fused_op_for(jax.default_backend())


def smallest_head(qs) -> str:
    """Head key of the numerically smallest K. Lexicographic sort is wrong
    for multi-K runs including K >= 10 ('k10' < 'k3')."""
    return min(qs, key=lambda hk: int(hk[1:]))


def _supervised_term(qs, pops_batch, row_weight, supervised_loss_weight):
    # Single-head supervised mode: CE over the (softmaxed) Q of the
    # smallest-K head, treated as logits -- faithful to the reference
    # (model/neural_admixture.py:460-474).
    return supervised_loss_weight * softmax_cross_entropy_sum(
        qs[smallest_head(qs)], pops_batch, row_weight)


def _loss_fn(params, batch, row_weight, col_mask, pops_batch,
             supervised: bool, supervised_loss_weight: float,
             use_pallas: bool, fused_op=None):
    if use_pallas:
        enc = {k: params[k] for k in ("rmsnorm", "common", "heads")}
        loss, qs = fused_op(params["V"], enc, params["decoders"], batch,
                            row_weight)
    else:
        X = unpack_dosage_x(batch)
        recs, qs = qp.forward_train(params, X)
        loss = jnp.asarray(0.0, jnp.float32)
        for hk in recs:
            loss = loss + clamped_bce_sum(recs[hk], X, col_mask, row_weight)
    if supervised:
        loss = loss + _supervised_term(qs, pops_batch, row_weight,
                                       supervised_loss_weight)
    return loss


def batch_align(use_pallas: bool, mesh) -> int:
    """Row alignment required of each padded batch: the fused op's row step
    (ops.fused.ROWS) x the data-axis extent (even device split)."""
    d_sz = mesh.shape[DATA_AXIS] if mesh is not None else 1
    return (ROWS if use_pallas else 1) * d_sz


def shard_quantum(use_pallas: bool, d_sz: int, blk: int) -> int:
    """block_geometry's row-alignment quantum, computable without a mesh
    object: batch_align == (ROWS if pallas else 1) * d_sz in every case."""
    return int(np.lcm((ROWS if use_pallas else 1) * d_sz, d_sz * blk))


def shard_row_order(N: int, seed: int, n_proc: int, rows_pp: int
                    ) -> np.ndarray:
    """Global resident-row -> input-row map under PER-PROCESS pre-shuffle.

    Block sampling pre-shuffles resident rows so each `sample_block`-row
    block is a random population mixture. Multi-process, rows cannot move
    between hosts (each host read only its own input-row block from disk),
    so each process shuffles its LOCAL block independently; seeding each
    local permutation by (seed, process) lets every process reconstruct
    the full map -- needed to restore input order in Q/pops -- without
    communication. Real resident rows stay globally contiguous at [0, N)
    because only the tail process's block is partial (host_sample_shard).
    """
    parts = []
    for p in range(n_proc):
        s = min(p * rows_pp, N)
        e = min(s + rows_pp, N)
        if e > s:
            parts.append(s + np.random.default_rng([seed, p])
                         .permutation(e - s))
    return np.concatenate(parts)


def block_geometry(N: int, batch_size: int, use_pallas: bool, mesh,
                   blk: int) -> Tuple[int, int, int, int]:
    """(b_round, nb, b_rem, resident_rows) for block sampling (blk > 1).

    An epoch runs nb = ceil(N / b_round) optimizer steps -- nb-1 full
    b_round-row batches plus one REMAINDER batch of b_rem <= b_round rows,
    mirroring the reference DataLoader's short final batch
    (/root/reference/neural_admixture/src/loaders.py:33, drop_last
    defaulting False). Padding therefore costs at most one alignment
    quantum of rows instead of a full batch (at N=4096, B=800 the old
    nb*b_round padding computed 4800 rows/epoch for 4096 real ones).
    The step count is unchanged (extra all-padding steps are not harmless:
    Adam moments decay on zero-grad steps). b_round and b_rem are
    multiples of d_sz * blk, so blocks never straddle devices; resident
    rows are padded to exactly (nb-1) * b_round + b_rem."""
    d_sz = mesh.shape[DATA_AXIS] if mesh is not None else 1
    q = int(np.lcm(batch_align(use_pallas, mesh), d_sz * blk))
    b_round = ((min(batch_size, N) + q - 1) // q) * q
    nb = (N + b_round - 1) // b_round
    rem = N - (nb - 1) * b_round
    b_rem = ((rem + q - 1) // q) * q
    return b_round, nb, b_rem, (nb - 1) * b_round + b_rem


def _batch_plan(N: int, batch_size: int, use_pallas: bool, mesh, blk: int,
                n_rows: Optional[int]) -> Tuple[int, int, int]:
    """(b_round, nb, b_rem) — the epoch's batch geometry, shared by the
    resident (make_epoch_fn) and host-streaming (make_stream_epoch_fn)
    builders so both sample identically."""
    if blk > 1:
        # Block sampling: batches are whole blocks of `blk` consecutive
        # resident rows; the epoch is a permutation of the FULL data blocks,
        # split into nb-1 full batches and one remainder batch. The partial
        # data block (N % blk rows + padding) and the all-padding blocks
        # ride only in the remainder.
        b_round, nb, b_rem, want_rows = block_geometry(
            N, batch_size, use_pallas, mesh, blk)
        assert n_rows == want_rows, (n_rows, want_rows)
        return b_round, nb, b_rem
    align = batch_align(use_pallas, mesh)
    nb = (N + batch_size - 1) // batch_size
    rem = N - (nb - 1) * batch_size
    b_round = ((batch_size + align - 1) // align) * align
    b_rem = ((rem + align - 1) // align) * align
    return b_round, nb, b_rem


def _stratified_plan(key, ep: int, blk: int, N: int, n_rows: int,
                     b_round: int, nb: int, b_rem: int):
    """Host-partition-stratified sampling plan (multi-host out-of-core).

    When the packed genotypes live only in each host's RAM (--stream on a
    multi-host mesh), a batch row cannot come from another host without a
    per-step network exchange; instead each of the ``ep`` host partitions
    samples its OWN local rows to fill its OWN shard of every batch -- the
    semantics of the reference's DistributedSampler, which also confines
    each rank to a fixed partition
    (/root/reference/neural_admixture/src/loaders.py:30-35). Partitions
    are contiguous INPUT row blocks (a data-locality necessity: each host
    read only its block from disk), locally pre-shuffled when blk > 1
    (shard_row_order) -- so on a population-sorted file a partition can be
    a population stratum. Mixing comes from the batch composition instead:
    every batch draws from ALL partitions (F_p units from each), so each
    optimizer step still sees a cross-population sample.

    Returns GLOBAL resident indices ``(idx_full (nb-1, F), idx_rem (R,))``
    with batch columns [p*F_p, (p+1)*F_p) holding partition p's picks --
    exactly the rows of the P(data, snp) batch shard that partition p's
    devices own, so a streamed host can slice its columns out locally.
    Unit = ``blk`` consecutive rows when blk > 1 (indices are block ids
    over the padded resident array; each partition permutes ALL its local
    blocks, so padding blocks can land in any batch), else single rows
    (real local rows padded with the sentinel N). Threefry draws are identical on every host:
    fold_in(key, p)."""
    assert n_rows % ep == 0, (n_rows, ep)
    rows_pp = n_rows // ep
    unit = blk * ep if blk > 1 else ep
    # Holds whenever ep divides the mesh's data axis (host_sample_shard
    # asserts it): b_round/b_rem are multiples of batch_align ⊇ d_sz ⊇ ep.
    assert b_round % unit == 0 and b_rem % unit == 0, (b_round, b_rem, unit)
    if blk > 1:
        upp = rows_pp // blk
        F_p, R_p = b_round // (blk * ep), b_rem // (blk * ep)
        assert (nb - 1) * F_p + R_p == upp, (nb, F_p, R_p, upp)
        perms = jnp.stack([
            jax.random.permutation(jax.random.fold_in(key, p), upp) + p * upp
            for p in range(ep)])
    else:
        F_p, R_p = b_round // ep, b_rem // ep
        supply = (nb - 1) * F_p + R_p
        parts = []
        for p in range(ep):
            n_local = min(rows_pp, max(0, N - p * rows_pp))
            # supply * ep = (nb-1)*b_round + b_rem >= ceil(N/align)*align
            # >= rows_pp * ep (align is a multiple of d_sz and ep | d_sz).
            assert supply >= n_local, (supply, n_local, ep, N)
            perm = (jax.random.permutation(jax.random.fold_in(key, p),
                                           max(n_local, 1))[:n_local]
                    + p * rows_pp)
            if supply > n_local:
                perm = jnp.concatenate(
                    [perm, jnp.full((supply - n_local,), N, perm.dtype)])
            parts.append(perm)
        perms = jnp.stack(parts)
    idx_full = (perms[:, :(nb - 1) * F_p]
                .reshape(ep, nb - 1, F_p).transpose(1, 0, 2)
                .reshape(nb - 1, ep * F_p))
    idx_rem = perms[:, (nb - 1) * F_p:].reshape(ep * R_p)
    return idx_full, idx_rem


def _make_loss_and_grad(supervised: bool, supervised_loss_weight: float,
                        use_pallas: bool, mesh, params_template,
                        compute_loss: bool, interpret: bool):
    """Loss-and-grad callable shared by the resident and streaming epoch
    builders: (params, xb, row_weight, col_mask, pops_b) -> (loss, grads).
    On the fused path ``compute_loss=False`` skips the BCE value (the
    returned loss is then not the BCE; callers discard it)."""
    if mesh is None:
        fused_op = None
        if use_pallas:
            from ..ops.fused import make_fused_training_loss
            fused_op = make_fused_training_loss(
                sorted(params_template["heads"]), with_loss=compute_loss,
                interpret=interpret)
        loss_fn = partial(_loss_fn, supervised=supervised,
                          supervised_loss_weight=supervised_loss_weight,
                          use_pallas=use_pallas, fused_op=fused_op)

        def loss_and_grad(params, xb, row_weight, col_mask, pops_b):
            return jax.value_and_grad(loss_fn)(
                params, xb, row_weight, col_mask, pops_b)

        return loss_and_grad
    from ..parallel.sharded_step import make_sharded_loss_and_grad
    return make_sharded_loss_and_grad(
        mesh, params_template, supervised, supervised_loss_weight,
        use_pallas, compute_loss=compute_loss, interpret=interpret)


def make_epoch_fn(tx, N: int, batch_size: int, supervised: bool,
                  supervised_loss_weight: float, use_pallas: bool = False,
                  mesh=None, params_template=None, compute_loss: bool = True,
                  sample_block: int = 1, n_rows: Optional[int] = None,
                  epochs_per_call: int = 1, period_len: int = 0,
                  stratified: int = 0, interpret: bool = False,
                  _raw: bool = False):
    """Build the jitted one-epoch function (scan over shuffled batches).

    ``stratified > 0``: host-partition-stratified sampling over that many
    partitions (see _stratified_plan) -- the policy of multi-host streamed
    runs, selectable here (resident path) so a resident run can reproduce a
    streamed multi-host run exactly (NA_TPU_STRATIFIED=1).

    ``epochs_per_call > 1`` returns a function taking a STACK of per-epoch
    keys (E, 2) and running E epochs inside one jit -- one host dispatch
    instead of E. With ``compute_loss=True`` the group is one or more LOG
    PERIODS of ``period_len`` epochs each (E must be a whole multiple;
    ``period_len=0`` means one period of E): each period's first epoch
    runs the logged program, the rest the loss-free program, and the
    returned loss is the (n_periods,) stack of logged losses.
    With ``compute_loss=False`` all E epochs are loss-free. Same per-epoch
    math and key stream as E single calls -- bit-exact on the XLA path. On
    the fused path the surrounding encoder/Adam ops may fuse differently
    under the outer scan: last-ulp per step, amplified through Adam over
    the group (grouped/ungrouped are NOT bitwise-interchangeable; pinned
    at rtol 5e-3 by tests/test_epoch_group.py).

    ``_raw`` (internal) returns the single-epoch body unjitted so the
    grouped builder can compose the logged and fast variants in one jit.

    With ``mesh`` set, the loss/grad of each step runs under shard_map on the
    (data, snp) mesh (parallel.sharded_step); batches are gathered globally
    and constrained to P(data, snp). Requires ``params_template`` for specs.

    Batch rows are padded up to the row alignment (batch_align) with
    sentinel indices carrying zero row-weight.

    ``compute_loss=False`` replaces the returned per-step loss with a
    constant 0: on the XLA path the value_and_grad primal is then dead and
    XLA eliminates the loss forward (the BCE *value* needs two logs per
    genotype while its gradient needs none); the fused op skips it
    explicitly. The trainer uses this for epochs whose loss is not logged.
    """
    blk = max(1, sample_block)
    b_round, nb, b_rem = _batch_plan(N, batch_size, use_pallas, mesh, blk,
                                     n_rows)
    loss_and_grad = _make_loss_and_grad(
        supervised, supervised_loss_weight, use_pallas, mesh,
        params_template, compute_loss, interpret)
    if mesh is None:
        batch_sharding = None
    else:
        batch_sharding = NamedSharding(mesh, P(DATA_AXIS, SNP_AXIS))
        row_sharding = NamedSharding(mesh, P(DATA_AXIS))

    def run_epoch(params, opt_state, packed, col_mask, pops, key):
        if stratified:
            idx_full, idx_rem = _stratified_plan(
                key, stratified, blk, N, n_rows if blk > 1 else
                (n_rows or N), b_round, nb, b_rem)
        elif blk > 1:
            # Permute the FULL data blocks; full batches take the first
            # (nb-1) * F of them, the remainder batch takes the rest plus
            # the partial data block (if N % blk) and the all-padding blocks
            # at the top of the resident array. (nb-1)*F <= N // blk always:
            # (nb-1)*b_round = N - rem with rem >= 1 and b_round a multiple
            # of blk, so (N - rem)/blk <= floor(N/blk).
            F = b_round // blk
            nblk_res = n_rows // blk
            nblk_full = N // blk
            perm = jax.random.permutation(key, nblk_full)
            idx_full = perm[:(nb - 1) * F].reshape(nb - 1, F)
            idx_rem = jnp.concatenate(
                [perm[(nb - 1) * F:],
                 jnp.arange(nblk_full, nblk_res, dtype=perm.dtype)])
        else:
            # Per-row sampling: sentinel index N marks padding rows (zero
            # row-weight; gathers clamp to N-1).
            perm = jax.random.permutation(key, N)
            idx_full = perm[:(nb - 1) * batch_size].reshape(
                nb - 1, batch_size)
            if b_round != batch_size:
                idx_full = jnp.concatenate(
                    [idx_full,
                     jnp.full((nb - 1, b_round - batch_size), N,
                              idx_full.dtype)], axis=1)
            tail = perm[(nb - 1) * batch_size:]
            idx_rem = jnp.concatenate(
                [tail, jnp.full((b_rem - tail.shape[0],), N, perm.dtype)])

        def step(carry, idx_b):
            params, opt_state = carry
            if blk > 1:
                # Gather at block granularity: one dynamic-slice per block
                # of blk contiguous rows, concatenated.
                row_idx = (idx_b[:, None] * blk
                           + jnp.arange(blk, dtype=idx_b.dtype)).reshape(-1)
                row_weight = (row_idx < N).astype(jnp.float32)
                safe = jnp.minimum(row_idx, N - 1)
                xb = jnp.concatenate(
                    [jax.lax.dynamic_slice_in_dim(packed, idx_b[b] * blk,
                                                  blk, axis=0)
                     for b in range(idx_b.shape[0])], axis=0)
            else:
                row_weight = (idx_b < N).astype(jnp.float32)
                safe = jnp.minimum(idx_b, N - 1)
                xb = jnp.take(packed, safe, axis=0)
            pops_b = jnp.take(pops, safe, axis=0)
            if batch_sharding is not None:
                xb = jax.lax.with_sharding_constraint(xb, batch_sharding)
                row_weight = jax.lax.with_sharding_constraint(
                    row_weight, row_sharding)
                pops_b = jax.lax.with_sharding_constraint(
                    pops_b, row_sharding)
            loss, grads = loss_and_grad(
                params, xb, row_weight, col_mask, pops_b)
            if not compute_loss:
                loss = jnp.float32(0)  # primal DCE'd; see docstring
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            params = qp.restrict_P(params)
            return (params, opt_state), loss

        carry = (params, opt_state)
        loss_total = jnp.float32(0)
        if nb > 1:
            carry, losses = jax.lax.scan(step, carry, idx_full)
            loss_total = loss_total + jnp.sum(losses)
        # The remainder batch has its own (smaller) static width -- the step
        # traces a second time at b_rem rows, like the reference's short
        # final DataLoader batch -- and carries the padding.
        (params, opt_state), loss_rem = step(carry, idx_rem)
        return params, opt_state, loss_total + loss_rem

    if _raw:
        return run_epoch
    if epochs_per_call <= 1:
        return jax.jit(run_epoch, donate_argnums=(0, 1))

    run_fast = run_epoch
    if compute_loss:
        # A log-period group: each period's epoch 0 runs the LOGGED
        # program, epochs 1..n_per-1 the loss-free one -- the exact
        # programs the ungrouped loop selects.
        run_fast = make_epoch_fn(
            tx, N, batch_size, supervised, supervised_loss_weight,
            use_pallas=use_pallas, mesh=mesh, params_template=params_template,
            compute_loss=False, sample_block=sample_block, n_rows=n_rows,
            stratified=stratified, interpret=interpret, _raw=True)
    n_per = period_len if (compute_loss and period_len) else epochs_per_call
    assert epochs_per_call % n_per == 0, (epochs_per_call, n_per)
    n_periods = epochs_per_call // n_per

    @partial(jax.jit, donate_argnums=(0, 1))
    def epochs_fn(params, opt_state, packed, col_mask, pops, keys):
        def fast_scan(carry, ks):
            def body(c, k_epoch):
                p, o = c
                p, o, _ = run_fast(p, o, packed, col_mask, pops, k_epoch)
                return (p, o), None
            return jax.lax.scan(body, carry, ks)

        if not compute_loss:
            (params, opt_state), _ = fast_scan((params, opt_state), keys)
            return params, opt_state, jnp.float32(0)

        def period(carry, keys_p):
            p, o = carry
            p, o, loss = run_epoch(p, o, packed, col_mask, pops, keys_p[0])
            (p, o), _ = fast_scan((p, o), keys_p[1:])
            return (p, o), loss

        keys_pp = keys.reshape((n_periods, n_per) + keys.shape[1:])
        (params, opt_state), losses = jax.lax.scan(
            period, (params, opt_state), keys_pp)
        return params, opt_state, losses  # (n_periods,)

    return epochs_fn


def make_stream_epoch_fn(tx, N: int, batch_size: int, supervised: bool,
                         supervised_loss_weight: float,
                         use_pallas: bool = False, mesh=None,
                         params_template=None,
                         compute_loss: bool = True, sample_block: int = 1,
                         n_rows: Optional[int] = None, stratified: int = 0,
                         interpret: bool = False):
    """Host-streaming (out-of-core) counterpart of ``make_epoch_fn``.

    The packed genotype matrix stays in HOST memory; each step's batch is
    assembled on host and ``device_put`` -- the path for datasets whose
    2-bit packed bytes exceed the memory of the device (e.g. 500K x 1M =
    125 GB packed vs one 80 GB card). The reference cannot run these at
    all: it materializes the full uint8 matrix in host shared memory AND a
    packed copy in device memory
    (/root/reference/neural_admixture/entry.py:186,
    /root/reference/neural_admixture/model/train.py:120-126).

    Same batch geometry (_batch_plan), key stream, sampling policy, and
    per-step math as make_epoch_fn; only the batch SOURCE differs (host
    gather + transfer instead of an on-device gather inside the scan), so
    a streamed run is interchangeable with a resident run: BIT-exact on the
    XLA path; last-ulp on the fused path (ops around the kernels fuse
    differently in the standalone step jit than in the scan body -- pinned
    by tests/test_stream.py). Throughput is
    host-gather + host->device-transfer bound by design; JAX's async
    dispatch overlaps the next batch's host assembly with device compute.

    Returns ``run_epoch(params, opt_state, packed_host, col_mask,
    pops_host, key)`` with the same signature as make_epoch_fn's, where
    ``packed_host`` is the (pre-shuffled, padded) resident array as host
    numpy and ``pops_host`` the shuffled
    labels as host numpy.

    With ``mesh`` (single-process, multi-device), each batch is
    device_put straight into the P(data, snp) batch sharding and the step
    runs the same shard_map loss/grad as the resident path -- out-of-core
    over a whole host's mesh, for packed matrices that exceed even the
    mesh's combined device memory.

    With ``stratified = ep > 0`` (multi-HOST out-of-core), sampling follows
    the host-partition-stratified plan (_stratified_plan). In a
    multi-process run, ``packed_host`` / ``pops_host`` are this process's
    LOCAL row block (rows [p*rows_pp, (p+1)*rows_pp) of the resident
    layout) and the global (N,) labels respectively; each host gathers only
    its own shard of every batch and the shards join into the global
    P(data, snp) batch via jax.make_array_from_process_local_data -- so a
    dataset whose packed bytes exceed all cards' combined memory trains,
    each host holding only rows_pp packed rows in RAM. Single-process with
    ``stratified`` set reproduces the same runs for tests
    (NA_TPU_STRATIFIED=1 + NA_TPU_EMULATE_PROC_SHARDS).
    """
    import os
    blk = max(1, sample_block)
    b_round, nb, b_rem = _batch_plan(N, batch_size, use_pallas, mesh, blk,
                                     n_rows)
    lag = _make_loss_and_grad(
        supervised, supervised_loss_weight, use_pallas, mesh,
        params_template, compute_loss, interpret)
    n_proc = jax.process_count()
    # Multi-process streaming: this host assembles only its own shard of
    # every batch (1/n_proc of the batch rows; see _stratified_plan).
    local_shard = stratified if (stratified and n_proc > 1) else 0
    if mesh is None:
        put_batch = put_rows = jnp.asarray
    else:
        batch_sharding = NamedSharding(mesh, P(DATA_AXIS, SNP_AXIS))
        row_sharding = NamedSharding(mesh, P(DATA_AXIS))
        if local_shard:
            def put_batch(local):
                g = list(local.shape)
                g[0] *= n_proc
                return jax.make_array_from_process_local_data(
                    batch_sharding, np.ascontiguousarray(local), tuple(g))

            def put_rows(local):
                local = np.ascontiguousarray(local)
                return jax.make_array_from_process_local_data(
                    row_sharding, local, (local.shape[0] * n_proc,))
        else:
            put_batch = partial(jax.device_put, device=batch_sharding)
            put_rows = partial(jax.device_put, device=row_sharding)

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, xb, row_weight, col_mask, pops_b):
        loss, grads = lag(params, xb, row_weight, col_mask, pops_b)
        if not compute_loss:
            loss = jnp.float32(0)  # primal DCE'd; see make_epoch_fn
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        params = qp.restrict_P(params)
        return params, opt_state, loss

    def run_epoch(params, opt_state, packed_host, col_mask, pops_host, key):
        # Index derivation identical to make_epoch_fn.run_epoch (threefry
        # values are backend-independent, so the streamed epoch samples the
        # exact batches the resident epoch would).
        base_row = 0
        if stratified:
            gi_full, gi_rem = _stratified_plan(
                key, stratified, blk, N, n_rows or N, b_round, nb, b_rem)
            idx_full, idx_rem = np.asarray(gi_full), np.asarray(gi_rem)
            if local_shard:
                # This host's columns of every batch (its picks are drawn
                # from its own rows by construction) and the row offset
                # mapping global resident indices to its local block.
                p = jax.process_index()
                unit = blk * n_proc if blk > 1 else n_proc
                F_p, R_p = b_round // unit, b_rem // unit
                idx_full = idx_full[:, p * F_p:(p + 1) * F_p]
                idx_rem = idx_rem[p * R_p:(p + 1) * R_p]
                base_row = p * ((n_rows or N) // stratified)
        elif blk > 1:
            F = b_round // blk
            nblk_res = n_rows // blk
            nblk_full = N // blk
            perm = np.asarray(jax.random.permutation(key, nblk_full))
            idx_full = perm[:(nb - 1) * F].reshape(nb - 1, F)
            idx_rem = np.concatenate(
                [perm[(nb - 1) * F:],
                 np.arange(nblk_full, nblk_res, dtype=perm.dtype)])
        else:
            perm = np.asarray(jax.random.permutation(key, N))
            idx_full = perm[:(nb - 1) * batch_size].reshape(
                nb - 1, batch_size)
            if b_round != batch_size:
                idx_full = np.concatenate(
                    [idx_full,
                     np.full((nb - 1, b_round - batch_size), N,
                             idx_full.dtype)], axis=1)
            tail = perm[(nb - 1) * batch_size:]
            idx_rem = np.concatenate(
                [tail, np.full((b_rem - tail.shape[0],), N, perm.dtype)])

        def gather(idx_b):
            """Host mirror of the resident step's batch gather. Indices are
            GLOBAL resident rows/blocks; ``base_row`` maps them into this
            host's local block when it holds only its own shard."""
            if blk > 1:
                row_idx = (idx_b[:, None] * blk
                           + np.arange(blk, dtype=idx_b.dtype)).reshape(-1)
                row_weight = (row_idx < N).astype(np.float32)
                xb = np.empty((row_idx.shape[0],) + packed_host.shape[1:],
                              packed_host.dtype)
                for j, b in enumerate(idx_b):
                    lo = int(b) * blk - base_row
                    xb[j * blk:(j + 1) * blk] = packed_host[lo:lo + blk]
                safe = np.minimum(row_idx, N - 1)
            else:
                row_weight = (idx_b < N).astype(np.float32)
                safe = np.minimum(idx_b, N - 1)
                lrow = (np.clip(idx_b - base_row, 0, packed_host.shape[0] - 1)
                        if local_shard else safe)
                xb = np.take(packed_host, lrow, axis=0)
            return xb, row_weight, pops_host[safe].astype(np.int32)

        # Double-buffered host pipeline: batch t+1's host gather -- and,
        # at level 2, its device_put staging copy -- runs on a worker
        # thread while step t's device work proceeds (numpy slice copies
        # and transfer staging release the GIL). Batch content and order
        # are identical, so streamed == resident exactness is untouched
        # (tests/test_stream.py pins all three levels).
        # NA_TPU_STREAM_PREFETCH: 0 = serial, 1 = prefetch the gather
        # (default), 2 = gather + device_put on the worker. Not yet
        # measured on the GPU host (ROADMAP B6 decides the default).
        prefetch = int(os.environ.get("NA_TPU_STREAM_PREFETCH", "1") or 0)
        all_idx = [idx_full[i] for i in range(nb - 1)] + [idx_rem]

        def produce(idx_b):
            xb, rw, pb = gather(idx_b)
            if prefetch >= 2:
                return put_batch(xb), put_rows(rw), put_rows(pb)
            return xb, rw, pb

        losses = []
        loss_rem = None

        def consume(i, batch):
            nonlocal params, opt_state, loss_rem
            xb, rw, pb = batch
            if prefetch < 2:
                xb, rw, pb = put_batch(xb), put_rows(rw), put_rows(pb)
            # The remainder batch's own static width traces the step a
            # second time, like the reference's short final DataLoader batch.
            params, opt_state, loss = step(params, opt_state, xb, rw,
                                           col_mask, pb)
            if i < nb - 1:
                losses.append(loss)
            else:
                loss_rem = loss

        if prefetch:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=1) as ex:
                fut = ex.submit(produce, all_idx[0])
                for i in range(nb):
                    batch = fut.result()
                    if i + 1 < nb:
                        fut = ex.submit(produce, all_idx[i + 1])
                    consume(i, batch)
        else:
            for i in range(nb):
                consume(i, produce(all_idx[i]))
        # Same reduction as the resident path: jnp.sum over the stacked
        # full-batch losses, then + the remainder's.
        loss_total = (jnp.sum(jnp.stack(losses)) if losses
                      else jnp.float32(0)) + loss_rem
        return params, opt_state, loss_total

    return run_epoch


@jax.jit
def _infer_batch(params, packed_batch):
    X = unpack_dosage_x(packed_batch)
    return qp.forward_infer(params, X)


def log_device(use_pallas: bool) -> None:
    """One log line naming the platform, the device and the training path."""
    dev = jax.devices()[0]
    log.info(f"    Device: {dev.platform} ({dev.device_kind}) x "
             f"{jax.device_count()}; step: "
             + ("fused Triton op" if use_pallas else "XLA"))


class NeuralAdmixtureTrainer:
    """Orchestrates init -> epochs -> Q inference -> results."""

    def __init__(self, cfg: TrainConfig, master: bool = True):
        setup_logging()
        self.cfg = cfg
        self.master = master
        self.ks = sorted(cfg.ks)

    def launch_training(self, P_init: np.ndarray, packed, V: np.ndarray,
                        M: int, N: int, pops: Optional[np.ndarray] = None,
                        host_rows: Optional[Tuple[int, int]] = None
                        ) -> Tuple[List[np.ndarray], List[np.ndarray], Dict]:
        """Train and return (Qs, Ps, params).

        Args:
          P_init: (sum(ks), M) initial P rows (ascending K groups).
          packed: (N, W) uint8 2-bit packed genotypes (host numpy). In a
            multi-process run, only this process's sample rows
            [host_rows[0], host_rows[1]) -- see parallel.distributed.
          V: (D, M) RSVD projection (transposed to (M, D) trainable param).
          pops: optional GLOBAL (N,) int labels enabling supervised mode.
          host_rows: this process's sample-row block in a multi-process run
            (from host_sample_shard(N, data_axis_size)); None single-process.
        """
        import os
        cfg = self.cfg
        use_pallas = _use_pallas(cfg)
        if self.master:
            log_device(use_pallas)
        packed_np = np.asarray(packed)
        m_pad = packed_np.shape[1] * 4

        mesh = self._pick_mesh(m_pad, use_pallas)
        self._mesh_shape = (tuple(int(s) for s in mesh.devices.shape)
                            if mesh is not None else (1, 1))
        if self.master:
            log.info(f"    Mesh: {self._mesh_shape[0]}x{self._mesh_shape[1]} "
                     "(data x snp)")
        n_proc = jax.process_count()
        blk = max(1, cfg.sample_block)
        emul = os.environ.get("NA_TPU_EMULATE_PROC_SHARDS")

        # Phase 1: resident layout (u32 words for the fused op, block
        # pre-shuffle).
        data_host, col_mask_np = self._resident_layout(
            packed_np, m_pad, M, N, use_pallas, mesh, n_proc, blk, emul)
        # Phase 2: pad rows / per-process blocks to the resident extent.
        data_host, resident_rows = self._assemble_row_blocks(
            data_host, N, mesh, n_proc, blk, use_pallas, host_rows)
        # Phase 3: HBM capacity policy (resident vs host-streamed) and the
        # host-partition-stratified sampling decision.
        stream, stratified = self._capacity_policy(
            data_host, m_pad, mesh, n_proc, blk, use_pallas, emul,
            resident_rows)
        # Phase 4: device placement (or host residency when streaming).
        data_dev, col_mask = self._place_data(
            data_host, col_mask_np, mesh, n_proc, resident_rows, stream)

        # Phase 5: model/optimizer state, labels, and the epoch programs.
        key = jax.random.PRNGKey(cfg.seed)
        key, k_init = jax.random.split(key)
        params, opt_state, tx = self._init_state(k_init, V, P_init, m_pad,
                                                 mesh)
        supervised = pops is not None
        self._supervised = supervised  # resume-compat guard (_ckpt_meta)
        pops_arr = self._prepare_pops(pops, N, stream, mesh, n_proc,
                                      supervised)
        fns = self._epoch_fns(tx, N, mesh, params, blk, resident_rows,
                              stream, stratified, supervised, use_pallas)

        # Phase 6: the epoch loop (resume, SIGTERM checkpointing, grouped
        # log-period dispatch, profiler trace, throughput log).
        params, opt_state, key = self._run_epochs(
            fns, params, opt_state, key, data_dev, col_mask, pops_arr, N,
            n_proc)

        # Finalize: full-data Q pass, then restore the input sample order.
        Qs = self._infer_q(params, data_dev, N, use_pallas, mesh=mesh)
        if self._row_order is not None:
            # Resident rows were pre-shuffled for block sampling; restore
            # the input sample order in every host-visible Q.
            Qs = [self._unshuffle_rows(q) for q in Qs]

        if self.master:
            log.info("")
            log.info("    Training finished!")
            log.info("")

        # Bring the trained parameters to host numpy (an all-gather joined
        # by every process when leaves are sharded across hosts).
        from ..parallel.distributed import to_host
        params = jax.tree.map(to_host, params)
        self.display_divergences(params, M)
        Ps = [np.asarray(params["decoders"][f"k{k}"]).T[:M].astype(np.float32)
              for k in self.ks]
        return Qs, Ps, params

    def _resident_layout(self, packed_np, m_pad: int, M: int, N: int,
                         use_pallas: bool, mesh, n_proc: int, blk: int,
                         emul) -> Tuple[np.ndarray, np.ndarray]:
        """Phase 1: the resident genotype layout -- uint32 words for the
        fused op -- and the one-time block-sampling row pre-shuffle
        (self._row_order); returns (data_host, col_mask_np)."""
        cfg = self.cfg
        col_mask_np = (np.arange(m_pad) < M).astype(np.float32)
        if use_pallas:
            assert m_pad % TILE_SNPS == 0, \
                f"m_pad={m_pad} must be a multiple of {TILE_SNPS} for " \
                "the fused op (pack with pack_with_padding defaults)"
            data_host = pk.packed_view_u32(packed_np)
        else:
            data_host = packed_np

        self._row_order = None
        if blk > 1 and (n_proc > 1 or emul):
            # Multi-process block sampling: per-process pre-shuffle of the
            # LOCAL row block (see shard_row_order); the seeded global
            # block permutation inside the epoch fn is identical on every
            # process, and block gathers are global dynamic slices on the
            # assembled resident array, so blocks from all hosts mix in
            # every batch. NA_TPU_EMULATE_PROC_SHARDS="P,D" (test-only)
            # makes a single-process run reproduce the exact resident
            # layout of a P-process run over a D-wide data axis, enabling
            # exact multi/single comparisons (the sampling POLICY differs
            # from the single-process global pre-shuffle, so plain runs
            # are not bitwise-comparable across process counts).
            if n_proc > 1:
                ep, d_sz = n_proc, mesh.shape[DATA_AXIS]
            else:
                ep, d_sz = (int(s) for s in emul.split(","))
            from ..parallel.distributed import rows_per_process
            # The SAME formula sample_shard/host_sample_shard used for the
            # input reads -- one source, so the host_rows assert below
            # genuinely pins this layout too.
            rows_pp = rows_per_process(N, d_sz, ep,
                                       shard_quantum(use_pallas, d_sz, blk))
            self._row_order = shard_row_order(N, cfg.seed, ep, rows_pp)
            if n_proc > 1:
                p = jax.process_index()
                s = min(p * rows_pp, N)
                e = min(s + rows_pp, N)
                assert data_host.shape[0] >= e - s, (data_host.shape, s, e)
                local_perm = self._row_order[s:e] - s
                data_host = np.ascontiguousarray(
                    data_host[:e - s][local_perm])
            else:
                data_host = np.ascontiguousarray(
                    data_host[self._row_order])
        elif blk > 1:
            # One-time host pre-shuffle: with block-granular sampling,
            # contiguous resident rows form the sampling unit; shuffling
            # once makes every block a random population mixture regardless
            # of the input file's sample ordering (BED files are often
            # family/population-sorted).
            self._row_order = np.random.default_rng(cfg.seed).permutation(N)
            data_host = np.ascontiguousarray(data_host[self._row_order])
        return data_host, col_mask_np

    def _assemble_row_blocks(self, data_host, N: int, mesh, n_proc: int,
                             blk: int, use_pallas: bool, host_rows
                             ) -> Tuple[np.ndarray, int]:
        """Phase 2: pad the local rows (and, multi-process, the per-process
        blocks) to the exact resident extent the epoch fn samples; returns
        (data_host, resident_rows) where resident_rows is the GLOBAL row
        count of the assembled resident array."""
        cfg = self.cfg
        if n_proc > 1:
            # Multi-process: ``data_host`` is this process's row block; pad
            # it to the even per-process extent and assemble the global
            # resident array from the per-process blocks below.
            from ..parallel.distributed import host_sample_shard
            assert mesh is not None, \
                "multi-process execution requires a device mesh"
            assert jax.local_device_count() % mesh.shape[SNP_AXIS] == 0, (
                "each process must own whole (data) rows of the mesh: "
                f"local devices {jax.local_device_count()} not divisible by "
                f"snp axis {mesh.shape[SNP_AXIS]}")
            start, end, rows_pp = host_sample_shard(
                N, mesh.shape[DATA_AXIS],
                quantum=(shard_quantum(use_pallas, mesh.shape[DATA_AXIS], blk)
                         if blk > 1 else 1))
            assert host_rows == (start, end), (
                f"launch_training got rows {host_rows} but this process owns "
                f"[{start}, {end}) -- read the data with "
                "NeuralAdmixtureTrainer.sample_shard")
            n_local = end - start
            assert data_host.shape[0] >= n_local, (data_host.shape, n_local)
            data_host = data_host[:n_local]
            if rows_pp != n_local:
                data_host = np.concatenate(
                    [data_host, np.zeros(
                        (rows_pp - n_local, data_host.shape[1]),
                        data_host.dtype)], axis=0)
            n_rows_global = rows_pp * n_proc
        elif blk > 1:
            # Rows must tile exactly into nb whole batches of whole blocks
            # (see block_geometry).
            _, _, _, target = block_geometry(N, cfg.batch_size, use_pallas,
                                          mesh, blk)
            if target != N:
                data_host = np.concatenate(
                    [data_host, np.zeros((target - N, data_host.shape[1]),
                                         data_host.dtype)], axis=0)
            n_rows_global = data_host.shape[0]
        elif mesh is not None:
            d_sz = mesh.shape[DATA_AXIS]
            if N % d_sz:
                data_host = np.concatenate(
                    [data_host, np.zeros((d_sz - N % d_sz, data_host.shape[1]),
                                         data_host.dtype)], axis=0)
            n_rows_global = data_host.shape[0]
        # The epoch fn samples the GLOBAL resident array (local rows are
        # only this process's shard of it).
        return data_host, (n_rows_global if n_proc > 1
                           else data_host.shape[0])

    def _capacity_policy(self, data_host, m_pad: int, mesh, n_proc: int,
                         blk: int, use_pallas: bool, emul,
                         resident_rows: int) -> Tuple[bool, int]:
        """Phase 3: the HBM capacity policy -- resident vs host-streamed
        training (sets self._streamed) -- and the host-partition-stratified
        sampling decision; returns (stream, stratified)."""
        import os
        cfg = self.cfg
        # Pre-flight device-memory estimate: resident packed genotypes +
        # SNP-plane training state per device. An allocator OOM here is
        # opaque; warn with the actionable fix (a bigger mesh) instead.
        # Capacity: utils.hbm.hbm_capacity_bytes.
        from ..utils.hbm import hbm_capacity_bytes
        cap_gb = hbm_capacity_bytes() / 2**30
        n_chips = 1 if mesh is None else mesh.size
        n_snp_ax = 1 if mesh is None else mesh.shape[SNP_AXIS]
        # Resident data and the gathered batch shard over the WHOLE mesh
        # (batch_sharding is P(data, snp)); the gathered batch stays 2-bit
        # packed, plus an f32 unpack transient on the XLA path (the fused
        # op unpacks in registers). The SNP-plane state replicates over the
        # data axis, sharding only over snp.
        batch_bytes = cfg.batch_size * m_pad // 4
        if not use_pallas:
            batch_bytes += cfg.batch_size * m_pad * 4
        per_chip = ((data_host.nbytes * max(1, n_proc) + batch_bytes)
                    / n_chips + self._plane_state_bytes(m_pad) / n_snp_ax)
        # Host-streaming decision: the per-chip footprint without the
        # resident genotypes (batches are transferred per step instead;
        # the streamed batch lands in the same P(data, snp) sharding, so
        # it too divides across the mesh).
        from ..utils.hbm import HBM_BUDGET_FRAC
        budget = HBM_BUDGET_FRAC * cap_gb * 2**30
        per_chip_stream = (batch_bytes / n_chips
                           + self._plane_state_bytes(m_pad) / n_snp_ax)
        resident_fits = per_chip <= budget
        stream = cfg.stream
        if stream is None:
            # Inputs to this decision are process-identical (rows_pp-padded
            # local blocks have equal nbytes), so every host picks the same
            # program.
            stream = (not resident_fits and per_chip_stream <= budget)
        self._streamed = bool(stream)
        # Host-partition-stratified sampling (_stratified_plan): REQUIRED by
        # multi-host streaming (each host can only assemble batch rows it
        # holds); opt-in for resident runs (NA_TPU_STRATIFIED=1) so a
        # resident run can reproduce a streamed multi-host run exactly.
        if n_proc > 1:
            strat_parts = n_proc
        elif emul and blk > 1:
            # Emulated layout only exists with block sampling (the blk > 1
            # branch above arranged per-process row blocks).
            strat_parts = int(emul.split(",")[0])
        else:
            strat_parts = 0
        stratified = 0
        if strat_parts > 1 and ((stream and n_proc > 1)
                                or os.environ.get("NA_TPU_STRATIFIED") == "1"):
            stratified = strat_parts
        if self.master and stream:
            log.info(
                f"    Host-streaming (out-of-core) training: packed "
                f"genotypes ({data_host.nbytes / 2**30:.1f} GiB"
                + (" per host" if n_proc > 1 else "")
                + ") stay in host memory; estimated per-chip HBM need "
                f"drops to ~{per_chip_stream / 2**30:.1f} GiB.")
        elif self.master and not resident_fits:
            log.warning(
                f"    Estimated per-chip HBM need ~{per_chip / 2**30:.1f} "
                f"GiB exceeds ~{cap_gb:.0f} GiB capacity; training will "
                f"likely OOM. Use --mesh DxS over more chips (packed data "
                f"and SNP-plane state shard across both axes), or --stream 1 "
                f"(single-device out-of-core).")
        if stratified:
            assert resident_rows % stratified == 0, (resident_rows,
                                                     stratified)
        return stream, stratified

    def _place_data(self, data_host, col_mask_np, mesh, n_proc: int,
                    resident_rows: int, stream: bool):
        """Phase 4: device placement of the resident genotypes and the
        column mask (the streaming path keeps the data on host); returns
        (data_dev, col_mask)."""
        if stream:
            data_dev = data_host  # stays host-side; batches stream per step
            if mesh is not None:
                from ..parallel.mesh import global_put
                col_mask = global_put(jnp.asarray(col_mask_np),
                                      NamedSharding(mesh, P(SNP_AXIS)))
            else:
                col_mask = jnp.asarray(col_mask_np)
        elif mesh is not None:
            from ..parallel.mesh import global_put
            batch_sharding = NamedSharding(mesh, P(DATA_AXIS, SNP_AXIS))
            if n_proc > 1:
                gshape = (resident_rows, data_host.shape[1])
                data_dev = jax.make_array_from_process_local_data(
                    batch_sharding, data_host, gshape)
            else:
                data_dev = jax.device_put(data_host, batch_sharding)
            col_mask = global_put(jnp.asarray(col_mask_np),
                                  NamedSharding(mesh, P(SNP_AXIS)))
        else:
            data_dev = jnp.asarray(data_host)
            col_mask = jnp.asarray(col_mask_np)
        return data_dev, col_mask

    def _init_state(self, k_init, V, P_init, m_pad: int, mesh):
        """Phase 5a: parameter pytree (mesh-sharded) and Adam state; returns
        (params, opt_state, tx)."""
        cfg = self.cfg
        params = qp.init_params(k_init, np.asarray(V).T, P_init,
                                cfg.hidden_size, self.ks, m_pad=m_pad)
        if mesh is not None:
            params = shard_params(params, mesh)
        tx = optax.adam(cfg.learning_rate, b1=0.9, b2=0.95, eps=1e-8)
        return params, tx.init(params), tx

    def _prepare_pops(self, pops, N: int, stream: bool, mesh, n_proc: int,
                      supervised: bool):
        """Phase 5b: population labels in resident row order (host-side
        when streaming, replicated device array otherwise)."""
        pops_np = np.asarray(pops if supervised else np.zeros(N))
        if self._row_order is not None:
            pops_np = pops_np[self._row_order]
        if stream:
            # The streaming epoch slices labels on host per batch (every
            # host holds the full (N,) labels -- they are tiny).
            pops_arr = pops_np.astype(np.int32)
        else:
            pops_arr = jnp.asarray(pops_np, dtype=jnp.int32)
            if n_proc > 1:
                from ..parallel.mesh import global_put
                pops_arr = global_put(np.asarray(pops_arr),
                                      NamedSharding(mesh, P()))
        return pops_arr

    def _epoch_fns(self, tx, N: int, mesh, params, blk: int,
                   resident_rows: int, stream: bool, stratified: int,
                   supervised: bool, use_pallas: bool) -> Dict:
        """Phase 5c: the jitted epoch programs -- per-epoch logged/fast
        variants plus the grouped log-period dispatch variants -- and the
        loop cadence knobs; returns {logged, fast, multi, multi_j,
        log_every, e_group, j_periods}."""
        import os
        cfg = self.cfg
        mk = partial(make_stream_epoch_fn if stream else make_epoch_fn,
                     tx, N, min(cfg.batch_size, N), supervised,
                     cfg.supervised_loss_weight, use_pallas=use_pallas,
                     mesh=mesh, params_template=params, sample_block=blk,
                     n_rows=resident_rows, stratified=stratified,
                     interpret=cfg.interpret)
        epoch_fn_logged = mk(compute_loss=True)
        epoch_fn_fast = mk(compute_loss=False)
        # LOG PERIODS (the logged epoch + the log_every-1 loss-free epochs
        # after it) run grouped inside ONE jit dispatch: grouping
        # amortizes the per-call host->device dispatch latency to one
        # dispatch per NA_TPU_EPOCH_GROUP_PERIODS
        # periods (default 1). Identical key stream and per-epoch programs
        # (each period's first epoch runs the logged program; the stacked
        # losses are logged after the call, so a >1 setting trades log
        # latency for fewer dispatches). NA_TPU_EPOCH_GROUP=0 disables.
        log_every = 2 if supervised else cfg.log_every
        e_group = log_every
        if (os.environ.get("NA_TPU_EPOCH_GROUP", "1") == "0" or e_group < 2
                or stream):
            # Streaming epochs dispatch per step by construction (the
            # per-call latency hides under the batch transfers); no
            # grouped-dispatch variants exist for them.
            e_group = 0
        j_periods = max(1, int(os.environ.get(
            "NA_TPU_EPOCH_GROUP_PERIODS", "1")))
        epoch_fn_multi = (mk(compute_loss=True, epochs_per_call=e_group,
                             period_len=log_every)
                          if e_group else None)
        epoch_fn_multi_j = (mk(compute_loss=True,
                               epochs_per_call=e_group * j_periods,
                               period_len=log_every)
                            if e_group and j_periods > 1 else None)
        return {"logged": epoch_fn_logged, "fast": epoch_fn_fast,
                "multi": epoch_fn_multi, "multi_j": epoch_fn_multi_j,
                "log_every": log_every, "e_group": e_group,
                "j_periods": j_periods}

    def _run_epochs(self, fns: Dict, params, opt_state, key, data_dev,
                    col_mask, pops_arr, N: int, n_proc: int):
        """Phase 6: the epoch loop -- resume, SIGTERM-safe checkpointing,
        grouped log-period dispatch, profiler trace, throughput log;
        returns (params, opt_state, key)."""
        cfg = self.cfg
        epoch_fn_logged, epoch_fn_fast = fns["logged"], fns["fast"]
        epoch_fn_multi, epoch_fn_multi_j = fns["multi"], fns["multi_j"]
        log_every, e_group = fns["log_every"], fns["e_group"]
        j_periods = fns["j_periods"]

        if self.master:
            log.info("")
            log.info("    Starting training...")
            log.info("")

        start_epoch = 0
        if cfg.resume and cfg.checkpoint_path:
            loaded = self._load_checkpoint(params, opt_state, key)
            if loaded is not None:
                start_epoch, params, opt_state, key = loaded
                if self.master:
                    log.info(f"    Resuming from epoch {start_epoch}.")

        # Preemption-safe checkpointing: when the user opted into
        # checkpointing, a SIGTERM (what cluster maintenance events and
        # preemptible schedulers deliver) saves a resumable checkpoint at
        # the next epoch-loop boundary and exits 143 -- restart with
        # --resume to continue bit-exactly. Single-process only: the save
        # is a collective (to_host all-gathers sharded leaves), and a
        # signal landing on hosts at different epochs would deadlock it;
        # multi-host preemption recovery is the driver's job (requeue +
        # --resume from the last periodic checkpoint).
        self._preempted = False
        prev_sigterm = None
        if cfg.checkpoint_every and cfg.checkpoint_path and n_proc == 1:
            import signal

            def _on_sigterm(signum, frame):
                self._preempted = True

            try:
                prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
            except ValueError:  # not the main thread; feature unavailable
                prev_sigterm = None

        trace_on = bool(cfg.profile_dir)
        if trace_on:
            jax.profiler.start_trace(cfg.profile_dir)
        t_train = time.time()

        def _ckpt_inside(epoch: int, n: int) -> bool:
            """A checkpoint boundary strictly inside [epoch, epoch+n) --
            the group must not skip it (the boundary at the group's LAST
            epoch is fine: the save happens right after the call)."""
            if not (cfg.checkpoint_every and cfg.checkpoint_path):
                return False
            return any((epoch + i + 1) % cfg.checkpoint_every == 0
                       for i in range(n - 1))

        epoch = start_epoch
        try:
            while epoch < cfg.epochs:
                # All ranks must select the same program: the variants differ
                # in collectives under shard_map (the loss psum is DCE'd in the
                # fast ones), and the selection inputs (epoch, log_every,
                # checkpoint cadence) are rank-identical. Only logging is
                # master-gated.
                logged = epoch % log_every == 0
                run_n, group_fn = 1, None
                if logged and e_group:
                    def fits(n):
                        return (epoch + n <= cfg.epochs
                                and not _ckpt_inside(epoch, n))
                    if epoch_fn_multi_j is not None and fits(e_group * j_periods):
                        run_n, group_fn = e_group * j_periods, epoch_fn_multi_j
                    elif fits(e_group):
                        run_n, group_fn = e_group, epoch_fn_multi
                if run_n > 1:
                    ks = []
                    for _ in range(run_n):
                        key, k_epoch = jax.random.split(key)
                        ks.append(k_epoch)
                    params, opt_state, losses = group_fn(
                        params, opt_state, data_dev, col_mask, pops_arr,
                        jnp.stack(ks))
                    if self.master:
                        for i, ls in enumerate(np.asarray(losses)):
                            log.info(f"            Loss in epoch "
                                     f"{epoch + i * log_every:3d} is {ls:,.0f}")
                else:
                    key, k_epoch = jax.random.split(key)
                    epoch_fn = epoch_fn_logged if logged else epoch_fn_fast
                    params, opt_state, loss = epoch_fn(
                        params, opt_state, data_dev, col_mask, pops_arr, k_epoch)
                    if logged and self.master:
                        log.info(f"            Loss in epoch {epoch:3d} is "
                                 f"{float(loss):,.0f}")
                if (cfg.checkpoint_every and cfg.checkpoint_path
                        and (epoch + run_n) % cfg.checkpoint_every == 0):
                    self._save_checkpoint(epoch + run_n, params, opt_state, key)
                epoch += run_n
                if cfg.progress and self.master:
                    log.info(f"            Epochs done: {epoch}/{cfg.epochs}")
                if self._preempted and epoch < cfg.epochs:
                    self._save_checkpoint(epoch, params, opt_state, key)
                    log.info(f"    SIGTERM received: resumable checkpoint saved "
                             f"at epoch {epoch} "
                             f"({cfg.checkpoint_path}); exiting. Restart with "
                             "--resume to continue.")
                    raise SystemExit(143)
        except BaseException:
            # An exception (incl. the SIGTERM SystemExit above) must not
            # leave a dangling profiler trace (ADVICE r3).
            if trace_on:
                jax.profiler.stop_trace()
                trace_on = False
            raise
        finally:
            # Always hand the previous SIGTERM handler back, on success
            # and on every exception path alike (ADVICE r3).
            if prev_sigterm is not None:
                import signal
                signal.signal(signal.SIGTERM, prev_sigterm)
        jax.block_until_ready(params)
        self.train_seconds = time.time() - t_train
        if trace_on:
            jax.profiler.stop_trace()
        epochs_run = cfg.epochs - start_epoch
        if self.master and epochs_run and self.train_seconds > 0:
            sps = N * epochs_run / self.train_seconds
            log.info(f"    Training throughput: {sps:,.0f} samples/s "
                     f"({self.train_seconds:.2f}s for {epochs_run} epochs).")
        return params, opt_state, key

    def _ckpt_meta(self) -> Dict:
        """Hyperparameters that must match between save and resume: training
        silently diverges (or fails late on device) if any of them changes
        under a restored optimizer state."""
        cfg = self.cfg
        return {
            "mesh_shape": list(self._mesh_shape),
            "ks": list(self.ks),
            "batch_size": int(cfg.batch_size),
            "hidden_size": int(cfg.hidden_size),
            "n_components": int(cfg.n_components),
            "seed": int(cfg.seed),
            "sample_block": int(max(1, cfg.sample_block)),
            # Loss/optimizer trajectory shapers: a resume under a different
            # LR, CE weight, or supervision mode steps the restored Adam
            # moments through a different objective -- silent divergence.
            "learning_rate": float(cfg.learning_rate),
            "supervised": bool(getattr(self, "_supervised", False)),
            "supervised_loss_weight": float(cfg.supervised_loss_weight),
        }

    def _save_checkpoint(self, epoch: int, params, opt_state, key) -> None:
        """Serialize the full resumable training state (params including
        decoders, optimizer moments, RNG key) -- a capability the reference
        lacks (final-state-only save, SURVEY.md section 5)."""
        import json
        from ..parallel.distributed import to_host
        # to_host may all-gather sharded leaves -- a collective every
        # process must join; only the write itself is master-only.
        leaves = [to_host(x) for x in jax.tree.leaves((params, opt_state))]
        if not self.master:
            return
        arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
        tmp = f"{self.cfg.checkpoint_path}.tmp.npz"
        np.savez(tmp, epoch=np.int64(epoch), key=np.asarray(key),
                 meta=np.bytes_(json.dumps(self._ckpt_meta()).encode()),
                 **arrays)
        import os
        os.replace(tmp, self.cfg.checkpoint_path)

    def _load_checkpoint(self, params, opt_state, key):
        import json
        import os
        path = self.cfg.checkpoint_path
        if not path or not os.path.exists(path):
            return None
        with np.load(path) as data:
            epoch = int(data["epoch"])
            new_key = jnp.asarray(data["key"], dtype=key.dtype)
            if "meta" in data:
                saved = json.loads(bytes(data["meta"]).decode())
                now = self._ckpt_meta()
                # The mesh shape is NOT load-bearing: checkpoint leaves are
                # layout-free host numpy and _restore reshards them into the
                # freshly initialized shardings -- so a preempted job can
                # resume on a DIFFERENT device count (preemption rarely
                # returns the same topology). The training trajectory from
                # the resume point is equivalent, not bitwise (batch-alignment padding and
                # collective accumulation order change with the mesh; same
                # class of drift as grouped dispatch,
                # tests/test_checkpoint_resume.py::test_resume_across_mesh_shapes).
                saved_mesh = saved.pop("mesh_shape", None)
                now_mesh = now.pop("mesh_shape")
                # Keys absent from the checkpoint (older format) are not
                # compared -- newly-guarded hyperparameters must not brick
                # resumes of checkpoints written before the key existed.
                diffs = {k: (saved[k], now[k]) for k in now
                         if k in saved and saved[k] != now[k]}
                if diffs:
                    raise ValueError(
                        "Checkpoint hyperparameters do not match this run; "
                        "refusing to resume. Mismatches (checkpoint vs now): "
                        + ", ".join(f"{k}: {a} vs {b}"
                                    for k, (a, b) in sorted(diffs.items())))
                if saved_mesh is not None and list(saved_mesh) != now_mesh:
                    if self.master:
                        log.info(
                            f"    Checkpoint was trained on mesh "
                            f"{tuple(saved_mesh)}; resharding onto "
                            f"{tuple(now_mesh)} on resume.")
            leaves = [data[f"leaf_{i}"]
                      for i in range(len(jax.tree.leaves((params, opt_state))))]
        treedef = jax.tree.structure((params, opt_state))
        new_params, new_opt = jax.tree.unflatten(treedef, leaves)

        # Reproduce mesh shardings of the freshly initialized state; leave
        # everything else uncommitted so jit may place it freely.
        def _restore(tgt, src):
            sharding = getattr(tgt, "sharding", None)
            if isinstance(sharding, NamedSharding):
                from ..parallel.mesh import global_put
                return global_put(src, sharding)
            return jnp.asarray(src)

        new_params = jax.tree.map(_restore, params, new_params)
        new_opt = jax.tree.map(_restore, opt_state, new_opt)
        return epoch, new_params, new_opt, new_key

    def _plane_state_bytes(self, m_pad: int) -> int:
        """f32 SNP-plane training state: V plus every decoder P row, each
        carried three times (parameter + two Adam moments)."""
        plane_rows = self.cfg.n_components + sum(self.ks)
        return m_pad * plane_rows * 4 * 3

    def _auto_snp_axis(self, n_dev: int, m_pad: int, snp_quantum: int) -> int:
        """Auto mesh policy: devices go to the snp axis only when the
        SNP-plane training state (V + every decoder P, each with two Adam
        moments, plus gathered-batch scratch) would exceed the per-device
        budget; otherwise pure data parallelism (fewer collectives). The
        budget is half the device capacity (utils.hbm), leaving the rest
        for the resident packed genotypes; NA_TPU_HBM_BUDGET_GB overrides
        it. The batch term is deliberately conservative (not divided by the
        data axis): it errs toward engaging the snp axis."""
        import os
        env = os.environ.get("NA_TPU_HBM_BUDGET_GB")
        if env:
            budget = float(env) * 2**30
        else:
            from ..utils.hbm import hbm_capacity_bytes
            budget = 0.5 * hbm_capacity_bytes()
        cfg = self.cfg
        plane_bytes = self._plane_state_bytes(m_pad) \
            + cfg.batch_size * m_pad  # + packed/transient batch scratch
        n_snp = 1
        while (plane_bytes / n_snp > budget and n_snp < n_dev
               and n_dev % (n_snp * 2) == 0
               and m_pad % (n_snp * 2 * snp_quantum) == 0):
            n_snp *= 2
        return n_snp

    def data_axis_size(self, m_pad: int) -> int:
        """Extent of the mesh's data axis for this config (1 = no mesh).
        Lets the input pipeline compute per-host row blocks
        (parallel.distributed.host_sample_shard) before any data is read."""
        mesh = self._pick_mesh(m_pad, _use_pallas(self.cfg))
        return mesh.shape[DATA_AXIS] if mesh is not None else 1

    def sample_shard(self, m_pad: int, N: int) -> Tuple[int, int, int]:
        """This process's input row block (start, end, rows_per_process),
        including the block-sampling row quantum (resident rows must tile
        exactly into whole batches of whole sample blocks; see
        block_geometry). The input pipeline MUST use this (not a bare
        host_sample_shard) so reads line up with launch_training's
        assembly."""
        from ..parallel.distributed import host_sample_shard
        use_pallas = _use_pallas(self.cfg)
        d_sz = self.data_axis_size(m_pad)
        blk = max(1, self.cfg.sample_block)
        q = shard_quantum(use_pallas, d_sz, blk) if blk > 1 else 1
        return host_sample_shard(N, d_sz, quantum=q)

    def _pick_mesh(self, m_pad: int, use_pallas: bool):
        """Resolve the device mesh: explicit cfg.mesh_shape, or the auto
        policy (all visible devices, snp axis engaged only under memory
        pressure) when more than one device is present."""
        shape = self.cfg.mesh_shape
        snp_quantum = TILE_SNPS if use_pallas else 4
        if shape is None:
            n_dev = jax.device_count()
            if n_dev <= 1:
                return None
            n_snp = self._auto_snp_axis(n_dev, m_pad, snp_quantum)
            shape = (n_dev // n_snp, n_snp)
        n_data, n_snp = shape
        if n_data * n_snp <= 1:
            return None
        assert m_pad % (n_snp * snp_quantum) == 0, (
            f"m_pad={m_pad} is not divisible by n_snp={n_snp} x "
            f"{snp_quantum}; choose a smaller snp mesh axis")
        devices = jax.devices()
        if len(devices) < n_data * n_snp:
            raise ValueError(
                f"mesh_shape {shape} needs {n_data * n_snp} devices but "
                f"only {len(devices)} are available")
        return make_mesh(n_data, n_snp, devices=devices[:n_data * n_snp])

    def _unshuffle_rows(self, q: np.ndarray) -> np.ndarray:
        out = np.empty_like(q)
        out[self._row_order] = q
        return out

    def _infer_q(self, params, data_dev, N: int, use_pallas: bool,
                 mesh=None) -> List[np.ndarray]:
        """Sequential full-data encoder pass at batch <= 1024
        (reference: model/neural_admixture.py:368-383). On the fused path
        the pass runs through the xv kernel (ops.fused.fused_infer_q), so X
        never materializes in f32."""
        interpret = self.cfg.interpret
        if mesh is not None:
            if isinstance(data_dev, np.ndarray) and jax.process_count() > 1:
                # Multi-host out-of-core: data_dev is this host's LOCAL
                # packed row block; run the pass per host and rejoin.
                return self._infer_q_local_hosts(params, data_dev, N,
                                                 use_pallas)
            from ..parallel.sharded_step import infer_q_sharded
            qs = infer_q_sharded(mesh, params, data_dev, N, use_pallas,
                                 INFER_BATCH, interpret=interpret)
            return [qs[f"k{k}"] for k in self.ks]
        from .chunked import chunked_forward
        if use_pallas:
            from ..ops.fused import fused_infer_q
            fwd = jax.jit(partial(fused_infer_q, interpret=interpret))
            B = -(-min(N, INFER_BATCH) // ROWS) * ROWS
        else:
            fwd = _infer_batch
            B = min(N, INFER_BATCH)
        qs = chunked_forward(lambda blk: fwd(params, blk), data_dev, N, B)
        return [qs[f"k{k}"] for k in self.ks]

    def _infer_q_local_hosts(self, params, data_local, N: int,
                             use_pallas: bool) -> List[np.ndarray]:
        """Post-training Q pass for the multi-host out-of-core path: the
        (small) trained parameters are all-gathered to every host -- a
        collective all processes join -- and each host runs the
        single-device encoder pass over its OWN resident row block (the
        genotypes never leave its RAM except one chunk at a time); the
        per-host Q rows rejoin in process order (real resident rows are
        globally contiguous, parallel.distributed.host_sample_shard)."""
        from ..parallel.distributed import gather_ragged_rows, to_host
        host_params = jax.tree.map(to_host, params)
        rows_pp = data_local.shape[0]
        p = jax.process_index()
        n_local = min(rows_pp, max(0, N - p * rows_pp))
        if n_local > 0:
            local_params = jax.tree.map(jnp.asarray, host_params)
            qs_local = self._infer_q(local_params, data_local, n_local,
                                     use_pallas, mesh=None)
        else:
            qs_local = [np.zeros((0, k), np.float32) for k in self.ks]
        return [np.asarray(gather_ragged_rows(np.asarray(q)))
                for q in qs_local]

    def display_divergences(self, params, M: int) -> None:
        if not self.master:
            return
        log.info("    Results:")
        for k in self.ks:
            P = np.asarray(params["decoders"][f"k{k}"]).T[:M]  # (M, k)
            log.info(f"\n            Fst divergences between estimated "
                     f"populations: (K = {k})")
            log.info("")
            for line in fst_table(P):
                log.info(line)
            log.info("\n")
