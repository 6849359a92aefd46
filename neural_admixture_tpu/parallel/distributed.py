"""Multi-host initialization and host-sharded data loading.

One Python process per host drives all of that host's devices; there is no
per-GPU mp.spawn as in the reference (/root/reference/neural_admixture/
entry.py:188-193, /root/reference/neural_admixture/src/utils.py:69-95).
This module wires ``jax.distributed.initialize`` from an explicit
coordinator (NA_TPU_COORDINATOR / NA_TPU_NUM_PROCESSES / NA_TPU_PROCESS_ID)
and computes each host's sample-row block so the input pipeline reads only
local rows; the engine assembles the global resident genotype array from
the per-process blocks (jax.make_array_from_process_local_data).

Single-host runs are unaffected: ``maybe_initialize_distributed`` is a no-op
unless a multi-process configuration is given.
"""
import os
from typing import Optional, Tuple

import jax
import numpy as np

from ..utils.logger import log, setup_logging


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when running multi-process.

    Returns True if distributed mode is active. Safe to call unconditionally:
    on a single host with no coordinator configured it does nothing.
    """
    setup_logging()
    env_coord = coordinator_address or os.environ.get("NA_TPU_COORDINATOR")
    env_nproc = num_processes if num_processes is not None else \
        int(os.environ.get("NA_TPU_NUM_PROCESSES", "0") or 0)

    # NOTE: jax.process_count()/device queries would initialize the backend
    # and preempt jax.distributed.initialize -- the idempotency check and
    # the no-distributed fallthrough must not touch the backend (a plain
    # single-host `infer --num_gpus 0` still needs to pick its platform
    # after this returns).
    if jax.distributed.is_initialized():
        return True
    # A PARTIAL multi-process config must fail loudly, not fall through to
    # "single-process": every rank believing it is the master duplicates
    # the whole run and races on output writes.
    env_pid = process_id if process_id is not None else \
        (os.environ.get("NA_TPU_PROCESS_ID") or None)  # "" == unset
    if (env_coord or env_nproc > 1 or env_pid is not None) \
            and not (env_coord and env_nproc > 1 and env_pid is not None):
        # Includes coordinator + num_processes WITHOUT a process id:
        # defaulting it to 0 would make every rank process 0 and fail
        # later at the coordinator (or hang) instead of here.
        raise ValueError(
            "Incomplete multi-process configuration: set ALL of "
            "NA_TPU_COORDINATOR, NA_TPU_NUM_PROCESSES (> 1), and "
            "NA_TPU_PROCESS_ID (or none of them). Got coordinator="
            f"{env_coord!r}, num_processes={env_nproc}, "
            f"process_id={env_pid!r}.")
    if env_coord and env_nproc > 1:
        pid = int(env_pid)
        if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
            # The CPU backend has no cross-process collectives by default;
            # gloo gives working psum/all_gather between host processes
            # (used by the 2-process CPU integration test).
            try:
                jax.config.update("jax_cpu_collectives_implementation",
                                  "gloo")
            except Exception:
                pass
        # A genuine failure (unreachable coordinator, port clash) must
        # propagate: swallowing it would leave every rank believing it is
        # a single-process master, duplicating work and racing on writes.
        jax.distributed.initialize(coordinator_address=env_coord,
                                   num_processes=env_nproc,
                                   process_id=pid)
        log.info(f"    Distributed: process {pid}/{env_nproc} via {env_coord}")
        return True
    return False


def is_master() -> bool:
    return jax.process_index() == 0


def shutdown_distributed() -> None:
    """Tear down the jax.distributed runtime if it is active (the multi-host
    analogue of the reference's process-group teardown on failure,
    /root/reference/neural_admixture/src/main.py:119-133). No-op otherwise.

    Gated on jax.distributed.is_initialized(), NOT jax.process_count():
    the latter would initialize the XLA backend just to decide the
    teardown is a no-op (see the note at the top of
    maybe_initialize_distributed)."""
    if jax.distributed.is_initialized():
        try:
            jax.distributed.shutdown()
        except Exception:
            pass


def rows_per_process(N: int, d_sz: int, n_proc: int, quantum: int = 1) -> int:
    """Padded per-process resident-row count: the global sample count
    rounded up to lcm(d_sz, n_proc, quantum), divided evenly. THE single
    source of the formula -- host_sample_shard and the engine's
    block-sampling layout (engine.launch_training, incl. its emulated
    NA_TPU_EMULATE_PROC_SHARDS mode) must agree byte-for-byte on it."""
    q = np.lcm(np.lcm(d_sz, n_proc), quantum)
    return int(((N + q - 1) // q) * q) // n_proc


def host_sample_shard(N: int, data_axis_size: Optional[int] = None,
                      quantum: int = 1) -> Tuple[int, int, int]:
    """This host's sample-row block: (start, end, rows_per_process).

    Rows [start, end) of the dataset belong to this process; its resident
    block must be zero-padded to ``rows_per_process`` rows (the global
    padded sample count divided evenly over processes). The split is aligned
    with the device order of the (data, snp) mesh, so the engine can hand
    each process block to jax.make_array_from_process_local_data unchanged.

    ``data_axis_size``: the mesh's data-axis extent (defaults to all
    devices, the auto-mesh case). ``quantum``: extra alignment of the
    global padded row count -- block sampling needs resident rows to tile
    exactly into whole batches of whole blocks (engine.block_geometry's
    lcm(batch_align, d_sz * blk); use engine's
    NeuralAdmixtureTrainer.sample_shard, which supplies it). The reference
    instead loads the full matrix into every process's shared memory
    (entry.py:186) -- untenable at biobank scale.
    """
    p, n_proc = jax.process_index(), jax.process_count()
    d_sz = data_axis_size or jax.device_count()
    assert d_sz % n_proc == 0, (
        f"data axis ({d_sz}) must spread evenly over {n_proc} processes")
    rows_pp = rows_per_process(N, d_sz, n_proc, quantum)
    # With more padding than rows_pp (tiny N, many processes) a tail
    # process can own only padding; clamp so start <= end <= N and it
    # simply reads an empty block.
    start = min(p * rows_pp, N)
    return start, min(start + rows_pp, N), rows_pp


def allsum_hosts(x: np.ndarray) -> np.ndarray:
    """Elementwise sum of a host numpy array over all processes."""
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(np.asarray(x))
                      .sum(axis=0))


def gather_ragged_rows(local: np.ndarray) -> np.ndarray:
    """Concatenate per-process row blocks (possibly unequal row counts) in
    process order into one global array on every host."""
    local = np.asarray(local)
    if jax.process_count() == 1:
        return local
    from jax.experimental import multihost_utils
    counts = multihost_utils.process_allgather(
        np.asarray([local.shape[0]], np.int64)).ravel()
    pad_to = int(counts.max())
    padded = np.zeros((pad_to,) + local.shape[1:], local.dtype)
    padded[:local.shape[0]] = local
    parts = multihost_utils.process_allgather(padded)
    return np.concatenate([parts[p, :counts[p]]
                           for p in range(len(counts))], axis=0)


def to_host(x) -> np.ndarray:
    """Device array -> full host numpy, on every process.

    np.asarray works only on fully-addressable (or fully replicated)
    arrays; across processes a genuinely sharded global array must be
    all-gathered first."""
    if (jax.process_count() == 1
            or getattr(x, "is_fully_addressable", True)
            or getattr(getattr(x, "sharding", None),
                       "is_fully_replicated", False)):
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
