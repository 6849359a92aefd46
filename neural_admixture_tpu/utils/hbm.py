"""Per-device memory capacity shared by the out-of-core decisions.

One source of truth for "does a host-resident array fit on the device":
the training engine's pre-flight estimate and auto-mesh budget
(train.engine), the RSVD driver (ops.rsvd), and the PCA projection
(train.init) all budget against hbm_capacity_bytes().
"""
import os

# Fraction of capacity a phase may plan to occupy; the rest is headroom for
# allocator fragmentation and XLA scratch. Shared by every decision site so
# the phases agree on what "fits".
HBM_BUDGET_FRAC = 0.9

# The CPU backend (tests, small runs) reports no device limit; its
# decisions use this explicit figure unless NA_TPU_HBM_CAPACITY_GB is set.
CPU_CAPACITY_GB = 16.0


def hbm_capacity_bytes() -> float:
    """Per-device memory the program may allocate.

    Priority: NA_TPU_HBM_CAPACITY_GB, then the accelerator runtime's own
    ``memory_stats()["bytes_limit"]`` (on a GPU this already reflects JAX's
    preallocated fraction of the card), then CPU_CAPACITY_GB on the CPU.
    An accelerator that reports no limit is an error."""
    env = os.environ.get("NA_TPU_HBM_CAPACITY_GB")
    if env:
        try:
            gb = float(env)
        except ValueError:
            raise ValueError(
                f"NA_TPU_HBM_CAPACITY_GB must be a number of GiB, got "
                f"{env!r}") from None
        if gb <= 0:
            raise ValueError(
                f"NA_TPU_HBM_CAPACITY_GB must be > 0, got {env!r}")
        return gb * 2**30
    import jax
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return CPU_CAPACITY_GB * 2**30
    stats = dev.memory_stats() or {}
    if not stats.get("bytes_limit"):
        raise RuntimeError(
            f"{dev.platform} device {dev.device_kind!r} reports no memory "
            "limit; set NA_TPU_HBM_CAPACITY_GB")
    return float(stats["bytes_limit"])


def should_stream_host(nbytes: int, frac: float = HBM_BUDGET_FRAC) -> bool:
    """True when a device-resident footprint of ``nbytes`` (the host array
    plus the op's own transients -- callers include them) should stream from
    host instead: it would claim more than ``frac`` of per-device capacity."""
    return nbytes > frac * hbm_capacity_bytes()
