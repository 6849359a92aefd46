"""Test env: run JAX on CPU with 8 virtual devices so sharding tests can
exercise a (data, snp) mesh without accelerators (SURVEY.md section 4)."""
import os

# Force CPU even on a GPU machine: the test suite must be runnable anywhere,
# and sharding tests need 8 virtual devices.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# Some pytest plugins import jax before this conftest runs, freezing the
# platform choice from the ambient env; override the config directly (the
# backend itself is not initialized until first use, so this still applies).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Demo fixtures vendored from the reference's demo/ data set (identical
# bytes; the repo is self-contained without the reference checkout).
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_BED = os.path.join(_REPO, "demo/data/demo_data.bed")
DEMO_Q_EXPECTED = os.path.join(_REPO, "demo/expected/demo_run.7.Q.expected")
DEMO_P_EXPECTED = os.path.join(_REPO, "demo/expected/demo_run.7.P.expected")

from neural_admixture_tpu.utils.trajectory import (  # noqa: E402,F401
    assert_trajectory_close)
