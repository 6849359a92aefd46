"""Device plumbing: kernel choice by platform, device capacity, the compile
cache directory, and chip_smoke.py's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

from neural_admixture_tpu.train.engine import (TrainConfig, _use_pallas,
                                               fused_op_for)
from neural_admixture_tpu.utils import hbm, platform

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,fused", [("gpu", True), ("cpu", False)])
def test_kernel_choice_by_platform(name, fused):
    assert fused_op_for(name) is fused


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(name):
    with pytest.raises(ValueError, match="no training path"):
        fused_op_for(name)


def test_use_pallas_override_and_cpu_default():
    """The test suite runs on the CPU: no override -> the XLA step; an
    explicit choice wins (the fused op then runs only with interpret=True,
    which nothing sets implicitly)."""
    assert _use_pallas(TrainConfig()) is False
    assert _use_pallas(TrainConfig(use_pallas=True)) is True
    assert TrainConfig().interpret is False


class _FakeDevice:
    def __init__(self, platform_name, stats):
        self.platform = platform_name
        self.device_kind = "fake"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _fake_devices(monkeypatch, platform_name, stats):
    import jax
    monkeypatch.delenv("NA_TPU_HBM_CAPACITY_GB", raising=False)
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice(platform_name, stats)])


def test_capacity_from_gpu_memory_stats(monkeypatch):
    _fake_devices(monkeypatch, "gpu", {"bytes_limit": 60 * 2**30,
                                       "bytes_in_use": 0})
    assert hbm.hbm_capacity_bytes() == 60 * 2**30


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_gpu_without_limit_is_an_error(monkeypatch, stats):
    _fake_devices(monkeypatch, "gpu", stats)
    with pytest.raises(RuntimeError, match="no memory limit"):
        hbm.hbm_capacity_bytes()


def test_cpu_capacity_is_explicit(monkeypatch):
    _fake_devices(monkeypatch, "cpu", None)
    assert hbm.hbm_capacity_bytes() == hbm.CPU_CAPACITY_GB * 2**30
    monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", "3")
    assert hbm.hbm_capacity_bytes() == 3 * 2**30


def test_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.compile_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.compile_cache_dir()
    assert path == os.path.join(_ROOT, ".jax_cache")
    with open(os.path.join(_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("in_checkout", [True, False])
def test_cache_dir_only_inside_a_checkout(tmp_path, in_checkout):
    """An installed package (no pyproject.toml above it) has no default."""
    root = tmp_path / "lib"
    package_file = root / "neural_admixture_tpu" / "utils" / "platform.py"
    package_file.parent.mkdir(parents=True)
    if in_checkout:
        (root / "pyproject.toml").write_text("")
    expected = root / ".jax_cache" if in_checkout else None
    assert platform.checkout_cache_dir(str(package_file)) == expected


@pytest.mark.parametrize("case", ["installed", "unwritable"])
def test_enable_compile_cache_never_fails_the_run(monkeypatch, tmp_path,
                                                  case):
    import jax
    calls = {}
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setattr(platform, "_CACHE_SET", False)
    monkeypatch.setattr(platform, "DEFAULT_CACHE_DIR",
                        None if case == "installed" else blocker / "cache")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    platform.enable_compile_cache()
    assert calls == {}
    if case == "installed":
        assert platform.compile_cache_dir() is None


@pytest.mark.parametrize("env_dir", [True, False])
def test_enable_compile_cache_sets_dir_only_without_env(monkeypatch, tmp_path,
                                                        env_dir):
    import jax
    calls = {}
    monkeypatch.setattr(platform, "_CACHE_SET", False)
    monkeypatch.setattr(platform, "DEFAULT_CACHE_DIR", tmp_path / "cache")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    platform.enable_compile_cache()
    if env_dir:
        assert "jax_compilation_cache_dir" not in calls
    else:
        assert calls["jax_compilation_cache_dir"] == str(tmp_path / "cache")
        assert (tmp_path / "cache").is_dir()


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    proc = _run_smoke(_ROOT, os.path.join(_ROOT, "chip_smoke.py"))
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_needs_the_repository(tmp_path):
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


class _Mesh:
    def __init__(self, d):
        self.shape = {"data": d, "snp": 1}


@pytest.mark.parametrize("use_pallas,d_sz", [(True, 1), (True, 4),
                                             (False, 1), (False, 4)])
def test_batch_alignment_follows_the_fused_row_step(use_pallas, d_sz):
    from neural_admixture_tpu.ops.fused import ROWS
    from neural_admixture_tpu.train.engine import batch_align
    mesh = _Mesh(d_sz) if d_sz > 1 else None
    assert batch_align(use_pallas, mesh) == (ROWS if use_pallas else 1) * d_sz


def test_log_device_names_platform_and_step(caplog):
    import logging

    from neural_admixture_tpu.train.engine import log_device
    with caplog.at_level(logging.INFO, logger="neural_admixture_tpu"):
        log_device(False)
    assert any(r.getMessage().strip().startswith("Device: cpu")
               and r.getMessage().endswith("step: XLA")
               for r in caplog.records)


def test_chunked_forward_pads_and_crops_host_rows():
    """Host arrays may hold padding rows past N: every chunk is cut at N,
    zero-padded to the batch and cropped after."""
    import numpy as np

    from neural_admixture_tpu.train.chunked import chunked_forward
    data = np.arange(11 * 2, dtype=np.uint8).reshape(11, 2)
    seen = []

    def fwd(blk):
        seen.append(np.asarray(blk).copy())
        return {"k2": np.asarray(blk, np.float32)}

    out = chunked_forward(fwd, data, N=9, batch=4)
    assert [b.shape for b in seen] == [(4, 2)] * 3
    np.testing.assert_array_equal(seen[-1][1:], 0)
    np.testing.assert_array_equal(out["k2"], data[:9])
