"""bench.py is the throughput artifact: a regression in it loses the
headline measurement, so CI smoke-runs the real script end to end on tiny
workloads and validates the JSON contract (one parseable line with the
metric/value/unit keys and the device it ran on, multi_head skippable).

Subprocess-based: bench.py reads its NA_BENCH_* workload knobs at import
time, so each leg gets a fresh interpreter with the env prepared.
"""
import json
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(extra_env, timeout=420):
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "NA_BENCH_M": "8192",
        "NA_BENCH_N": "64",
        "NA_BENCH_K": "3",
        "NA_BENCH_B": "16",
        "NA_BENCH_EPOCHS": "2",
        "NA_BENCH_BLOCK": "8",
        "NA_BENCH_MULTIHEAD": "0",
    })
    env.update(extra_env)
    proc = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "bench.py")],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=_ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.strip().splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, f"expected ONE JSON line, got: {proc.stdout!r}"
    return json.loads(lines[0])


def test_bench_json_contract_xla_path():
    out = _run_bench({"NA_BENCH_NO_TORCH": "1"})
    assert out["metric"] == "train_samples_per_sec_8kSNP_K3"
    assert out["unit"] == "samples/s"
    assert out["value"] > 0
    # no torch leg and the pinned baseline targets the 1M workload ->
    # vs_baseline must be reported as absent, not fabricated
    assert out["vs_baseline"] is None
    # the result names its device; on the CPU the engine picks the XLA step
    assert (out["platform"], out["device_count"], out["step"]) == \
        ("cpu", 8, "xla")
    assert out["device_kind"]
    assert "multi_head" not in out        # NA_BENCH_MULTIHEAD=0


def test_bench_json_contract_pallas_interpret_with_baseline():
    out = _run_bench({"NA_BENCH_INTERPRET": "1",
                      "NA_BENCH_TORCH_STEPS": "1"})
    assert out["value"] > 0
    assert out["step"] == "fused-interpret"
    # live torch leg ran (tiny): vs_baseline present and positive
    assert out["baseline_source"] == "live"
    assert out["vs_baseline"] > 0
