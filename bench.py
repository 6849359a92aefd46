#!/usr/bin/env python
"""Benchmark: training throughput of the Neural ADMIXTURE JAX engine.

Headline metric (BASELINE.md): training samples/sec on a 1M-SNP workload
(single device). Baseline for ``vs_baseline`` is the reference architecture's
throughput measured with torch on this host's CPU (the reference's own
non-CUDA execution path), on an identical down-scaled workload, extrapolated
per-step -- the only reference path runnable in this environment.

Prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "platform": ..., "device_kind": ..., "device_count": N}

The step is the engine's own choice for the platform (the fused op on a
GPU, the XLA step on the CPU); NA_BENCH_INTERPRET=1 runs the fused op in
the Pallas interpreter instead (CPU smoke tests).
"""
import json
import os
import sys
import time
from functools import partial

import numpy as np

# Workload: 1M SNPs x 4096 samples. Overridable for smoke runs.
M = int(os.environ.get("NA_BENCH_M", 1_000_000))
N = int(os.environ.get("NA_BENCH_N", 4096))
K = int(os.environ.get("NA_BENCH_K", 8))
# Multi-head sweep: comma list of K values trained jointly (one head +
# decoder each, all sharing every pass's packed reads and unpack). Default:
# the single headline K.
KS = sorted(int(s) for s in
            os.environ.get("NA_BENCH_KS", str(K)).split(","))
B = int(os.environ.get("NA_BENCH_B", 800))
D = 8
H = 1024
# 5 = the production log period (TrainConfig.log_every): the engine runs
# one jit dispatch per period, so measuring 5 epochs in one grouped call
# reproduces the production dispatch:compute ratio exactly.
EPOCHS_MEASURE = int(os.environ.get("NA_BENCH_EPOCHS", 5))
TORCH_STEPS = int(os.environ.get("NA_BENCH_TORCH_STEPS", 3))


_PACKED_CACHE = {}


def make_synthetic_packed(n, m, k, seed=0):
    """Random genotypes -- content does not affect throughput, so plain
    uniform {0,1,2} keeps generation fast at biobank scale. Memoized: the
    single-head and multi-head measurements share the identical matrix
    (minutes of host generation at 1M SNPs otherwise repeat)."""
    key = (n, m, seed)
    if key in _PACKED_CACHE:
        return _PACKED_CACHE[key]
    rng = np.random.default_rng(seed)
    from neural_admixture_tpu.io.packed import pack_2bit_rows, packed_width
    m_pad = ((m + 2047) // 2048) * 2048
    packed = np.empty((n, packed_width(m_pad)), dtype=np.uint8)
    for i in range(0, n, 1024):
        G = rng.integers(0, 3, size=(min(1024, n - i), m), dtype=np.uint8)
        packed[i:i + 1024] = pack_2bit_rows(G, m_pad=m_pad)
    _PACKED_CACHE[key] = (packed, m_pad)
    return packed, m_pad


def bench_jax(KS=KS):
    import jax
    import optax

    from neural_admixture_tpu.utils.platform import enable_compile_cache
    enable_compile_cache()

    from neural_admixture_tpu.models import qp
    from neural_admixture_tpu.ops import pack as pk
    from neural_admixture_tpu.train.engine import (TrainConfig, _use_pallas,
                                                   block_geometry,
                                                   make_epoch_fn,
                                                   make_stream_epoch_fn)

    interpret = os.environ.get("NA_BENCH_INTERPRET") == "1"
    use_pallas = _use_pallas(TrainConfig(use_pallas=True if interpret
                                         else None))
    # NA_BENCH_STREAM=1: measure the host-streaming (out-of-core) path
    # instead -- packed genotypes stay in host memory, each batch is
    # assembled on host and transferred per step (engine.
    # make_stream_epoch_fn). This knob documents the out-of-core
    # throughput; it is not the headline.
    stream = os.environ.get("NA_BENCH_STREAM") == "1"
    # 16 = the production CLI default --sample_block.
    blk = int(os.environ.get("NA_BENCH_BLOCK", 16))
    packed, m_pad = make_synthetic_packed(N, M, K)
    rng = np.random.default_rng(1)
    V = rng.normal(size=(D, M)).astype(np.float32) * 0.01
    P_init = rng.uniform(0.1, 0.9, size=(sum(KS), M)).astype(np.float32)

    params = qp.init_params(jax.random.PRNGKey(0), V.T, P_init, H, KS,
                            m_pad=m_pad)
    tx = optax.adam(2e-3, b1=0.9, b2=0.95, eps=1e-8)
    opt_state = tx.init(params)
    col_mask = jax.numpy.asarray((np.arange(m_pad) < M).astype(np.float32))
    data = pk.packed_view_u32(packed) if use_pallas else packed

    # Block-granular sampling (the production default) needs the resident
    # rows padded to whole batches of whole blocks.
    n_rows = None
    if blk > 1:
        _, _, _, n_rows = block_geometry(N, B, use_pallas, None, blk)
        data = np.pad(data, ((0, n_rows - N), (0, 0)))
    packed_dev = data if stream else jax.device_put(data)
    pops = (np.zeros((N,), np.int32) if stream
            else jax.numpy.zeros((N,), jax.numpy.int32))

    # Measure ONE TRUE PRODUCTION LOG PERIOD: the engine runs each period
    # (1 logged epoch followed by log_every-1 loss-free epochs) as one
    # grouped jit dispatch (engine.make_epoch_fn(epochs_per_call=E,
    # period_len=E)); the bench's default EPOCHS_MEASURE=5 with
    # compute_loss=True reproduces that dispatch:compute ratio AND epoch
    # mix exactly. NA_BENCH_LOSSFREE=1 measures all-loss-free epochs
    # instead (the cheapest variant); NA_BENCH_GROUP=0 measures per-epoch
    # dispatch.
    group = (os.environ.get("NA_BENCH_GROUP", "1") == "1"
             and EPOCHS_MEASURE > 1 and not stream)
    lossfree = os.environ.get("NA_BENCH_LOSSFREE") == "1"
    common = dict(supervised=False, supervised_loss_weight=0.0,
                  use_pallas=use_pallas, params_template=params,
                  sample_block=blk, n_rows=n_rows, interpret=interpret)
    if group:
        epoch_fn = make_epoch_fn(
            tx, N, B, compute_loss=not lossfree,
            epochs_per_call=EPOCHS_MEASURE,
            period_len=0 if lossfree else EPOCHS_MEASURE, **common)
    else:
        mk = partial(make_stream_epoch_fn if stream else make_epoch_fn,
                     tx, N, B, **common)
        fast = mk(compute_loss=False)
        epoch_fns = [fast if lossfree else mk(compute_loss=True)] \
            + [fast] * (EPOCHS_MEASURE - 1)
    key = jax.random.PRNGKey(42)

    def run_epochs(params, opt_state, key):
        if group:
            return epoch_fn(params, opt_state, packed_dev, col_mask, pops,
                            jax.random.split(key, EPOCHS_MEASURE))[:2]
        for fn in epoch_fns:
            key, ke = jax.random.split(key)
            params, opt_state, _ = fn(params, opt_state, packed_dev,
                                      col_mask, pops, ke)
        return params, opt_state

    # Warm-up / compile.
    key, kw = jax.random.split(key)
    params, opt_state = jax.block_until_ready(
        run_epochs(params, opt_state, kw))

    t0 = time.time()
    params, opt_state = jax.block_until_ready(
        run_epochs(params, opt_state, key))
    dt = time.time() - t0
    dev = jax.devices()[0]
    stats = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": jax.device_count(),
        "step": ("fused-interpret" if interpret
                 else "fused" if use_pallas else "xla"),
    }
    return N * EPOCHS_MEASURE / dt, stats


def pinned_baseline():
    """The torch-CPU reference throughput pinned by
    tools/pin_bench_baseline.py (median of 5 x 10-step runs), rescaled to
    the current M (per-step cost is M-proportional). None when no pin
    exists or the pinned workload's other knobs (B/D/H/KS) differ --
    callers then fall back to a live measurement. Pinning exists because
    the live 3-step re-measure scattered +/-40% across driver rounds,
    swinging vs_baseline 550x -> 2480x on a flat engine number."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "bench_baseline.json")
    try:
        with open(path) as fh:
            rec = json.load(fh)
    except (OSError, ValueError):
        return None
    w = rec.get("workload", {})
    if (w.get("B"), w.get("D"), w.get("H"), w.get("KS")) != (B, D, H, KS):
        return None
    return float(rec["samples_per_sec"]) * (float(w["M"]) / M)


def bench_torch_baseline():
    """Reference-architecture step in torch (CPU).

    Measured at min(M, 131072) SNPs and scaled linearly to M (every
    M-proportional term dominates the step), keeping the baseline run
    time-boxed at biobank scale.
    """
    try:
        import torch
    except ImportError:
        return None
    torch.manual_seed(0)
    m = min(M, 131072)
    X = torch.randint(0, 3, (B, m), dtype=torch.uint8)

    V = torch.nn.Parameter(torch.randn(m, D) * 0.01)
    norm = torch.nn.RMSNorm(D, eps=1e-8)
    common = torch.nn.Sequential(torch.nn.Linear(D, H), torch.nn.ReLU())
    heads = [torch.nn.Linear(H, k) for k in KS]
    decs = [torch.nn.Linear(k, m, bias=False) for k in KS]
    with torch.no_grad():
        for dec in decs:
            dec.weight.uniform_(0.1, 0.9)
    params = [V] + list(norm.parameters()) + list(common.parameters())
    for mod in heads + decs:
        params += list(mod.parameters())
    opt = torch.optim.Adam(params, lr=2e-3, betas=(0.9, 0.95))
    lossf = torch.nn.BCELoss(reduction="sum")

    def step():
        opt.zero_grad(set_to_none=True)
        x = X.float() / 2
        x = torch.where(x == 1.5, torch.tensor(0.0), x)
        h = common(norm(x @ V))
        loss = sum(
            lossf(torch.clamp(dec(torch.softmax(head(h), dim=1)), 0, 1), x)
            for head, dec in zip(heads, decs))
        loss.backward()
        opt.step()
        with torch.no_grad():
            for dec in decs:
                dec.weight.clamp_(0, 1)

    step()  # warm-up
    t0 = time.time()
    for _ in range(TORCH_STEPS):
        step()
    dt = time.time() - t0
    return (B * TORCH_STEPS / dt) * (m / M)


def main():
    sps, stats = bench_jax()
    # vs_baseline uses the PINNED torch-CPU reference number when the
    # workload matches the pin (tools/bench_baseline.json); otherwise --
    # or with NA_BENCH_LIVE_BASELINE=1, reported separately -- the live
    # re-measure. NA_BENCH_NO_TORCH=1 skips the live leg entirely.
    base, base_src = pinned_baseline(), "pinned"
    live = None
    if os.environ.get("NA_BENCH_NO_TORCH", "0") != "1" and (
            base is None or os.environ.get("NA_BENCH_LIVE_BASELINE") == "1"):
        live = bench_torch_baseline()
    if base is None:
        base, base_src = live, "live"
    vs = (sps / base) if base else None
    k_tag = (f"K{KS[0]}" if len(KS) == 1
             else f"K{KS[0]}-{KS[-1]}x{len(KS)}heads")
    out = {
        "metric": f"train_samples_per_sec_{M//1000}kSNP_{k_tag}",
        "value": round(sps, 2),
        "unit": "samples/s",
        "vs_baseline": round(vs, 2) if vs else None,
        "baseline_samples_per_sec": round(base, 2) if base else None,
        "baseline_source": base_src if base else None,
    }
    if live is not None and base_src == "pinned":
        out["baseline_live_samples_per_sec"] = round(live, 2)
    out.update(stats)
    # Second headline: the multi-head K sweep (--min_k/--max_k), the real
    # ADMIXTURE workflow (reference entry.py:33-34 defaults K=2..10 when no
    # single K is given). Skipped when NA_BENCH_KS pins an explicit K list
    # or NA_BENCH_MULTIHEAD=0 (smoke runs).
    if ("NA_BENCH_KS" not in os.environ
            and os.environ.get("NA_BENCH_MULTIHEAD", "1") == "1"):
        ks_sweep = list(range(2, 11))
        sps_mh, _ = bench_jax(KS=ks_sweep)
        out["multi_head"] = {
            "ks": f"{ks_sweep[0]}-{ks_sweep[-1]}",
            "heads": len(ks_sweep),
            "samples_per_sec": round(sps_mh, 2),
            "head_samples_per_sec": round(sps_mh * len(ks_sweep), 2),
            "cost_vs_single_head": round(sps / sps_mh, 2),
        }
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
