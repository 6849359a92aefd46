#!/usr/bin/env python
"""Scaling-efficiency harness: epoch throughput across mesh shapes.

Runs the production epoch function on 1 device and on (n_data, n_snp)
meshes over all visible devices, and reports samples/s plus parallel
efficiency vs the single-device run. On a multi-GPU host this measures
NVLink/NCCL scaling; on CPU (JAX_PLATFORMS=cpu with
xla_force_host_platform_device_count) it validates the harness and the
collective paths, not real speedups.

Usage: python tools/scaling_bench.py [--meshes 1x1,2x1,4x1,4x2,8x1]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="1x1,2x1,4x1,8x1,4x2")
    ap.add_argument("--m", type=int, default=int(os.environ.get("SB_M", 65536)))
    ap.add_argument("--n", type=int, default=int(os.environ.get("SB_N", 2048)))
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--batch", type=int, default=800)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args()

    import jax
    import optax

    from neural_admixture_tpu.io.packed import pack_2bit_rows
    from neural_admixture_tpu.models import qp
    from neural_admixture_tpu.train.engine import (NeuralAdmixtureTrainer,
                                                   TrainConfig, _use_pallas,
                                                   make_epoch_fn)
    from neural_admixture_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()

    n_dev = jax.device_count()
    M, N, K, B = args.m, args.n, args.k, args.batch
    m_pad = ((M + 2047) // 2048) * 2048
    rng = np.random.default_rng(0)
    G = rng.integers(0, 3, size=(N, M), dtype=np.uint8)
    packed = pack_2bit_rows(G, m_pad=m_pad)
    V = rng.normal(size=(K, M)).astype(np.float32) * 0.01  # D=K here is fine
    P_init = rng.uniform(0.1, 0.9, size=(K, M)).astype(np.float32)

    results = []
    base_sps = None
    for mesh_str in args.meshes.split(","):
        n_data, n_snp = (int(x) for x in mesh_str.split("x"))
        if n_data * n_snp > n_dev:
            print(f"# skip {mesh_str}: only {n_dev} devices", file=sys.stderr)
            continue
        cfg = TrainConfig(epochs=args.epochs, batch_size=B,
                          learning_rate=1e-3, seed=0, hidden_size=256,
                          ks=[K], progress=False, log_every=10 ** 9,
                          mesh_shape=(n_data, n_snp))
        tr = NeuralAdmixtureTrainer(cfg)
        t0 = time.time()
        tr.launch_training(P_init.copy(), packed, V, M, N)
        sps = N * args.epochs / tr.train_seconds
        if base_sps is None:
            base_sps = sps
        eff = sps / (base_sps * max(1, n_data * n_snp))
        results.append({"mesh": mesh_str, "samples_per_sec": round(sps, 1),
                        "efficiency_vs_1dev": round(eff, 3),
                        "wall_s": round(tr.train_seconds, 2)})
        print(json.dumps(results[-1]), file=sys.stderr)

    print(json.dumps({"metric": "scaling_efficiency",
                      "workload": f"{M // 1000}kSNP_N{N}_K{K}",
                      "pallas": _use_pallas(cfg), "results": results}))


if __name__ == "__main__":
    main()
