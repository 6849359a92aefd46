#!/usr/bin/env python
"""Proof that the program trains and infers on an NVIDIA GPU.

Run from the root of the repository on a machine with a GPU:

    python chip_smoke.py           # one card, the four phases below
    python chip_smoke.py --four    # four cards: K=8 training data-parallel
                                   # (--num_gpus 4) and on a 2x2 mesh, each
                                   # against the same run on one card

Phases on one card, in one process (a second JAX process could not get the
card's memory). Phase 4 runs right after phase 1, on a device that holds
nothing else: its XLA reference step at K=2..10 needs 57.4 GiB.

  1. device      JAX must see a GPU; the card's name and power limit come
                 from nvidia-smi. Without a GPU the script exits non-zero.
  2. demo gate   CLI ``train --k 7 --epochs 5 --seed 42`` on the demo BED,
                 then ``infer --num_gpus 1``; Q is gated against the golden
                 outputs with the thresholds of tests/test_train_demo.py and
                 the log-likelihood must beat the golden outputs'.
  3. full width  a synthetic BED of 4096 samples x 1,000,000 SNPs (K=8);
                 CLI ``train --k 8`` (2 epochs), ``train --min_k 2
                 --max_k 10`` (1 epoch) and ``infer --num_gpus 1``; outputs
                 must be finite, Q on the simplex, P in [0, 1].
  4. kernels     the fused op against the plain XLA step at B=800,
                 m_pad=1,001,472 for K=8 and K=2..10 (loss, Xp, dQ, dP, dV),
                 then a full train step of each, timed.

Every timing is printed beside the card's name and power limit. The last
line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
import argparse
import gc
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# The process is the card's only user; the default 75% would leave phase 4's
# XLA reference step at K=2..10 (57.4 GiB) under 1 GiB of room.
os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")

import neural_admixture_tpu  # noqa: E402,F401  (fails outside a checkout)

ROOT = os.path.dirname(os.path.abspath(__file__))
DEMO_BED = os.path.join(ROOT, "demo", "data", "demo_data.bed")
DEMO_Q = os.path.join(ROOT, "demo", "expected", "demo_run.7.Q.expected")
DEMO_P = os.path.join(ROOT, "demo", "expected", "demo_run.7.P.expected")
N_FULL, M_FULL, K_FULL = 4096, 1_000_000, 8
# --four's batch: a multiple of 4 cards x 16-row sample blocks, so one card,
# 4x1 and 2x2 run the same sequence of batches. At the CLI's 800 the 4x1
# run rounds its batches up to 832 rows and takes 5 steps an epoch, not 6.
FOUR_BATCH = 768
B_STEP, M_PAD_STEP = 800, 1_001_472     # phase 4: bench batch, padded 1M SNPs
SNP_BLOCK = 1 << 16                     # SNPs drawn per device call
THREADS = str(os.cpu_count() or 1)
CARD = "?"


def say(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, seconds: float) -> None:
    say(f"    [{CARD}] {label}: {seconds:.2f} s")


class _LogCapture(logging.Handler):
    """Keeps the CLI's log lines; the script prints only the ones it reads."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


_CAPTURE = _LogCapture()


def cli(*argv) -> list:
    """Run one CLI command in this process; returns its log lines."""
    from neural_admixture_tpu.entry import main

    start = len(_CAPTURE.lines)
    t0 = time.time()
    rc = main([str(a) for a in argv])
    lines = _CAPTURE.lines[start:]
    if rc != 0:
        raise RuntimeError(f"CLI {argv[0]} exited {rc}:\n" + "\n".join(lines))
    timed(f"CLI {' '.join(str(a) for a in argv[:3])} ...", time.time() - t0)
    for ln in lines:
        s = ln.strip()
        if s.startswith(("Device:", "Mesh:", "Training throughput",
                         "Total time SVD", "Log-likelihood", "Total elapsed")):
            say(f"      log: {s}")
    return lines


def assert_backend_gpu(lines) -> None:
    dev = [ln for ln in lines if ln.strip().startswith("Device:")]
    assert dev and dev[0].strip().startswith("Device: gpu"), dev


def load_checked(prefix: str, k: int, n: int, m: int, with_p: bool = True):
    """Q (and P) of one K, asserted finite, Q on the simplex, P in [0, 1]."""
    Q = np.loadtxt(f"{prefix}.{k}.Q", ndmin=2)
    assert Q.shape == (n, k), (prefix, k, Q.shape)
    assert np.isfinite(Q).all() and (Q >= 0).all()
    np.testing.assert_allclose(Q.sum(axis=1), 1.0, atol=1e-4)
    if not with_p:
        return Q, None
    P = np.loadtxt(f"{prefix}.{k}.P", ndmin=2)
    assert P.shape == (m, k), (prefix, k, P.shape)
    assert np.isfinite(P).all() and P.min() >= 0 and P.max() <= 1
    return Q, P


def check_outputs(prefix: str, ks, n: int, m: int, with_p: bool = True):
    for k in ks:
        load_checked(prefix, k, n, m, with_p)


# ------------------------------- phase 1 ----------------------------------

def device_phase(count: int):
    global CARD
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX platform is {devs[0].platform!r}",
              file=sys.stderr)
        sys.exit(2)
    if len(devs) < count:
        print(f"chip_smoke: needs {count} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    CARD = smi.stdout.strip().splitlines()[0].strip()
    say(smi.stdout.strip())
    from neural_admixture_tpu.native import bed_native
    say(f"phase 1 device: {devs[0].platform} {devs[0].device_kind} "
        f"x{len(devs)}; native host decoder built: {bed_native.available()}")
    return devs


# ------------------------------- phase 2 ----------------------------------

def best_permutation(Q, Q_ref):
    from scipy.optimize import linear_sum_assignment
    K = Q.shape[1]
    corr = np.array([[np.corrcoef(Q[:, i], Q_ref[:, j])[0, 1]
                      for j in range(K)] for i in range(K)])
    rows, cols = linear_sum_assignment(-np.nan_to_num(corr))
    perm = np.empty(K, dtype=int)
    perm[cols] = rows
    return perm, corr[rows, cols]


def demo_gate(work: str) -> float:
    """Train and infer on the demo data through the CLI; returns the LL."""
    from neural_admixture_tpu.io.bed import read_bed
    from neural_admixture_tpu.ops.loglikelihood import loglikelihood

    out = os.path.join(work, "demo")
    lines = cli("train", "--k", 7, "--epochs", 5, "--seed", 42,
                "--data_path", DEMO_BED, "--save_dir", out,
                "--name", "demo_run", "--threads", THREADS, "--no_progress")
    assert_backend_gpu(lines)
    lines = cli("infer", "--name", "demo_run", "--save_dir", out,
                "--data_path", DEMO_BED, "--out_name", "demo_proj",
                "--num_gpus", 1, "--threads", THREADS)
    assert_backend_gpu(lines)
    Q = np.loadtxt(f"{out}/demo_run.7.Q")
    P = np.loadtxt(f"{out}/demo_run.7.P")
    Q_proj = np.loadtxt(f"{out}/demo_proj.7.Q")
    np.testing.assert_allclose(Q_proj, Q, atol=1e-5)
    Q_ref, P_ref = np.genfromtxt(DEMO_Q), np.genfromtxt(DEMO_P)
    # Gates of tests/test_train_demo.py.
    perm, q_corr = best_permutation(Q, Q_ref)
    p_corr = [np.corrcoef(P[:, perm[j]], P_ref[:, j])[0, 1]
              for j in range(7)]
    G = read_bed(DEMO_BED)
    ll = loglikelihood(G, P, Q, 7)
    ll_ref = loglikelihood(G, P_ref, Q_ref, 7)
    say(f"    demo: Q corr {np.round(q_corr, 3).tolist()} "
        f"(mean {q_corr.mean():.4f}); P corr mean {np.mean(p_corr):.4f}; "
        f"LL {ll:,.1f} vs golden {ll_ref:,.1f}")
    assert q_corr.mean() > 0.78 and np.sort(q_corr)[1] > 0.85, q_corr
    assert np.mean(p_corr) > 0.93 and np.min(p_corr) > 0.80, p_corr
    assert ll > ll_ref, (ll, ll_ref)
    return ll


# ------------------------------- phase 3 ----------------------------------

def write_synthetic_bed(path: str, n: int, m: int, seed: int = 42) -> None:
    """An n x m BED from the ADMIXTURE generative model of
    tools/convergence_bench.py's synth_admixed (Q ~ Dirichlet(0.2),
    P ~ U(0.05, 0.95), G ~ Binomial(2, QP)), drawn on the device in SNP
    blocks: the host draw takes minutes at this size."""
    import jax
    import jax.numpy as jnp

    key_q, key_p, key_g = jax.random.split(jax.random.PRNGKey(seed), 3)
    Q = jax.random.dirichlet(key_q, jnp.full((K_FULL,), 0.2), (n,))
    code_of = jnp.asarray([3, 2, 0, 1], jnp.uint8)   # dosage -> BED code
    shifts = jnp.asarray([0, 2, 4, 6], jnp.uint8)

    @jax.jit
    def block(i):
        P = jax.random.uniform(jax.random.fold_in(key_p, i),
                               (K_FULL, SNP_BLOCK), minval=0.05, maxval=0.95)
        af = (Q @ P).T                                  # (snps, samples)
        u = jax.random.uniform(jax.random.fold_in(key_g, i),
                               (2,) + af.shape)
        g = (u[0] < af).astype(jnp.uint8) + (u[1] < af).astype(jnp.uint8)
        codes = code_of[g].reshape(g.shape[0], n // 4, 4) << shifts
        return codes.sum(axis=-1, dtype=jnp.uint8)     # (snps, N/4) bytes

    with open(path, "wb") as f:
        f.write(b"\x6c\x1b\x01")
        for i, m0 in enumerate(range(0, m, SNP_BLOCK)):
            rows = np.asarray(block(i))
            f.write(rows[:min(SNP_BLOCK, m - m0)].tobytes())
    stem = path[:-4]
    with open(stem + ".fam", "w") as f:
        f.write("".join(f"s{i} s{i} 0 0 0 -9\n" for i in range(n)))
    with open(stem + ".bim", "w") as f:
        f.write("".join(f"1 rs{j} 0 {j + 1} A C\n" for j in range(m)))


def full_width(work: str, n: int, m: int) -> None:
    bed = os.path.join(work, "synth.bed")
    t0 = time.time()
    write_synthetic_bed(bed, n, m)
    timed(f"synthetic BED {n} x {m:,} written", time.time() - t0)
    out = os.path.join(work, "full")
    common = ("--data_path", bed, "--save_dir", out, "--seed", 42,
              "--threads", THREADS, "--no_progress")
    assert_backend_gpu(cli("train", "--k", K_FULL, "--epochs", 2,
                           "--name", "k8", *common))
    check_outputs(f"{out}/k8", [K_FULL], n, m)
    assert_backend_gpu(cli("train", "--min_k", 2, "--max_k", 10,
                           "--epochs", 1, "--name", "sweep", *common))
    check_outputs(f"{out}/sweep", range(2, 11), n, m)
    assert_backend_gpu(cli("infer", "--name", "k8", "--save_dir", out,
                           "--data_path", bed, "--out_name", "k8_proj",
                           "--num_gpus", 1, "--threads", THREADS))
    check_outputs(f"{out}/k8_proj", [K_FULL], n, m, with_p=False)
    np.testing.assert_allclose(np.loadtxt(f"{out}/k8_proj.{K_FULL}.Q"),
                               np.loadtxt(f"{out}/k8.{K_FULL}.Q"), atol=1e-5)
    say("    full width: K=8 and K=2..10 train and infer outputs valid")


# ------------------------------- phase 4 ----------------------------------

# Tolerances of the op against the XLA step's own operations, both in f32
# (XLA at HIGHEST precision; the op's products are f32 FMAs on the CUDA
# cores). They differ only in summation order -- per-tile partial sums over
# 512 SNPs, then over tiles, against XLA's reduction tree over ~1M SNPs --
# which on the CPU at this width leaves 1e-7..6e-7 relative to the largest
# entry (tests/test_fused.py shapes scaled to 1M SNPs). The bounds leave
# 100x room for the GPU's different reduction trees.
TOLERANCE = {"loss": 1e-5, "Xp": 1e-4, "dQ": 1e-4, "dP": 1e-4, "dV": 1e-4}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def kernel_phase() -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from neural_admixture_tpu.models import qp
    from neural_admixture_tpu.ops import fused as F
    from neural_admixture_tpu.ops.loss import clamped_bce_sum
    from neural_admixture_tpu.ops.pack import unpack_dosage_x

    B, m_pad = B_STEP, M_PAD_STEP
    M = m_pad - 472
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=(B, m_pad // 4), dtype=np.uint8)
    u8[:, M // 4:] = 0                                  # SNP padding
    u8_dev = jnp.asarray(u8)
    u32 = jnp.asarray(u8.view("<u4"))
    rw = jnp.ones((B,), jnp.float32)
    cm = jnp.asarray((np.arange(m_pad) < M).astype(np.float32))
    enc_keys = ("rmsnorm", "common", "heads")

    def median_ms(fn, *args, reps=10):
        jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(ts))

    for ks in ([K_FULL], list(range(2, 11))):
        tag = "K=8" if len(ks) == 1 else "K=2..10"
        V = (rng.normal(size=(M, 8)) * 0.01).astype(np.float32)
        P0 = rng.uniform(0.05, 0.95, size=(sum(ks), M)).astype(np.float32)
        params = qp.init_params(jax.random.PRNGKey(0), V, P0, 1024, ks,
                                m_pad=m_pad)
        heads = sorted(params["heads"])

        # Batches reach every jitted function as arguments: a closed-over
        # device array would be compiled in as a constant.
        def xla_loss(p, u8, cm, rw):
            X = unpack_dosage_x(u8)
            recs, _ = qp.forward_train(p, X)
            return sum(clamped_bce_sum(recs[h], X, cm, rw) for h in heads)

        op = F.make_fused_training_loss(heads, with_loss=False)

        def fused_loss(p, u32, rw):
            enc = {k: p[k] for k in enc_keys}
            return op(p["V"], enc, p["decoders"], u32, rw)[0]

        # Accuracy, kernel by kernel: xv against X @ V, the heads kernel
        # (loss, dQ, dP) against XLA's BCE and its VJP at the same Q, dv
        # against X^T dXp at the same dXp.
        X = unpack_dosage_x(u8_dev)
        xp_ref = jnp.matmul(X, params["V"], precision="highest")
        xp = F.xv(u32, params["V"])
        qs = qp.encode_from_xp(params, xp_ref)
        qs_l = [qs[h] for h in heads]
        ps_l = [params["decoders"][h] for h in heads]

        def bce(q, P, X):
            return clamped_bce_sum(jnp.matmul(q, P, precision="highest"),
                                   X, cm, rw)

        # One head at a time: the heads' terms are independent, and all nine
        # (B, M) planes at once do not fit beside X.
        bce_grad = jax.jit(jax.value_and_grad(bce, argnums=(0, 1)))
        loss_ref, dq_ref, dp_ref = 0.0, [], []
        for q, P in zip(qs_l, ps_l):
            l_h, (dq_h, dp_h) = bce_grad(q, P, X)
            loss_ref += float(l_h)
            dq_ref.append(dq_h)
            dp_ref.append(dp_h)
        loss, dq, dp = F.heads(u32, qs_l, ps_l, rw, with_loss=True)
        dxp = jnp.asarray(rng.normal(size=(B, 8)), jnp.float32)
        dv_ref = jnp.matmul(X.T, dxp, precision="highest")
        dv = F.dv(u32, dxp)
        del X
        say(f"    {tag} BCE sum: op {float(loss)!r}, XLA (f64 sum of the "
            f"heads' f32 sums) {loss_ref!r}")
        err = {
            "loss": abs(float(loss) - loss_ref) / abs(loss_ref),
            "Xp": _rel(xp, xp_ref),
            "dQ": max(_rel(a, b) for a, b in zip(dq, dq_ref)),
            "dP": max(_rel(a, b) for a, b in zip(dp, dp_ref)),
            "dV": _rel(dv, dv_ref),
        }
        say(f"phase 4 {tag} op vs XLA, max |diff| / max |ref|, f32: "
            + ", ".join(f"{k} {v:.2e} (tol {TOLERANCE[k]:.0e})"
                        for k, v in err.items()))
        for k, v in err.items():
            assert v <= TOLERANCE[k], (tag, k, v)
        del dq_ref, dp_ref, dq, dp, dv_ref

        tx = optax.adam(2e-3, b1=0.9, b2=0.95, eps=1e-8)
        opt = tx.init(params)

        def make_step(loss_fn):
            @jax.jit
            def step(p, o, *batch):
                g = jax.grad(loss_fn)(p, *batch)
                upd, o = tx.update(g, o, p)
                return qp.restrict_P(optax.apply_updates(p, upd)), o
            return step

        steps = {"fused op": (make_step(fused_loss), (u32, rw)),
                 "XLA": (make_step(xla_loss), (u8_dev, cm, rw))}
        times = {}
        for name, (step, batch) in steps.items():
            mem = step.lower(params, opt, *batch).compile().memory_analysis()
            say(f"    {tag} {name} step memory: temp "
                f"{mem.temp_size_in_bytes / 2**30:.2f} GiB, arguments "
                f"{mem.argument_size_in_bytes / 2**30:.2f} GiB, output "
                f"{mem.output_size_in_bytes / 2**30:.2f} GiB")
            times[name] = median_ms(step, params, opt, *batch)
            say(f"    [{CARD}] {tag} train step ({name}, Adam + P clamp, "
                f"B={B}, m_pad={m_pad:,}): median {times[name]:.3f} ms "
                "of 10")
        say(f"    {tag}: fused op / XLA step time = "
            f"{times['fused op'] / times['XLA']:.3f}")


# ------------------------------- --four -----------------------------------

def four_cards(work: str, n: int, m: int) -> None:
    """K=8 full width, data-parallel over 4 cards and on a 2x2 mesh, each
    against the same run on one card (Adam-aware trajectory gate)."""
    from neural_admixture_tpu.utils.trajectory import assert_trajectory_close

    bed = os.path.join(work, "synth.bed")
    t0 = time.time()
    write_synthetic_bed(bed, n, m)
    timed(f"synthetic BED {n} x {m:,} written", time.time() - t0)
    runs = {"1 card": (("--num_gpus", 1), "1x1"),
            "--num_gpus 4": (("--num_gpus", 4), "4x1"),
            "--mesh 2x2": (("--mesh", "2x2"), "2x2")}
    results = {}
    for label, (flag, mesh) in runs.items():
        out = os.path.join(work, label.replace(" ", "_").replace("-", ""))
        lines = cli("train", "--k", K_FULL, "--epochs", 2, "--name", "k8",
                    "--batch_size", FOUR_BATCH,
                    "--data_path", bed, "--save_dir", out, "--seed", 42,
                    "--threads", THREADS, "--no_progress", *flag)
        assert_backend_gpu(lines)
        assert f"Mesh: {mesh} (data x snp)" in [ln.strip() for ln in lines]
        results[label] = load_checked(f"{out}/k8", K_FULL, n, m)
    Q1, P1 = results.pop("1 card")
    # The gate's absolute bound is 10 x its lr: one Adam step of +-lr per
    # sign flip. Two programs can flip a near-zero gradient's sign on every
    # one of the run's 2 x ceil(n / FOUR_BATCH) steps, so the bound is that
    # many steps x the CLI's learning rate.
    lr_gate = 2 * -(-n // FOUR_BATCH) * 20e-4 / 10
    for label, (Q, P) in results.items():
        assert_trajectory_close(Q, Q1, lr=lr_gate)
        assert_trajectory_close(P, P1, lr=lr_gate)
        say(f"    {label} vs 1 card: Q max |diff| {np.abs(Q - Q1).max():.2e}, "
            f"P max |diff| {np.abs(P - P1).max():.2e} (Adam-aware gate "
            "passed)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its comparison")
    ap.add_argument("--samples", type=int, default=N_FULL,
                    help="samples of the synthetic BED of phase 3 and --four "
                         "(a multiple of 64)")
    ap.add_argument("--snps", type=int, default=M_FULL,
                    help="SNPs of the synthetic BED of phase 3 and --four")
    args = ap.parse_args()
    if args.samples % 64:
        ap.error("--samples must be a multiple of 64")

    logger = logging.getLogger("neural_admixture_tpu")
    logger.propagate = False
    logger.setLevel(logging.INFO)
    logger.addHandler(_CAPTURE)

    from neural_admixture_tpu.utils.platform import enable_compile_cache
    enable_compile_cache()
    devs = device_phase(4 if args.four else 1)
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        if args.four:
            four_cards(work, args.samples, args.snps)
        else:
            t0 = time.time()
            kernel_phase()
            timed("phase 4 kernels", time.time() - t0)
            gc.collect()
            t0 = time.time()
            demo_gate(work)
            timed("phase 2 demo gate", time.time() - t0)
            t0 = time.time()
            full_width(work, args.samples, args.snps)
            timed("phase 3 full width", time.time() - t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
