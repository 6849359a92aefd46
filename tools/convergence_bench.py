#!/usr/bin/env python
"""Convergence benchmark: epochs needed to reach the reference golden
log-likelihood (BASELINE.md "epochs-to-match" row).

Trains the reference demo dataset (105 x 8451, K=7) in resumable segments
(exercising the checkpoint/resume path) and scores the log-likelihood of
the trained (Q, P) after each segment against the CONVERGED reference.

The converged target is a RANGE, not a point: the reference architecture
trained to its own 250-epoch default on the demo (via the line-cited
torch-CPU replica tools/reference_convergence.py, sklearn GMM init)
converges to a seed-dependent basin -- measured -301,867.5 / -305,178.4 /
-303,259.1 at seeds 42 / 1 / 7 (and this engine's plateaus fall inside
the same spread; swapping only the P init moves either implementation
across most of it). "Matched" therefore means ENTERING the reference's
measured converged range (LL >= -305,178.4, its worst-seed plateau);
epochs-to-best additionally reports reaching the best-seed plateau
(-301,867.5, within 0.01%) when the run's basin allows it. The
reference's shipped 5-epoch golden outputs score only ~-326,814;
NA_CONV_TARGET=golden selects that easier legacy bar. Prints one JSON
line:

  {"metric": "epochs_to_match_ll", "value": E, "unit": "epochs",
   "final_ll": ..., "target_ll": ..., "ll_curve": [[epoch, ll], ...]}

Environment overrides:
  NA_CONV_EPOCHS   total epochs (default 100)
  NA_CONV_SEGMENT  LL measurement cadence (default 5)
  NA_CONV_DATA     BED path (default: the reference demo)
  NA_CONV_K        K (default 7)
  NA_CONV_BLOCK    engine sample_block (gather granularity experiment)
  NA_CONV_TARGET   'converged' (default) | 'golden' (5-epoch expected files)
"""
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neural_admixture_tpu.io.bed import read_bed_packed  # noqa: E402
from neural_admixture_tpu.ops.loglikelihood import (  # noqa: E402
    loglikelihood_packed)
from neural_admixture_tpu.ops.rsvd import rsvd  # noqa: E402
from neural_admixture_tpu.train.engine import (  # noqa: E402
    NeuralAdmixtureTrainer, TrainConfig)
from neural_admixture_tpu.train.init import init_p_unsupervised  # noqa: E402
from neural_admixture_tpu.utils.platform import (  # noqa: E402
    enable_compile_cache)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(_REPO, "demo/data/demo_data.bed")
EXPECTED_Q = os.path.join(_REPO, "demo/expected/demo_run.7.Q.expected")
EXPECTED_P = os.path.join(_REPO, "demo/expected/demo_run.7.P.expected")
# tools/reference_convergence.py @ 250 epochs (the reference CLI default),
# demo data, K=7: best and worst converged plateaus over seeds {42, 1, 7}
# (-301,867.5 / -305,178.4 / -303,259.1). Matched = entering the range;
# best = within CONV_SLACK of the best-seed plateau.
REF_CONVERGED_BEST = -301867.5
REF_CONVERGED_WORST = -305178.4
CONV_SLACK = 1e-4


def synth_admixed(n: int, m: int, k: int, seed: int):
    """Synthetic admixed cohort from the ADMIXTURE generative model:
    Q ~ Dirichlet(0.2) rows (sparse ancestry mixes), P ~ U(0.05, 0.95),
    G_ij ~ Binomial(2, (Q P)_ij). Generated and packed in row blocks so
    the float allele-frequency matrix never exceeds block x m."""
    from neural_admixture_tpu.io.packed import pack_2bit_rows, packed_width
    rng = np.random.default_rng(seed)
    Q = rng.dirichlet(np.full(k, 0.2), size=n)
    P = rng.uniform(0.05, 0.95, size=(k, m))
    m_pad = ((m + 2047) // 2048) * 2048
    packed = np.empty((n, packed_width(m_pad)), dtype=np.uint8)
    rows = max(1, (1 << 28) // (8 * m))    # ~256 MB of float64 per block
    for i in range(0, n, rows):
        af = Q[i:i + rows] @ P
        G = rng.binomial(2, af).astype(np.uint8)
        packed[i:i + rows] = pack_2bit_rows(G, m_pad=m_pad)
    return packed, Q, P


def main() -> int:
    enable_compile_cache()
    total = int(os.environ.get("NA_CONV_EPOCHS", 100))
    seg = int(os.environ.get("NA_CONV_SEGMENT", 5))
    data_path = os.environ.get("NA_CONV_DATA", DEMO)
    K = int(os.environ.get("NA_CONV_K", 7))
    seed = 42

    # NA_CONV_SYNTH="N,M,K" benchmarks a synthetic admixed cohort instead
    # of a file: the target is the ORACLE log-likelihood (the generating
    # Q, P scored on the sampled genotypes), and recovery of the true Q is
    # reported as Hungarian-matched column correlations.
    synth = os.environ.get("NA_CONV_SYNTH")
    Q_true = None
    if synth:
        N, M, K = (int(x) for x in synth.split(","))
        packed, Q_true, P_true = synth_admixed(N, M, K, seed)
        data_path = f"synthetic({N}x{M},K={K})"
        target_ll = float(loglikelihood_packed(
            packed, M, np.ascontiguousarray(P_true.T.astype(np.float64)),
            np.ascontiguousarray(Q_true.astype(np.float64))))
    else:
        packed, N, M = read_bed_packed(data_path)
        if data_path != DEMO:
            target_ll = float("nan")
        elif os.environ.get("NA_CONV_TARGET") == "golden":
            # Legacy bar: the reference's shipped 5-epoch golden outputs.
            Qe = np.genfromtxt(EXPECTED_Q)
            Pe = np.genfromtxt(EXPECTED_P)
            target_ll = float(loglikelihood_packed(
                packed, M, np.ascontiguousarray(Pe.astype(np.float64)),
                np.ascontiguousarray(Qe.astype(np.float64))))
        else:
            # The real bar: the converged reference's measured range (see
            # module docstring); matched = entering it.
            target_ll = REF_CONVERGED_WORST
    V = rsvd(packed, N, M, 8, seed)
    P_init = init_p_unsupervised(packed, V, N, M, [K], seed)

    curve = []
    matched = None
    matched_best = None
    best_ll = REF_CONVERGED_BEST - CONV_SLACK * abs(REF_CONVERGED_BEST)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "conv_ckpt.npz")
        for e in range(seg, total + 1, seg):
            cfg = TrainConfig(
                epochs=e,
                batch_size=int(os.environ.get("NA_CONV_BATCH", 800)),
                seed=seed, ks=[K], progress=False,
                checkpoint_every=seg, checkpoint_path=ckpt, resume=True,
                sample_block=int(os.environ.get("NA_CONV_BLOCK", "1")))
            tr = NeuralAdmixtureTrainer(cfg)
            Qs, Ps, _ = tr.launch_training(P_init, packed, V, M, N)
            ll = float(loglikelihood_packed(
                packed, M,
                np.ascontiguousarray(Ps[0].astype(np.float64)),
                np.ascontiguousarray(Qs[0].astype(np.float64))))
            curve.append([e, round(ll, 1)])
            print(f"# epoch {e:4d}  ll {ll:,.1f}  (target {target_ll:,.1f})",
                  file=sys.stderr, flush=True)
            if matched is None and ll >= target_ll:
                matched = e
            if matched_best is None and ll >= best_ll:
                matched_best = e

    q_corr = None
    if Q_true is not None:
        # Recovery of the generating Q: Hungarian-matched mean column
        # correlation (column order is arbitrary across runs).
        from scipy.optimize import linear_sum_assignment
        Qf = np.asarray(Qs[0])
        corr = np.array([[np.corrcoef(Qf[:, i], Q_true[:, j])[0, 1]
                          for j in range(K)] for i in range(K)])
        r, c = linear_sum_assignment(-np.nan_to_num(corr))
        q_corr = round(float(np.mean(corr[r, c])), 4)

    out = {
        "metric": "epochs_to_match_ll",
        "value": matched if matched is not None else -1,
        "unit": "epochs",
        "workload": data_path,
        "final_ll": curve[-1][1],
        "target_ll": round(target_ll, 1),
        "epochs_to_best_seed_plateau": matched_best if matched_best else -1,
        "seconds": round(time.time() - t0, 1),
        "ll_curve": curve,
    }
    if q_corr is not None:
        out["q_corr_vs_truth"] = q_corr
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
