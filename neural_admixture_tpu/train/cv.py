"""K-fold cross-validation for choosing K (the classic ADMIXTURE workflow).

The reference SHIPS this only as dead code: the ``--cv`` flag and the whole
``perform_cross_validation`` body are commented out and call helpers
(``utils.process_cv_loglikelihood``, ``utils.save_cv_error_plot``) that do
not exist anywhere in its tree
(/root/reference/neural_admixture/entry.py:48,
/root/reference/neural_admixture/src/main.py:47-79). This module implements
it for real, keeping the dead code's structure: KFold(shuffle=True,
random_state=seed) over samples, per-fold training, per-K validation
scores reduced to mean +/- std and logged as
``CV error (K=k): mean ± std``.

Definitions (the reference's phantom helpers left them unspecified):
  * each fold trains ONE multi-head model on the training rows (all Ks
    jointly -- this engine's multi-head training shares every pass, so a
    K sweep costs ~5x less than the reference's per-K loop would);
  * held-out samples are PROJECTED through the trained encoder (the same
    operation as `infer`), giving Q_val;
  * cv_error(K) = -loglikelihood(G_val | P_K, Q_val) / n_val -- the
    per-sample negative validation log-likelihood (lower is better),
    the masked-genotype-free analogue of ADMIXTURE's CV deviance.

Results are logged, written to ``{name}.cv_errors.csv``, and returned.
Single-process only (each fold re-slices the packed rows on host).
"""
from typing import Dict, List, Tuple

import numpy as np

from ..utils.logger import log

__all__ = ["kfold_indices", "run_cross_validation"]


def kfold_indices(N: int, n_splits: int, seed: int
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train_idx, val_idx) per fold, matching sklearn
    KFold(n_splits, shuffle=True, random_state=seed) exactly (the split
    the reference's dead code builds at src/main.py:62): RandomState
    shuffle, then contiguous test blocks with the first N % n_splits
    folds one larger."""
    if not 2 <= n_splits <= N:
        raise ValueError(
            f"--cv needs between 2 and N={N} folds, got {n_splits}.")
    idx = np.arange(N)
    np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(n_splits, N // n_splits, dtype=np.int64)
    sizes[: N % n_splits] += 1
    folds, start = [], 0
    for sz in sizes:
        val = idx[start:start + sz]
        train = np.concatenate([idx[:start], idx[start + sz:]])
        folds.append((np.sort(train), np.sort(val)))
        start += sz
    return folds




def run_cross_validation(packed: np.ndarray, N: int, M: int,
                         ks: List[int], n_splits: int, seed: int,
                         trainer_cfg, name: str, save_dir: str,
                         pops: np.ndarray = None) -> Dict[int, Tuple[float, float]]:
    """Run the folds; returns {K: (cv_error_mean, cv_error_std)}."""
    import os

    from ..ops.loglikelihood import loglikelihood_packed
    from ..ops.rsvd import rsvd
    from .engine import NeuralAdmixtureTrainer
    from .init import init_p_supervised_packed, init_p_unsupervised

    log.info(f"    Performing {n_splits}-fold cross-validation...")
    errs: Dict[int, List[float]] = {k: [] for k in ks}
    for f, (tr_idx, val_idx) in enumerate(
            kfold_indices(N, n_splits, seed)):
        packed_tr = np.ascontiguousarray(packed[tr_idx])
        packed_val = np.ascontiguousarray(packed[val_idx])
        n_tr, n_val = tr_idx.size, val_idx.size
        V = rsvd(packed_tr, n_tr, M, trainer_cfg.n_components, seed)
        if pops is not None:
            P_init = init_p_supervised_packed(packed_tr, pops[tr_idx],
                                              ks[0], M)
        else:
            P_init = init_p_unsupervised(packed_tr, V, n_tr, M, ks, seed)
        import copy
        cfg_f = copy.deepcopy(trainer_cfg)
        cfg_f.progress = False
        cfg_f.checkpoint_every = 0
        cfg_f.resume = False
        trainer = NeuralAdmixtureTrainer(cfg_f)
        _, Ps, params = trainer.launch_training(
            P_init, packed_tr, V, M, n_tr,
            pops=pops[tr_idx] if pops is not None else None)
        # Project held-out rows through the trained encoder -- the same
        # helper `infer` uses (the fused xv kernel on the GPU).
        from ..infer import infer_q
        q_val = infer_q(params, packed_val, n_val, ks)
        for i, k in enumerate(ks):
            ll = float(loglikelihood_packed(
                packed_val, M,
                np.ascontiguousarray(Ps[i].astype(np.float64)),
                np.ascontiguousarray(q_val[i].astype(np.float64))))
            errs[k].append(-ll / n_val)
        log.info(f"        Fold {f + 1}/{n_splits} done "
                 f"({n_tr} train / {n_val} validation samples).")

    out: Dict[int, Tuple[float, float]] = {}
    lines = ["K,cv_error_mean,cv_error_std"]
    for k in ks:
        mean = float(np.mean(errs[k]))
        std = float(np.std(errs[k]))
        out[k] = (mean, std)
        # Same log format as the reference's dead code (src/main.py:76-77).
        log.info(f"CV error (K={k}): {mean:.5f} ± {std:.3f}")
        lines.append(f"{k},{mean:.6f},{std:.6f}")
    path = os.path.join(save_dir, f"{name}.cv_errors.csv")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    log.info(f"    CV errors written to {path}.")
    _save_cv_error_plot(out, ks, os.path.join(save_dir,
                                              f"{name}.cv_errors.png"))
    best = min(out, key=lambda k: out[k][0])
    log.info(f"    Lowest CV error at K={best}.")
    return out


def _save_cv_error_plot(out, ks, path: str) -> None:
    """CV-error-vs-K elbow plot (the reference's phantom
    utils.save_cv_error_plot, src/main.py:79). Best-effort: skipped
    without matplotlib or with a single K."""
    if len(ks) < 2:
        return
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        means = [out[k][0] for k in ks]
        stds = [out[k][1] for k in ks]
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.errorbar(ks, means, yerr=stds, marker="o", capsize=3)
        ax.set_xlabel("K")
        ax.set_ylabel(
            "CV error (per-sample negative validation log-likelihood)")
        ax.set_xticks(list(ks))
        ax.set_title("Cross-validation error by K")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
    except Exception as e:  # noqa: BLE001 - an optional plot must never
        # abort the run before the full-data fit (broken backend cache,
        # font-cache OSError, read-only dir...); the csv already has the
        # numbers.
        log.info(f"    CV error plot skipped ({type(e).__name__}: {e}).")
        return
    log.info(f"    CV error plot written to {path}.")
