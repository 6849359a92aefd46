#!/usr/bin/env python
"""Measure the REFERENCE architecture's converged log-likelihood on the demo.

BASELINE.md's "epochs-to-match" metric needs a converged-reference target;
the shipped golden outputs are only a 5-epoch run (they score ~-326,814).
This script runs a faithful torch-CPU replica of the reference's full
training loop -- same model, init, sampling, optimizer, and epoch count
(/root/reference/neural_admixture/model/neural_admixture.py:157-177,324-431,
model/train.py:44-84, entry.py:27-45 defaults: 250 epochs, batch 800,
lr 2e-3, Adam(0.9, 0.95), hidden 1024, D=8) -- on the demo BED and records
the LL trajectory. The replica, not the reference package itself, because
the reference's Cython extensions cannot be built here without installing
into the environment; every numerical choice below cites the line it
mirrors.

Prints one JSON line:
  {"metric": "reference_converged_ll", "value": LL, "epochs": E,
   "ll_curve": [[epoch, ll], ...]}

Env: NA_REFCONV_EPOCHS (default 250), NA_REFCONV_DATA, NA_REFCONV_K (7),
NA_REFCONV_EVERY (LL cadence, default 10).
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neural_admixture_tpu.io.bed import read_bed  # noqa: E402
from neural_admixture_tpu.io.packed import pack_with_padding  # noqa: E402
from neural_admixture_tpu.ops.loglikelihood import loglikelihood  # noqa: E402
from neural_admixture_tpu.ops.rsvd import rsvd  # noqa: E402

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "demo/data/demo_data.bed")


def gmm_p_init(G, V, K, seed):
    """Reference P init (model/train.py:49-67): PCA-project X = G/2 in
    blocks, sklearn GaussianMixture(k-means++, full covariance, n_init=5),
    P = clip(means @ V, 5e-6, 1 - 5e-6)."""
    from sklearn.mixture import GaussianMixture
    X_pca = (G.astype(np.float32) / 2.0) @ V.T  # (N, D)
    gm = GaussianMixture(n_components=K, init_params="k-means++", n_init=5,
                         tol=1e-4, covariance_type="full", max_iter=100,
                         random_state=seed).fit(X_pca)
    return np.clip(gm.means_ @ V, 5e-6, 1 - 5e-6).astype(np.float32)


def main() -> int:
    import torch

    epochs = int(os.environ.get("NA_REFCONV_EPOCHS", 250))
    every = int(os.environ.get("NA_REFCONV_EVERY", 10))
    data_path = os.environ.get("NA_REFCONV_DATA", DEMO)
    K = int(os.environ.get("NA_REFCONV_K", 7))
    seed = 42
    batch_size, lr, hidden, D = 800, 2e-3, 1024, 8  # entry.py:27-45

    G = read_bed(data_path)  # (N, M) uint8 dosages, 3 = missing
    N, M = G.shape
    packed, _ = pack_with_padding(G)
    V_np = rsvd(packed, N, M, D, seed)  # (D, M), same algo as svd.py:39-84
    P_init = gmm_p_init(G, V_np, K, seed)

    torch.manual_seed(seed)
    # Model: neural_admixture.py:100-177 (V trainable, RMSNorm eps 1e-8,
    # shared Linear(D, H)+ReLU, head Linear(H, K), softmax, decoder
    # Linear(K, M, bias=False) initialized to P_init^T, clamp [0, 1]).
    V = torch.nn.Parameter(torch.from_numpy(np.ascontiguousarray(V_np.T)))
    norm = torch.nn.RMSNorm(D, eps=1e-8)
    common = torch.nn.Sequential(torch.nn.Linear(D, hidden), torch.nn.ReLU())
    head = torch.nn.Linear(hidden, K)
    dec = torch.nn.Linear(K, M, bias=False)
    with torch.no_grad():
        dec.weight.copy_(torch.from_numpy(P_init.T))
    params = ([V] + list(norm.parameters()) + list(common.parameters())
              + list(head.parameters()) + list(dec.parameters()))
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.95))  # :187-204
    lossf = torch.nn.BCELoss(reduction="sum")  # :288

    Xg = torch.from_numpy(G.astype(np.int64))
    x_full = Xg.float() / 2
    x_full = torch.where(Xg == 3, torch.tensor(0.0), x_full)  # :169-170

    gen = torch.Generator().manual_seed(seed)

    def q_of(x):
        return torch.softmax(head(common(norm(x @ V))), dim=1)

    def ll_now():
        with torch.no_grad():
            Q = q_of(x_full).numpy().astype(np.float64)
            P = dec.weight.detach().numpy().astype(np.float64)  # (M, K)
        return float(loglikelihood(G, np.ascontiguousarray(P),
                                   np.ascontiguousarray(Q), K))

    curve = []
    t0 = time.time()
    for epoch in range(1, epochs + 1):
        # RandomSampler + DataLoader(batch_size) per epoch (loaders.py:26-33)
        order = torch.randperm(N, generator=gen)
        for i in range(0, N, batch_size):
            idx = order[i:i + batch_size]
            x = x_full[idx]
            opt.zero_grad(set_to_none=True)
            rec = torch.clamp(dec(q_of(x)), 0, 1)  # :96-97
            loss = lossf(rec, x)  # :431
            loss.backward()
            opt.step()
            with torch.no_grad():
                dec.weight.clamp_(0, 1)  # restrict_P :179-185
        if epoch % every == 0 or epoch == epochs:
            ll = ll_now()
            curve.append([epoch, round(ll, 1)])
            print(f"# epoch {epoch:4d}  ll {ll:,.1f}", file=sys.stderr,
                  flush=True)

    print(json.dumps({
        "metric": "reference_converged_ll",
        "value": curve[-1][1],
        "epochs": epochs,
        "workload": data_path,
        "seconds": round(time.time() - t0, 1),
        "ll_curve": curve,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
