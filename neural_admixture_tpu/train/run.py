"""Train-mode orchestration: read -> pack -> RSVD -> init P -> train -> save.

Combines the responsibilities of the reference's entry/train orchestration
(/root/reference/neural_admixture/entry.py:179-193,
/root/reference/neural_admixture/src/main.py:19-46,
/root/reference/neural_admixture/model/train.py:19-149) into one pipeline.

BED input takes the packed-native path: genotypes go straight from BED bytes
to the sample-major 2-bit layout (native C++ decoder when built), and every
consumer -- RSVD, GMM/supervised init, training, final log-likelihood --
operates on packed rows, so the (N, M) uint8 matrix never materializes in
host memory (the reference holds it in shared memory, entry.py:186, which
is untenable at biobank scale). PGEN and VCF stream the same way;
only formats without a packed reader decode densely first.
"""
import time
from pathlib import Path

import numpy as np

from ..io.bed import read_bed_packed
from ..io.packed import pack_with_padding
from ..io.snp_reader import read_data
from ..io.writers import save_checkpoint, save_config, write_outputs
from ..ops.loglikelihood import loglikelihood, loglikelihood_packed
from ..ops.rsvd import rsvd
from ..parallel.distributed import is_master, shutdown_distributed
from ..utils.logger import log, setup_logging
from .engine import NeuralAdmixtureTrainer, TrainConfig
from .init import (encode_populations, init_p_supervised,
                   init_p_supervised_packed, init_p_unsupervised)


def _read_pops(pops_path):
    if not pops_path:
        return None
    log.info("    Population file provided!")
    with open(pops_path, "r") as fb:
        # Skip blank lines, matching io.bed.read_bed_dims's .fam handling
        # (a shared trailing newline would otherwise make the label count
        # disagree with the sample count, or '' a phantom ancestry).
        return [p.strip() for p in fb.readlines() if p.strip()]


def _resolve_mesh_shape(args):
    """(n_data, n_snp) from --mesh 'DxS', else --num_gpus (all-DP), else
    None (engine auto-policy over all visible devices)."""
    mesh = getattr(args, "mesh", None)
    if mesh:
        n_data, n_snp = (int(s) for s in mesh.lower().split("x"))
        return (n_data, n_snp)
    if int(args.num_gpus) > 0:
        return (int(args.num_gpus), 1)
    return None


def main_train(args, t0: float) -> int:
    setup_logging()
    if args.k is not None:
        K, min_k, max_k = int(args.k), None, None
        ks = [K]
    else:
        K, min_k, max_k = None, int(args.min_k), int(args.max_k)
        ks = list(range(min_k, max_k + 1))

    # Host-streaming (out-of-core) control, threaded through every phase
    # that would otherwise make the packed matrix device-resident (RSVD,
    # PCA projection, training). None = auto by size. YAML configs bypass
    # argparse's choices check and may supply ints/bools (`stream: 0`,
    # `stream: true`), so normalize robustly: a falsy 0 must mean
    # FORCED-RESIDENT, not auto.
    stream_raw = getattr(args, "stream", "auto")
    stream_map = {"auto": None, None: None, "0": False, 0: False,
                  False: False, "1": True, 1: True, True: True}
    if stream_raw not in stream_map:
        raise ValueError(f"--stream must be auto, 0, or 1; got "
                         f"{stream_raw!r}")
    stream_cli = stream_map[stream_raw]
    cfg = TrainConfig(
        epochs=int(args.epochs), batch_size=int(args.batch_size),
        learning_rate=float(args.learning_rate), seed=int(args.seed),
        hidden_size=int(args.hidden_size), n_components=int(args.n_components),
        supervised_loss_weight=float(args.supervised_loss_weight), ks=ks,
        progress=not getattr(args, "no_progress", False),
        profile_dir=getattr(args, "profile_dir", None),
        checkpoint_every=int(getattr(args, "checkpoint_every", 0) or 0),
        checkpoint_path=str(Path(args.save_dir) / f"{args.name}_ckpt.npz"),
        resume=bool(getattr(args, "resume", False)),
        sample_block=int(getattr(args, "sample_block", 1) or 1),
        stream=stream_cli,
        # --mesh DxS pins the (data, snp) mesh explicitly; --num_gpus N>0
        # pins the device count, all data-parallel (reference semantics);
        # otherwise auto (all visible devices, snp axis engaged only when
        # the SNP-plane state exceeds the per-device memory budget).
        mesh_shape=_resolve_mesh_shape(args))
    if cfg.checkpoint_every or cfg.resume:
        Path(args.save_dir).mkdir(parents=True, exist_ok=True)

    try:
        # ------------------------- input pipeline --------------------------
        # BED, PGEN, and VCF stream straight into the sample-major 2-bit
        # packed layout (no (N, M) uint8 matrix on host). Multi-process runs
        # read only this host's row block (BED/PGEN).
        import jax
        suffixes = Path(args.data_path).suffixes
        # Formats that stream straight into the 2-bit packed layout; all
        # three also support per-host ROW-BLOCK reads (multi-process) --
        # VCF stores samples as columns, so each host makes one streaming
        # pass parsing only its own column slice.
        packed_native = (".bed" in suffixes or ".pgen" in suffixes
                         or ".vcf" in suffixes)
        # FIRST backend contact (is_master -> jax.process_index starts the
        # runtime; with several GPUs or hosts that takes a while) -- log
        # before touching it, and only construct the trainer (whose master
        # flag needs the backend) after.
        log.info("    Initializing the JAX backend...")
        n_proc = jax.process_count()
        log.info(f"    Backend '{jax.default_backend()}' with "
                 f"{len(jax.devices())} device(s).")
        trainer = NeuralAdmixtureTrainer(cfg, master=is_master())
        data, host_rows = None, None
        if n_proc > 1:
            assert packed_native, (
                "Multi-process training requires BED, PGEN, or VCF input "
                "(each host reads only its sample rows).")
            from math import ceil
            from ..io.bed import (flip_packed_minor_allele,
                                  rezero_flip_padding)
            from ..parallel.distributed import allsum_hosts
            if ".bed" in suffixes:
                from ..io.bed import read_bed_dims, read_bed_packed_rows
                log.info("    Input format is BED.")
                N, M = read_bed_dims(args.data_path)
                read_rows = read_bed_packed_rows
            elif ".pgen" in suffixes:
                from ..io.pgen import pgen_dims, read_pgen_packed_rows
                log.info("    Input format is PGEN.")
                N, M = pgen_dims(args.data_path)
                read_rows = read_pgen_packed_rows
            else:
                from ..io.vcf import read_vcf_packed_rows, vcf_dims
                log.info("    Input format is VCF.")
                N, M = vcf_dims(args.data_path)
                read_rows = read_vcf_packed_rows
            start, end, _ = trainer.sample_shard(ceil(M / 2048) * 2048, N)
            host_rows = (start, end)
            packed, counts_local = read_rows(args.data_path, start, end)
            # The minor-allele flip needs the GLOBAL dosage mean.
            counts = allsum_hosts(counts_local)
            assert counts[0] > 0 and (counts[2] > 0 or counts[3] > 0), (
                "Only biallelic SNPs are supported. Please make sure "
                "multiallelic sites have been removed.")
            if (counts * np.arange(4)).sum() / max(1, counts.sum()) >= 1:
                packed = rezero_flip_padding(
                    flip_packed_minor_allele(packed), M)
            log.info(f"    Data contains {N} samples and {M} SNPs "
                     f"({n_proc} hosts; this one holds rows "
                     f"[{start}, {end})).")
            pops = _read_pops(args.pops_path or None)
        elif packed_native:
            if ".bed" in suffixes:
                log.info("    Input format is BED.")
                packed, N, M = read_bed_packed(args.data_path)
            elif ".pgen" in suffixes:
                log.info("    Input format is PGEN.")
                from ..io.pgen import read_pgen_packed
                packed, N, M = read_pgen_packed(args.data_path)
            else:
                log.info("    Input format is VCF.")
                from ..io.vcf import read_vcf_packed
                packed, N, M = read_vcf_packed(args.data_path)
            log.info(f"    Data contains {N} samples and {M} SNPs.")
            pops = _read_pops(args.pops_path or None)
        else:
            data, pops, N, M = read_data(args.data_path, args.pops_path or None)
            packed, _ = pack_with_padding(data)

        log.info("")
        log.info("    Running SVD...")
        log.info("")
        t_svd = time.time()
        V = rsvd(packed, N, M, int(args.n_components), int(args.seed),
                 rows=host_rows, stream=stream_cli)
        log.info(f"    Total time SVD: {time.time() - t_svd:.4f}s")
        log.info("")

        y_num = None
        if pops is not None:
            assert K is not None, "Supervised mode requires --k (a single K)."
            assert len(pops) == N, (
                f"Population file has {len(pops)} labels but the data has {N} "
                "samples.")
            log.info("")
            log.info("    Running Supervised Mode...")
            log.info("")
            y_num, _ = encode_populations(pops, K)
            if packed_native:
                P_init = init_p_supervised_packed(packed, y_num, K, M,
                                                  rows=host_rows)
            else:
                P_init = init_p_supervised(data, y_num, K)
        else:
            log.info("")
            log.info("    Running Gaussian Mixture in PCA subspace...")
            log.info("")

        # --------------------------- cross-validation -----------------------
        # --cv N: the reference declares the flag but ships the whole
        # implementation commented out (entry.py:48, src/main.py:47-79,
        # calling helpers that do not exist in its tree); here it runs for
        # real before the full-data fit (train/cv.py).
        cv_folds = int(getattr(args, "cv", 0) or 0)
        if cv_folds:
            assert n_proc == 1, \
                "--cv runs single-process (each fold re-slices sample rows)."
            from .cv import run_cross_validation
            if is_master():
                Path(args.save_dir).mkdir(parents=True, exist_ok=True)
            run_cross_validation(packed, N, M, sorted(ks), cv_folds,
                                 int(args.seed), cfg, args.name,
                                 args.save_dir, pops=y_num)

        # ------------------------------ train ------------------------------
        # --init_restarts R: train R independently seeded runs (fresh GMM
        # init + training RNG per restart) and keep the one with the best
        # total log-likelihood. Motivated by measurement, not speculation:
        # the converged basin on the demo varies by ~3,000 LL with the init
        # draw for BOTH this engine and the reference architecture (see
        # BASELINE.md); restarts recover that spread the same way classic
        # ADMIXTURE practice reruns seeds. The reference has no equivalent
        # (one GMM init, one run). Seeds are rank-deterministic, so every
        # process selects the same winner without communication.
        restarts = max(1, int(getattr(args, "init_restarts", 1) or 1))

        def _lls(Qs, Ps):
            """Per-K log-likelihoods (reference: model/train.py:134-146);
            multi-process sums each host's local-row partials -- a
            collective all ranks must join."""
            out = []
            for i, _k in enumerate(sorted(ks)):
                P64 = np.ascontiguousarray(Ps[i].astype(np.float64))
                Q64 = np.ascontiguousarray(Qs[i].astype(np.float64))
                if host_rows is not None:
                    from ..parallel.distributed import allsum_hosts
                    out.append(float(allsum_hosts(np.asarray(
                        loglikelihood_packed(
                            packed, M, P64,
                            Q64[host_rows[0]:host_rows[1]])))))
                elif packed_native:
                    out.append(float(loglikelihood_packed(packed, M, P64,
                                                          Q64)))
                else:
                    out.append(float(loglikelihood(data, P64, Q64, _k)))
            return out

        best = None
        base_ckpt = trainer.cfg.checkpoint_path
        # The PCA projection depends only on (packed, V), not the restart
        # seed: compute the full-matrix pass once and reuse it across
        # restarts (R - 1 redundant out-of-core passes otherwise).
        x_pca = None
        if y_num is None and restarts > 1:
            from .init import pca_coords
            x_pca = pca_coords(packed, V, N, rows=host_rows,
                               stream=stream_cli)
        for r in range(restarts):
            seed_r = int(args.seed) + r
            if restarts > 1 and is_master():
                log.info(f"    Restart {r + 1}/{restarts} (seed {seed_r})...")
            if y_num is None:
                P_init = init_p_unsupervised(packed, V, N, M, ks, seed_r,
                                             rows=host_rows,
                                             stream=stream_cli, x_pca=x_pca)
            trainer.cfg.seed = seed_r
            if base_ckpt and restarts > 1:
                trainer.cfg.checkpoint_path = base_ckpt.replace(
                    ".npz", f"_r{r}.npz")
            Qs, Ps, params = trainer.launch_training(P_init, packed, V, M, N,
                                                     pops=y_num,
                                                     host_rows=host_rows)
            lls = _lls(Qs, Ps)
            if best is None or sum(lls) > sum(best[3]):
                best = (Qs, Ps, params, lls)
        Qs, Ps, params, lls = best
        trainer.cfg.seed = int(args.seed)
        trainer.cfg.checkpoint_path = base_ckpt

        for i, k in enumerate(sorted(ks)):
            if is_master():
                suffix = "" if K is not None else f" for K={k}"
                # ':2f' (not ':.2f') mirrors the reference's own format
                # quirk verbatim (model/train.py:140,146) -- log-scraping
                # parity beats prettiness here.
                log.info(f"    Log-likelihood{suffix}: {lls[i]:2f}.")

        if is_master():
            Path(args.save_dir).mkdir(parents=True, exist_ok=True)
            save_checkpoint(params, args.name, args.save_dir,
                            strip_decoders=True)
            # Also export the reference's torch .pt format (decoder-stripped,
            # exact-M V) so its tooling can consume models trained here and
            # output files are a superset of the reference's
            # (/root/reference/neural_admixture/src/main.py:40-43).
            try:
                from ..io.torch_interop import save_pt_checkpoint
                save_pt_checkpoint(params, args.name, args.save_dir,
                                   num_snps=M)
            except ImportError:
                log.info("    torch not available; skipping the .pt export.")
            save_config(args.name, args.save_dir, ks=sorted(ks),
                        num_features=V.shape[0],
                        hidden_size=int(args.hidden_size), num_snps=M)
            write_outputs(Qs, args.name, K, min_k, max_k, args.save_dir, Ps)
    except Exception:
        # Tear down the multi-process runtime before re-raising so peer
        # processes fail fast instead of hanging on a dead collective
        # (reference: src/main.py:119-133 tears down the NCCL group).
        shutdown_distributed()
        raise

    log.info("")
    log.info(f"    Total elapsed time: {time.time() - t0:.2f} seconds.")
    log.info("")
    return 0
