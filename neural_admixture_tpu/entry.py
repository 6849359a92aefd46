"""CLI entry point: ``neural-admixture-tpu {train,infer}``.

Drop-in flag surface of the reference CLI
(/root/reference/neural_admixture/entry.py:20-67), including YAML config-file
support (``--config file.yaml``; the reference uses configargparse with a
YAML parser) and the same argument validation (:110-132).

Differences, by design:
  * no ``mp.spawn`` process launch -- one process drives all the GPUs of a
    host: multi-device scaling comes from jax.sharding over a device mesh
    (see neural_admixture_tpu.parallel), and XLA runs the collectives over
    NCCL; several hosts run one process each (parallel.distributed);
  * ``--num_gpus`` keeps its reference meaning, the number of devices
    (0 = CPU for ``infer``).
"""
import argparse
import logging
import os
import sys
import time
from typing import List, Optional


def _early_pin_threads() -> None:
    """BLAS/OpenMP pools size themselves at ``import numpy`` -- which the
    imports just below trigger -- so ``--threads`` must reach the
    environment BEFORE them (setting OPENBLAS_NUM_THREADS after the pool
    exists is ignored). Scans sys.argv directly; no-op when the flag is
    absent. Best-effort: an embedding process that already imported numpy
    (e.g. a sitecustomize) has sized its pools. Programmatic
    ``main(argv)`` callers bypass sys.argv and get only the late
    ``_pin_threads`` (kept for them and for the log line)."""
    val = None
    for i, tok in enumerate(sys.argv):
        if tok == "--threads" and i + 1 < len(sys.argv):
            val = sys.argv[i + 1]
        elif tok.startswith("--threads="):
            val = tok.split("=", 1)[1]
    if val and val.isdigit():
        _pin_threads(int(val))


def _pin_threads(threads: int) -> None:
    for var in ("NUMEXPR_MAX_THREADS", "NUMEXPR_NUM_THREADS",
                "MKL_MAX_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_MAX_THREADS", "OPENBLAS_NUM_THREADS",
                "OMP_MAX_THREADS", "OMP_NUM_THREADS"):
        os.environ[var] = str(threads)


_early_pin_threads()

from .utils.logger import log, setup_logging  # noqa: E402
from .utils.seeding import set_seed  # noqa: E402

__version__ = "0.1.0"


class _ConfigParser(argparse.ArgumentParser):
    """ArgumentParser that records its own actions as ``add_argument``
    returns them, so YAML config support needs no argparse private API
    (the documented ``add_argument`` return value IS the Action)."""

    def __init__(self, *a, **kw):
        # Before super().__init__: the base constructor itself registers
        # the -h/--help action through add_argument.
        self.config_actions: List[argparse.Action] = []
        super().__init__(*a, **kw)

    def add_argument(self, *a, **kw):
        action = super().add_argument(*a, **kw)
        self.config_actions.append(action)
        return action


def _add_config_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", required=False, default=None, type=str,
                        help="YAML file with default values for any flag.")


def _apply_yaml_defaults(parser: "_ConfigParser", argv: List[str]):
    """configargparse-style YAML config support: values in the YAML file
    become parser defaults (CLI flags still win), and required flags
    provided by the file are no longer demanded on the command line."""
    # argparse (allow_abbrev default) accepts unambiguous abbreviations
    # like '--conf'; the pre-scan must accept exactly the same spellings
    # or the file would be swallowed by argparse yet its defaults ignored.
    opts = [s for a in parser.config_actions for s in a.option_strings
            if s.startswith("--")]

    def _is_config_flag(tok: str) -> bool:
        if not tok.startswith("--") or len(tok) < 3:
            return False
        return [o for o in opts if o.startswith(tok)] == ["--config"]

    cfg_path = None
    for i, tok in enumerate(argv):
        head, _, tail = tok.partition("=")
        if _is_config_flag(head):
            cfg_path = tail if tail else (
                argv[i + 1] if i + 1 < len(argv) else None)
    if not cfg_path:
        return
    import yaml
    with open(cfg_path, "r") as fb:
        cfg = yaml.safe_load(fb) or {}
    dests = {a.dest: a for a in parser.config_actions}
    unknown = [k for k in cfg if k not in dests]
    if unknown:
        parser.error(f"unknown keys in config file {cfg_path}: {unknown}")
    for key, value in list(cfg.items()):
        action = dests[key]
        # YAML scalars like "1e-4" resolve to strings under YAML 1.1; apply
        # the flag's argparse type converter (as configargparse does).
        if action.type is not None and isinstance(value, str):
            cfg[key] = action.type(value)
    parser.set_defaults(**cfg)
    for action in parser.config_actions:
        if action.required and action.dest in cfg:
            action.required = False


def parse_train_args(argv: List[str]) -> argparse.Namespace:
    parser = _ConfigParser(
        prog="neural-admixture train",
        description="Rapid population clustering with autoencoders - training mode")
    _add_config_arg(parser)
    parser.add_argument("--epochs", required=False, type=int, default=250,
                        help="Maximum number of epochs.")
    parser.add_argument("--batch_size", required=False, default=800, type=int,
                        help="Batch size.")
    parser.add_argument("--learning_rate", required=False, default=20e-4,
                        type=float, help="Learning rate.")
    parser.add_argument("--seed", required=False, type=int, default=42, help="Seed")
    parser.add_argument("--k", required=False, type=int,
                        help="Number of populations/clusters.")
    parser.add_argument("--min_k", required=False, type=int,
                        help="Minimum number of populations/clusters (multi-head)")
    parser.add_argument("--max_k", required=False, type=int,
                        help="Maximum number of populations/clusters (multi-head)")
    parser.add_argument("--hidden_size", required=False, default=1024, type=int,
                        help="Dimension of first projection in encoder.")
    parser.add_argument("--save_dir", required=True, type=str,
                        help="Save model in this directory")
    parser.add_argument("--data_path", required=True, type=str,
                        help="Path containing the main data")
    parser.add_argument("--name", required=True, type=str,
                        help="Experiment/model name")
    parser.add_argument("--supervised_loss_weight", required=False, default=100,
                        type=float, help="Weight given to the supervised loss")
    parser.add_argument("--pops_path", required=False, default="", type=str,
                        help="Path containing the main data populations")
    parser.add_argument("--n_components", required=False, type=int, default=8,
                        help="Number of components to use for the SVD initialization.")
    parser.add_argument("--num_gpus", required=False, default=0, type=int,
                        help="Number of devices to be used in the execution.")
    parser.add_argument("--mesh", required=False, default=None, type=str,
                        help="Device mesh as DATAxSNP, e.g. '4x2' = 4-way "
                        "sample parallelism x 2-way SNP sharding of V/P/"
                        "batches. Overrides --num_gpus. Default: all devices "
                        "data-parallel, moving devices to the snp axis "
                        "automatically when per-chip SNP-plane state would "
                        "exceed the device-memory budget.")
    parser.add_argument("--sample_block", required=False, default=16,
                        type=int, help="Batch sampling granularity: draw "
                        "random runs of this many consecutive (pre-shuffled) "
                        "samples instead of single rows (1 = classic per-row "
                        "shuffling). Default 16: contiguous block gathers, "
                        "with demo convergence indistinguishable from "
                        "per-row (PARITY.md, tools/convergence_bench.py).")
    parser.add_argument("--stream", required=False, default="auto",
                        choices=("auto", "0", "1"),
                        help="Host-streaming (out-of-core) training: keep "
                        "the 2-bit packed genotypes in host memory and "
                        "transfer each batch per step, for datasets whose "
                        "packed bytes exceed device memory (e.g. 500K x 1M "
                        "= 125 GB packed vs one 80 GB GPU). 'auto' (default) "
                        "streams only when the resident estimate exceeds "
                        "capacity in a single-process run; 1/0 force. Works "
                        "on one device or a single-host mesh (batches land "
                        "straight in the (data, snp) sharding); multi-host "
                        "runs shard the resident data across hosts instead.")
    parser.add_argument("--init_restarts", required=False, default=1,
                        type=int, help="Train this many independently "
                        "seeded runs (fresh GMM init + training RNG, seeds "
                        "seed..seed+R-1) and keep the best by "
                        "log-likelihood. The converged LL varies by a few "
                        "thousand units with the init draw (BASELINE.md); "
                        "restarts recover that spread at R x the training "
                        "cost. Default 1 (reference behavior).")
    parser.add_argument("--cv", required=False, default=None, type=int,
                        help="Number of folds for cross-validation. The "
                        "reference declares this flag but ships it (and its "
                        "whole implementation) commented out "
                        "(reference entry.py:48, src/main.py:47-79); here "
                        "it works: per-fold multi-head training, held-out "
                        "samples projected through the trained encoder, "
                        "per-K mean±std validation error logged and written "
                        "to {name}.cv_errors.csv before the full-data fit.")
    parser.add_argument("--threads", required=False, default=1, type=int,
                        help="Number of threads to be used during execution.")
    parser.add_argument("--no_progress", action="store_true",
                        help="Disable the per-dispatch epoch progress lines.")
    parser.add_argument("--profile_dir", required=False, default=None,
                        type=str, help="Write a jax.profiler trace of the "
                        "training epochs to this directory.")
    parser.add_argument("--checkpoint_every", required=False, default=0,
                        type=int, help="Save a resumable training checkpoint "
                        "every N epochs (0 = disabled). Also arms "
                        "preemption safety: a SIGTERM (maintenance / "
                        "preemptible scheduler) saves a checkpoint at the "
                        "next epoch boundary and exits 143; restart with "
                        "--resume (single-process runs).")
    parser.add_argument("--resume", action="store_true",
                        help="Resume training from the checkpoint in save_dir "
                        "if one exists.")
    _apply_yaml_defaults(parser, argv)
    return parser.parse_args(argv)


def parse_infer_args(argv: List[str]) -> argparse.Namespace:
    parser = _ConfigParser(
        prog="neural-admixture infer",
        description="Rapid population clustering with autoencoders - inference mode")
    _add_config_arg(parser)
    parser.add_argument("--out_name", required=True, type=str,
                        help="Name used to output files on inference mode.")
    parser.add_argument("--save_dir", required=True, type=str,
                        help="Load model from this directory.")
    parser.add_argument("--data_path", required=True, type=str,
                        help="Path containing the main data.")
    parser.add_argument("--name", required=True, type=str,
                        help="Trained experiment/model name.")
    parser.add_argument("--batch_size", required=False, default=1024, type=int,
                        help="Batch size.")
    parser.add_argument("--seed", required=False, type=int, default=42, help="Seed")
    parser.add_argument("--num_gpus", required=False, default=0, type=int,
                        help="Number of devices to be used in the execution "
                        "(0 = CPU, 1 = one device, N>1 = N-way data-parallel "
                        "sharded inference -- extends the reference, which "
                        "rejects multi-device inference).")
    parser.add_argument("--mesh", required=False, default=None, type=str,
                        help="Device mesh as DATAxSNP for sharded inference, "
                        "e.g. '4x2' = sample rows over 4 devices x V/SNP "
                        "columns over 2. Overrides --num_gpus.")
    parser.add_argument("--threads", required=False, default=1, type=int,
                        help="Number of threads to be used during execution.")
    _apply_yaml_defaults(parser, argv)
    return parser.parse_args(argv)


def print_banner(version: str = __version__) -> None:
    try:
        from colorama import Fore, Style, init
        init(autoreset=True)
        cyan, reset = Fore.CYAN, Style.RESET_ALL
    except ImportError:
        cyan = reset = ""
    banner = f"""
{cyan}
    _   _                      _       ___  ____  __  __ _______   _________ _    _ _____  ______
   | \\ | |                    | |     / _ \\|  _ \\|  \\/  |_   _\\ \\ / /__   __| |  | |  __ \\|  ____|
   |  \\| | ___ _   _ _ __ __ _| |    / /_\\ | | | | \\  / | | |  \\ V /   | |  | |  | | |__) | |__
   | . ` |/ _ \\ | | | '__/ _` | |    |  _  | | | | |\\/| | | |   > <    | |  | |  | |  _  /|  __|
   | |\\  |  __/ |_| | | | (_| | |    | | | | |_| | |  | |_| |_ / . \\   | |  | |__| | | \\ \\| |____
   |_| \\_|\\___|\\__,_|_|  \\__,_|_|    \\_| |_/____/|_|  |_|_____/_/ \\_\\  |_|   \\____/|_|  \\_\\______|
{reset}
                                  JAX engine — version {version}
    """
    log.info(banner)


def _validate(mode: str, args: argparse.Namespace) -> None:
    assert args.threads > 0, "Please select a valid number of threads (>0)."
    assert args.seed >= 0, "Please select a valid seed (>=0)."
    assert args.num_gpus >= 0, "Number of devices must be >= 0."
    assert args.batch_size > 0, "Batch size must be > 0."
    if getattr(args, "mesh", None):
        import re
        assert re.fullmatch(r"[1-9]\d*x[1-9]\d*", args.mesh), (
            f"--mesh must look like '4x2' (data x snp), got "
            f"'{args.mesh}'.")
    if mode == "train":
        assert args.epochs > 0, "Number of epochs must be > 0."
        assert args.learning_rate > 0, "Learning rate must be > 0."
        assert args.hidden_size > 0, "Hidden size must be > 0."
        assert args.supervised_loss_weight >= 0, \
            "Supervised loss weight must be >= 0."
        assert args.n_components > 0, \
            "Number of components for SVD must be > 0."
        assert getattr(args, "sample_block", 1) >= 1, \
            "sample_block must be >= 1."
        assert getattr(args, "cv", None) is None or args.cv >= 2, \
            "Number of cross-validation folds must be >= 2."
        assert getattr(args, "init_restarts", 1) >= 1, \
            "init_restarts must be >= 1."
        if args.k is not None:
            assert args.k > 1, "Please select K > 1."
            log.info(f"    Running on K = {args.k}.")
        elif args.min_k is not None and args.max_k is not None:
            assert args.min_k > 1, "min_k must be greater than 1."
            assert args.max_k > args.min_k, "max_k must be greater than min_k."
            log.info(f"    Running from K={args.min_k} to K={args.max_k}.")
        else:
            raise ValueError("Please provide either --k or both --min_k and --max_k.")


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging(logging.INFO)
    print_banner()
    argv = list(sys.argv[1:] if argv is None else argv)
    assert len(argv) > 0, ('Please provide either the argument "train" or '
                           '"infer" to choose running mode.')
    mode = argv[0]
    if mode == "train":
        args = parse_train_args(argv[1:])
    elif mode == "infer":
        args = parse_infer_args(argv[1:])
    else:
        raise AssertionError(
            f'Unknown mode "{mode}". Please use "train" or "infer".')

    _validate(mode, args)
    t0 = time.time()
    _pin_threads(args.threads)
    log.info(f"    Using {args.threads} threads...")
    set_seed(args.seed)

    from .utils.platform import enable_compile_cache
    enable_compile_cache()

    # Multi-host bring-up is env-driven and a no-op on one host.
    from .parallel.distributed import maybe_initialize_distributed
    maybe_initialize_distributed()

    # Device-count clamp, mirroring the reference's GPU clamp message
    # (/root/reference/neural_admixture/entry.py:167-173).
    if args.num_gpus > 0:
        import jax
        available = jax.device_count()
        if args.num_gpus > available:
            log.warning(f"    Requested {args.num_gpus} devices, but only "
                        f"{available} are available. Using {available} "
                        "devices.")
            args.num_gpus = available

    if mode == "train":
        from .train.run import main_train
        return main_train(args, t0)
    from .infer import main_infer
    return main_infer(args, t0)


if __name__ == "__main__":
    sys.exit(main())
