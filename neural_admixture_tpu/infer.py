"""Projective inference: run the trained encoder on new data, write .Q files.

Mirrors /root/reference/neural_admixture/src/inference.py:16-102: load
``{name}_config.json`` + the decoder-stripped weights, rebuild the encoder-only
model (V comes from the checkpoint), batched forward, write ``{out_name}.{K}.Q``.
"""
import time
from functools import partial
from pathlib import Path
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from .io.packed import pack_with_padding
from .io.snp_reader import read_data
from .io.writers import load_checkpoint, load_config, write_outputs
from .models import qp
from .ops.pack import unpack_dosage_x
from .utils.logger import log, setup_logging


def infer_q(params, packed, N: int, ks: List[int], batch_size: int = 1024,
            use_pallas: Optional[bool] = None, interpret: bool = False
            ) -> List[np.ndarray]:
    """Single-device projective inference. ``use_pallas`` None = by
    platform (train.engine.fused_op_for); ``interpret`` as in TrainConfig."""
    import jax

    from .ops.fused import ROWS, fused_infer_q
    from .ops.pack import packed_view_u32
    from .train.chunked import chunked_forward
    from .train.engine import fused_op_for

    packed = np.asarray(packed)
    if use_pallas is None:
        use_pallas = fused_op_for(jax.default_backend())
    if use_pallas:
        # The xv kernel computes X @ V from the 2-bit words directly; the
        # (B, M) f32 X of the XLA path (16x the packed bytes) never exists.
        fwd = jax.jit(partial(fused_infer_q, interpret=interpret))
        data = packed_view_u32(packed)
        B = -(-min(N, batch_size) // ROWS) * ROWS
    else:
        fwd = jax.jit(lambda p, xb: qp.forward_infer(p, unpack_dosage_x(xb)))
        data, B = packed, min(N, batch_size)
    qs = chunked_forward(lambda blk: fwd(params, blk), data, N, B)
    return [qs[f"k{k}"] for k in sorted(ks)]


def infer_q_mesh(params, packed, N: int, ks: List[int], batch_size: int,
                 mesh_shape, use_pallas: Optional[bool] = None,
                 interpret: bool = False) -> List[np.ndarray]:
    """Sharded projective inference over a (data, snp) device mesh.

    The reference rejects multi-GPU inference outright
    (/root/reference/neural_admixture/src/inference.py:20-21). Here the
    encoder pass runs under shard_map with sample rows over ``data`` and V
    plus each batch's packed SNP columns over ``snp``
    (parallel.sharded_step.infer_q_sharded, the same op the post-training
    Q pass uses) -- the path biobank-M checkpoints need, where V alone
    outgrows one device. Deviation from the reference documented in
    PARITY.md.
    """
    import jax

    from .ops.fused import TILE_SNPS
    from .ops.pack import packed_view_u32
    from .parallel.mesh import make_mesh, shard_params
    from .parallel.sharded_step import infer_q_sharded
    from .train.engine import fused_op_for

    n_data, n_snp = mesh_shape
    devices = jax.devices()
    if len(devices) < n_data * n_snp:
        raise ValueError(
            f"Sharded inference over a {n_data}x{n_snp} mesh needs "
            f"{n_data * n_snp} devices but only {len(devices)} are "
            "visible; use a smaller --mesh (or --num_gpus), or run "
            "single-device.")
    mesh = make_mesh(n_data, n_snp, devices=devices[:n_data * n_snp])
    packed = np.asarray(packed)
    if use_pallas is None:
        use_pallas = fused_op_for(jax.default_backend())
    quantum = TILE_SNPS if use_pallas else 4
    assert (packed.shape[1] * 4) % (n_snp * quantum) == 0, (
        f"{packed.shape[1] * 4} (padded) SNPs do not split into {n_snp} "
        f"shards of whole {quantum}-SNP tiles; choose a smaller snp axis")
    data = packed_view_u32(packed) if use_pallas else packed
    params = shard_params(jax.tree.map(jnp.asarray, params), mesh)
    qs = infer_q_sharded(mesh, params, data, N, use_pallas, batch_size,
                         interpret=interpret)
    return [qs[f"k{k}"] for k in sorted(ks)]


def _resolve_infer_mesh(args):
    """(n_data, n_snp) from --mesh 'DxS', else --num_gpus N>1 (all
    data-parallel), else None (single-device inference)."""
    if getattr(args, "mesh", None):
        n_data, n_snp = (int(s) for s in args.mesh.lower().split("x"))
        return (n_data, n_snp) if n_data * n_snp > 1 else None
    if int(args.num_gpus) > 1:
        return (int(args.num_gpus), 1)
    return None


def _select_backend(num_gpus: int) -> None:
    """Honor the reference's device-selection semantics for inference
    (/root/reference/neural_admixture/src/inference.py:20-40): --num_gpus 0
    runs on CPU, 1 on the accelerator. Must run before the first backend use;
    once a backend is initialized the platform is pinned for the process."""
    import jax
    if num_gpus == 0:
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass
        # Verify rather than trust: if any earlier code initialized a
        # device backend, the config update silently has no effect.
        if jax.default_backend() == "cpu":
            log.info("    Running inference on CPU (--num_gpus 0).")
        else:
            log.warning("    Could not force the CPU backend (a device "
                        "backend is already initialized); inference will "
                        f"run on {jax.default_backend()}.")


def main_infer(args, t0: float) -> int:
    setup_logging()
    mesh_shape = _resolve_infer_mesh(args)
    if mesh_shape is None:
        _select_backend(int(args.num_gpus))

    try:
        config = load_config(args.name, args.save_dir)
    except FileNotFoundError:
        log.error(f"    Config file ({args.save_dir}/{args.name}_config.json) "
                  "not found. Make sure it is in the correct directory and "
                  "with the correct name.")
        return 1

    log.info("    Model config file loaded. Loading weights...")
    from_torch = False
    try:
        params = load_checkpoint(args.name, args.save_dir)
    except FileNotFoundError:
        # Drop-in path for models trained by the reference implementation:
        # fall back to its torch state-dict format
        # (/root/reference/neural_admixture/src/inference.py:54-57).
        from .io.torch_interop import load_pt_checkpoint
        pt = Path(args.save_dir) / f"{args.name}.pt"
        if not pt.exists():
            log.error(f"    No weights found: neither {args.save_dir}/"
                      f"{args.name}.npz nor {pt} exists.")
            return 1
        log.info(f"    Loading reference-format torch weights ({pt}).")
        params = load_pt_checkpoint(args.name, args.save_dir,
                                    [int(k) for k in config["ks"]])
        from_torch = True
    params = {k: v for k, v in params.items()}  # shallow copy; no decoders
    log.info("")
    log.info("    Model weights loaded.")
    log.info("")

    # BED/PGEN/VCF take the packed-native path (straight to 2-bit rows,
    # like training): the dense (N, M) uint8 matrix -- 100 GB at biobank
    # scale -- never materializes on host.
    suffixes = Path(args.data_path).suffixes
    packed = None
    if ".bed" in suffixes:
        from .io.bed import read_bed_packed
        packed, N, M = read_bed_packed(args.data_path)
    elif ".pgen" in suffixes:
        from .io.pgen import read_pgen_packed
        packed, N, M = read_pgen_packed(args.data_path)
    elif ".vcf" in suffixes:
        from .io.vcf import read_vcf_packed
        packed, N, M = read_vcf_packed(args.data_path)
    else:
        data, *_ = read_data(args.data_path)
        N, M = data.shape
    trained_m = config.get("num_snps")
    if from_torch:
        # A reference .pt stores V with exactly the trained M rows (no
        # padding), which pins the variant count; pad V to the packed lane
        # multiple so device shapes line up (zero rows are inert in X @ V).
        trained_m = params["V"].shape[0] if trained_m is None else trained_m
        lane = 2048
        m_aligned = ((params["V"].shape[0] + lane - 1) // lane) * lane
        pad = m_aligned - params["V"].shape[0]
        if pad:
            params["V"] = np.concatenate(
                [params["V"],
                 np.zeros((pad, params["V"].shape[1]), np.float32)], axis=0)
    if trained_m is not None:
        assert M == int(trained_m), (
            f"Data has {M} SNPs but the model was trained on {trained_m}; "
            "projective inference requires the same variant set.")
    else:
        # num_snps is this implementation's extension key; externally-authored
        # configs lack it, leaving only the weak padded-V bound below.
        log.warning(
            "    Config has no 'num_snps' entry; cannot verify the dataset "
            f"matches the trained variant set (data has {M} SNPs, V has "
            f"{params['V'].shape[0]} padded rows). A mismatched variant set "
            "produces meaningless Q values.")
    assert params["V"].shape[0] >= M, (
        f"Data has {M} SNPs but the model was trained with "
        f"{params['V'].shape[0]} (padded) SNP rows in V.")
    if packed is None:
        packed, _ = pack_with_padding(data,
                                      lane_multiple=params["V"].shape[0])
    elif packed.shape[1] * 4 != params["V"].shape[0]:
        # The packed-native readers pad M to 2048-SNP lanes -- the same
        # multiple training (and the torch-import path above) pads V to, so
        # widths agree whenever the variant sets match; a torch config
        # without num_snps can leave V wider. Zero columns are inert.
        want_w = params["V"].shape[0] // 4
        assert want_w >= packed.shape[1], (
            f"Packed data is {packed.shape[1] * 4} (padded) SNPs wide but V "
            f"has only {params['V'].shape[0]} rows.")
        packed = np.pad(packed, ((0, 0), (0, want_w - packed.shape[1])))

    import jax

    from .train.engine import fused_op_for, log_device
    log_device(fused_op_for(jax.default_backend()))
    log.info("    Running inference...")
    # Qs come back in ascending-K order (infer_q sorts); normalize the
    # config's list the same way so filenames match their contents even
    # for hand-edited / externally-authored configs.
    ks = sorted(int(k) for k in config["ks"])
    if mesh_shape is not None:
        log.info(f"    Sharded inference over a {mesh_shape[0]}x"
                 f"{mesh_shape[1]} (data, snp) mesh.")
        Qs = infer_q_mesh(params, packed, N, ks, int(args.batch_size),
                          mesh_shape)
    else:
        Qs = infer_q(params, packed, N, ks, int(args.batch_size))
    log.info("    Inference run successfully! Writing outputs...!")

    if len(ks) == 1:
        write_outputs(Qs, args.out_name, ks[0], None, None, args.save_dir)
    elif ks == list(range(ks[0], ks[-1] + 1)):
        write_outputs(Qs, args.out_name, None, ks[0], ks[-1], args.save_dir)
    else:
        # Non-contiguous K list (externally-authored config): write each
        # K by name instead of letting the min..max range mislabel files.
        for i, k in enumerate(ks):
            write_outputs([Qs[i]], args.out_name, k, None, None,
                          args.save_dir)

    log.info("")
    log.info(f"    Total elapsed time: {time.time() - t0:.2f} seconds.")
    log.info("")
    return 0
