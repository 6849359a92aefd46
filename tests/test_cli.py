"""CLI end-to-end on CPU: train (multi-head) -> files -> infer."""
import numpy as np
import pytest

from neural_admixture_tpu.entry import main
from tests.conftest import DEMO_BED


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli_out")
    rc = main(["train", "--min_k", "2", "--max_k", "3",
               "--data_path", DEMO_BED, "--save_dir", str(out),
               "--name", "cli_run", "--epochs", "2", "--seed", "42",
               "--threads", "2", "--batch_size", "64", "--hidden_size", "64",
               "--no_progress"])
    assert rc == 0
    return out


def test_train_writes_all_artifacts(trained_dir):
    for k in (2, 3):
        Q = np.loadtxt(trained_dir / f"cli_run.{k}.Q")
        P = np.loadtxt(trained_dir / f"cli_run.{k}.P")
        assert Q.shape == (105, k)
        assert P.shape == (8451, k)
        np.testing.assert_allclose(Q.sum(axis=1), 1.0, rtol=1e-4)
        assert P.min() >= 0 and P.max() <= 1
    assert (trained_dir / "cli_run.npz").exists()
    assert (trained_dir / "cli_run_config.json").exists()
    # Reference-format torch export: decoder-stripped, exact-M (unpadded) V
    # (/root/reference/neural_admixture/src/main.py:40-43 output contract).
    import torch
    sd = torch.load(trained_dir / "cli_run.pt", weights_only=True)
    assert sd["V"].shape == (8451, 8)
    assert not any(k.startswith("decoders") for k in sd)
    assert {"batch_norm.weight", "common_encoder.0.weight",
            "multihead_encoder.heads.0.weight",
            "multihead_encoder.heads.1.bias"} <= set(sd)


def test_infer_cli_reproduces_training_q(trained_dir):
    rc = main(["infer", "--name", "cli_run", "--save_dir", str(trained_dir),
               "--data_path", DEMO_BED, "--out_name", "proj",
               "--threads", "2"])
    assert rc == 0
    for k in (2, 3):
        Qp = np.loadtxt(trained_dir / f"proj.{k}.Q")
        Q = np.loadtxt(trained_dir / f"cli_run.{k}.Q")
        np.testing.assert_allclose(Qp, Q, atol=1e-6)


def test_infer_cli_sharded_matches_single_device(trained_dir):
    """`infer --mesh DxS` (sharded projective inference -- a deliberate
    extension; the reference rejects multi-device inference,
    src/inference.py:20-21) must reproduce the single-device Q through
    the real CLI. Mesh 4x1: the demo's packed width (2113 bytes, odd)
    does not divide a 2-wide snp axis on the CPU path; snp sharding is
    covered by tests/test_fused_infer.py at aligned widths."""
    rc = main(["infer", "--name", "cli_run", "--save_dir", str(trained_dir),
               "--data_path", DEMO_BED, "--out_name", "proj_mesh",
               "--threads", "2", "--mesh", "4x1"])
    assert rc == 0
    for k in (2, 3):
        Qm = np.loadtxt(trained_dir / f"proj_mesh.{k}.Q")
        Q = np.loadtxt(trained_dir / f"cli_run.{k}.Q")
        np.testing.assert_allclose(Qm, Q, atol=1e-6)


def test_init_restarts_selects_best_ll(tmp_path):
    """--init_restarts R trains R independently seeded runs and keeps the
    best by log-likelihood; the selected LL must be >= the single-run
    (restart 0 == plain seed) LL. Motivated by the measured ~3k-LL init
    lottery on the converged demo (BASELINE.md)."""
    import re

    def run(name, restarts):
        rc = main(["train", "--k", "2", "--data_path", DEMO_BED,
                   "--save_dir", str(tmp_path), "--name", name,
                   "--epochs", "2", "--seed", "11", "--threads", "2",
                   "--batch_size", "64", "--hidden_size", "32",
                   "--no_progress", "--init_restarts", str(restarts)])
        assert rc == 0

    from neural_admixture_tpu.io.bed import read_bed_packed
    from neural_admixture_tpu.ops.loglikelihood import loglikelihood_packed

    packed, N, M = read_bed_packed(DEMO_BED)

    def ll_of(name):
        Q = np.loadtxt(tmp_path / f"{name}.2.Q")
        P = np.loadtxt(tmp_path / f"{name}.2.P")
        return float(loglikelihood_packed(
            packed, M, np.ascontiguousarray(P.astype(np.float64)),
            np.ascontiguousarray(Q.astype(np.float64))))

    run("single", 1)
    run("multi", 3)
    assert ll_of("multi") >= ll_of("single") - 1e-6


def test_infer_missing_config_returns_error(tmp_path):
    rc = main(["infer", "--name", "nope", "--save_dir", str(tmp_path),
               "--data_path", DEMO_BED, "--out_name", "x", "--threads", "1"])
    assert rc == 1


def test_mesh_flag_reaches_the_engine(tmp_path):
    """`--mesh DxS` must activate the (data, snp) mesh from the CLI (the
    round-1 gap: SNP sharding existed but was unreachable by users). The
    demo BED pads to m_pad=16384, so a 2-wide snp axis is legal."""
    from neural_admixture_tpu.train.run import _resolve_mesh_shape
    from neural_admixture_tpu.entry import parse_train_args

    args = parse_train_args(
        ["--k", "3", "--data_path", DEMO_BED, "--save_dir", str(tmp_path),
         "--name", "m", "--mesh", "2x2"])
    assert _resolve_mesh_shape(args) == (2, 2)
    args.mesh = None
    args.num_gpus = 4
    assert _resolve_mesh_shape(args) == (4, 1)
    args.num_gpus = 0
    assert _resolve_mesh_shape(args) is None

    rc = main(["train", "--k", "2", "--data_path", DEMO_BED,
               "--save_dir", str(tmp_path), "--name", "mesh_run",
               "--epochs", "1", "--threads", "2", "--batch_size", "64",
               "--hidden_size", "32", "--mesh", "2x2", "--no_progress"])
    assert rc == 0
    assert np.loadtxt(tmp_path / "mesh_run.2.Q").shape == (105, 2)


def test_mesh_flag_validation():
    with pytest.raises(AssertionError, match="mesh"):
        main(["train", "--k", "3", "--data_path", DEMO_BED,
              "--save_dir", "/tmp/x", "--name", "m", "--mesh", "8"])


def test_stream_flag_cli_matches_resident(tmp_path):
    """`--stream 1` (host-streaming out-of-core training) through the real
    CLI must reproduce the resident run's outputs on a (1,1) mesh. The XLA
    CPU path is bit-exact (tests/test_stream.py); the text outputs are
    compared at their full printed precision."""
    common = ["train", "--k", "2", "--data_path", DEMO_BED,
              "--save_dir", str(tmp_path), "--epochs", "2", "--seed", "42",
              "--threads", "2", "--batch_size", "64", "--hidden_size", "32",
              "--mesh", "1x1", "--no_progress"]
    assert main(common + ["--name", "res", "--stream", "0"]) == 0
    assert main(common + ["--name", "str", "--stream", "1"]) == 0
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "str.2.Q"),
                                  np.loadtxt(tmp_path / "res.2.Q"))
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "str.2.P"),
                                  np.loadtxt(tmp_path / "res.2.P"))


def test_infer_cli_pgen_matches_bed(trained_dir, tmp_path):
    """Projective inference through the packed-native PGEN reader must
    reproduce the BED-input Q exactly (same variant set, same minor-allele
    flip semantics in the packed domain)."""
    from neural_admixture_tpu.io.bed import read_bed
    from neural_admixture_tpu.io.pgen import write_pgen_mode2

    G = read_bed(DEMO_BED)  # raw dosages; both readers apply the same flip
    pgen = tmp_path / "demo.pgen"
    write_pgen_mode2(str(pgen), G)
    rc = main(["infer", "--name", "cli_run", "--save_dir", str(trained_dir),
               "--data_path", str(pgen), "--out_name", "proj_pgen",
               "--threads", "2"])
    assert rc == 0
    for k in (2, 3):
        Qp = np.loadtxt(trained_dir / f"proj_pgen.{k}.Q")
        Qb = np.loadtxt(trained_dir / f"proj.{k}.Q")
        np.testing.assert_array_equal(Qp, Qb)
