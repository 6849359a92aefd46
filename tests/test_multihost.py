"""Multi-process distributed training must reproduce the single-process run.

Spawns REAL processes running the production CLI, rendezvousing through
jax.distributed (gloo collectives on CPU). Each process reads only its BED
row block (io.bed.read_bed_packed_rows via
engine.NeuralAdmixtureTrainer.sample_shard), the engine assembles the global
resident array with jax.make_array_from_process_local_data, and only rank 0
writes outputs. This is the working analogue of the reference's multi-GPU
mp.spawn path (/root/reference/neural_admixture/entry.py:188-193) -- but
multi-HOST, which the reference cannot do.

Two configurations:
  * (2 procs x 1 device) = a (2, 1) all-data mesh, per-row sampling,
    vs a plain single-process run. The engine path is bit-exact on the
    XLA backend; the only cross-run difference is the RSVD/GMM init,
    whose cross-host partial accumulation (ops.rsvd rows= path) sums in
    a different order than the single-host GEMM -- last-ulp V
    differences that 6 Adam epochs amplify slightly, hence the tight
    but non-zero tolerance.
  * (2 procs x 2 devices) = a (2, 2) data x snp mesh with BLOCK sampling
    (--sample_block 16): the multi-host configuration, pinning per-process
    pre-shuffle (engine.shard_row_order), tile/row-block global-array
    assembly under P(data, snp), and the snp-axis psums, vs a
    single-process 4-device run emulating the same resident layout
    (NA_TPU_EMULATE_PROC_SHARDS).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import DEMO_BED

# 6 epochs > log_every (5) so the grouped log-period dispatch (one jit
# per period, engine.make_epoch_fn(epochs_per_call)) runs under the real
# two-process mesh: epoch 0-4 grouped, epoch 5 logged single.
EPOCHS, K, BATCH, HIDDEN, SEED = 6, 2, 64, 32, 7


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(out_dir, name, data=DEMO_BED, sample_block=1, mesh=None):
    cmd = [sys.executable, "-m", "neural_admixture_tpu.entry", "train",
           "--k", str(K), "--data_path", str(data), "--save_dir",
           str(out_dir), "--name", name, "--epochs", str(EPOCHS),
           "--seed", str(SEED), "--batch_size", str(BATCH),
           "--hidden_size", str(HIDDEN), "--no_progress",
           "--sample_block", str(sample_block)]
    if mesh:
        cmd += ["--mesh", mesh]
    return cmd


def _env(extra, devices=1):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    if devices > 1:
        env["XLA_FLAGS"] = \
            f"--xla_force_host_platform_device_count={devices}"
    env.update(extra)
    return env


def _spawn_pair(cmd_builder, devices=1, extra=None):
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        cmd_builder(), env=_env({
            "NA_TPU_COORDINATOR": coord,
            "NA_TPU_NUM_PROCESSES": "2",
            "NA_TPU_PROCESS_ID": str(pid),
            **(extra or {}),
        }, devices=devices),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (1, 0)]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"
    return outs


def test_partial_distributed_config_fails_loudly(monkeypatch):
    """A partially-set multi-process env must raise, not fall through to
    every rank believing it is a single-process master (duplicate work +
    racing output writes)."""
    from neural_admixture_tpu.parallel.distributed import (
        maybe_initialize_distributed)
    for k in ("NA_TPU_COORDINATOR", "NA_TPU_NUM_PROCESSES",
              "NA_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NA_TPU_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="Incomplete multi-process"):
        maybe_initialize_distributed()
    monkeypatch.delenv("NA_TPU_COORDINATOR")
    monkeypatch.setenv("NA_TPU_PROCESS_ID", "1")
    with pytest.raises(ValueError, match="Incomplete multi-process"):
        maybe_initialize_distributed()
    # coordinator + num_processes WITHOUT a process id: defaulting the
    # rank to 0 would duplicate the master on every host -- must raise.
    monkeypatch.delenv("NA_TPU_PROCESS_ID")
    monkeypatch.setenv("NA_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("NA_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="Incomplete multi-process"):
        maybe_initialize_distributed()


def test_two_process_training_matches_single_process(tmp_path):
    single, multi = tmp_path / "single", tmp_path / "multi"
    outs = _spawn_pair(lambda: _cli(multi, "mh"))

    # Per-host row blocks and master-only writes must both have happened.
    rank0_log = outs[1]
    assert "this one holds rows [53, 105)" in outs[0], outs[0][-2000:]
    assert "this one holds rows [0, 53)" in rank0_log, rank0_log[-2000:]
    assert (multi / "mh.2.Q").exists()

    ref = subprocess.run(_cli(single, "sp"), env=_env({}), timeout=420,
                         capture_output=True, text=True)
    assert ref.returncode == 0, ref.stdout[-3000:] + ref.stderr[-2000:]

    Q1 = np.loadtxt(single / f"sp.{K}.Q")
    Q2 = np.loadtxt(multi / f"mh.{K}.Q")
    P1 = np.loadtxt(single / f"sp.{K}.P")
    P2 = np.loadtxt(multi / f"mh.{K}.P")
    # XLA-path engine is bit-exact across process counts; the residual
    # tolerance covers only the init's cross-host accumulation order.
    np.testing.assert_allclose(Q2, Q1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(P2, P1, rtol=1e-4, atol=1e-5)


def _write_synthetic_bed(path, N=120, M=256, seed=11):
    """BED fileset with M % 8 == 0 so a 2-wide snp axis divides the packed
    width (engine._pick_mesh's m_pad % (n_snp * 4) requirement on the XLA
    path; the demo BED's M=8451 does not)."""
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, size=(N, M)).astype(np.uint8)
    # Missing genotypes in the FIRST rows only: process 0's shard has
    # code-3 entries while process 1's does not, so the engine's global
    # has-missing reduction (trace-time kernel-variant consistency across
    # hosts) is exercised with genuinely differing local answers.
    G[:4, ::17] = 3
    code_of = np.array([3, 2, 0, 1], dtype=np.uint8)  # dosage -> BED code
    nb = (N + 3) // 4
    B = np.zeros((M, nb), dtype=np.uint8)
    for n in range(N):
        B[:, n // 4] |= code_of[G[n]] << np.uint8(2 * (n % 4))
    with open(path, "wb") as f:
        f.write(b"\x6c\x1b\x01" + B.tobytes())
    stem = str(path)[:-4]
    with open(stem + ".fam", "w") as f:
        f.writelines(f"f{i} i{i} 0 0 0 -9\n" for i in range(N))
    with open(stem + ".bim", "w") as f:
        f.writelines(f"1 snp{j} 0 {j} A C\n" for j in range(M))
    return G


def test_two_process_streamed_out_of_core(tmp_path):
    """Multi-HOST out-of-core training: 2 procs x 2 devices on a (2, 2)
    mesh with a fake HBM capacity that the RESIDENT estimate exceeds but
    the streaming one fits, so the auto policy engages host-streaming.
    Each host keeps only its packed row block in RAM, assembles its shard
    of every batch (host-partition-stratified sampling,
    engine._stratified_plan), and the shards join the global P(data, snp)
    batch via jax.make_array_from_process_local_data. Must reproduce a
    resident 2-process run under the same stratified policy
    (NA_TPU_STRATIFIED=1) at the standard multi-host tolerance."""
    bed = tmp_path / "syn.bed"
    _write_synthetic_bed(bed)
    resident, streamed = tmp_path / "resident", tmp_path / "streamed"

    # Mirror of launch_training's per-chip estimates at this workload
    # (N=120, M=256 -> m_pad=2048, rows_pp=64, b_round=64, XLA path,
    # (2, 2) mesh): capacity between the streaming and resident needs.
    m_pad, rows_pp, b_round, n_chips, n_snp = 2048, 64, 64, 4, 2
    data_bytes = 2 * rows_pp * (m_pad // 4)
    batch_bytes = b_round * (m_pad // 4) + b_round * m_pad * 4
    plane = m_pad * (8 + K) * 12
    per_chip_stream = batch_bytes / n_chips + plane / n_snp
    per_chip_resident = per_chip_stream + data_bytes / n_chips
    cap = (per_chip_stream + per_chip_resident) / 2 / 0.9 / 2**30
    outs = _spawn_pair(
        lambda: _cli(streamed, "st", data=bed, sample_block=16, mesh="2x2"),
        devices=2, extra={"NA_TPU_HBM_CAPACITY_GB": repr(cap)})
    assert (streamed / "st.2.Q").exists()
    assert "Host-streaming (out-of-core) training" in outs[1], outs[1][-3000:]

    outs_r = _spawn_pair(
        lambda: _cli(resident, "re", data=bed, sample_block=16, mesh="2x2"),
        devices=2, extra={"NA_TPU_STRATIFIED": "1"})
    assert "Host-streaming" not in outs_r[1]

    Q1 = np.loadtxt(resident / f"re.{K}.Q")
    Q2 = np.loadtxt(streamed / f"st.{K}.Q")
    P1 = np.loadtxt(resident / f"re.{K}.P")
    P2 = np.loadtxt(streamed / f"st.{K}.P")
    np.testing.assert_allclose(Q2, Q1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(P2, P1, rtol=1e-4, atol=1e-5)


def test_two_process_block_sampling_snp_mesh(tmp_path):
    """2 procs x 2 local devices on a (2, 2) mesh with --sample_block 16
    must match a single 4-device process emulating the same per-process
    resident layout. Pins the untested pod configuration: cross-process
    global-array assembly under the P(data, snp) batch spec plus the
    snp-axis collectives, with block sampling active (no fallback)."""
    bed = tmp_path / "syn.bed"
    _write_synthetic_bed(bed)
    single, multi = tmp_path / "single", tmp_path / "multi"

    outs = _spawn_pair(
        lambda: _cli(multi, "mh", data=bed, sample_block=16, mesh="2x2"),
        devices=2)
    assert (multi / "mh.2.Q").exists()
    for out in outs:
        assert "falling back to per-row sampling" not in out

    ref = subprocess.run(
        _cli(single, "sp", data=bed, sample_block=16, mesh="2x2"),
        env=_env({"NA_TPU_EMULATE_PROC_SHARDS": "2,2"}, devices=4),
        timeout=420, capture_output=True, text=True)
    assert ref.returncode == 0, ref.stdout[-3000:] + ref.stderr[-2000:]

    Q1 = np.loadtxt(single / f"sp.{K}.Q")
    Q2 = np.loadtxt(multi / f"mh.{K}.Q")
    P1 = np.loadtxt(single / f"sp.{K}.P")
    P2 = np.loadtxt(multi / f"mh.{K}.P")
    np.testing.assert_allclose(Q2, Q1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(P2, P1, rtol=1e-4, atol=1e-5)


def test_two_process_vcf_input(tmp_path):
    """Multi-host VCF ingestion: samples are COLUMNS in a VCF, so each
    host makes one streaming pass parsing only its own column slice
    (io.vcf.read_vcf_packed_rows) -- where the reference reads the whole
    matrix on one host before mp.spawn (entry.py:181-190). The 2-process
    run must reproduce the single-process run on the same VCF at the
    standard multi-host tolerance (init accumulation order only)."""
    rng = np.random.default_rng(31)
    N, M = 90, 120
    G = rng.integers(0, 3, size=(N, M)).astype(np.uint8)
    G[:3, ::13] = 3  # missing rows concentrated in process 0's shard
    vcf = tmp_path / "syn.vcf"
    header = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + \
        "\t".join(f"S{i}" for i in range(N))
    code = {0: "0/0", 1: "0/1", 2: "1/1", 3: "./."}
    lines = ["##fileformat=VCFv4.2", header]
    for v in range(M):
        lines.append(f"1\t{v}\trs{v}\tA\tG\t50\tPASS\t.\tGT\t"
                     + "\t".join(code[int(G[s, v])] for s in range(N)))
    vcf.write_text("\n".join(lines) + "\n")

    single, multi = tmp_path / "single", tmp_path / "multi"
    outs = _spawn_pair(lambda: _cli(multi, "mh", data=vcf))
    assert "Input format is VCF." in outs[1], outs[1][-2000:]
    assert "this one holds rows [0, 45)" in outs[1], outs[1][-2000:]
    assert "this one holds rows [45, 90)" in outs[0], outs[0][-2000:]
    assert (multi / "mh.2.Q").exists()

    ref = subprocess.run(_cli(single, "sp", data=vcf), env=_env({}),
                         timeout=420, capture_output=True, text=True)
    assert ref.returncode == 0, ref.stdout[-3000:] + ref.stderr[-2000:]

    Q1 = np.loadtxt(single / f"sp.{K}.Q")
    Q2 = np.loadtxt(multi / f"mh.{K}.Q")
    P1 = np.loadtxt(single / f"sp.{K}.P")
    P2 = np.loadtxt(multi / f"mh.{K}.P")
    np.testing.assert_allclose(Q2, Q1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(P2, P1, rtol=1e-4, atol=1e-5)


def test_two_process_supervised_convergence(tmp_path):
    """Supervised mode (--pops_path) under a real 2-process run: every
    host reads the full label file, the per-class supervised P init runs
    on each host's packed ROW BLOCK (train.init.init_p_supervised_packed
    rows=), and the weighted CE term flows through the sharded step.
    This was the one 2-process CLI matrix cell with no coverage.

    The gate is FUNCTIONAL (label recovery), not element-wise equality
    with the single-process run, deliberately: the supervised per-class-
    mean init sits near gradient-symmetric points, where Adam's
    normalized first steps (update = +-lr at any near-zero gradient)
    amplify the legitimate sharded-vs-single reduction-order ulps
    (~1e-5, measured) into O(lr) trajectory divergence -- measured
    5.7e-2 Q divergence after ONE epoch even with the CE weight forced
    to 0, while (a) the supervised and unsupervised programs produce
    BIT-IDENTICAL gradients at CE weight 0, (b) the lr->0 outputs of
    single and 2-process supervised runs match to file precision (init
    identical), and (c) both runs converge to perfect label recovery.
    The unsupervised element-wise comparisons above stay valid because
    the GMM init keeps gradients away from Adam's sign-sensitive zero
    region on those fixtures."""
    rng = np.random.default_rng(5)
    N, M = 120, 256
    # two populations with well-separated per-SNP allele frequencies
    freqs = rng.beta(0.5, 0.5, size=(K, M))
    labels = np.arange(N) % K
    draws = (rng.random((2, N, M)) < freqs[labels]).astype(np.uint8)
    G = draws[0] + draws[1]
    code_of = np.array([3, 2, 0, 1], dtype=np.uint8)
    B = np.zeros((M, (N + 3) // 4), dtype=np.uint8)
    for n in range(N):
        B[:, n // 4] |= code_of[G[n]] << np.uint8(2 * (n % 4))
    bed = tmp_path / "sup.bed"
    bed.write_bytes(b"\x6c\x1b\x01" + B.tobytes())
    (tmp_path / "sup.fam").write_text(
        "".join(f"f{i} i{i} 0 0 0 -9\n" for i in range(N)))
    (tmp_path / "sup.bim").write_text(
        "".join(f"1 snp{j} 0 {j} A C\n" for j in range(M)))
    pops = tmp_path / "sup.pops"
    pops.write_text("\n".join(f"Pop{l + 1}" for l in labels) + "\n")

    def cli(out_dir, name):
        c = _cli(out_dir, name, data=bed) + ["--pops_path", str(pops)]
        c[c.index("--epochs") + 1] = "40"   # CE needs room to bind
        return c

    single, multi = tmp_path / "single", tmp_path / "multi"
    outs = _spawn_pair(lambda: cli(multi, "mh"))
    assert "Running Supervised Mode..." in outs[1], outs[1][-2000:]
    assert "this one holds rows [0, 60)" in outs[1], outs[1][-2000:]
    assert "this one holds rows [60, 120)" in outs[0], outs[0][-2000:]

    ref = subprocess.run(cli(single, "sp"), env=_env({}), timeout=420,
                         capture_output=True, text=True)
    assert ref.returncode == 0, ref.stdout[-3000:] + ref.stderr[-2000:]
    assert "Running Supervised Mode..." in ref.stdout

    # supervision must bind WITHOUT permutation matching (the supervised
    # init aligns Q columns to label indices) in BOTH runs
    Q1 = np.loadtxt(single / f"sp.{K}.Q")
    Q2 = np.loadtxt(multi / f"mh.{K}.Q")
    assert (Q1.argmax(1) == labels).mean() >= 0.95, \
        (Q1.argmax(1) == labels).mean()
    assert (Q2.argmax(1) == labels).mean() >= 0.95, \
        (Q2.argmax(1) == labels).mean()
    # at convergence both P matrices approach the class mean genotypes
    P1 = np.loadtxt(single / f"sp.{K}.P")
    P2 = np.loadtxt(multi / f"mh.{K}.P")
    assert np.abs(P1 - P2).mean() < 0.02, np.abs(P1 - P2).mean()
