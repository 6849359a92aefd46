"""The fused op as compiled for the GPU (no interpreter) against the XLA step.

The test process itself is held to the CPU (tests/conftest.py), so the check
runs in a child process that sees the card. Skips where there is none; run
on a GPU machine with ``python -m pytest tests/ -m gpu``.
"""
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import jax, jax.numpy as jnp, numpy as np
from neural_admixture_tpu.io.packed import pack_2bit_rows
from neural_admixture_tpu.models import qp
from neural_admixture_tpu.ops import fused as F
from neural_admixture_tpu.ops.loss import clamped_bce_sum
from neural_admixture_tpu.ops.pack import packed_view_u32, unpack_dosage_x

assert jax.devices()[0].platform == "gpu"
rng = np.random.default_rng(0)
B, M, m_pad, ks = 64, 8000, 8192, [2, 3, 4]
G = rng.integers(0, 4, size=(B, M)).astype(np.uint8)
packed = pack_2bit_rows(G, m_pad=m_pad)
params = qp.init_params(jax.random.PRNGKey(0),
                        (rng.normal(size=(M, 8)) * 0.1).astype(np.float32),
                        rng.uniform(0.05, 0.95, size=(sum(ks), M)), 32, ks,
                        m_pad=m_pad)
rw = jnp.asarray((np.arange(B) < 60).astype(np.float32))
cm = jnp.asarray((np.arange(m_pad) < M).astype(np.float32))
op = F.make_fused_training_loss(sorted(params["heads"]))
u32 = jnp.asarray(packed_view_u32(packed))

def fused(p):
    enc = {k: p[k] for k in ("rmsnorm", "common", "heads")}
    return op(p["V"], enc, p["decoders"], u32, rw)[0]

def ref(p):
    X = unpack_dosage_x(jnp.asarray(packed))
    recs, _ = qp.forward_train(p, X)
    return sum(clamped_bce_sum(recs[h], X, cm, rw) for h in recs)

lf, gf = jax.jit(jax.value_and_grad(fused))(params)
lr, gr = jax.jit(jax.value_and_grad(ref))(params)
np.testing.assert_allclose(float(lf), float(lr), rtol=1e-5)
for a, b in zip(jax.tree.leaves(gf), jax.tree.leaves(gr)):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=2e-4,
                               atol=2e-4 * max(1.0, np.abs(b).max()))
print("GPU_OK")
"""


@pytest.fixture
def gpu_env():
    """Environment for a child process that uses the GPU; skips without one.
    Decided here, at test time, never while the module is imported."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = _ROOT
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.returncode != 0 or probe.stdout.strip() != "gpu":
        pytest.skip("no NVIDIA GPU visible to JAX")
    return env


@pytest.mark.gpu
def test_fused_op_compiled_for_gpu_matches_xla(gpu_env):
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=gpu_env,
                          capture_output=True, text=True, timeout=900,
                          cwd=_ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "GPU_OK" in proc.stdout
