"""The Q_P autoencoder as a pure-JAX pytree of parameters.

Architecture (mirrors /root/reference/neural_admixture/model/neural_admixture.py:100-177):

    X (B, M) dosage/2, missing->0
      -> X @ V                 V: (M, D) *trainable*, initialized from RSVD
      -> RMSNorm(D, eps=1e-8)  (learnable scale, no bias)
      -> Linear(D -> H) + ReLU (shared encoder)
      -> per-K head Linear(H -> k) -> softmax  => Q_k (B, k)
      -> per-K decoder Q_k @ P_k, P_k: (k, M), output clamped to [0, 1]

The decoder weights ARE the allele-frequency matrices P (stored (k, M);
the reference stores the transpose as torch Linear weights, model/
neural_admixture.py:69-76). Multi-head: one head + decoder per K in ks.

Params pytree layout:
    {"V": (M, D), "rmsnorm": {"weight": (D,)},
     "common": {"kernel": (D, H), "bias": (H,)},
     "heads": {"k3": {"kernel": (H, 3), "bias": (3,)}, ...},
     "decoders": {"k3": (3, M), ...}}
"""
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp

RMSNORM_EPS = 1e-8
# Precision of the model's own matmuls. Pinned because a GPU otherwise runs
# f32 products in TF32 (about three decimal digits), while the reference
# trains in f32 torch. Read at trace time.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def matmul(a, b):
    return jnp.matmul(a, b, precision=MATMUL_PRECISION)


def head_keys(ks: List[int]) -> List[str]:
    return [f"k{k}" for k in sorted(ks)]


def _linear_init(key, fan_in: int, fan_out: int, dtype=jnp.float32):
    """torch.nn.Linear default init: kaiming_uniform(a=sqrt(5)) for the
    kernel and U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the bias — both reduce
    to U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    kk, kb = jax.random.split(key)
    bound = 1.0 / jnp.sqrt(fan_in)
    kernel = jax.random.uniform(kk, (fan_in, fan_out), dtype, -bound, bound)
    bias = jax.random.uniform(kb, (fan_out,), dtype, -bound, bound)
    return {"kernel": kernel, "bias": bias}


def init_params(key, V: jnp.ndarray, P_init: Optional[jnp.ndarray],
                hidden_size: int, ks: List[int], m_pad: Optional[int] = None
                ) -> Dict:
    """Build the parameter pytree.

    Args:
      key: PRNG key for encoder initialization.
      V: (M, D) PCA projection from RSVD (becomes trainable).
      P_init: (sum(ks), M) initial allele frequencies, rows grouped per K in
        ascending order (as produced by GMM init), or None for infer mode.
      hidden_size: encoder hidden width H.
      ks: list of K values (one head + decoder each).
      m_pad: pad the SNP axis of V / decoders to this many rows/cols
        (zero-padded) so device shapes stay lane-aligned.
    """
    ks = sorted(ks)
    M, D = V.shape
    m_tgt = max(m_pad or 0, M)
    V = jnp.asarray(V, jnp.float32)
    if m_tgt != M:
        V = jnp.concatenate([V, jnp.zeros((m_tgt - M, D), jnp.float32)], axis=0)

    k_common, *k_heads = jax.random.split(key, 1 + len(ks))
    params = {
        "V": V,
        "rmsnorm": {"weight": jnp.ones((D,), jnp.float32)},
        "common": _linear_init(k_common, D, hidden_size),
        "heads": {f"k{k}": _linear_init(kh, hidden_size, k)
                  for k, kh in zip(ks, k_heads)},
    }
    if P_init is not None:
        P_init = jnp.asarray(P_init, jnp.float32)
        decoders = {}
        start = 0
        for k in ks:
            Pk = P_init[start:start + k]
            start += k
            if m_tgt != M:
                Pk = jnp.concatenate(
                    [Pk, jnp.zeros((k, m_tgt - M), jnp.float32)], axis=1)
            decoders[f"k{k}"] = Pk
        params["decoders"] = decoders
    return params


def encode_from_xp(params: Dict, Xp: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """PCA-space input (B, D) -> {head_key: Q (B, k)}.

    The single definition of the RMSNorm -> shared MLP -> heads -> softmax
    encoder, shared by the XLA forward, the fused op, and the
    sharded paths (so the math cannot drift between them). ``params`` needs
    only the "rmsnorm"/"common"/"heads" entries.
    """
    ms = jnp.mean(jnp.square(Xp), axis=-1, keepdims=True)
    h = Xp * jax.lax.rsqrt(ms + RMSNORM_EPS) * params["rmsnorm"]["weight"]
    e = jax.nn.relu(matmul(h, params["common"]["kernel"])
                    + params["common"]["bias"])
    out = {}
    for hk, head in params["heads"].items():
        logits = matmul(e, head["kernel"]) + head["bias"]
        out[hk] = jax.nn.softmax(logits, axis=-1)
    return out


def encode(params: Dict, X: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """X (B, M) -> {head_key: Q (B, k)} admixture proportions."""
    return encode_from_xp(params, matmul(X, params["V"]))


def forward_train(params: Dict, X: jnp.ndarray):
    """Training forward: returns ({head: raw reconstruction Q @ P}, {head: Q}).

    Reconstructions are *pre-clamp*; the [0,1] clamp is fused into the loss
    (ops.loss.clamped_bce_sum) with torch-matching clamp gradients.
    """
    qs = encode(params, X)
    recs = {hk: matmul(qs[hk], params["decoders"][hk]) for hk in qs}
    return recs, qs


def forward_infer(params: Dict, X: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """Inference forward: encoder only, returns {head: Q}."""
    return encode(params, X)


def restrict_P(params: Dict) -> Dict:
    """Clamp decoder weights into [0, 1] after an optimizer step
    (mirrors /root/reference/neural_admixture/model/neural_admixture.py:179-185)."""
    if "decoders" not in params:
        return params
    new = dict(params)
    new["decoders"] = {hk: jnp.clip(P, 0.0, 1.0)
                       for hk, P in params["decoders"].items()}
    return new
