"""The fused multi-head training op for NVIDIA GPUs (Pallas, Triton route).

Every quantity of a training step that touches the (B, M) genotype plane --
X @ V, the decode Q @ P of every head, the clamped BCE, and their gradients
dQ, dP, dV -- is computed here straight from the 2-bit packed batch. The
plain XLA step (models.qp + ops.loss) writes an f32 X, one f32 Q @ P plane
per head and a BCE backward plane, each 16x the packed bytes; this op reads
the packed batch once per pass and never forms a (B, M) plane:

  forward   xv kernel      Xp = X @ V, per-tile partials        (read #1)
            (jnp)          qs = softmax(heads(relu(common(rmsnorm(Xp)))))
  backward  heads kernel   for every head: raw = q P, draw = d BCE / d raw,
                           dq = draw P^T (per-tile partials), dP = q^T draw
                           [+ the BCE value on logged steps]       (read #2)
            (jnp)          encoder VJP -> d(encoder params), dXp
            dv kernel      dV = X^T dXp                            (read #3)

Layout. The batch is the sample-major packed matrix viewed as uint32
words, (B, M/16): word w of a row holds SNPs 16w .. 16w+15 at bit pairs
0..15, so a block of TW words is one coalesced 4*TW-byte segment per row.
Each program owns one tile of TILE_SNPS consecutive SNPs (the grid runs
over M tiles: ~2,000 programs at 1M SNPs), holds that tile of V / P in
registers, and loops over the batch in ROWS-row steps. dP and dV are
complete per tile. Xp and dq reduce over M, so each program writes its
partial sums and XLA adds the tiles afterwards: deterministic, no atomics.

Numerics follow ops.loss exactly: torch's -100 log clamp, the backward
(rec - x) / max(rec (1 - rec), 1e-12), and the boundary-inclusive clamp
mask. All products are f32 FMAs on the CUDA cores (K and D are far below
a tensor-core tile), so no TF32 rounding enters.

Padding. Padded SNP columns need no mask: packed padding decodes to x = 0
and padded P columns are 0 at init and stay 0 (their gradients are 0 and
Adam maps zero moments to a zero update), so every padded-column term is
exactly 0. Padded batch rows carry row weight 0, applied to the tiny
(B, k) factors outside the plane loops.

``interpret=True`` runs the kernels in the Pallas interpreter (CPU tests);
nothing selects it implicitly.
"""
from functools import partial
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..models import qp

TW = 32                  # u32 words per SNP tile
TILE_SNPS = 16 * TW      # SNPs per program (512)
ROWS = 8                 # batch rows per inner-loop step
NUM_WARPS = 8
NUM_STAGES = 1
_LOG_CLAMP = -100.0
_GRAD_EPS = 1e-12


def _params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES)


def _unpack(u_ref, rows, cols, scale: bool):
    """(ROWS, TW) packed words -> (ROWS, TILE_SNPS) dosages in SNP order.

    Missing (code 3) -> 0. ``scale`` gives X = g / 2 (the model input);
    without it the raw dosage g, for kernels that fold the 0.5 into their
    small operand instead (exact: halving is an exponent decrement)."""
    w = u_ref[rows, cols]
    shifts = 2 * jax.lax.broadcasted_iota(jnp.uint32, (1, 1, 16), 2)
    g = ((w[:, :, None] >> shifts) & jnp.uint32(3)).astype(jnp.int32)
    g = g.reshape(ROWS, TILE_SNPS)
    x = g.astype(jnp.float32)
    if scale:
        x = x * 0.5
    return jnp.where(g == 3, 0.0, x)


def _xv_kernel(u_ref, vt_ref, out_ref):
    """Per-tile partial Xp^T: out[t, d, i] = sum_{m in tile t} g[i, m] v[m, d]
    with V^T passed pre-halved, so g (not g/2) is the unpacked operand."""
    t = pl.program_id(0)
    cols = pl.ds(t * TW, TW)
    snps = pl.ds(t * TILE_SNPS, TILE_SNPS)
    D = vt_ref.shape[0]
    vs = [vt_ref[d, snps] for d in range(D)]

    @pl.loop(0, u_ref.shape[0] // ROWS)
    def _(r):
        rows = pl.ds(r * ROWS, ROWS)
        g = _unpack(u_ref, rows, cols, scale=False)
        for d in range(D):
            out_ref[t, d, rows] = jnp.sum(g * vs[d][None, :], axis=1)


def _heads_kernel(*refs, ks: List[int], with_loss: bool):
    """Per tile t, for every head: dq partials, the complete dP tile and,
    with ``with_loss``, per-row BCE partials.

    refs: u (B, W4) u32, q^T (sum k, B), rw (B,) row weights (scaled by the
    loss cotangent), P (sum k, m_pad); outputs dq_part (nT, sum k, B),
    dP (sum k, m_pad)[, loss_part (nT, n_heads, B)]."""
    u_ref, qt_ref, rw_ref, p_ref, dq_ref, dp_ref = refs[:6]
    loss_ref = refs[6] if with_loss else None
    t = pl.program_id(0)
    cols = pl.ds(t * TW, TW)
    snps = pl.ds(t * TILE_SNPS, TILE_SNPS)
    n_steps = u_ref.shape[0] // ROWS
    off = 0
    for h, k in enumerate(ks):
        ps = [p_ref[off + j, snps] for j in range(k)]

        def body(r, acc, off=off, k=k, ps=ps, h=h):
            rows = pl.ds(r * ROWS, ROWS)
            x = _unpack(u_ref, rows, cols, scale=True)
            qs = [qt_ref[off + j, rows] for j in range(k)]
            raw = qs[0][:, None] * ps[0][None, :]
            for j in range(1, k):
                raw = raw + qs[j][:, None] * ps[j][None, :]
            rec = jnp.clip(raw, 0.0, 1.0)
            if with_loss:
                logr = jnp.maximum(jnp.log(rec), _LOG_CLAMP)
                log1mr = jnp.maximum(jnp.log1p(-rec), _LOG_CLAMP)
                elem = -(x * logr + (1.0 - x) * log1mr)
                loss_ref[t, h, rows] = jnp.sum(elem, axis=1)
            denom = jnp.maximum(rec * (1.0 - rec), _GRAD_EPS)
            # In range iff clip is the identity: raw == rec (NaN -> 0 too).
            draw = jnp.where(raw == rec, (rec - x) / denom, 0.0)
            rw = rw_ref[rows]
            new = []
            for j in range(k):
                dq_ref[t, off + j, rows] = jnp.sum(draw * ps[j][None, :],
                                                   axis=1)
                new.append(acc[j] + jnp.sum((qs[j] * rw)[:, None] * draw,
                                            axis=0))
            return new

        acc = jax.lax.fori_loop(
            0, n_steps, body,
            [jnp.zeros((TILE_SNPS,), jnp.float32) for _ in range(k)])
        for j in range(k):
            dp_ref[off + j, snps] = acc[j]
        off += k


def _dv_kernel(u_ref, dxpt_ref, dvt_ref):
    """dV^T tile t = dXp^T X over the batch; dXp^T is passed pre-halved."""
    t = pl.program_id(0)
    cols = pl.ds(t * TW, TW)
    snps = pl.ds(t * TILE_SNPS, TILE_SNPS)
    D = dxpt_ref.shape[0]

    def body(r, acc):
        rows = pl.ds(r * ROWS, ROWS)
        g = _unpack(u_ref, rows, cols, scale=False)
        return [acc[d] + jnp.sum(dxpt_ref[d, rows][:, None] * g, axis=0)
                for d in range(D)]

    acc = jax.lax.fori_loop(
        0, u_ref.shape[0] // ROWS, body,
        [jnp.zeros((TILE_SNPS,), jnp.float32) for _ in range(D)])
    for d in range(D):
        dvt_ref[d, snps] = acc[d]


def _check_shapes(u32):
    B, W4 = u32.shape
    if u32.dtype != jnp.uint32:
        raise TypeError(f"packed batch must be uint32 words, got {u32.dtype}")
    if B % ROWS or W4 % TW:
        raise ValueError(
            f"packed batch {u32.shape} must have rows in multiples of {ROWS} "
            f"and SNPs in multiples of {TILE_SNPS}")
    return B, W4 // TW


def xv(u32, V, interpret: bool = False):
    """Xp = X @ V (B, D) from a (B, m_pad/16) uint32 packed batch."""
    B, nT = _check_shapes(u32)
    D = V.shape[1]
    part = pl.pallas_call(
        _xv_kernel, grid=(nT,),
        out_shape=jax.ShapeDtypeStruct((nT, D, B), jnp.float32),
        compiler_params=_params(), interpret=interpret, name="na_xv",
    )(u32, V.T * 0.5)
    return part.sum(axis=0).T


def heads(u32, qs: List, Ps: List, row_w, with_loss: bool,
          interpret: bool = False):
    """One packed pass for all heads. Returns (loss or None, [dq_h (B, k)],
    [dP_h (k, m_pad)]) for sum_h BCE(clip(q_h P_h), X) weighted by row_w:
    dq and the loss are row-weighted here, dP inside the kernel."""
    B, nT = _check_shapes(u32)
    ks = [int(q.shape[1]) for q in qs]
    kt = sum(ks)
    m_pad = Ps[0].shape[1]
    qt = jnp.concatenate([q.T for q in qs], axis=0)
    out_shape = [jax.ShapeDtypeStruct((nT, kt, B), jnp.float32),
                 jax.ShapeDtypeStruct((kt, m_pad), jnp.float32)]
    if with_loss:
        out_shape.append(jax.ShapeDtypeStruct((nT, len(ks), B), jnp.float32))
    outs = pl.pallas_call(
        partial(_heads_kernel, ks=ks, with_loss=with_loss), grid=(nT,),
        out_shape=out_shape, compiler_params=_params(),
        interpret=interpret, name="na_heads",
    )(u32, qt, row_w.astype(jnp.float32), jnp.concatenate(Ps, axis=0))
    dq_all = outs[0].sum(axis=0).T * row_w[:, None]
    bounds = [sum(ks[:i]) for i in range(len(ks) + 1)]
    dqs = [dq_all[:, a:b] for a, b in zip(bounds, bounds[1:])]
    dps = [outs[1][a:b] for a, b in zip(bounds, bounds[1:])]
    loss = jnp.sum(outs[2].sum(axis=(0, 1)) * row_w) if with_loss else None
    return loss, dqs, dps


def dv(u32, dXp, interpret: bool = False):
    """dV = X^T dXp (m_pad, D)."""
    B, nT = _check_shapes(u32)
    D = dXp.shape[1]
    dvt = pl.pallas_call(
        _dv_kernel, grid=(nT,),
        out_shape=jax.ShapeDtypeStruct((D, nT * TILE_SNPS), jnp.float32),
        compiler_params=_params(), interpret=interpret, name="na_dv",
    )(u32, dXp.T * 0.5)
    return dvt.T


def fused_infer_q(params: Dict, u32, interpret: bool = False) -> Dict:
    """Encoder-only forward (infer and the post-training Q pass): the xv
    kernel, then the encoder. The (B, M) f32 X never exists."""
    return qp.encode_from_xp(params, xv(u32, params["V"], interpret))


def make_fused_training_loss(head_keys: List[str],
                             snp_axis: Optional[str] = None,
                             with_loss: bool = True,
                             interpret: bool = False):
    """Build the (V, enc_params, Ps, u32, row_w) -> (bce_loss_sum, qs) op.

    ``with_loss=False`` (steps whose loss is not read) skips the BCE value:
    the returned loss is 0.0 and the gradients are unchanged. With it, the
    forward runs the heads kernel once for the loss and the unscaled dq/dP,
    which the backward reuses, so either way a step reads the packed batch
    three times.

    ``snp_axis`` (shard_map over SNP shards): psums the Xp partial sums in
    the forward and the dXp cotangent in the backward."""
    head_keys = sorted(head_keys)

    def _encode(V, enc_params, u32):
        Xp = xv(u32, V, interpret)
        if snp_axis is not None:
            Xp = jax.lax.psum(Xp, snp_axis)
        return qp.encode_from_xp(enc_params, Xp), Xp

    def _heads(qs, Ps, u32, row_w, loss):
        return heads(u32, [qs[hk] for hk in head_keys],
                     [Ps[hk] for hk in head_keys], row_w, loss, interpret)

    def _forward(V, enc_params, Ps, u32, row_w):
        qs, Xp = _encode(V, enc_params, u32)
        if not with_loss:
            return jnp.float32(0.0), qs, Xp, None
        loss, dqs, dps = _heads(qs, Ps, u32, row_w, True)
        return loss, qs, Xp, (dqs, dps)

    @jax.custom_vjp
    def fused_training_loss(V, enc_params, Ps, u32, row_w):
        loss, qs, *_ = _forward(V, enc_params, Ps, u32, row_w)
        return loss, qs

    def fwd(V, enc_params, Ps, u32, row_w):
        loss, qs, Xp, grads = _forward(V, enc_params, Ps, u32, row_w)
        return (loss, qs), (enc_params, Ps, u32, row_w, Xp, grads)

    def bwd(res, cts):
        g_loss, g_qs = cts
        enc_params, Ps, u32, row_w, Xp, grads = res
        qs, enc_vjp = jax.vjp(qp.encode_from_xp, enc_params, Xp)
        if grads is None:
            _, dqs, dps = _heads(qs, Ps, u32, row_w * g_loss, False)
        else:
            dqs = [dq * g_loss for dq in grads[0]]
            dps = [dp * g_loss for dp in grads[1]]
        denc, dXp = enc_vjp({hk: dqs[i] + g_qs[hk]
                             for i, hk in enumerate(head_keys)})
        if snp_axis is not None:
            # True cotangent of this shard's Xp partial: the psum of the
            # per-shard cotangents of the replicated result.
            dXp = jax.lax.psum(dXp, snp_axis)
        dPs = {hk: dps[i] for i, hk in enumerate(head_keys)}
        return (dv(u32, dXp, interpret), denc, dPs, None, None)

    fused_training_loss.defvjp(fwd, bwd)
    return fused_training_loss
