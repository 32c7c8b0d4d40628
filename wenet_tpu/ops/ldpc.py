"""H2064_516 LDPC encode + batched sum-product decode (JAX).

Encoder (reference: tx/ldpc_enc.c:33-48): repeat-accumulate — parity bit p is
the running XOR of 12 tapped data bits per row.  Re-expressed as one gather +
row-sum + cumulative-sum mod 2: O(516*12) integer work, trivially batchable.

Decoder (reference: src/mpdecode_core.c:385-489 SumProduct, :494-566
run_ldpc_decoder): sum-product belief propagation in the phi-domain.  The
batched formulation abandons the per-node linked structs for a dense padded edge
tensor (516 checks x 14 edge slots, see core/ldpc_tables.py):

  * check-side reduction  = masked row reduce over the 14-slot axis
  * var-side reduction    = gather-sum of edge messages into the 2580 vars
                            over the per-var edge-slot table
  * per-codeword early exit (mpdecode_core.c:473-483) = convergence mask —
    converged codewords freeze their state while the batch keeps stepping,
    reproducing the exact early-exit output bits.

phi0: we use the exact phi(x) = -log(tanh(x/2)) with the reference's clamps
(phi0 approximations differ between builds; parity is defined at CRC-gated
packet output, per the reference's own benchmarking methodology).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import ldpc_tables as T

# ------------------------------------------------------------------ encode


def encode_bits_np(ibits: np.ndarray) -> np.ndarray:
    """ibits (..., 2064) uint8 -> parity (..., 516) uint8 (numpy, host)."""
    taps = T.encoder_taps()                       # (516, 12)
    par = ibits[..., taps].sum(axis=-1)           # (..., 516)
    return (np.cumsum(par, axis=-1) & 1).astype(np.uint8)


@jax.jit
def encode_bits(ibits: jnp.ndarray) -> jnp.ndarray:
    """ibits (..., 2064) -> parity (..., 516), device version."""
    taps = jnp.asarray(T.encoder_taps())
    par = jnp.take(ibits.astype(jnp.int32), taps, axis=-1).sum(axis=-1)
    return (jnp.cumsum(par, axis=-1) & 1).astype(jnp.uint8)


def encode_bytes(payload258: bytes) -> bytes:
    """258-byte payload+CRC -> 65-byte parity block (tx/ldpc_encoder.py:42-52:
    unpackbits MSB-first, encode, packbits)."""
    if len(payload258) != 258:
        raise ValueError("payload must be 258 bytes (2064-bit codeword)")
    ibits = np.unpackbits(np.frombuffer(payload258, dtype=np.uint8))
    return np.packbits(encode_bits_np(ibits)).tobytes()


# ------------------------------------------------------------------ decode


def phi0(x: jnp.ndarray) -> jnp.ndarray:
    """phi(x) = ln((e^x+1)/(e^x-1)) = -ln(tanh(x/2)), with the reference's
    clamps (mpdecode_core.c:95-123): x > 10 -> 0, x < 9.08e-5 -> 10."""
    xs = jnp.clip(x, 9.08e-5, 10.0)
    val = -jnp.log(jnp.tanh(xs * 0.5))
    val = jnp.where(x > 10.0, 0.0, val)
    return jnp.where(x < 9.08e-5, 10.0, val)


def sd_to_llr(sd: jnp.ndarray) -> jnp.ndarray:
    """Soft decisions -> LLRs with blind Es/N0 estimation
    (mpdecode_core.c:569-595).  sd: (..., n)."""
    n = sd.shape[-1]
    mean = jnp.mean(jnp.abs(sd), axis=-1, keepdims=True)
    sign = jnp.sign(sd)
    x = sd / mean - sign
    s = jnp.sum(x, axis=-1, keepdims=True)
    sq = jnp.sum(x * x, axis=-1, keepdims=True)
    estvar = (n * sq - s * s) / (n * (n - 1))
    est_esn0 = 1.0 / (2.0 * estvar + 1e-3)
    return 4.0 * est_esn0 * sd


def _decoder_constants():
    var_idx, mask = T.check_edges()
    vslots, vmask = T.var_edges()
    return (
        jnp.asarray(var_idx),                 # (516, 14) int32
        jnp.asarray(mask),                    # (516, 14) bool
        jnp.asarray(vslots),                  # (2580, 3) int32 flat edge slots
        jnp.asarray(vmask),                   # (2580, 3) bool
    )


@partial(jax.jit, static_argnames=("max_iter",))
def decode(llr: jnp.ndarray, max_iter: int = T.MAX_ITER):
    """Batched sum-product decode.

    Args:
      llr: (B, 2580) float32 input LLRs (positive = bit 0).
    Returns:
      bits:      (B, 2580) uint8 decoded codeword bits
      iters:     (B,) int32 iterations used (early-exit aware, matches the
                 C decoder's return value)
      parity_ok: (B,) bool — all 516 parity checks satisfied
    """
    var_idx, mask, vslots, vmask = _decoder_constants()
    B = llr.shape[0]
    fmask = mask.astype(llr.dtype)
    vfmask = vmask.astype(llr.dtype)

    def gather_vars(values):  # (B, 2580) -> (B, 516, 14)
        return values[:, var_idx]

    # v-side init (mpdecode_core.c:352-359): message = phi0(|llr|), sign bit
    llr_e = gather_vars(llr)                          # (B, 516, 14)
    vmsg = phi0(jnp.abs(llr_e)) * fmask
    vsgn = (llr_e < 0) & mask

    def body(state):
        it, vmsg, vsgn, bits, iters, converged = state

        # ---- R update (check -> var), mpdecode_core.c:412-436
        phi_sum = jnp.sum(vmsg, axis=-1, keepdims=True)          # (B,516,1)
        sgn_tot = (jnp.sum(vsgn, axis=-1, keepdims=True) & 1)    # parity of signs
        r_mag = phi0(phi_sum - vmsg)                             # (B,516,14)
        r_sgn = (sgn_tot ^ vsgn.astype(jnp.int32)) & 1
        rmsg = jnp.where(r_sgn == 1, -r_mag, r_mag) * fmask
        checks_ok = (sgn_tot[..., 0] == 0)                       # (B,516)
        ssum = jnp.sum(checks_ok, axis=-1)                       # (B,)

        # ---- Q update (var -> check), mpdecode_core.c:439-464
        # Qi = llr + sum of incoming r at each var.  Formulated as a GATHER
        # over the per-var edge-slot table (a scatter-add serialises on
        # colliding indices; the gather does not)
        flat_vals = (rmsg * fmask).reshape(B, -1)
        qsum = jnp.sum(flat_vals[:, vslots] * vfmask, axis=-1)
        qi = llr + qsum                                          # (B, 2580)
        new_bits = (qi < 0).astype(jnp.uint8)

        q_e = gather_vars(qi) - rmsg                             # extrinsic
        new_vmsg = phi0(jnp.abs(q_e)) * fmask
        new_vsgn = (q_e <= 0) & mask                             # C: >0 -> 0 else 1

        # ---- early exit (mpdecode_core.c:466-483): data bits all zero
        # (bitErrors==0 vs the all-zero data[] array) OR all checks satisfied.
        data_zero = jnp.all(new_bits[:, : T.N_DATA] == 0, axis=-1)
        trigger = data_zero | (ssum == T.N_PARITY)

        upd = ~converged
        vmsg = jnp.where(upd[:, None, None], new_vmsg, vmsg)
        vsgn = jnp.where(upd[:, None, None], new_vsgn, vsgn)
        bits = jnp.where(upd[:, None], new_bits, bits)
        iters = jnp.where(upd, it + 1, iters)
        converged = converged | trigger
        return it + 1, vmsg, vsgn, bits, iters, converged

    def cond(state):
        it, *_, converged = state
        return (it < max_iter) & ~jnp.all(converged)

    # derive the zero-init carry from llr so it carries the same device-
    # varying type under shard_map (scan/while carries must match)
    zerof = llr[:, 0] * 0.0
    init = (
        jnp.array(0, jnp.int32), vmsg, vsgn,
        (llr * 0.0).astype(jnp.uint8)[:, : T.CODE_LEN],
        zerof.astype(jnp.int32) + max_iter,
        zerof.astype(bool),
    )
    _, _, vsgn, bits, iters, _ = jax.lax.while_loop(cond, body, init)

    # final parity check on output bits (H @ bits mod 2 == 0)
    bits_e = bits[:, var_idx].astype(jnp.int32) * mask.astype(jnp.int32)
    parity_ok = jnp.all(jnp.sum(bits_e, axis=-1) % 2 == 0, axis=-1)
    return bits, iters, parity_ok


def decode_np(llr: np.ndarray, max_iter: int = T.MAX_ITER):
    """Convenience host wrapper (adds batch dim if needed)."""
    llr = np.atleast_2d(np.asarray(llr, np.float32))
    bits, iters, ok = decode(jnp.asarray(llr), max_iter=max_iter)
    return np.asarray(bits), np.asarray(iters), np.asarray(ok)


@partial(jax.jit, static_argnames=("max_iter", "scale"))
def decode_minsum(llr: jnp.ndarray, max_iter: int = T.MAX_ITER,
                  scale: float = 0.8):
    """Batched NORMALIZED MIN-SUM decode — the fast sweep engine.

    Same graph, same early-exit/convergence-masking semantics as
    `decode`, but the check-node update is the standard normalized
    min-sum approximation (r = scale · sign-product · min-excluded |q|)
    instead of the phi-domain sum-product.  No transcendentals anywhere
    in the iteration: pure compare/select/add, no log/tanh per edge.

    NOT the reference algorithm (mpdecode_core.c is sum-product): packet
    decisions can differ near threshold by a fraction of a dB — use
    `decode` whenever oracle parity matters; use this for Monte-Carlo
    volume.  The 0.8 normalization is the conventional single-scalar
    correction for the min-sum overestimate.
    """
    var_idx, mask, vslots, vmask = _decoder_constants()
    B = llr.shape[0]
    fmask = mask.astype(llr.dtype)
    vfmask = vmask.astype(llr.dtype)
    BIG = jnp.float32(1e30)
    slot_idx = jnp.arange(mask.shape[1], dtype=jnp.int32)       # (14,)

    def gather_vars(values):  # (B, 2580) -> (B, 516, 14)
        return values[:, var_idx]

    q_e = gather_vars(llr)                                      # (B,516,14)
    qmag = jnp.where(mask, jnp.abs(q_e), BIG)
    qsgn = (q_e < 0) & mask

    def body(state):
        it, qmag, qsgn, bits, iters, converged = state

        # ---- R update: normalized min-sum (two-min trick, portable
        # first-min position from min reductions — no arg* primitives)
        m1 = jnp.min(qmag, axis=-1, keepdims=True)              # (B,516,1)
        pos = jnp.min(jnp.where(qmag <= m1, slot_idx, mask.shape[1]),
                      axis=-1, keepdims=True)                   # (B,516,1)
        m2 = jnp.min(jnp.where(slot_idx == pos, BIG, qmag),
                     axis=-1, keepdims=True)
        r_mag = jnp.where(slot_idx == pos, m2, m1) * scale      # (B,516,14)
        sgn_tot = (jnp.sum(qsgn, axis=-1, keepdims=True) & 1)
        r_sgn = (sgn_tot ^ qsgn.astype(jnp.int32)) & 1
        new_rmsg = jnp.where(r_sgn == 1, -r_mag, r_mag) * fmask
        checks_ok = (sgn_tot[..., 0] == 0)
        ssum = jnp.sum(checks_ok, axis=-1)

        # ---- Q update (identical structure to sum-product)
        flat_vals = new_rmsg.reshape(B, -1)
        qsum = jnp.sum(flat_vals[:, vslots] * vfmask, axis=-1)
        qi = llr + qsum
        new_bits = (qi < 0).astype(jnp.uint8)
        q_e = gather_vars(qi) - new_rmsg
        new_qmag = jnp.where(mask, jnp.abs(q_e), BIG)
        new_qsgn = (q_e < 0) & mask

        data_zero = jnp.all(new_bits[:, : T.N_DATA] == 0, axis=-1)
        trigger = data_zero | (ssum == T.N_PARITY)

        upd = ~converged
        qmag = jnp.where(upd[:, None, None], new_qmag, qmag)
        qsgn = jnp.where(upd[:, None, None], new_qsgn, qsgn)
        bits = jnp.where(upd[:, None], new_bits, bits)
        iters = jnp.where(upd, it + 1, iters)
        converged = converged | trigger
        return it + 1, qmag, qsgn, bits, iters, converged

    def cond(state):
        it, *_, converged = state
        return (it < max_iter) & ~jnp.all(converged)

    zerof = llr[:, 0] * 0.0
    init = (
        jnp.array(0, jnp.int32), qmag, qsgn,
        (llr * 0.0).astype(jnp.uint8)[:, : T.CODE_LEN],
        zerof.astype(jnp.int32) + max_iter,
        zerof.astype(bool),
    )
    _, _, _, bits, iters, _ = jax.lax.while_loop(cond, body, init)

    bits_e = bits[:, var_idx].astype(jnp.int32) * mask.astype(jnp.int32)
    parity_ok = jnp.all(jnp.sum(bits_e, axis=-1) % 2 == 0, axis=-1)
    return bits, iters, parity_ok
