"""Tensor-parallel LDPC decode: check rows sharded across a mesh axis.

SURVEY.md §2.3 TP row: the (516 x 14) check-side message tensors are
sharded over the 'model' mesh axis; the var-side reduction — each shard
scatter-adds its edges into the full 2580-var axis — is completed with one
psum over that axis per iteration.
Semantics identical to ops/ldpc.decode (same early-exit masking).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..core import ldpc_tables as T
from ..ops.ldpc import phi0


def _padded_tables(tp: int):
    var_idx, mask = T.check_edges()
    rows = var_idx.shape[0]
    pad = (-rows) % tp
    var_idx = np.pad(var_idx, ((0, pad), (0, 0)))
    mask = np.pad(mask, ((0, pad), (0, 0)))
    return jnp.asarray(var_idx), jnp.asarray(mask), rows + pad


def decode_sharded(llr, mesh, max_iter: int = T.MAX_ITER,
                   batch_axis: str = "batch", model_axis: str = "model"):
    """llr (B, 2580) -> (bits, iters, parity_ok), B sharded over batch_axis,
    check rows over model_axis."""
    tp = mesh.shape[model_axis]
    var_idx, mask, rows_p = _padded_tables(tp)
    n_real_checks = T.N_PARITY

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(batch_axis, None), P(model_axis, None),
                       P(model_axis, None)),
             out_specs=(P(batch_axis, None), P(batch_axis), P(batch_axis)))
    def run(llr, var_idx, mask):
        B = llr.shape[0]
        R = var_idx.shape[0]                      # local check rows
        fmask = mask.astype(llr.dtype)
        # count of real (unpadded) checks on this shard
        shard_i = jax.lax.axis_index(model_axis)
        row0 = shard_i * R
        real_rows = jnp.clip(n_real_checks - row0, 0, R)

        def gather_vars(values):
            return values[:, var_idx]

        llr_e = gather_vars(llr)
        vmsg = phi0(jnp.abs(llr_e)) * fmask
        vsgn = (llr_e < 0) & mask

        flat_idx = var_idx.reshape(-1)

        def body(state):
            it, vmsg, vsgn, bits, iters, converged = state
            phi_sum = jnp.sum(vmsg, axis=-1, keepdims=True)
            sgn_tot = (jnp.sum(vsgn, axis=-1, keepdims=True) & 1)
            r_mag = phi0(phi_sum - vmsg)
            r_sgn = (sgn_tot ^ vsgn.astype(jnp.int32)) & 1
            rmsg = jnp.where(r_sgn == 1, -r_mag, r_mag) * fmask
            checks_ok = (sgn_tot[..., 0] == 0)
            # only real rows count toward the all-checks-satisfied exit
            row_valid = jax.lax.broadcasted_iota(
                jnp.int32, checks_ok.shape, 1) < real_rows
            ssum = jax.lax.psum(
                jnp.sum(checks_ok & row_valid, axis=-1), model_axis)

            flat_vals = (rmsg * fmask).reshape(B, -1)
            partial_q = jnp.zeros_like(llr).at[:, flat_idx].add(flat_vals)
            qsum = jax.lax.psum(partial_q, model_axis)       # <- TP collective
            qi = llr + qsum
            new_bits = (qi < 0).astype(jnp.uint8)

            q_e = gather_vars(qi) - rmsg
            new_vmsg = phi0(jnp.abs(q_e)) * fmask
            new_vsgn = (q_e <= 0) & mask

            data_zero = jnp.all(new_bits[:, : T.N_DATA] == 0, axis=-1)
            trigger = data_zero | (ssum == n_real_checks)

            upd = ~converged
            vmsg = jnp.where(upd[:, None, None], new_vmsg, vmsg)
            vsgn = jnp.where(upd[:, None, None], new_vsgn, vsgn)
            bits = jnp.where(upd[:, None], new_bits, bits)
            iters = jnp.where(upd, it + 1, iters)
            return it + 1, vmsg, vsgn, bits, iters, converged | trigger

        def cond(state):
            it, *_, converged = state
            return (it < max_iter) & ~jnp.all(converged)

        zerof = llr[:, 0] * 0.0
        init = (jnp.array(0, jnp.int32), vmsg, vsgn,
                (llr * 0.0).astype(jnp.uint8),
                zerof.astype(jnp.int32) + max_iter, zerof.astype(bool))
        _, _, _, bits, iters, _ = jax.lax.while_loop(cond, body, init)

        bits_e = gather_vars(bits).astype(jnp.int32) * mask.astype(jnp.int32)
        row_valid = jax.lax.broadcasted_iota(
            jnp.int32, (B, R), 1) < real_rows
        bad = jnp.sum(((jnp.sum(bits_e, axis=-1) % 2) != 0) & row_valid,
                      axis=-1)
        parity_ok = jax.lax.psum(bad, model_axis) == 0
        return bits, iters, parity_ok

    return run(llr, var_idx, mask)
