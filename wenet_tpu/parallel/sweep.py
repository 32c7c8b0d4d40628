"""Sharded Monte-Carlo sweeps: LDPC BER/FER curves and full-chain PER curves.

BASELINE.json configs 2 and 5: batches of noisy realisations are data-
parallel over a device mesh (shard_map), per-device counters are
psum-reduced across the mesh, and everything inside is jitted — zero host
round-trips per point.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..core import framing
from ..utils import compat
from ..ops import crc as dcrc
from ..ops import fsk, ldpc
from ..utils.rng import prng_key


# ------------------------------------------------------------- LDPC-only MC


def _ldpc_trial_batch(key, ebno_db, n_cw: int, max_iter: int,
                      algo: str = "sum-product"):
    """One batch of codeword trials at one Eb/N0 point (runs on device)."""
    kbits, knoise = jax.random.split(key)
    ibits = jax.random.bernoulli(kbits, 0.5, (n_cw, 2064)).astype(jnp.uint8)
    parity = ldpc.encode_bits(ibits)
    cw = jnp.concatenate([ibits, parity], axis=1)
    sym = 1.0 - 2.0 * cw.astype(jnp.float32)
    esn0 = 10.0 ** (ebno_db / 10.0) * (2064.0 / 2580.0)
    sigma = jnp.sqrt(1.0 / (2.0 * esn0))
    sd = sym + sigma * jax.random.normal(knoise, sym.shape, jnp.float32)
    llr = ldpc.sd_to_llr(sd)
    dec = ldpc.decode_minsum if algo == "min-sum" else ldpc.decode
    bits, iters, parity_ok = dec(llr, max_iter=max_iter)
    bit_errs = jnp.sum(bits[:, :2064] != ibits, dtype=jnp.int32)
    frame_errs = jnp.sum(jnp.any(bits[:, :2064] != ibits, axis=1), dtype=jnp.int32)
    return bit_errs, frame_errs, jnp.sum(iters, dtype=jnp.int32)


@partial(jax.jit, static_argnames=("n_cw", "max_iter", "algo"))
def _ldpc_point(key, ebno_db, n_cw, max_iter, algo="sum-product"):
    return _ldpc_trial_batch(key, ebno_db, n_cw, max_iter, algo)


def ldpc_ber_sweep(ebno_grid, n_cw_per_point: int, key=None, mesh=None,
                   max_iter: int = 10, algo: str = "sum-product"):
    """BER/FER vs Eb/N0 for H2064_516.  With a mesh, trials are sharded over
    the 'batch' axis and counters psum-reduced on device.

    algo: "sum-product" (reference-exact) or "min-sum" (normalized,
    transcendental-free — the fast Monte-Carlo engine for big sweeps).

    Returns dict of numpy arrays: ebno, ber, fer, mean_iters.
    """
    key = prng_key(0) if key is None else key
    ebno_grid = np.atleast_1d(np.asarray(ebno_grid, np.float32))
    keys = jax.random.split(key, len(ebno_grid))

    if mesh is None:
        out = [_ldpc_point(k, e, n_cw_per_point, max_iter, algo)
               for k, e in zip(keys, ebno_grid)]
        be, fe, it = (np.array([o[i] for o in out]) for i in range(3))
        n = n_cw_per_point
    else:
        ndev = mesh.devices.size
        per_dev = -(-n_cw_per_point // ndev)
        n = per_dev * ndev

        @partial(jax.jit, static_argnames=())
        @partial(jax.shard_map, mesh=mesh, in_specs=(P("batch"), P()),
                 out_specs=P())
        def point(dev_keys, ebno):
            b, f, i = _ldpc_trial_batch(dev_keys[0], ebno, per_dev, max_iter,
                                        algo)
            return (jax.lax.psum(b, "batch"), jax.lax.psum(f, "batch"),
                    jax.lax.psum(i, "batch"))

        be, fe, it = [], [], []
        for k, e in zip(keys, ebno_grid):
            dev_keys = jax.random.split(k, ndev)
            b, f, i = point(dev_keys, jnp.float32(e))
            be.append(int(b)), fe.append(int(f)), it.append(int(i))
        be, fe, it = np.array(be), np.array(fe), np.array(it)

    return {"ebno_db": ebno_grid, "ber": be / (n * 2064.0), "fer": fe / n,
            "mean_iters": it / n, "n_codewords": n}


# ---------------------------------------------------------- full-chain MC


def make_single_packet_stream(cfg: fsk.FSKConfig, payload: bytes,
                              mode: str = "v2", pad_frames: int = 4,
                              seed: int = 0):
    """Host-side: frame one payload and modulate a short capture around it.
    Returns (iq clean complex64, tx signal variance) for device trials."""
    rng = np.random.default_rng(seed)
    frame = framing.frame_packet(payload, ldpc.encode_bytes, mode=mode)
    bits = np.concatenate([
        rng.integers(0, 2, cfg.Nbits * pad_frames).astype(np.uint8),
        framing.frame_to_bits(frame, mode),
        rng.integers(0, 2, cfg.Nbits * pad_frames).astype(np.uint8)])
    bits = np.concatenate([bits, np.zeros((-len(bits)) % cfg.Nbits, np.uint8)])
    f1 = 2 * cfg.Rs
    sig, _ = fsk.fsk_mod_np(cfg, bits, f1, cfg.Rs)
    return sig.astype(np.complex64), float(np.mean(np.abs(sig) ** 2))


def _uw_window_decode(cfg, soft, mode: str, max_iter: int):
    """Device-side UW locate + decode of one packet window from a soft
    stream (simplified greedy acquisition: strongest correlation peak)."""
    if mode == "v2":
        uw = framing.UW_BITS_V2
        syms = framing.V2_SYMBOLS_PER_PACKET
    else:
        uw = framing.UW_BITS_V1
        syms = framing.V1_SYMBOLS_PER_PACKET
    n = soft.shape[0]
    nuw = uw.shape[0]
    hard_pm = jnp.where(soft < 0, -1.0, 1.0)
    kern = jnp.asarray(1.0 - 2.0 * uw.astype(np.float32))
    # scores[s] = correlation of the window starting at s with the UW
    scores = jnp.correlate(hard_pm, kern, mode="valid")
    # need the full packet window [t+1, t+syms] in-stream (t = s + nuw - 1)
    idx = jnp.arange(scores.shape[0])
    scores = jnp.where(idx <= n - syms - nuw, scores, -1e9)
    # first-max index without arg* primitives (backend portability)
    s_first = jnp.min(jnp.where(scores >= jnp.max(scores), idx,
                                scores.shape[0]))
    t = s_first + nuw - 1
    win = jax.lax.dynamic_slice(soft, (t + 1,), (syms,))
    if mode == "v2":
        code = jnp.asarray(np.resize(framing.SCRAMBLE_PM1, syms))
        sd = (win * code)[:2580]
    else:
        w = win.reshape(-1, 10)
        sd = w[:, 8:0:-1].reshape(-1)[:2580]
    llr = ldpc.sd_to_llr(sd[None])
    bits, iters, _ = ldpc.decode(llr, max_iter=max_iter)
    ok = dcrc.packet_crc_ok(bits[0])
    return ok, iters[0]


def chain_per_sweep(cfg: fsk.FSKConfig, ebno_grid, trials_per_point: int,
                    payload: bytes | None = None, mode: str = "v2",
                    key=None, mesh=None, max_iter: int = 10):
    """Full-chain PER vs Eb/N0: mod -> AWGN -> scan demod -> UW -> BP -> CRC,
    entirely on device, vmapped over trials (sharded over a mesh if given).

    Reproduces the shape of benchmarking/test_demod.py's curve (PER cliff
    near 8.5 dB for the real code) with zero external binaries.
    """
    key = prng_key(42) if key is None else key
    payload = bytes(range(256)) if payload is None else payload
    sig, var = make_single_packet_stream(cfg, payload, mode)
    sig_j = compat.put_complex(sig)
    nf = cfg.num_frames(len(sig))

    def one_trial(k, ebno_db, s):
        ebno = 10.0 ** (ebno_db / 10.0)
        nvar = var * cfg.Fs / (cfg.Rs * ebno)
        z = jax.random.normal(k, (len(sig), 2), jnp.float32)
        iq = s + jnp.sqrt(nvar / 2.0) * jax.lax.complex(z[:, 0], z[:, 1])
        iq = iq / jnp.max(jnp.abs(iq))
        _, outs = fsk.demod_stream(
            cfg, iq, nf, frames_per_step=fsk.default_frames_per_step())
        soft = outs.soft.reshape(-1)
        ok, iters = _uw_window_decode(cfg, soft, mode, max_iter)
        return ok.astype(jnp.int32), iters

    trial_v = jax.jit(jax.vmap(one_trial, in_axes=(0, None, None)))

    ebno_grid = np.atleast_1d(np.asarray(ebno_grid, np.float32))
    pers, mean_iters = [], []
    if mesh is not None:
        ndev = mesh.devices.size
        trials = -(-trials_per_point // ndev) * ndev

        @jax.jit
        @partial(jax.shard_map, mesh=mesh, in_specs=(P("batch"), P(), P()),
                 out_specs=(P(), P()))
        def sharded(keys, ebno, s):
            ok, iters = jax.vmap(one_trial, in_axes=(0, None, None))(
                keys, ebno, s)
            return (jax.lax.psum(jnp.sum(ok), "batch"),
                    jax.lax.psum(jnp.sum(iters), "batch"))

        for i, e in enumerate(ebno_grid):
            keys = jax.random.split(jax.random.fold_in(key, i), trials)
            nok, it = sharded(keys, jnp.float32(e), sig_j)
            pers.append(1.0 - int(nok) / trials)
            mean_iters.append(int(it) / trials)
    else:
        trials = trials_per_point
        for i, e in enumerate(ebno_grid):
            keys = jax.random.split(jax.random.fold_in(key, i), trials)
            ok, iters = trial_v(keys, jnp.float32(e), sig_j)
            pers.append(1.0 - float(jnp.mean(ok.astype(jnp.float32))))
            mean_iters.append(float(jnp.mean(iters.astype(jnp.float32))))

    return {"ebno_db": ebno_grid, "per": np.array(pers),
            "mean_iters": np.array(mean_iters), "trials": trials}


# -------------------------------------------------- coarse acquisition search


def acquisition_search(cfg: fsk.FSKConfig, iq, offsets_hz,
                       mode: str = "v2", probe_frames: int | None = None,
                       mesh=None):
    """Coarse frequency-offset acquisition over a candidate grid.

    When the capture's tones sit outside the demod estimator's band
    [Rs/4, Fs/2-Rs/4] (fsk.c:175-180) — a wideband SDR tuned far off, the
    start_rx.sh offset formula misapplied — the reference has no recovery
    path short of re-tuning the SDR. Here each candidate offset is searched
    in parallel on device: mix the capture down by the offset, scan-demod a
    short probe span, and score the strongest UW correlation of the hard
    bits. The offset grid is data-parallel (vmap; shard_map over a mesh axis
    for pod-scale search — BASELINE config 5).

    Returns (best_offset_hz, scores ndarray aligned with offsets_hz).
    """
    offsets_hz = np.atleast_1d(np.asarray(offsets_hz, np.float32))
    syms_pp = (framing.V2_SYMBOLS_PER_PACKET if mode == "v2"
               else framing.V1_SYMBOLS_PER_PACKET)
    # default probe: two packet lengths + estimator warmup, so at least one
    # whole UW lies inside the span wherever packet boundaries fall
    default_nf = 2 * (syms_pp // cfg.Nsym + 2) + 16
    nf = probe_frames or min(cfg.num_frames(len(iq)), default_nf)
    npad = nf * cfg.N + cfg.Nmem + cfg.Ts
    iq = np.asarray(iq)[:npad]
    iq_j = compat.put_complex(iq)
    uw = framing.UW_BITS_V2 if mode == "v2" else framing.UW_BITS_V1
    kern = jnp.asarray(1.0 - 2.0 * uw.astype(np.float32))
    n = np.arange(len(iq), dtype=np.float32)

    def score_one(off_hz, s):
        # wrapped fractional phase keeps f32 exact over long probes
        frac = jnp.mod(off_hz / cfg.Fs, 1.0)
        ph = jnp.mod(n * frac, 1.0) * np.float32(2 * np.pi)
        mixed = s * jax.lax.complex(jnp.cos(ph), -jnp.sin(ph))
        _, outs = fsk.demod_stream(
            cfg, mixed, nf, frames_per_step=fsk.default_frames_per_step())
        hard = jnp.where(outs.soft.reshape(-1) < 0, -1.0, 1.0)
        return jnp.max(jnp.correlate(hard, kern, mode="valid"))

    if mesh is not None:
        ndev = mesh.devices.size
        ngrid = -(-len(offsets_hz) // ndev) * ndev
        grid = np.resize(offsets_hz, ngrid)

        @jax.jit
        @partial(jax.shard_map, mesh=mesh, in_specs=(P("batch"), P()),
                 out_specs=P("batch"))
        def sharded(offs, s):
            return jax.vmap(score_one, in_axes=(0, None))(offs, s)

        scores = np.asarray(sharded(jnp.asarray(grid), iq_j))[:len(offsets_hz)]
    else:
        scores = np.asarray(jax.jit(jax.vmap(score_one, in_axes=(0, None)))(
            jnp.asarray(offsets_hz), iq_j))
    return float(offsets_hz[int(np.argmax(scores))]), scores
