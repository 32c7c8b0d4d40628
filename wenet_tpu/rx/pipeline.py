"""End-to-end RX pipeline: IQ samples -> CRC-verified 256-byte packets.

Replaces the reference's multi-process shell pipeline
(start_rx.sh:125-133: rtl_sdr | fsk_demod | wenet_ldpc | rx_ssdv.py) with a
single in-process chain: a jitted scan demodulator feeding the batched
deframer.  Both one-shot (`decode_iq`) and chunked streaming (`push`) APIs,
with exact state carry so chunked == one-shot.
"""
from __future__ import annotations

import dataclasses
import functools as _functools
import os as _os

import numpy as np

from ..core import framing
from ..ops import deframe, fsk
from ..utils import compat


MODE_CONFIGS = {
    "v1": fsk.V1_CONFIG,     # 115177 baud RS232 framing (drs232_ldpc path)
    "v2": fsk.V2_CONFIG,     # 96000 baud raw+scrambled (wenet_ldpc path)
}

INPUT_CONVERTERS = {
    "cu8": (fsk.iq_from_cu8, np.uint8, 2),
    "cs16": (fsk.iq_from_cs16, np.int16, 2),
    "s16": (fsk.iq_from_s16_real, np.int16, 1),
    "c64": (lambda raw: np.asarray(raw, np.complex64), np.complex64, 1),
}


@dataclasses.dataclass
class RxStats:
    frames: int = 0
    samples: int = 0
    detections: int = 0
    crc_ok: int = 0
    ebno_db: float = 0.0
    f_est: tuple = (0.0, 0.0)
    ppm: float = 0.0

    @property
    def per(self) -> float:
        return (self.detections - self.crc_ok) / max(self.detections, 1)


def decode_iq_parallel(iq: np.ndarray, mode: str = "v2",
                       cfg: fsk.FSKConfig | None = None,
                       n_chunks: int = 8, warmup_frames: int = 8,
                       max_iter: int = 10, mesh=None,
                       input_format: str = "c64"):
    """Data-parallel single-capture decode: overlap-save over the time axis.

    The sequential scan demod is exact but serial; for throughput the
    capture is split into n_chunks segments demodulated concurrently
    (vmap — or sharded across chips by the caller), each with a halo of
    `warmup_frames` preceding frames to converge the estimators plus one
    packet length of overlap so every packet lies wholly inside some chunk.
    Chunk deframes run independently; duplicate packets from the overlap
    are deduplicated by (content, approximate global position).

    This is the project's sequence-parallelism (SURVEY.md §2.3): halo
    exchange of carried demod state replaced by recompute-from-overlap,
    which maps better onto XLA than cross-chunk state threading.
    """
    import jax
    import jax.numpy as jnp

    cfg = MODE_CONFIGS[mode] if cfg is None else cfg
    if input_format == "cu8":
        raw = np.asarray(iq, np.uint8)
        n = len(raw) // 2
    else:
        iq = np.asarray(iq, np.complex64)
        n = len(iq)
    syms_pp = (framing.V2_SYMBOLS_PER_PACKET if mode == "v2"
               else framing.V1_SYMBOLS_PER_PACKET)
    packet_frames = syms_pp // cfg.Nsym + 2
    halo_frames = warmup_frames + packet_frames
    halo = halo_frames * cfg.N

    core = -(-n // n_chunks)                       # samples per chunk core
    # flush tail: the scan needs lookahead (stash + timing interp) past the
    # last symbol, so a packet ending exactly at the capture end still
    # demodulates in the final chunk (zero-padded; interior duplicates dedup)
    flush = 8 * cfg.N
    chunk_len = core + halo + flush
    starts = np.maximum(np.arange(n_chunks) * core - halo, 0)
    nf = cfg.num_frames(chunk_len)

    if input_format == "cu8":
        # move the raw rtl_sdr bytes (2 B/sample, 4x less host->device
        # traffic than complex64 pairs) and do BOTH the u8->complex
        # conversion (fsk_demod.c:281-287) and the overlap-save chunk gather
        # on device, in the same program as the vmapped demod; this also
        # skips one full host-side copy of the capture.
        pad = np.zeros(((n + chunk_len) - n) * 2, np.uint8)
        raw_pairs = np.concatenate([raw[: 2 * n], pad]).reshape(-1, 2)
        starts_j = jnp.asarray(starts.astype(np.int32))

        @jax.jit
        def front(r, st):
            x = (r.astype(jnp.float32) - 127.0) * (1.0 / 128.0)
            z = jax.lax.complex(x[:, 0], x[:, 1])
            ix = st[:, None] + jnp.arange(chunk_len, dtype=jnp.int32)
            return jax.vmap(lambda s: fsk.demod_stream(cfg, s, nf)[1])(z[ix])

        outs = jax.tree.map(np.asarray, front(jnp.asarray(raw_pairs),
                                              starts_j))
    else:
        # gather fixed-size chunks (pad capture at both ends)
        buf = np.zeros(n + chunk_len, np.complex64)
        buf[:n] = iq
        chunks = np.stack([buf[s:s + chunk_len] for s in starts])

        vdemod = jax.jit(jax.vmap(lambda x: fsk.demod_stream(cfg, x, nf)[1]),
                         static_argnums=())
        chunks_j = compat.put_complex(chunks)
        if mesh is not None:
            # shard the chunk axis over the mesh: each device demodulates
            # its chunks concurrently
            from jax.sharding import NamedSharding, PartitionSpec as P
            axis = mesh.axis_names[0]
            chunks_j = jax.device_put(chunks_j, NamedSharding(mesh, P(axis)))
        outs = jax.tree.map(np.asarray, vdemod(chunks_j))

    # "all" acquisition per chunk (a chunk can start mid-packet, where the
    # FSM's freeze-during-collection semantics are path-dependent; batched
    # correlation + CRC gating is order-independent), with every chunk's
    # candidate windows concatenated into ONE decoder dispatch
    all_windows, metas = [], []
    for k in range(n_chunks):
        valid = outs.valid[k]
        skip = warmup_frames if starts[k] > 0 else 0  # drop halo warmup output
        soft = outs.soft[k][valid][skip:].reshape(-1)
        hard = (soft < 0).astype(np.uint8)
        pos = deframe.correlation_candidates(hard, mode)
        if len(pos) == 0:
            continue
        idx = pos[:, None] + 1 + np.arange(syms_pp)[None, :]
        all_windows.append(soft[idx])
        base_bit = starts[k] // cfg.Ts + skip * cfg.Nsym
        metas.extend((k, int(t), base_bit + int(t)) for t in pos)

    results = []
    if metas:
        windows = np.concatenate(all_windows)
        pkts, ok, _ = deframe.decode_windows(windows, mode, max_iter)
        last_end = {}                      # per-chunk greedy overlap resolve
        for i, (k, t, gpos) in enumerate(metas):
            if ok[i] and t > last_end.get(k, -1):
                last_end[k] = t + syms_pp
                results.append((gpos, pkts[i, :256].tobytes()))

    # dedup: same content within one packet-length of global bit position
    results.sort(key=lambda x: x[0])
    payloads, last_pos = [], {}
    for pos, payload in results:
        if payload in last_pos and pos - last_pos[payload] < syms_pp:
            last_pos[payload] = pos
            continue
        last_pos[payload] = pos
        payloads.append(payload)
    return payloads


def _fused_geometry(cfg: fsk.FSKConfig, mode: str, n: int, n_chunks: int,
                    warmup_frames: int):
    """Static overlap-save geometry shared by the fused decoder."""
    syms_pp = (framing.V2_SYMBOLS_PER_PACKET if mode == "v2"
               else framing.V1_SYMBOLS_PER_PACKET)
    packet_frames = syms_pp // cfg.Nsym + 2
    halo = (warmup_frames + packet_frames) * cfg.N
    core = -(-n // n_chunks)
    flush = 8 * cfg.N
    chunk_len = core + halo + flush
    starts = np.maximum(np.arange(n_chunks) * core - halo, 0).astype(np.int32)
    skips = np.where(starts > 0, warmup_frames, 0).astype(np.int32)
    return syms_pp, chunk_len, starts, skips


@_functools.lru_cache(maxsize=8)
def _fused_program(cfg: fsk.FSKConfig, mode: str, chunk_len: int, nf: int,
                   k: int, max_iter: int, fmt: str, unroll: int = 1,
                   fstep: int = 1, starts_static: tuple | None = None):
    """Compile the ONE-dispatch RX chain: ingest-format conversion +
    overlap-save chunk gather + vmapped scan demod + on-device UW top-k
    deframe + batched BP decode + CRC — a single XLA program.

    Everything after the raw-byte H2D lives in one program, so the host
    pays one dispatch per capture and only dedups the (tiny)
    packet/position results.
    """
    import jax
    import jax.numpy as jnp

    def run(data, starts, skips):
        # pad on DEVICE (one chunk_len of silence) so the host hands over a
        # zero-copy view of the raw capture instead of copying all of it
        pad_val = 127 if fmt == "cu8" else 0       # 127 == 0.0 after center
        pad = jnp.full((chunk_len, 2), pad_val, data.dtype)
        buf = jnp.concatenate([data, pad], axis=0)
        if starts_static is not None:
            # chunk starts are compile-time (the geometry already keys the
            # program on n via chunk_len): C contiguous STATIC slices, plain
            # copies where an advanced-indexing gather computes every
            # element's address
            chunks = jnp.stack([
                jax.lax.slice(buf, (s, 0), (s + chunk_len, 2))
                for s in starts_static])
        else:
            # mesh path: traced starts carry the chunk-axis sharding that
            # drives XLA's partitioning — keep the gather form there
            ix = starts[:, None] + jnp.arange(chunk_len, dtype=jnp.int32)
            chunks = buf[ix]              # (C, chunk_len, 2) raw pairs

        def one(chunk, skip):
            # format conversion per chunk, after the gather: avoids
            # materialising full-capture f32/complex intermediates in HBM
            if fmt == "cu8":
                x = (chunk.astype(jnp.float32) - 127.0) * (1.0 / 128.0)
            elif fmt == "cs16":           # KA9Q pcmcat s16 IQ pairs
                x = chunk.astype(jnp.float32) * np.float32(1 / fsk.FDMDV_SCALE)
            else:                         # float32 (re, im) pairs
                x = chunk
            z = jax.lax.complex(x[..., 0], x[..., 1])
            # scan unroll and fstep frames per scan step amortize the
            # per-step overhead of the sequential demod (the per-lane
            # window gather runs once per step) — both bit-exact
            _, outs = fsk.demod_stream(cfg, z, nf, unroll=unroll,
                                       frames_per_step=fstep)
            # blank halo-warmup + past-end frames to +1.0 (hard bit 0: can
            # never hit the UW, so no spurious candidates) — keeps shapes
            # static where the host path drops those frames
            keep = outs.valid & (jnp.arange(nf, dtype=jnp.int32) >= skip)
            soft = jnp.where(keep[:, None], outs.soft, 1.0).reshape(-1)
            pb, ok, _, pos = deframe.deframe_topk(
                soft, mode=mode, k=k, max_iter=max_iter)
            # ONE uint8 result array == one D2H fetch; the host side
            # reverses it with unpack_decode_results
            return deframe.pack_decode_results(pb, ok, pos)
        return jax.vmap(one)(chunks, skips)

    return jax.jit(run)


def _fused_unroll(value):
    """Fused-path scan unroll: semantics-preserving codegen knob (identical
    outputs for any value).  Default 1; WENET_FUSED_UNROLL for
    experiments."""
    if value is not None:
        return int(value)
    return int(_os.environ.get("WENET_FUSED_UNROLL", "1"))


def _normalize_fused_input(raw, input_format: str):
    """Raw input -> ((n,2) zero-copy pairs view, n samples, canonical fmt)."""
    if input_format == "cu8":
        raw = np.asarray(raw, np.uint8)
        n = len(raw) // 2
        return raw[: 2 * n].reshape(-1, 2), n, "cu8"
    if input_format == "cs16":
        raw = np.asarray(raw, np.int16)
        n = len(raw) // 2
        return raw[: 2 * n].reshape(-1, 2), n, "cs16"
    if input_format == "c64":
        iq = np.asarray(raw, np.complex64)
    else:
        conv, dtype, _ = INPUT_CONVERTERS[input_format]
        iq = conv(np.asarray(raw, dtype))
    return iq.view(np.float32).reshape(-1, 2), len(iq), "c64"


def _unpack_fused(packed: np.ndarray, starts, cfg, base_bit: int = 0):
    """Host-side decode of the fused program's packed result array into
    (global bit position, payload bytes) tuples."""
    pb, ok, pos = deframe.unpack_decode_results(packed)
    results = []
    for c in range(packed.shape[0]):
        cb = base_bit + int(starts[c]) // cfg.Ts
        for i in range(packed.shape[1]):
            if ok[c, i] and pos[c, i] >= 0:
                results.append((cb + int(pos[c, i]), pb[c, i, :256].tobytes()))
    return results


def _dedup_payloads(results, syms_pp: int):
    """Drop duplicates: same content within one packet-length of global bit
    position (chunk/slab halos decode boundary packets more than once)."""
    results.sort(key=lambda x: x[0])
    payloads, last_pos = [], {}
    for p, payload in results:
        if payload in last_pos and p - last_pos[payload] < syms_pp:
            last_pos[payload] = p
            continue
        last_pos[payload] = p
        payloads.append(payload)
    return payloads


def fused_plan(raw: np.ndarray, mode: str = "v2",
               cfg: fsk.FSKConfig | None = None, n_chunks: int = 16,
               warmup_frames: int = 8, max_iter: int = 10,
               input_format: str = "cu8", k_per_chunk: int | None = None,
               static_starts: bool = True, scan_unroll: int | None = None,
               frames_per_step: int | None = None):
    """The fused program for a capture and its host-side arguments:
    (fn, data, starts, skips, syms_pp), where fn(data, starts, skips)
    returns the packed per-chunk packet results.  data is a zero-copy
    (n, 2) view of the raw samples."""
    cfg = MODE_CONFIGS[mode] if cfg is None else cfg
    data, n, input_format = _normalize_fused_input(raw, input_format)
    syms_pp, chunk_len, starts, skips = _fused_geometry(
        cfg, mode, n, n_chunks, warmup_frames)
    nf = cfg.num_frames(chunk_len)
    if k_per_chunk is None:
        k_per_chunk = int(np.ceil(chunk_len / cfg.Ts / syms_pp)) + 2
    fn = _fused_program(cfg, mode, chunk_len, nf, k_per_chunk, max_iter,
                        input_format, _fused_unroll(scan_unroll),
                        fsk.default_frames_per_step(frames_per_step),
                        tuple(int(s) for s in starts) if static_starts
                        else None)
    return fn, data, starts, skips, syms_pp


def decode_iq_fused(raw: np.ndarray, mode: str = "v2",
                    cfg: fsk.FSKConfig | None = None, n_chunks: int = 16,
                    warmup_frames: int = 8, max_iter: int = 10,
                    input_format: str = "cu8", k_per_chunk: int | None = None,
                    mesh=None, scan_unroll: int | None = None,
                    frames_per_step: int | None = None):
    """Single-dispatch capture decode: raw samples -> CRC-valid payloads.

    The production whole-capture ingest path (the contract of the
    reference's benchmarking/test_demod.py:82-118, rtl_sdr bytes included):
    ONE H2D transfer of the raw bytes, ONE device program for the whole
    chain, one small D2H of decoded packets.  Acquisition is per-chunk
    "all"/top-k with CRC gating (order-independent), deduplicated across
    chunk halos by (content, approximate global bit position) exactly like
    `decode_iq_parallel`.

    k_per_chunk bounds the packets recovered per chunk; the default covers
    a back-to-back packet stream with margin.

    mesh: optional jax.sharding.Mesh — the chunk axis shards over the
    mesh's first axis (n_chunks must divide by its size): the capture
    bytes replicate, each device demodulates/deframes its own chunks, and
    XLA partitions the whole one-dispatch program (computation follows
    the input shardings — the pod configuration of this path).
    """
    cfg = MODE_CONFIGS[mode] if cfg is None else cfg
    import jax.numpy as jnp

    fn, data, starts, skips, syms_pp = fused_plan(
        raw, mode, cfg, n_chunks, warmup_frames, max_iter, input_format,
        k_per_chunk, mesh is None, scan_unroll, frames_per_step)
    if mesh is not None:
        # device_put the NUMPY arrays directly with their target shardings
        # (going through jnp.asarray first would move the full capture
        # twice); XLA partitions the program for this mesh
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        ax = mesh.axis_names[0]
        data_j = jax.device_put(data, NamedSharding(mesh, P()))
        starts_j = jax.device_put(starts, NamedSharding(mesh, P(ax)))
        skips_j = jax.device_put(skips, NamedSharding(mesh, P(ax)))
    else:
        data_j = jnp.asarray(data)
        starts_j, skips_j = jnp.asarray(starts), jnp.asarray(skips)
    out = fn(data_j, starts_j, skips_j)
    if not getattr(out, "is_fully_addressable", True):
        # multi-process mesh: each process holds only its chunk shards;
        # gather the (small) packed packet results onto every host so the
        # dedup below sees the global set (SPMD-consistent on all hosts)
        from jax.experimental import multihost_utils
        packed = np.asarray(multihost_utils.process_allgather(out,
                                                              tiled=True))
    else:
        packed = np.asarray(out)
    return _dedup_payloads(_unpack_fused(packed, starts, cfg), syms_pp)


def decode_iq_fused_overlap(raw: np.ndarray, mode: str = "v2",
                            cfg: fsk.FSKConfig | None = None,
                            n_slabs: int = 4, chunks_per_slab: int = 4,
                            warmup_frames: int = 8, max_iter: int = 10,
                            input_format: str = "cu8",
                            k_per_chunk: int | None = None, depth: int = 2,
                            scan_unroll: int | None = None,
                            frames_per_step: int | None = None):
    """Slab-pipelined fused decode: H2D transfer overlapped with execution.

    Same one-program chain as `decode_iq_fused`, but the capture is cut
    into `n_slabs` overlapping slabs whose H2D transfer, device execution
    and (small) D2H fetch are kept `depth` in flight via JAX's async
    dispatch: slab s executes while slab s+1's bytes cross the wire, so
    wall-clock approaches max(total H2D, total exec) instead of their sum.

    Slabs overlap by one halo (estimator warmup + one packet length) so a
    packet spanning a slab seam decodes wholly inside the next slab;
    duplicates dedup by (content, global bit position) exactly like the
    chunk halos.  Output contract == `decode_iq_fused`.
    """
    cfg = MODE_CONFIGS[mode] if cfg is None else cfg
    import jax.numpy as jnp

    data, n, input_format = _normalize_fused_input(raw, input_format)
    pad_val = 127 if input_format == "cu8" else 0

    # slab geometry: same halo/flush rule as the chunk level
    syms_pp = (framing.V2_SYMBOLS_PER_PACKET if mode == "v2"
               else framing.V1_SYMBOLS_PER_PACKET)
    packet_frames = syms_pp // cfg.Nsym + 2
    halo = (warmup_frames + packet_frames) * cfg.N
    flush = 8 * cfg.N
    score = -(-n // n_slabs)                       # samples per slab core
    slab_nsamp = score + halo + flush
    slab_begins = np.maximum(
        np.arange(n_slabs) * score - halo, 0).astype(np.int64)

    # chunk geometry WITHIN a slab (identical for every slab -> one program)
    _, chunk_len, starts, skips = _fused_geometry(
        cfg, mode, slab_nsamp, chunks_per_slab, warmup_frames)
    nf = cfg.num_frames(chunk_len)
    if k_per_chunk is None:
        k_per_chunk = int(np.ceil(chunk_len / cfg.Ts / syms_pp)) + 2
    # a slab that starts mid-capture has un-converged estimators for its
    # whole first chunk's warmup too (start==0 within the slab): blank it
    skips_mid = np.where(starts > 0, skips, warmup_frames).astype(np.int32)

    fn = _fused_program(cfg, mode, chunk_len, nf, k_per_chunk, max_iter,
                        input_format, _fused_unroll(scan_unroll),
                        fsk.default_frames_per_step(frames_per_step),
                        tuple(int(s) for s in starts))
    starts_j = jnp.asarray(starts)
    skips_j = {False: jnp.asarray(skips), True: jnp.asarray(skips_mid)}

    results, inflight = [], []   # inflight: (begin, starts, device future)

    def drain(entry):
        begin, st, fut = entry
        results.extend(_unpack_fused(np.asarray(fut), st, cfg,
                                     base_bit=int(begin) // cfg.Ts))

    for s in range(n_slabs):
        begin = int(slab_begins[s])
        slab = data[begin: begin + slab_nsamp]
        if len(slab) < slab_nsamp:                 # pad only the tail slab
            padded = np.full((slab_nsamp, 2), pad_val, data.dtype)
            padded[: len(slab)] = slab
            slab = padded
        fut = fn(jnp.asarray(slab), starts_j, skips_j[begin > 0])
        inflight.append((begin, starts, fut))
        if len(inflight) > depth:
            drain(inflight.pop(0))
    while inflight:
        drain(inflight.pop(0))
    return _dedup_payloads(results, syms_pp)


class FusedReceiver:
    """Chunk-parallel streaming receiver — the THROUGHPUT live path.

    The classic `Receiver` threads exact demod state across pushes (one
    serial scan: bit-for-bit the C chain's fread loop, but bounded by the
    serial scan rate).  This receiver instead applies the one-dispatch
    fused chain (ingest conversion + overlap-save chunked demod + on-device
    top-k deframe + BP decode + CRC, `_fused_program`) to fixed-size slabs
    of the incoming stream: estimator state is RECOMPUTED from a halo of
    preceding samples rather than carried (the project's sequence-
    parallelism mapping, SURVEY.md §2.3 — recompute-from-overlap beats
    cross-chunk state threading on XLA), so each slab's chunks demodulate
    in parallel and the per-push D2H is just the (tiny) packed packet
    results.  Up to `depth` slabs stay in flight, overlapping the H2D of
    slab s+1 with the execution of slab s — payloads arrive <= depth
    pushes late; call flush() at end of stream.

    Packet output == `decode_iq_fused` of the concatenated stream
    (duplicates across slab halos dedup by content + global bit position).
    Acquisition is top-k + CRC gating, a strict superset of the C FSM's
    packets (deframe.deframe_soft docstring); use `Receiver` when exact
    FSM-path parity or live modem stats are required.

    push() accepts arbitrary-sized sample buckets (raw cu8/cs16 bytes or
    complex64 per input_format); internally slabs dispatch whenever
    `push_samples` new samples (plus the halo + lookahead flush) are
    buffered, so ONE compiled program serves the whole stream.
    """

    def __init__(self, mode: str = "v2", cfg: fsk.FSKConfig | None = None,
                 push_samples: int | None = None, n_chunks: int = 8,
                 warmup_frames: int = 8, max_iter: int = 10,
                 input_format: str = "cu8", depth: int = 2,
                 k_per_chunk: int | None = None,
                 scan_unroll: int | None = None,
                 frames_per_step: int | None = None):
        import jax.numpy as jnp
        self.mode = mode
        cfg = MODE_CONFIGS[mode] if cfg is None else cfg
        self.cfg = cfg
        if input_format not in ("c64", "cu8", "cs16"):
            raise ValueError("input_format must be 'c64', 'cu8' or 'cs16'")
        self.input_format = input_format
        self._dtype = {"cu8": np.uint8, "cs16": np.int16,
                       "c64": np.complex64}[input_format]
        self._width = 2 if input_format in ("cu8", "cs16") else 1
        self._pad_unit = 127 if input_format == "cu8" else 0

        self.push_samples = int(push_samples or 4 * cfg.Fs)
        syms_pp = (framing.V2_SYMBOLS_PER_PACKET if mode == "v2"
                   else framing.V1_SYMBOLS_PER_PACKET)
        self._syms_pp = syms_pp
        packet_frames = syms_pp // cfg.Nsym + 2
        self._halo = (warmup_frames + packet_frames) * cfg.N
        self._flush_len = 8 * cfg.N
        self._slab_nsamp = self.push_samples + self._halo + self._flush_len
        _, chunk_len, starts, skips = _fused_geometry(
            cfg, mode, self._slab_nsamp, n_chunks, warmup_frames)
        self._starts = starts
        nf = cfg.num_frames(chunk_len)
        if k_per_chunk is None:
            k_per_chunk = int(np.ceil(chunk_len / cfg.Ts / syms_pp)) + 2
        self._fn = _fused_program(
            cfg, mode, chunk_len, nf, k_per_chunk, max_iter, input_format,
            _fused_unroll(scan_unroll),
            fsk.default_frames_per_step(frames_per_step),
            tuple(int(s) for s in starts))
        self._starts_j = jnp.asarray(starts)
        # mid-stream slabs have cold estimators at chunk 0 too: blank its
        # warmup exactly like decode_iq_fused_overlap's skips_mid
        self._skips_first = jnp.asarray(skips)
        self._skips_mid = jnp.asarray(
            np.where(starts > 0, skips, warmup_frames).astype(np.int32))
        self.depth = depth
        self._buf = np.zeros(0, self._dtype)   # raw units from sample _base
        self._base = 0                         # global sample index of buf[0]
        self._next = 0                         # next slab BEGIN (global)
        self._received = 0                     # total samples pushed
        self._inflight = []                    # (begin, device future)
        self._results = []                     # decoded, pre-dedup tail
        self._emitted = {}                     # payload -> last global bit pos
        self.n_crc_ok = 0

    def _normalize(self, chunk):
        if self.input_format in ("cu8", "cs16"):
            chunk = np.asarray(chunk, self._dtype)
            return chunk[: 2 * (len(chunk) // 2)]
        return np.asarray(chunk, np.complex64)

    def _dispatch_slab(self, begin: int):
        import jax.numpy as jnp
        w = self._width
        lo = (begin - self._base) * w
        slab = self._buf[lo: lo + self._slab_nsamp * w]
        have = len(slab) // w
        if have < self._slab_nsamp:            # tail slab: pad with silence
            if self.input_format == "c64":
                padded = np.zeros(self._slab_nsamp, np.complex64)
            else:
                padded = np.full(self._slab_nsamp * w, self._pad_unit,
                                 self._dtype)
            padded[: len(slab)] = slab
            slab = padded
        if self.input_format == "c64":
            data = slab.view(np.float32).reshape(-1, 2)
        else:
            data = slab.reshape(-1, 2)
        fut = self._fn(jnp.asarray(data), self._starts_j,
                       self._skips_first if begin == 0 else self._skips_mid)
        self._inflight.append((begin, fut))

    def _drain_one(self):
        begin, fut = self._inflight.pop(0)
        self._results.extend(_unpack_fused(
            np.asarray(fut), self._starts, self.cfg,
            base_bit=begin // self.cfg.Ts))

    def _emit_ready(self) -> list:
        """Dedup (by content + global bit position, like the batch fused
        paths) and release all drained results; boundary packets re-found
        by a later slab's halo are suppressed by the position map."""
        self._results.sort(key=lambda x: x[0])
        out = []
        for p, payload in self._results:
            last = self._emitted.get(payload)
            if last is not None and p - last < self._syms_pp:
                self._emitted[payload] = p
                continue
            self._emitted[payload] = p
            out.append(payload)
        self._results = []
        self.n_crc_ok += len(out)
        return out

    def push(self, chunk) -> list:
        """Feed samples; returns newly-completed CRC-valid payloads (up to
        `depth` slabs late)."""
        chunk = self._normalize(chunk)
        self._buf = np.concatenate([self._buf, chunk])
        self._received += len(chunk) // self._width
        # dispatch every slab whose data (incl. lookahead flush) is here
        while self._received - self._next >= self._slab_nsamp:
            self._dispatch_slab(self._next)
            nxt = self._next + self.push_samples
            self._next = nxt
            # every future slab begins at >= nxt (its backward halo is the
            # previous slab's forward extension), so nothing before nxt is
            # ever read again
            if nxt > self._base:
                self._buf = self._buf[(nxt - self._base) * self._width:]
                self._base = nxt
        while len(self._inflight) > self.depth:
            self._drain_one()
        return self._emit_ready() if self._results else []

    def flush(self) -> list:
        """End of stream: process the remaining tail and drain everything.

        The receiver stays usable: a later push() starts a FRESH stream
        segment at the current global sample count (a packet actually
        spanning the flush boundary is inherently lost — flush means the
        stream ended there)."""
        while self._next < self._received:
            self._dispatch_slab(self._next)
            self._next += self.push_samples
        while self._inflight:
            self._drain_one()
        self._buf = np.zeros(0, self._dtype)
        # re-anchor for post-flush pushes: buf[0] is global sample
        # _received, and the next slab begins there (not at a stale _next
        # that may overshoot _received from the padded tail slab)
        self._base = self._received
        self._next = self._received
        return self._emit_ready()


@_functools.lru_cache(maxsize=32)
def _stream_program(cfg: fsk.FSKConfig, nf: int, with_eye: bool, fmt: str,
                    unroll: int = 1, fstep: int = 1):
    """Compiled streaming-push program: ingest conversion (cu8 -> complex on
    DEVICE — the rtl_sdr bytes are what crosses the wire, 4x less H2D than
    complex64 pairs) + scan demod + on-device last-valid-frame stat gather.

    Returns only what the host needs — (final carry, soft, valid,
    small stats[, eye]) — instead of the full FrameOut stack: the D2H
    fetch count/volume is what the pipelined path overlaps against, and
    unused FrameOut fields were previously transferred only to be dropped.
    """
    import jax
    import jax.numpy as jnp

    def run(data, state, n_valid):
        if fmt == "cu8":
            x = (data.astype(jnp.float32) - 127.0) * (1.0 / 128.0)
        elif fmt == "cs16":        # KA9Q pcmcat s16 IQ pairs
            x = data.astype(jnp.float32) * np.float32(1.0 / fsk.FDMDV_SCALE)
        else:                      # float32 (re, im) pairs
            x = data
        iq = jax.lax.complex(x[:, 0], x[:, 1])
        res = fsk.demod_stream(cfg, iq, nf, state, n_valid=n_valid,
                               with_eye=with_eye, unroll=unroll,
                               frames_per_step=fstep)
        final, outs = res[0], res[1]
        vidx = jnp.arange(nf, dtype=jnp.int32)
        last = jnp.max(jnp.where(outs.valid, vidx, -1))
        li = jnp.maximum(last, 0)
        stats = jnp.concatenate([
            jnp.stack([outs.ebno_db[li], outs.ppm[li],
                       outs.valid.astype(jnp.float32).sum(),
                       last.astype(jnp.float32)]),
            outs.f_est[li].astype(jnp.float32)])
        # pack soft + validity + stats into ONE array: one D2H fetch
        extra = jnp.zeros((nf, 2), jnp.float32)
        extra = extra.at[:, 0].set(outs.valid.astype(jnp.float32))
        extra = extra.at[: stats.shape[0], 1].set(stats)
        packed = jnp.concatenate([outs.soft, extra], axis=1)
        out = (final, packed)
        if with_eye:
            out = out + (res[2],)
        return out

    return jax.jit(run)


class Receiver:
    """Streaming Wenet receiver (one logical channel).

    Args:
      mode: 'v1' or 'v2' (selects modem geometry and deframer variant)
      cfg:  optional FSKConfig override (e.g. scaled rates for tests)
      estimator_limits: optional (min_hz, max_hz) like fsk_demod -b/-u
      input_format: 'c64' (push complex64 samples), 'cu8' (push raw
        rtl_sdr u8 IQ bytes; conversion happens on device, halving H2D
        traffic and removing the host conversion from the hot loop), or
        'cs16' (raw KA9Q pcmcat s16 IQ pairs, device-side conversion)
      pipelined: overlap the device demod of chunk k+1 with the host-side
        deframe of chunk k (the PP the reference gets from its Unix-pipe
        process stages, SURVEY.md §2.3): each push first retires the carry
        state of the in-flight chunk, queues the new chunk's demod on the
        device, and only then does the host-side work — soft-bit transfer,
        UW correlation, candidate gather — for the previous chunk while
        the device runs. Payloads therefore arrive one push late; call
        flush() at end-of-stream. Output is identical to the serial path.
    """

    def __init__(self, mode: str = "v2", cfg: fsk.FSKConfig | None = None,
                 estimator_limits: tuple | None = None, max_iter: int = 10,
                 pipelined: bool = False, with_eye: bool = False,
                 input_format: str = "c64"):
        self.mode = mode
        self.with_eye = with_eye     # True: carry the per-frame eye-probe
        #   select through the scan for live eye_diagram records (GUI/stats
        #   consumers opt in — cli/rx does when UDP stats are on); the
        #   default False keeps the decode-only hot path free of it
        #   (VERDICT r3 #8)
        if input_format not in ("c64", "cu8", "cs16"):
            raise ValueError("input_format must be 'c64', 'cu8' or 'cs16'")
        self.input_format = input_format
        base = MODE_CONFIGS[mode] if cfg is None else cfg
        if estimator_limits is not None:
            base = dataclasses.replace(
                base, est_min=estimator_limits[0], est_max=estimator_limits[1])
        self.cfg = base
        self.deframer = deframe.StreamDeframer(mode, max_iter=max_iter)
        self.state = None            # DemodState, created lazily
        # raw-int units per sample (u8 or s16 pairs) vs one complex64
        self._width = 2 if input_format in ("cu8", "cs16") else 1
        self._history = np.zeros(
            0, {"cu8": np.uint8, "cs16": np.int16,
                "c64": np.complex64}[input_format])
        self.stats = RxStats()
        self.pipelined = pipelined
        self._pending = None    # (final_dev, soft_dev, valid_dev, stats_dev,
        #                          eye_dev, buf, n_new)
        self.last_eye = None         # (f_int (M,(Nsym+1)P) c64, high int)

    # ------------------------------------------------------------- one-shot

    def decode_iq(self, iq: np.ndarray) -> list:
        """Decode a whole capture; returns the CRC-valid payloads in order.
        Equivalent to the full fsk_demod | {wenet,drs232}_ldpc pipeline.
        Takes complex64 samples (c64 receivers) or raw u8 IQ bytes (cu8)."""
        payloads = self.push(iq)
        payloads += self.flush()
        return payloads

    def decode_file(self, path: str, fmt: str = "cu8") -> list:
        conv, dtype, _ = INPUT_CONVERTERS[fmt]
        raw = np.fromfile(path, dtype=dtype)
        if fmt == self.input_format and fmt in ("cu8", "cs16"):
            return self.decode_iq(raw)          # device-side conversion
        return self.decode_iq(conv(raw))

    # ------------------------------------------------------------ streaming

    def _dispatch(self, chunk: np.ndarray):
        """Queue the demod scan for a chunk on the device; returns the
        in-flight tuple or None if not enough samples buffered yet."""
        import jax.numpy as jnp

        cfg = self.cfg
        w = self._width
        if self.input_format == "cu8":
            chunk = np.asarray(chunk, np.uint8)
            chunk = chunk[: 2 * (len(chunk) // 2)]
        elif self.input_format == "cs16":
            chunk = np.asarray(chunk, np.int16)
            chunk = chunk[: 2 * (len(chunk) // 2)]
        else:
            chunk = np.asarray(chunk, np.complex64)
        buf = np.concatenate([self._history, chunk])
        n_samples = len(buf) // w
        if self.state is None:
            self.state = fsk.demod_init(cfg)
        start_pos = int(self.state.pos)   # first unconsumed sample in buf
        nf = cfg.num_frames(max(n_samples - start_pos, 0))
        if nf <= 0 or n_samples < int(self.state.nin):
            self._history = buf
            return None
        # bucket shapes: pad the buffer and round the frame count so repeated
        # pushes of similar size reuse one compiled program
        nf = -(-nf // 32) * 32
        blen = -(-n_samples // (32 * cfg.N)) * (32 * cfg.N)
        if self.input_format == "cu8":
            data = np.full((blen, 2), 127, np.uint8)   # 127 == 0.0 centered
            data[:n_samples] = buf.reshape(-1, 2)
        elif self.input_format == "cs16":
            data = np.zeros((blen, 2), np.int16)
            data[:n_samples] = buf.reshape(-1, 2)
        else:
            data = np.zeros((blen, 2), np.float32)
            data[:n_samples] = buf.view(np.float32).reshape(-1, 2)
        fn = _stream_program(cfg, nf, self.with_eye, self.input_format,
                             _fused_unroll(None),
                             fsk.default_frames_per_step(None))
        res = fn(jnp.asarray(data), self.state, n_samples)
        final, packed = res[:2]
        eye = res[2] if self.with_eye else None
        return final, packed, eye, buf, len(chunk) // w

    def _retire_state(self, final, buf: np.ndarray):
        """Fold the in-flight chunk's scan carry back into host state.

        Only `pos` crosses to host (one small D2H instead of nine, one per
        carry field); the rest of the DemodState stays device-resident for
        the next dispatch."""
        cfg = self.cfg
        end_pos = int(np.asarray(final.pos))
        keep = min(end_pos, cfg.Nmem)
        self._history = buf[(end_pos - keep) * self._width:]
        self.state = final._replace(pos=np.int32(keep))

    def _complete(self, packed, eye, n_new: int) -> list:
        """Host-side half: ONE D2H fetch (soft bits + validity + stats
        packed in a single array), then deframe, decode, CRC."""
        packed = np.asarray(packed)
        valid = packed[:, -2] > 0.5
        stats = packed[: 4 + self.cfg.M, -1]
        soft = packed[:, :-2][valid].reshape(-1)
        nframes = int(stats[2])
        if nframes and eye is not None:  # last valid frame's integrators
            self.last_eye = (compat.get_complex(eye[0]), int(eye[1]))

        self.stats.frames += nframes
        self.stats.samples += n_new
        if nframes:
            self.stats.ebno_db = float(stats[0])
            self.stats.ppm = float(stats[1])
            self.stats.f_est = tuple(float(x) for x in stats[4:])

        payloads = self.deframer.push(soft)
        self.stats.detections = self.deframer.n_detections
        self.stats.crc_ok = self.deframer.n_crc_ok
        return payloads

    def push(self, chunk: np.ndarray) -> list:
        """Feed samples (complex64, or raw u8 IQ bytes for cu8 receivers);
        returns newly-completed CRC-valid payloads (from the previous chunk
        when pipelined)."""
        if not self.pipelined:
            inflight = self._dispatch(chunk)
            if inflight is None:
                return []
            final, packed, eye, buf, n_new = inflight
            self._retire_state(final, buf)
            return self._complete(packed, eye, n_new)

        payloads = []
        if self._pending is not None:
            final, packed, eye, buf, n_prev = self._pending
            self._pending = None
            # carry state first (cheap), THEN queue the next chunk's demod,
            # THEN do chunk k's host-side work while the device runs k+1
            self._retire_state(final, buf)
            self._pending = self._dispatch(chunk)
            payloads = self._complete(packed, eye, n_prev)
        else:
            self._pending = self._dispatch(chunk)
        return payloads

    def flush(self) -> list:
        """Drain the in-flight chunk (pipelined mode); serial mode no-op."""
        if self._pending is None:
            return []
        final, packed, eye, buf, n_new = self._pending
        self._pending = None
        self._retire_state(final, buf)
        return self._complete(packed, eye, n_new)
