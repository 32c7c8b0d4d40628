"""Deframing: UW acquisition + packet extraction + LDPC decode + CRC gate.

Batched re-architecture of the reference's one-symbol-at-a-time state
machines (src/wenet_ldpc.c:171-259 v2, src/drs232_ldpc.c:176-275 v1):

  * UW scoring over the whole soft stream is a single ±1 correlation
    (vectorised), not a per-bit sliding buffer
  * the sequential LOOK_FOR_UW / COLLECT_PACKET gating — detections are
    consumed greedily and searching is suspended during collection — is a
    cheap per-packet host loop over the precomputed score array, reproducing
    the C semantics exactly (including the stale-bit-buffer windows right
    after a packet, and the zero-filled buffer at stream start)
  * candidate windows are then gathered into a batch and decoded together on
    device: descramble/RS232-strip -> sd_to_llr -> batched BP decode -> CRC

The C FSM's output (CRC-valid 256-byte payloads, in order) is reproduced
byte-exactly; the batched decode is what runs on the accelerator.
"""
from __future__ import annotations

import dataclasses
import functools as _functools

import numpy as np
import jax.numpy as jnp

from ..core import framing
from ..core import ldpc_tables as T
from . import crc as dcrc
from . import ldpc

try:
    from .. import native as _native
except Exception:  # pragma: no cover
    _native = None


@dataclasses.dataclass
class DeframeResult:
    payloads: list            # CRC-valid 256-byte payloads (bytes), in order
    n_detections: int         # UW detections == attempted packets
    n_crc_ok: int
    iters: np.ndarray         # (n_detections,) LDPC iterations
    positions: np.ndarray     # (n_detections,) UW-end symbol index
    crc_ok: np.ndarray        # (n_detections,) bool
    packets_raw: np.ndarray   # (n_detections, 258) uint8 payload+crc bytes

    @property
    def per(self) -> float:
        return (self.n_detections - self.n_crc_ok) / max(self.n_detections, 1)


def _mode_params(mode: str):
    if mode == "v2":
        return (framing.UW_BITS_V2.astype(np.int8), framing.V2_UW_ALLOWED_ERRORS,
                framing.V2_SYMBOLS_PER_PACKET)
    if mode == "v1":
        return (framing.UW_BITS_V1.astype(np.int8), framing.V1_UW_ALLOWED_ERRORS,
                framing.V1_SYMBOLS_PER_PACKET)
    raise ValueError("mode must be 'v1' or 'v2'")


def uw_detect_positions(hard_bits: np.ndarray, mode: str = "v2",
                        init_buffer: np.ndarray | None = None,
                        force_numpy: bool = False):
    """Exact emulation of the C acquisition gating.

    hard_bits: (n,) uint8 stream (bit = soft < 0, wenet_ldpc.c:176).
    init_buffer: (nuw,) prior bit_buffer contents (zeros at stream start).
    Returns (positions, final_buffer): UW-end positions t — collection covers
    symbols [t+1, t+SYMS] — and the buffer state after the last detection,
    for exact stream resumption.
    """
    uw, allowed, syms_per_packet = _mode_params(mode)
    nuw = len(uw)
    thresh = nuw - allowed
    n = len(hard_bits)
    hard_bits = np.asarray(hard_bits, np.int8)
    if init_buffer is None:
        init_buffer = np.zeros(nuw, np.int8)   # bit_buffer memset, wenet_ldpc.c:172
    if n < 1:
        return np.zeros(0, np.int64), init_buffer

    if not force_numpy and _native is not None and _native.available():
        soft_pm = np.where(hard_bits > 0, -1.0, 1.0).astype(np.float32)
        pos, final = _native.uw_detect(
            soft_pm, np.asarray(uw, np.uint8), allowed, syms_per_packet,
            init_buffer)
        final = final if len(pos) else init_buffer
        return pos, np.asarray(final, np.int8)

    # scores[t] = #matching window positions for the window ending at stream
    # index t, buffer preloaded with init_buffer — a single ±1 correlation
    # over [init tail | stream]
    ext = np.concatenate([init_buffer[1:].astype(np.int8), hard_bits])
    pm = 1 - 2 * ext.astype(np.int32)
    uw_pm = 1 - 2 * uw.astype(np.int32)
    corr = np.correlate(pm, uw_pm, mode="valid")      # len n
    scores = (corr + nuw) // 2                        # equal-count per window

    detections = []
    t = 0                      # next window-end position to examine
    stale = init_buffer        # buffer content frozen during COLLECT
    fresh = 0                  # positions >= fresh follow the correlation
    hit_idx = np.flatnonzero(scores >= thresh)

    def window_at(t):
        """Emulated bit_buffer content after shifting in symbol t."""
        lo = t - nuw + 1
        if lo >= 0:
            return hard_bits[lo:t + 1]
        return np.concatenate([stale[lo:], hard_bits[:t + 1]])

    while t < n:
        if t < fresh:
            # mixed stale/new windows right after a packet: the C buffer was
            # frozen during collection, so these windows mix the detection
            # bits with post-packet bits — emulate the shift register
            buf = stale.copy()
            found = -1
            for u in range(t, min(fresh, n)):
                buf = np.roll(buf, -1)
                buf[-1] = hard_bits[u]
                if int(np.sum(buf == uw)) >= thresh:
                    found = u
                    break
            if found < 0:
                t = fresh
                continue
            t = found
            trigger_buf = buf
        else:
            k = np.searchsorted(hit_idx, t)
            if k >= len(hit_idx):
                break
            t = int(hit_idx[k])
            trigger_buf = None
        # detection at t: collect [t+1, t+syms]; abandoned if stream ends
        if t + syms_per_packet >= n:
            break
        detections.append(t)
        # resume: buffer keeps the bits that triggered the detection
        stale = np.array(trigger_buf if trigger_buf is not None
                         else window_at(t), np.int8)
        t = t + syms_per_packet + 1
        fresh = t + nuw - 1
    return np.asarray(detections, np.int64), stale


def decode_candidates(soft: np.ndarray, positions: np.ndarray, mode: str = "v2",
                      max_iter: int = T.MAX_ITER):
    """Batch-decode the candidate windows at `positions` (UW-end indices).

    Returns (packets_raw (B,258) uint8, crc_ok (B,) bool, iters (B,) int32).
    """
    _, _, syms = _mode_params(mode)
    B = len(positions)
    if B == 0:
        z = np.zeros(0, np.int64)
        return np.zeros((0, 258), np.uint8), np.zeros(0, bool), z.astype(np.int32)

    idx = positions[:, None] + 1 + np.arange(syms)[None, :]
    windows = soft[idx].astype(np.float64)            # C collects into double
    return decode_windows(windows, mode, max_iter)


@_functools.lru_cache(maxsize=8)
def _decode_windows_program(max_iter: int):
    """One-dispatch window decoder: sd_to_llr + BP decode + CRC gate +
    byte packing in a single program, results packed into ONE uint8 array
    (B, 258+2) so the host pays one dispatch and one fetch."""
    import jax

    @jax.jit
    def run(sd):
        llr = ldpc.sd_to_llr(sd)
        bits, iters, _ = ldpc.decode(llr, max_iter=max_iter)
        ok = dcrc.packet_crc_ok(bits)
        pbytes = dcrc.bits_to_bytes(bits[:, : 258 * 8]).astype(jnp.uint8)
        return jnp.concatenate(
            [pbytes, ok[:, None].astype(jnp.uint8),
             jnp.clip(iters, 0, 255)[:, None].astype(jnp.uint8)], axis=1)
    return run


def decode_windows(windows: np.ndarray, mode: str = "v2",
                   max_iter: int = T.MAX_ITER):
    """Decode pre-gathered (B, syms) soft windows in ONE device batch —
    the dispatch-count-critical path for chunk-parallel decode, where
    windows from every chunk concatenate into a single decoder call."""
    B = len(windows)
    if B == 0:
        z = np.zeros(0, np.int64)
        return np.zeros((0, 258), np.uint8), np.zeros(0, bool), z.astype(np.int32)
    windows = np.asarray(windows, np.float64)

    if mode == "v2":
        desc = framing.rx_descramble_soft(windows)    # ±1 table, exact
        sd = desc[:, : T.CODE_LEN]
    else:
        stripped = framing.rs232_strip_soft(windows)  # (B, 2584)
        sd = stripped[:, : T.CODE_LEN]

    # bucket the batch so repeated deframes reuse one compiled decoder
    Bp = 1 << max(int(np.ceil(np.log2(B))), 2)
    sd = np.asarray(sd, np.float32)
    if Bp != B:
        sd = np.concatenate([sd, np.tile(sd[-1:], (Bp - B, 1))], axis=0)
    packed = np.asarray(_decode_windows_program(max_iter)(jnp.asarray(sd)))
    packed = packed[:B]
    return (packed[:, :258].copy(), packed[:, 258].astype(bool),
            packed[:, 259].astype(np.int32))


def deframe_topk(soft: jnp.ndarray, mode: str = "v2", k: int = 8,
                 max_iter: int = T.MAX_ITER):
    """Deframe up to k packets from a soft stream ENTIRELY on device.

    The host-loop paths above reproduce the C FSM's greedy gating
    byte-exactly; this variant trades that for a single jittable program
    (static k), so a whole capture's deframe+decode can live inside one
    jit/vmap — the bench and Monte-Carlo configuration. Selection is k
    rounds of strongest-correlation pick + neighborhood blanking (a
    lax.scan), then all k windows decode as one BP batch.

    Returns (payload_bytes (k, 258) uint8, crc_ok (k,) bool,
    iters (k,) int32, positions (k,) int32). Weak picks (noise) simply
    fail the CRC gate, mirroring the C chain's behavior on false UW hits
    (wenet_ldpc.c:216-243); picks beyond the number of placeable windows
    return position -1 with a zeroed (CRC-failing) window.
    """
    import jax

    uw, _, syms = _mode_params(mode)
    n = soft.shape[0]
    nuw = len(uw)
    hard_pm = jnp.where(soft < 0, -1.0, 1.0).astype(jnp.float32)
    kern = jnp.asarray(1.0 - 2.0 * uw.astype(np.float32))
    scores0 = jnp.correlate(hard_pm, kern, mode="valid")
    idx = jnp.arange(scores0.shape[0], dtype=jnp.int32)
    # the full packet window [s+nuw, s+nuw+syms) must be in-stream
    scores0 = jnp.where(idx <= n - syms - nuw, scores0, -jnp.inf)

    def pick(scores, _):
        # first-max via one variadic reduce (fsk.argmax_first): half the
        # reduction ops of max + min-of-where, identical semantics
        from . import fsk as _fsk
        mx, s = _fsk.argmax_first(scores)
        exhausted = ~jnp.isfinite(mx)
        s = jnp.where(exhausted, jnp.int32(0), s)
        # blank every start whose window would overlap this packet's
        blank = (idx > s - (nuw + syms)) & (idx < s + nuw + syms)
        return (jnp.where(blank, -jnp.inf, scores),
                (s, exhausted))
    _, (starts, exhausted) = jax.lax.scan(pick, scores0, None, length=k)

    def window(s):
        return jax.lax.dynamic_slice(soft, (s + nuw,), (syms,))
    wins = jax.vmap(window)(starts)                    # (k, syms)
    wins = jnp.where(exhausted[:, None], 0.0, wins)    # sentinel: CRC-fails
    starts = jnp.where(exhausted, jnp.int32(-1), starts)

    if mode == "v2":
        sd = framing.rx_descramble_soft(wins)[:, : T.CODE_LEN]
    else:
        sd = framing.rs232_strip_soft(wins)[:, : T.CODE_LEN]
    llr = ldpc.sd_to_llr(sd.astype(jnp.float32))
    bits, iters, _ = ldpc.decode(llr, max_iter=max_iter)
    ok = dcrc.packet_crc_ok(bits)
    pbytes = dcrc.bits_to_bytes(bits[:, : 258 * 8]).astype(jnp.uint8)
    return pbytes, ok, iters, starts


def pack_decode_results(pb, ok, pos):
    """Device-side: pack deframe_topk results — payload bytes + ok flag +
    position(le32) — into ONE uint8 array (..., k, 263), so a whole
    program's packet output is a single D2H fetch."""
    pu = pos.astype(jnp.uint32)
    pos_b = jnp.stack([(pu >> s).astype(jnp.uint8)
                       for s in (0, 8, 16, 24)], axis=-1)
    return jnp.concatenate(
        [pb, ok[..., None].astype(jnp.uint8), pos_b], axis=-1)


def unpack_decode_results(packed: np.ndarray):
    """Host-side inverse of pack_decode_results:
    (..., 263) uint8 -> (payload_bytes (..., 258), ok bool, pos int32)."""
    pb = packed[..., :258]
    ok = packed[..., 258].astype(bool)
    pu = packed[..., 259:263].astype(np.uint32)
    pos = (pu[..., 0] | (pu[..., 1] << 8) | (pu[..., 2] << 16)
           | (pu[..., 3] << 24)).view(np.int32)
    return pb, ok, pos


class StreamDeframer:
    """Stateful chunked deframer for live streams.

    `push(chunk)` yields exactly the packets `deframe_soft` would produce on
    the concatenated stream: completed packets are consumed eagerly (they are
    final — the FSM is strictly left-to-right) and the post-detection
    bit_buffer state is carried so cross-chunk and stale-buffer UW windows
    are preserved bit-exactly.
    """

    def __init__(self, mode: str = "v2", max_iter: int = T.MAX_ITER):
        self.mode = mode
        self.max_iter = max_iter
        uw, _, self._syms = _mode_params(mode)
        self._nuw = len(uw)
        self._buf = np.zeros(0, np.float32)
        self._state = np.zeros(self._nuw, np.int8)   # bit_buffer at _buf[0]
        self.n_detections = 0
        self.n_crc_ok = 0

    def push(self, soft_chunk: np.ndarray) -> list:
        self._buf = np.concatenate(
            [self._buf, np.asarray(soft_chunk, np.float32)])
        hard = (self._buf < 0).astype(np.uint8)
        positions, stale = uw_detect_positions(hard, self.mode, self._state)
        pkts, ok, _ = decode_candidates(self._buf, positions, self.mode,
                                        self.max_iter)
        out = [pkts[i, :256].tobytes() for i in range(len(positions)) if ok[i]]
        self.n_detections += len(positions)
        self.n_crc_ok += int(ok.sum())
        if len(positions):
            # consume through the last packet; FSM state there is the frozen
            # detection buffer returned by uw_detect_positions
            cut = int(positions[-1]) + self._syms + 1
            self._buf = self._buf[cut:]
            self._state = stale
        elif len(self._buf) > self._syms + self._nuw:
            # no detection can still complete before the kept tail: any
            # trigger at t < n - syms was already recorded, so windows that
            # matter end at >= n - syms and need nuw - 1 bits of history
            cut = len(self._buf) - self._syms - self._nuw
            self._state = hard[cut - self._nuw:cut].astype(np.int8) \
                if cut >= self._nuw else np.concatenate(
                    [self._state[cut - self._nuw:], hard[:cut]]).astype(np.int8)
            self._buf = self._buf[cut:]
        return out


def correlation_candidates(hard_bits: np.ndarray, mode: str = "v2"
                           ) -> np.ndarray:
    """ALL in-stream UW correlation hits (no FSM skip): every window-end t
    with >= thresh matching bits whose packet window [t+1, t+syms] fits."""
    uw, allowed, syms = _mode_params(mode)
    nuw = len(uw)
    n = len(hard_bits)
    pm = 1 - 2 * np.asarray(hard_bits, np.int32)
    uw_pm = 1 - 2 * np.asarray(uw, np.int32)
    corr = np.correlate(pm, uw_pm, mode="valid")
    scores = (corr + nuw) // 2
    t = np.flatnonzero(scores >= nuw - allowed) + nuw - 1
    return t[t + syms < n].astype(np.int64)


def deframe_soft(soft: np.ndarray, mode: str = "v2",
                 max_iter: int = T.MAX_ITER,
                 acquisition: str = "fsm") -> DeframeResult:
    """Full deframe of a soft-decision stream -> CRC-valid payloads.

    acquisition="fsm" (default) reproduces the reference deframer exactly —
    piping `soft` through wenet_ldpc/drs232_ldpc and concatenating stdout —
    including its blind spot: a false UW hit freezes collection for a whole
    window, swallowing any real UW inside it.

    acquisition="all" is the batched variant: EVERY correlation
    hit becomes a decode candidate (they batch-decode together anyway), the
    CRC gates truth, and overlapping CRC-valid windows resolve greedily in
    stream order. A strict superset of the FSM's valid packets — used by the
    chunk-parallel decoder, where a chunk can start mid-packet and FSM
    semantics would be path-dependent."""
    soft = np.asarray(soft, np.float32)
    hard = (soft < 0).astype(np.uint8)
    if acquisition == "all":
        _, _, syms = _mode_params(mode)
        positions = correlation_candidates(hard, mode)
        pkts, ok, iters = decode_candidates(soft, positions, mode, max_iter)
        keep = np.zeros(len(positions), bool)
        last_end = -1
        for i, t in enumerate(positions):
            if ok[i] and t > last_end:
                keep[i] = True
                last_end = t + syms
        positions, pkts = positions[keep], pkts[keep]
        ok, iters = ok[keep], iters[keep]
    else:
        positions, _ = uw_detect_positions(hard, mode)
        pkts, ok, iters = decode_candidates(soft, positions, mode, max_iter)
    payloads = [pkts[i, :256].tobytes() for i in range(len(positions)) if ok[i]]
    return DeframeResult(
        payloads=payloads, n_detections=len(positions), n_crc_ok=int(ok.sum()),
        iters=iters, positions=positions, crc_ok=ok, packets_raw=pkts)
