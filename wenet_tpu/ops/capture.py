"""Deterministic synthetic flight captures, made from a seed.

A packet stream (a random lead-in, then framed packets separated by random
gaps) is FSK-modulated at a mode's rates, passed through calibrated
AWGN and quantised to rtl_sdr cu8 bytes.  The benchmark and the on-card
smoke test (chip_smoke.py) build their inputs here, so that both see the
same bytes for the same seed.

The lead-in matters: a frame starting at sample 0 loses its first packet
to estimator warm-up, which no real capture does (the reference TX idles
between packets and its benchmark captures start with signal,
benchmarking/README.md:63-86).  Filler is random (a constant pattern would
starve the tone estimator of one tone's statistics), but redrawn wherever
a window the acquisition FSM sees would come within the UW's allowed
errors + 2 of the UW: plain random filler aliases the UW about once per
100k bits, and under the exact C-FSM acquisition such a false hit
swallows the next real packet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import framing

LEAD_BITS = 2048     # stream lead-in before the first frame
GAP_BITS = 512       # random filler between frames

# preamble + UW + payload + CRC + parity, in on-air bits
_FRAME_BYTES = (len(framing.PREAMBLE) + len(framing.UNIQUE_WORD)
                + framing.PAYLOAD_BYTES + framing.CRC_BYTES
                + framing.PARITY_BYTES)


def frame_bits(mode: str) -> int:
    """On-air bits per framed packet (v1 sends 10-bit RS232 words)."""
    return _FRAME_BYTES * (framing.V1_BITS_PER_BYTE if mode == "v1" else 8)


def packet_cycle(mode: str, gap_bits: int = GAP_BITS) -> int:
    """Bits from one frame's start to the next one's."""
    return frame_bits(mode) + gap_bits


def _uw(mode: str):
    if mode == "v2":
        return framing.UW_BITS_V2, framing.V2_UW_ALLOWED_ERRORS
    return framing.UW_BITS_V1, framing.V1_UW_ALLOWED_ERRORS


def uw_margin_ok(bits: np.ndarray, mode: str) -> bool:
    """True when no window of `bits` lies within the mode's allowed UW
    errors + 2 of the UW."""
    uw, allowed = _uw(mode)
    w = np.lib.stride_tricks.sliding_window_view(bits, len(uw))
    return bool((np.sum(w != uw, axis=1) > allowed + 2).all())


def _filler(rng, n: int, mode: str, before, after) -> np.ndarray:
    """n random bits, redrawn until every FSM window that holds at least
    one of them stays clear of the UW.  before: the acquisition buffer as
    the filler starts (the stale UW after a packet, zeros at stream
    start); after: the on-air bits that follow (the next preamble).  Both
    contexts leave every such window feasible with margin, so the loop
    ends after a few draws."""
    ctx = len(_uw(mode)[0]) - 1
    while True:
        f = rng.integers(0, 2, n).astype(np.uint8)
        if uw_margin_ok(np.concatenate([before[-ctx:], f, after[:ctx]]),
                        mode):
            return f


def make_packet_bits(cfg, n_packets: int, rng, mode: str = "v2",
                     payloads=None, gap_bits: int = GAP_BITS,
                     lead_bits: int = LEAD_BITS):
    """(bits, payloads): `lead_bits` of random filler, then n_packets
    framed packets each followed by `gap_bits` of filler, zero-padded to
    whole demod frames.  Payloads are drawn from rng unless given."""
    from . import ldpc
    frames, sent = [], []
    for i in range(n_packets):
        p = (rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
             if payloads is None else payloads[i])
        sent.append(framing.pad_payload(p))
        frames.append(framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode=mode), mode))
    uw = _uw(mode)[0]
    none = np.zeros(0, np.uint8)
    # the acquisition FSM starts from an all-zero bit buffer, and resumes
    # after each packet with its buffer still holding that packet's UW
    bits = [_filler(rng, lead_bits, mode, np.zeros(len(uw), np.uint8),
                    frames[0] if frames else none)]
    for i, frame in enumerate(frames):
        bits.append(frame)
        bits.append(_filler(rng, gap_bits, mode, uw,
                            frames[i + 1] if i + 1 < n_packets else none))
    bits = np.concatenate(bits)
    bits = np.concatenate([bits, np.zeros((-len(bits)) % cfg.Nbits, np.uint8)])
    return bits, sent


def decodable_packets(n_bits: int, n_packets: int, mode: str = "v2",
                      lead_bits: int = LEAD_BITS) -> int:
    """Exact count of frames wholly inside the first n_bits of a
    make_packet_bits stream (frame i spans [lead + i*cycle,
    lead + i*cycle + frame_bits))."""
    fit = (n_bits - lead_bits - frame_bits(mode)) // packet_cycle(mode) + 1
    return max(0, min(n_packets, fit))


def flight_capture(cfg, secs: float, ebno_db: float, seed: int,
                   mode: str = "v2", payload_fn=None):
    """(raw cu8 bytes, sent payloads) of a `secs`-long capture at cfg's
    rates: tones at 2*Rs and 3*Rs, AWGN at ebno_db, peak-normalised.
    payload_fn(i) gives packet i's payload (random when None)."""
    from . import channel, fsk
    rng = np.random.default_rng(seed)
    n_packets = max((int(secs * cfg.Rs) - LEAD_BITS) // packet_cycle(mode)
                    - 1, 1)
    payloads = (None if payload_fn is None
                else [payload_fn(i) for i in range(n_packets)])
    bits, sent = make_packet_bits(cfg, n_packets, rng, mode, payloads)
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    iq = channel.add_awgn(sig, ebno_db, cfg.Fs, cfg.Rs, rng=rng)
    del sig
    return fsk.iq_to_cu8(iq / np.abs(iq).max()), sent


def wideband_capture(cfg, n_channels: int, n_packets: int, ebno_db: float,
                     seed: int, mode: str = "v2", payload_fn=None):
    """(complex64 iq at n_channels*cfg.Fs, {channel: sent payloads}).

    Every channel centre k*Fs_total/N carries its own packet stream, its
    frames staggered by 1/N of a packet cycle per channel: transmitters
    are not sample-synchronous, and similar packets sent in lock-step on
    every centre add coherently and leak through the filterbank (text
    messages padded alike decode on no channel without the stagger).  Each
    channel is modulated natively at the wideband rate and mixed to its
    centre; AWGN is sized from the total power, so +10log10(N) makes
    ebno_db the per-channel value.  payload_fn(k, i) gives channel k's
    packet i."""
    from . import channel, channelizer, fsk
    fs_total = cfg.Fs * n_channels
    cfg_wide = dataclasses.replace(cfg, Fs=fs_total)
    centres = channelizer.channel_centres(fs_total, n_channels)
    stagger = packet_cycle(mode) // n_channels
    streams, sent = [], {}
    for k in range(n_channels):
        rng = np.random.default_rng(seed + k)
        payloads = (None if payload_fn is None
                    else [payload_fn(k, i) for i in range(n_packets)])
        bits, sent[k] = make_packet_bits(cfg, n_packets, rng, mode, payloads,
                                         lead_bits=LEAD_BITS + k * stagger)
        streams.append(bits)
    n_bits = max(len(b) for b in streams)
    wide = None
    for k, bits in enumerate(streams):
        bits = np.concatenate([bits, np.zeros(n_bits - len(bits), np.uint8)])
        sig, _ = fsk.fsk_mod_np(cfg_wide, bits, 2 * cfg.Rs, cfg.Rs)
        if wide is None:
            t = np.arange(len(sig), dtype=np.float64) / fs_total
            wide = np.zeros(len(sig), np.complex64)
        wide += (sig * np.exp(2j * np.pi * centres[k] * t)).astype(
            np.complex64)
    wide = channel.add_awgn(wide, ebno_db + 10 * np.log10(n_channels),
                            fs_total, cfg.Rs,
                            rng=np.random.default_rng(seed + n_channels))
    return wide, sent
