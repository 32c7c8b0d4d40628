"""Capture-builder accounting: exact decodable-packet counts.

The bench and chip_smoke.py gate on packets wholly inside a capture or a
prefix of it; these tests pin the exact enumeration
(capture.decodable_packets) to the actual bit layout produced by
capture.make_packet_bits, for both framings.
"""
import numpy as np
import pytest

from wenet_tpu.ops import capture, fsk


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_layout_matches_decodable_packets(mode):
    """Frame i occupies bits [lead + i*cycle, lead + i*cycle + frame_bits)."""
    cfg = fsk.V2_CONFIG if mode == "v2" else fsk.V1_CONFIG
    rng = np.random.default_rng(0)
    n_packets = 5
    bits, sent = capture.make_packet_bits(cfg, n_packets, rng, mode)
    assert len(sent) == n_packets
    total = len(bits)
    lead, fb = capture.LEAD_BITS, capture.frame_bits(mode)
    cycle = capture.packet_cycle(mode)
    # no prefix shorter than lead+frame contains a packet
    assert capture.decodable_packets(lead + fb - 1, n_packets, mode) == 0
    # exactly at the first frame's end: 1
    assert capture.decodable_packets(lead + fb, n_packets, mode) == 1
    # mid-gap after frame 2: 3 frames fit
    nbits = lead + 2 * cycle + fb + 100
    assert capture.decodable_packets(nbits, n_packets, mode) == 3
    # the whole stream: capped at n_packets
    assert capture.decodable_packets(total, n_packets, mode) == n_packets
    assert capture.decodable_packets(10 * total, n_packets, mode) == n_packets


def test_lead_in_present_and_frames_at_cycle_offsets():
    """The capture starts with LEAD_BITS of filler and every frame lands
    at lead + i*cycle (the loss-census index mapping relies on it)."""
    from wenet_tpu.core import framing
    from wenet_tpu.ops import ldpc
    cfg = fsk.V2_CONFIG
    rng = np.random.default_rng(1)
    bits, sent = capture.make_packet_bits(cfg, 3, rng)
    # the payloads are the rng's first draws
    rng2 = np.random.default_rng(1)
    fb, cycle = capture.frame_bits("v2"), capture.packet_cycle("v2")
    for i in range(3):
        p = rng2.integers(0, 256, 256, dtype=np.uint8).tobytes()
        assert sent[i] == p
        frame = framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode="v2"), "v2")
        assert len(frame) == fb
        start = capture.LEAD_BITS + i * cycle
        np.testing.assert_array_equal(bits[start:start + fb], frame)


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_exact_fsm_finds_exactly_the_frames(mode):
    """On the noiseless on-air bits the exact C-FSM acquisition locks on
    every frame's UW and nowhere else: the filler never aliases the UW,
    so crc_ok can be gated on the decodable count."""
    from wenet_tpu.core import framing
    from wenet_tpu.ops import deframe
    n = 300
    bits, _ = capture.make_packet_bits(fsk.V2_CONFIG, n,
                                       np.random.default_rng(0), mode)
    pos, _ = deframe.uw_detect_positions(bits, mode)
    pre_uw = len(framing.frame_to_bits(framing.PREAMBLE + framing.UNIQUE_WORD,
                                       mode))
    expect = [capture.LEAD_BITS + i * capture.packet_cycle(mode) + pre_uw - 1
              for i in range(n)]
    assert list(pos) == expect


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_plain_random_filler_would_alias(mode):
    """The control: random bits of a long capture's filler length do come
    within the allowed UW errors + 2 somewhere."""
    rng = np.random.default_rng(0)
    assert not capture.uw_margin_ok(
        rng.integers(0, 2, 400 * capture.GAP_BITS).astype(np.uint8), mode)
