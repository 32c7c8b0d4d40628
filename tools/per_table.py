"""PER-vs-Eb/N0 regression table (benchmarking/README.md:63-86 mirror).

Sweeps the reference's Eb/N0 grid at REAL flight rates (v1
Fs=921416/Rs=115177 RS232 framing, v2 Fs=960000/Rs=96000) on multi-packet
captures through the full RX chain, and writes the committed golden
artifact `tests/golden/per_table_{mode}.json` — packets/bytes decoded per
point, the same metric the reference's harness records ("bytes of
CRC-valid output" per degraded file, test_demod.py:118).

tests/test_per_table.py (on the CPU) and chip_smoke.py (on the GPU)
regenerate the table with the same seeds and fail, through
`golden_failures`, if sensitivity regresses anywhere on the cliff.

Usage:
  python tools/per_table.py             # regenerate golden artifacts
  python tools/per_table.py --check    # regenerate + diff vs committed
"""
import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GRID = [round(x, 1) for x in np.arange(5.0, 15.01, 0.5)]
PACKETS = 12
SEED_BASE = 7000          # same scheme as the committed golden points


def make_flight_capture(cfg, mode, n_packets, rng, ebno_db):
    """Identical construction to tests/test_flight_rates.make_flight_capture
    (duplicated rather than imported: the tests package pulls in the
    reference-binary oracle machinery, which this tool must not need)."""
    from wenet_tpu.core import framing
    from wenet_tpu.ops import channel, fsk, ldpc
    payloads, bits = [], [rng.integers(0, 2, cfg.Nbits * 4).astype(np.uint8)]
    for _ in range(n_packets):
        p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        payloads.append(p)
        frame = framing.frame_packet(p, ldpc.encode_bytes, mode=mode)
        bits.append(framing.frame_to_bits(frame, mode))
        bits.append(rng.integers(0, 2, 512).astype(np.uint8))
    stream = np.concatenate(bits)
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
    sig, _ = fsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    iq = channel.add_awgn(sig.astype(np.complex64), ebno_db, cfg.Fs, cfg.Rs,
                          rng=rng)
    return fsk.iq_to_cu8(iq), payloads


def sweep(mode: str, log=lambda *a: None):
    from wenet_tpu.ops import fsk
    from wenet_tpu.rx.pipeline import Receiver

    cfg = fsk.V1_CONFIG if mode == "v1" else fsk.V2_CONFIG
    rows = []
    for ebno in GRID:
        rng = np.random.default_rng(SEED_BASE + int(ebno * 10))
        raw, payloads = make_flight_capture(cfg, mode, PACKETS, rng, ebno)
        rx = Receiver(mode=mode, cfg=cfg)
        got = rx.decode_iq(fsk.iq_from_cu8(raw))
        ok = sum(1 for p in got if p in payloads)
        rows.append({"ebno_db": ebno, "packets_ok": ok,
                     "bytes_ok": 256 * ok})
        log(f"  {mode} {ebno:5.1f} dB: {ok:2d}/{PACKETS} packets")
    return {"mode": mode, "Fs": cfg.Fs, "Rs": cfg.Rs, "packets": PACKETS,
            "seed_base": SEED_BASE, "grid": GRID, "rows": rows}


def golden_failures(table, golden) -> list:
    """What in `table` breaks the committed `golden`: the same grid, each
    point within +-2 packets (absorbs cross-platform float drift in the
    demod and BP near the cliff while catching real sensitivity loss), and
    the hard cliff invariants (the synthetic-AWGN channel sits ~1.5 dB
    below the reference's real-capture table).  Empty when it passes."""
    mode = table["mode"]
    fails = []
    if table["grid"] != golden["grid"]:
        fails.append(f"{mode}: grid differs from the golden")
    if table["packets"] != golden["packets"]:
        fails.append(f"{mode}: packet count differs from the golden")
    for new, old in zip(table["rows"], golden["rows"]):
        if abs(new["packets_ok"] - old["packets_ok"]) > 2:
            fails.append(f"{mode} @ {new['ebno_db']} dB: "
                         f"{new['packets_ok']} vs golden {old['packets_ok']}")
    by_ebno = {r["ebno_db"]: r["packets_ok"] for r in table["rows"]}
    n = table["packets"]
    if not all(by_ebno[e] == 0 for e in (5.0, 5.5, 6.0)):
        fails.append(f"{mode}: floor leak below 6 dB")
    if not all(by_ebno[e] >= n - 1 for e in by_ebno if e >= 8.5):
        fails.append(f"{mode}: sensitivity regression above the cliff")
    return fails


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--modes", default="v1,v2")
    args = ap.parse_args()
    os.makedirs(os.path.join(REPO, "tests", "golden"), exist_ok=True)
    rc = 0
    for mode in args.modes.split(","):
        table = sweep(mode, log=print)
        path = os.path.join(REPO, "tests", "golden",
                            f"per_table_{mode}.json")
        if args.check and os.path.exists(path):
            with open(path) as f:
                golden = json.load(f)
            for msg in golden_failures(table, golden):
                print(f"REGRESSION {msg}")
                rc = 1
        else:
            with open(path, "w") as f:
                json.dump(table, f, indent=1)
            print(f"wrote {path}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
