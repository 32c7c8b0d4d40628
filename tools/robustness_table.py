"""Shift/resample robustness table at REAL flight rates (the committed
envelope of /root/reference/benchmarking/README.md:94-172).

The reference commits baud-rate-error tables (tsrc-resampled captures at
0.3/0.4/0.5% error: 0.3% barely affects decode, 0.4-0.5% degrades
significantly, 0.6% fails completely) and sweeps frequency shift via csdr
shift_addition_cc (test_demod.py:71).  This tool reproduces that envelope
natively at both flight configurations — v1 Fs=921416/Rs=115177 (RS232
framing) and v2 Fs=960000/Rs=96000 — through the full RX chain, and
writes the committed golden artifact `tests/golden/robustness_{mode}.json`.

tests/test_robustness_table.py regenerates the grid with the same seeds
and fails on sensitivity drift (the reference's "so we know if we've
broken things" methodology).

Usage:
  python tools/robustness_table.py            # regenerate goldens
  python tools/robustness_table.py --check    # regenerate + diff
"""
import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PACKETS = 8
SEED_BASE = 9100

# baud-error grid (reference README.md:94-172; 0.997 proves the elastic
# nin tracks both signs) x Eb/N0 above / near the cliff
RESAMPLE_POINTS = [(0.997, 14.0), (1.003, 14.0), (1.004, 14.0),
                   (1.005, 14.0), (1.006, 14.0),
                   (1.003, 10.0), (1.005, 10.0)]
# frequency-shift grid in units of Rs (tones at 2Rs/3Rs must stay inside
# the estimator band [Rs/4, Fs/2 - Rs/4]): +-Rs/2 and +-Rs
SHIFT_POINTS = [(-1.0, 12.0), (-0.5, 12.0), (0.5, 12.0), (1.0, 12.0)]


def make_flight_capture(cfg, mode, n_packets, rng, ebno_db=None):
    """Same construction as tools/per_table.py (clean signal returned;
    noise applied after the impairment, as the reference harness degrades
    the resampled stream)."""
    from wenet_tpu.core import framing
    from wenet_tpu.ops import fsk, ldpc
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
    return sig.astype(np.complex64), payloads


def sweep(mode: str, log=lambda *a: None):
    from wenet_tpu.ops import channel, fsk
    from wenet_tpu.rx.pipeline import Receiver
    from wenet_tpu.utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()

    cfg = fsk.V1_CONFIG if mode == "v1" else fsk.V2_CONFIG
    rows = []

    def decode(iq, payloads):
        rx = Receiver(mode=mode, cfg=cfg)
        got = rx.decode_iq(iq)
        return sum(1 for p in got if p in payloads)

    for i, (ratio, ebno) in enumerate(RESAMPLE_POINTS):
        rng = np.random.default_rng(SEED_BASE + i)
        sig, payloads = make_flight_capture(cfg, mode, PACKETS, rng)
        iq = channel.resample_linear(sig, ratio)
        iq = channel.add_awgn(iq, ebno, cfg.Fs, cfg.Rs, rng=rng)
        ok = decode(iq, payloads)
        rows.append({"kind": "resample", "value": ratio, "ebno_db": ebno,
                     "packets_ok": ok})
        log(f"  {mode} resample {ratio:.3f} @ {ebno} dB: {ok}/{PACKETS}")

    for i, (shift_rs, ebno) in enumerate(SHIFT_POINTS):
        rng = np.random.default_rng(SEED_BASE + 50 + i)
        sig, payloads = make_flight_capture(cfg, mode, PACKETS, rng)
        iq = channel.freq_shift(sig, shift_rs * cfg.Rs, cfg.Fs)
        iq = channel.add_awgn(iq, ebno, cfg.Fs, cfg.Rs, rng=rng)
        ok = decode(iq, payloads)
        rows.append({"kind": "shift", "value": shift_rs, "ebno_db": ebno,
                     "packets_ok": ok})
        log(f"  {mode} shift {shift_rs:+.1f}*Rs @ {ebno} dB: "
            f"{ok}/{PACKETS}")

    return {"mode": mode, "Fs": cfg.Fs, "Rs": cfg.Rs, "packets": PACKETS,
            "seed_base": SEED_BASE, "rows": rows}


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
                            f"robustness_{mode}.json")
        if args.check and os.path.exists(path):
            with open(path) as f:
                golden = json.load(f)
            for new, old in zip(table["rows"], golden["rows"]):
                if abs(new["packets_ok"] - old["packets_ok"]) > 2:
                    print(f"REGRESSION {mode} {new['kind']} "
                          f"{new['value']}: {new['packets_ok']} vs "
                          f"golden {old['packets_ok']}")
                    rc = 1
        else:
            with open(path, "w") as f:
                json.dump(table, f, indent=1)
            print(f"wrote {path}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
