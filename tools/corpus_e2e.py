"""13-image corpus end-to-end run (BASELINE.json config 3): every reference
test image through SSDV -> TX framing -> flight-rate modulation -> AWGN ->
full RX chain -> SSDV reassembly, with payload-level comparison against the
reference C chain (fsk_demod | wenet_ldpc or drs232_ldpc) on the same cu8
bytes.

    JAX_PLATFORMS=cpu python tools/corpus_e2e.py
    JAX_PLATFORMS=cpu python tools/corpus_e2e.py \
        --mode v1 --limit 3        # v1 RS232 chain at 921416/115177
"""
import glob
import io
import os
import subprocess
import sys
import time

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

from wenet_tpu import ssdv                                   # noqa: E402
from wenet_tpu.core import framing                           # noqa: E402
from wenet_tpu.ops import channel, fsk, ldpc                 # noqa: E402
from wenet_tpu.rx.pipeline import Receiver                   # noqa: E402
import refbins                                               # noqa: E402


def main(ebno=12.0, resolution=(800, 608), mode="v2", limit=None,
         fused=0, slabs=0):
    # real flight rates: v2 Fs=960000/Rs=96000, v1 Fs=921416/Rs=115177
    cfg = fsk.V2_CONFIG if mode == "v2" else fsk.V1_CONFIG
    images = sorted(glob.glob("/root/reference/test_images/*.jpg"),
                    key=lambda p: int(os.path.basename(p).split(".")[0]))
    if limit:
        images = images[:limit]
    use_ref = refbins.reference_available()
    demod_bin = refbins.fsk_demod() if use_ref else None
    ldpc_bin = (refbins.wenet_ldpc() if mode == "v2"
                else refbins.drs232_ldpc()) if use_ref else None

    total_t, total_samples, exact = 0.0, 0, 0
    rows = []
    for img_path in images:
        name = os.path.basename(img_path)
        img = Image.open(img_path).convert("RGB").resize(resolution)
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90)
        pkts = ssdv.encode(buf.getvalue(), "VK5QI",
                           int(name.split(".")[0]) % 256)
        rng = np.random.default_rng(hash(name) % 2**32)
        bits = [rng.integers(0, 2, cfg.Nbits * 4).astype(np.uint8)]
        for p in pkts:
            frame = framing.frame_packet(p, ldpc.encode_bytes, mode)
            bits.append(framing.frame_to_bits(frame, mode))
        stream = np.concatenate(bits)
        stream = np.concatenate(
            [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
        sig, _ = fsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
        iq = channel.add_awgn(sig.astype(np.complex64), ebno, cfg.Fs, cfg.Rs,
                              rng=rng)
        # pad all captures to one length so the jitted demod compiles once
        # (fused mode: ~27 Msamples covers an 800x608 q90 image at flight
        # rate with margin; the pad is decoded too — throughput counts it,
        # real-time uses the unpadded signal duration)
        pad_len = 27_000_000 if fused else 10_000_000
        n_signal = len(iq)
        if len(iq) < pad_len:
            iq = np.concatenate(
                [iq, np.zeros(pad_len - len(iq), np.complex64)])
        raw = fsk.iq_to_cu8(iq)

        t0 = time.time()
        if fused:
            # the production one-dispatch ingest path, raw cu8 bytes in
            # (reference contract benchmarking/test_demod.py:21-44), with
            # optional slab H2D/exec overlap
            from wenet_tpu.rx.pipeline import (decode_iq_fused,
                                               decode_iq_fused_overlap)
            if slabs > 1:
                ours = decode_iq_fused_overlap(
                    raw, mode, cfg, n_slabs=slabs,
                    chunks_per_slab=max(fused // slabs, 1),
                    input_format="cu8")
            else:
                ours = decode_iq_fused(raw, mode, cfg, n_chunks=fused,
                                       input_format="cu8")
        else:
            rx = Receiver(mode=mode, cfg=cfg)
            ours = rx.decode_iq(fsk.iq_from_cu8(raw))
        dt = time.time() - t0
        total_t += dt
        total_samples += n_signal

        ref_n = "-"
        match = "-"
        if use_ref:
            p1 = subprocess.run(
                [demod_bin, "--cu8", "-s", "2", str(cfg.Fs), str(cfg.Rs),
                 "-", "-"], input=raw.tobytes(), capture_output=True)
            p2 = subprocess.run([ldpc_bin, "-", "-"], input=p1.stdout,
                                capture_output=True)
            ref = [p2.stdout[i:i + 256] for i in range(0, len(p2.stdout), 256)]
            ref_n = len(ref)
            match = "EXACT" if ours == ref else \
                f"{sum(1 for p in ours if p in ref)}/{len(ref)}"
            if ours == ref:
                exact += 1
        # reassemble the image
        jpeg = ssdv.decode(ours)
        a1 = np.asarray(Image.open(buf), np.float32)
        a2 = np.asarray(Image.open(io.BytesIO(jpeg)), np.float32)
        pix = float(np.abs(a1 - a2).mean())
        rows.append((name, len(pkts), len(ours), ref_n, match, pix, dt))
        print(f"{name:>7} pkts={len(pkts):>3} decoded={len(ours):>3} "
              f"ref={ref_n:>3} parity={match:>6} pixdiff={pix:5.2f} "
              f"t={dt:4.1f}s", flush=True)

    rt = total_samples / cfg.Fs / total_t
    print(f"\nTotal: {len(images)} images, {total_samples / 1e6:.0f} Msamples "
          f"decoded in {total_t:.1f}s = {rt:.1f}x real-time single-stream; "
          f"{exact}/{len(images)} byte-exact vs the C chain")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["v1", "v2"], default="v2")
    ap.add_argument("--ebno", type=float, default=12.0)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--fused", type=int, default=0, metavar="N",
                    help="decode via the one-dispatch fused path with N "
                         "chunks (the on-chip corpus configuration)")
    ap.add_argument("--slabs", type=int, default=0,
                    help="with --fused: slab-pipelined H2D/exec overlap")
    a = ap.parse_args()
    from wenet_tpu.utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()
    main(ebno=a.ebno, mode=a.mode, limit=a.limit, fused=a.fused,
         slabs=a.slabs)
