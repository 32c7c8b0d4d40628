"""RX pipeline CLI: IQ samples in, decoded packets/images/telemetry out.

Single-process replacement for the reference's
`rtl_sdr | fsk_demod --cu8 -s | wenet_ldpc | rx_ssdv.py` shell pipeline
(start_rx_headless.sh:130-133) with the same side-channels (UDP 7890/55672,
JSON logs, image directory) and fsk_demod-style flags (-b/-u estimator
limits, --stats emission)."""
from __future__ import annotations

import argparse
import queue
import sys
import threading
import time

import numpy as np


def _chunk_reader(fin, chunk_bytes: int, depth: int = 2):
    """Background-thread chunk prefetcher: IO overlaps device dispatch
    (the double-buffering SURVEY.md §7 calls for — the role the Unix pipe
    buffer plays between rtl_sdr and fsk_demod in the reference)."""
    q: queue.Queue = queue.Queue(maxsize=depth)

    def pump():
        try:
            while True:
                raw = fin.read(chunk_bytes)
                q.put(raw)
                if not raw:
                    return
        except Exception:
            q.put(b"")

    threading.Thread(target=pump, daemon=True).start()
    while True:
        raw = q.get()
        if not raw:
            return
        yield raw


def add_args(ap: argparse.ArgumentParser):
    ap.add_argument("input", help="IQ file path, or '-' for stdin")
    ap.add_argument("--format", choices=["cu8", "cs16", "s16", "c64"],
                    default="cu8", help="input sample format")
    ap.add_argument("--mode", choices=["v1", "v2"], default="v2",
                    help="framing mode (baud 115177 RS232 / 96000 scrambled)")
    ap.add_argument("--fs", type=int, default=None,
                    help="sample rate override (default: mode standard)")
    ap.add_argument("--rs", type=int, default=None, help="baud override")
    ap.add_argument("-b", "--est-min", type=int, default=None,
                    help="estimator lower limit, Hz (fsk_demod -b)")
    ap.add_argument("-u", "--est-max", type=int, default=None,
                    help="estimator upper limit, Hz (fsk_demod -u)")
    ap.add_argument("--image-dir", default="./rx_images")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--partialupdate", type=int, default=0,
                    help="decode partial image every N packets")
    ap.add_argument("--headless", action="store_true")
    ap.add_argument("--no-udp", action="store_true",
                    help="disable UDP side-channel emission")
    ap.add_argument("--stats-rate", type=float, default=1.0,
                    help="modem stats emission rate, Hz")
    ap.add_argument("--chunk-seconds", type=float, default=2.0)
    ap.add_argument("--acquire", type=float, default=0.0, metavar="SECONDS",
                    help="probe this many seconds first and search a coarse "
                         "frequency-offset grid (parallel on device) when "
                         "the SDR tuning is unknown; 0 = off")
    ap.add_argument("--throttle", action="store_true",
                    help="pace file input at real time (rx/play_iq.py role)")
    ap.add_argument("--pipelined", action="store_true",
                    help="overlap device demod of chunk k+1 with host "
                         "deframe of chunk k (pipeline parallelism; "
                         "payloads arrive one chunk later)")
    ap.add_argument("--parallel", type=int, default=0, metavar="N",
                    help="one-shot overlap-save decode with N concurrent "
                         "chunk demods in one device dispatch (whole-file "
                         "throughput mode; exact streaming uses chunked "
                         "push)")
    ap.add_argument("--slabs", type=int, default=0, metavar="S",
                    help="with --parallel: cut the capture into S "
                         "overlapping slabs kept 2-in-flight so the "
                         "host->device transfer of slab s+1 overlaps the "
                         "execution of slab s (throughput mode for "
                         "bandwidth-limited links)")
    ap.add_argument("--channels", type=int, default=0, metavar="N",
                    help="wideband mode: polyphase-channelize the capture "
                         "into N channels of --fs each and demod them all in "
                         "one device dispatch (the successor to the "
                         "reference's rx/grc wideband flowgraphs)")
    ap.add_argument("--channel-select", default=None, metavar="K[,K...]",
                    help="with --channels: only decode these channel indices")


def main(argv=None):
    from ..utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    add_args(ap)
    args = ap.parse_args(argv)

    from ..ops import fsk
    from ..rx import stats as rxstats
    from ..rx.pipeline import INPUT_CONVERTERS, MODE_CONFIGS, Receiver
    from ..rx.router import PacketRouter, UDPEmitter

    cfg = MODE_CONFIGS[args.mode]
    if args.fs or args.rs:
        cfg = fsk.FSKConfig(Fs=args.fs or cfg.Fs, Rs=args.rs or cfg.Rs)
    limits = None
    if args.est_min is not None or args.est_max is not None:
        limits = (args.est_min if args.est_min is not None else cfg.est_min,
                  args.est_max if args.est_max is not None else cfg.est_max)
    rx = Receiver(mode=args.mode, cfg=cfg, estimator_limits=limits,
                  pipelined=args.pipelined, with_eye=not args.no_udp)
    emitter = UDPEmitter(enabled=not args.no_udp)
    router = PacketRouter(image_dir=args.image_dir, log_dir=args.log_dir,
                          partial_update=args.partialupdate,
                          headless=args.headless, emitter=emitter)
    stats_acc = rxstats.FSKDemodStats(
        averaging_time=max(1.0 / args.stats_rate, 0.5), peak_hold=True,
        sample_rate=rx.cfg.Fs)

    conv, dtype, width = INPUT_CONVERTERS[args.format]

    if args.channels:
        # one-shot wideband decode: whole capture -> channelizer + vmapped
        # demods in a single jitted program, payloads routed per channel
        from ..ops.channelizer import demod_multichannel
        fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
        iq = conv(np.frombuffer(fin.read(), dtype=dtype))
        if fin is not sys.stdin.buffer:
            fin.close()
        sel = ([int(k) for k in args.channel_select.split(",")]
               if args.channel_select else None)
        t0 = time.time()
        per_channel = demod_multichannel(
            iq, Fs_total=cfg.Fs * args.channels, n_channels=args.channels,
            cfg=cfg, mode=args.mode, channels=sel)
        n = 0
        for k in sorted(per_channel):
            for payload in per_channel[k]:
                router.handle_packet(payload)
                n += 1
        router.flush()
        dt = time.time() - t0
        # iq is already at the full wideband rate Fs_total = cfg.Fs * channels
        print(f"wideband: {args.channels} channels, {n} packets, "
              f"images={router.images_decoded} wall={dt:.2f}s "
              f"({len(iq) / max(dt, 1e-9) / 1e6:.2f} Msamp/s)",
              file=sys.stderr)
        return 0
    if args.slabs > 1 and not args.parallel:
        # --slabs only selects a fused-path variant; without --parallel it
        # used to be silently ignored (ADVICE r3) — imply the default
        args.parallel = 4 * args.slabs
        print(f"--slabs {args.slabs} implies --parallel {args.parallel} "
              "(fused one-dispatch mode)", file=sys.stderr)
    if args.parallel:
        # one-shot fused decode: N concurrent chunk demods PLUS the UW
        # deframe + LDPC + CRC all in ONE device dispatch (cu8 bytes convert
        # on device); the throughput path for whole-file processing, one
        # dispatch per capture
        from ..rx.pipeline import decode_iq_fused, decode_iq_fused_overlap
        fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
        buf = np.frombuffer(fin.read(), dtype=dtype)
        if fin is not sys.stdin.buffer:
            fin.close()
        native = args.format in ("cu8", "cs16")   # device-side conversion
        data = buf if native else conv(buf)
        fmt = args.format if native else "c64"
        t0 = time.time()
        if args.slabs > 1:
            payloads = decode_iq_fused_overlap(
                data, mode=args.mode, cfg=cfg, n_slabs=args.slabs,
                chunks_per_slab=max(args.parallel // args.slabs, 1),
                input_format=fmt)
        else:
            payloads = decode_iq_fused(data, mode=args.mode, cfg=cfg,
                                       n_chunks=args.parallel,
                                       input_format=fmt)
        for payload in payloads:
            router.handle_packet(payload)
        router.flush()
        dt = time.time() - t0
        n_samp = len(buf) // width      # components per sample, per format
        print(f"parallel x{args.parallel}: {len(payloads)} packets, "
              f"images={router.images_decoded} wall={dt:.2f}s "
              f"({n_samp / max(dt, 1e-9) / 1e6:.2f} Msamp/s)",
              file=sys.stderr)
        return 0

    bytes_per_sample = np.dtype(dtype).itemsize * (
        2 if args.format in ("cu8", "cs16") else 1)
    chunk_samples = int(rx.cfg.Fs * args.chunk_seconds)

    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")

    # optional coarse acquisition: probe the head of the stream across a
    # device-parallel offset grid, then mix every chunk by the winner
    mix_frac = 0.0            # offset/Fs (fractional cycles per sample)
    mix_pos = 0               # global sample index for phase continuity
    pending = b""
    if args.acquire > 0:
        from ..parallel.sweep import acquisition_search
        probe_n = int(rx.cfg.Fs * args.acquire)
        pending = fin.read(probe_n * bytes_per_sample)
        probe_iq = conv(np.frombuffer(pending, dtype=dtype))
        step = rx.cfg.Rs // 2
        grid = np.arange(-(rx.cfg.Fs // 2) + 2 * step, rx.cfg.Fs // 2 - 2 * step,
                         step, dtype=np.float32)
        best, scores = acquisition_search(rx.cfg, probe_iq, grid,
                                          mode=args.mode)
        nuw = 32 if args.mode == "v2" else 40
        if scores.max() >= nuw - 2 * (4 if args.mode == "v2" else 5):
            mix_frac = float(best) / rx.cfg.Fs
            print(f"acquired coarse offset {best:+.0f} Hz "
                  f"(UW score {scores.max():.0f}/{nuw})", file=sys.stderr)
        else:
            print(f"acquisition found no UW lock (best score "
                  f"{scores.max():.0f}/{nuw}); leaving tuning unchanged",
                  file=sys.stderr)

    # cu8/cs16 ingest with no mixing: push the raw rtl_sdr / pcmcat bytes
    # and convert on device (less H2D traffic, no host conversion in loop)
    raw_push = args.format in ("cu8", "cs16") and mix_frac == 0.0
    if raw_push:
        rx = Receiver(mode=args.mode, cfg=cfg, estimator_limits=limits,
                      pipelined=args.pipelined, input_format=args.format,
                      with_eye=not args.no_udp)

    last_stats = 0.0
    t0 = time.time()
    next_deadline = t0
    try:
        reader = _chunk_reader(fin, chunk_samples * bytes_per_sample)
        while True:
            raw = pending + next(reader, b"")
            pending = b""
            if not raw:
                break
            if args.throttle:
                next_deadline += args.chunk_seconds
                delay = next_deadline - time.time()
                if delay > 0:
                    time.sleep(delay)
            buf = np.frombuffer(raw, dtype=dtype)
            if raw_push:
                for payload in rx.push(buf):
                    router.handle_packet(payload)
            else:
                iq = conv(buf)
                if mix_frac:
                    n = mix_pos + np.arange(len(iq), dtype=np.float64)
                    iq = (iq * np.exp(-2j * np.pi * np.mod(n * mix_frac, 1.0))
                          ).astype(np.complex64)
                mix_pos += len(iq)
                for payload in rx.push(iq):
                    router.handle_packet(payload)
            now = time.time()
            if not args.no_udp and now - last_stats > 1.0 / args.stats_rate:
                rec = rxstats.receiver_stats_record(rx)
                if rec:
                    stats_acc.update(rec)
                    rxstats.send_modem_stats(stats_acc.to_wire())
                last_stats = now
    finally:
        for payload in rx.flush():        # drain the in-flight chunk (PP)
            router.handle_packet(payload)
        router.flush()
        if fin is not sys.stdin.buffer:
            fin.close()
    dt = time.time() - t0
    s = rx.stats
    print(f"samples={s.samples} frames={s.frames} detections={s.detections} "
          f"crc_ok={s.crc_ok} images={router.images_decoded} "
          f"wall={dt:.2f}s ({s.samples / max(dt, 1e-9) / 1e6:.2f} Msamp/s)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
