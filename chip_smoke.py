#!/usr/bin/env python3
"""On-card bring-up check of the Wenet receive chain: one process, one card.

Drives the receive paths through the entry points users call, at flight
rates, and checks what comes out:

  0. card: nvidia-smi name and power limit, device kind, JAX version,
     compile-cache directory, whether the native host FSM built
  1. live v2 stream through `rx` (cli.rx.main): >= 20 s of cu8 carrying
     numbered text messages; crc_ok and the logged messages are checked
  2. the same for v1 (RS232 framing), >= 10 s
  3. the whole-capture fused path (decode_iq_fused, n_chunks=128, what
     `rx --parallel 128` runs) on the 95 s v2 capture, and its payloads
     against the exact-FSM Receiver on the first 20 s
  4. plain-reference numerics on the card: the committed PER tables, and
     the demod, LDPC decode and first-index argmax against the CPU
  5. wideband: `rx --channels 8`, and channelize against the CPU

Each phase prints one JSON line.  Any failed check raises, so the exit code
is non-zero.  The last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py          # one card, phases 0-5
    python3 chip_smoke.py --four   # only the multi-device paths, 4 cards
"""
import argparse
import contextlib
import glob
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 3            # the bench capture's seed
EBNO_DB = 12.0      # above the ~9.5 dB decode cliff

# demod on the card vs the CPU, same input.  A soft bit within float32
# rounding of zero may change sign between two backends (FMA contraction,
# transcendental approximations, reduction order); such bits carry no
# information for the decoder.  More than 0.1% sign flips would mean the
# carried estimator or timing state diverged, which moves packets.
DEMOD_SIGN_AGREEMENT_MIN = 0.999
# float32 roundoff through the DFT and integrator sums is ~1e-6 relative;
# a TF32 product (10-bit mantissa) in the demod would sit near 1e-3.
DEMOD_MEDIAN_REL_ERR_MAX = 1e-4
# LDPC decode on the card vs the CPU: the same bits wherever the CPU
# converged; the iteration count may differ only where a message sits on
# a rounding boundary of the early-exit test.
LDPC_ITERS_AGREEMENT_MIN = 0.99
# channelizer on the card vs the CPU, relative to the output's peak:
# float32 through a 12-tap filter and an N-point DFT stays below 1e-6;
# TF32 would give ~5e-4.
CHANNELIZE_MAX_REL_ERR = 1e-5


class SmokeFailure(AssertionError):
    """A check of the smoke run failed."""


def require(cond, what: str):
    if not cond:
        raise SmokeFailure(what)


def final_line(devices) -> str:
    """The run's last line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


class CompileMeter:
    """Compile seconds and persistent-cache hits/misses, from JAX's own
    monitoring events."""

    def __init__(self):
        self.secs = 0.0
        self.hits = 0
        self.misses = 0

    def install(self):
        import jax
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _duration(self, event, secs, **_):
        if event.startswith("/jax/core/compile/"):
            self.secs += secs

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def snapshot(self):
        return (self.secs, self.hits, self.misses)


def text_payload(mode: str, i: int) -> bytes:
    from wenet_tpu.core import packets
    return packets.encode_text_message(f"chip smoke {mode} #{i:05d}", i)


def run_rx(argv):
    """`rx` in this process; returns its stderr summary."""
    from wenet_tpu.cli import rx as rx_cli
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = rx_cli.main(argv)
    require(rc == 0, f"rx {argv} exited {rc}")
    return err.getvalue()


def logged_texts(log_dir: str):
    """(id, text) of every text message the router logged, in order."""
    out = []
    for path in sorted(glob.glob(os.path.join(log_dir, "*_text.log"))):
        with open(path) as f:
            out += [(d["id"], d["text"]) for d in map(json.loads, f)]
    return out


def sent_texts(payloads):
    from wenet_tpu.core import packets
    return [(d["id"], d["text"])
            for d in map(packets.decode_text_message, payloads)]


def rate_args(cfg, mode: str):
    from wenet_tpu.rx.pipeline import MODE_CONFIGS
    if (cfg.Fs, cfg.Rs) == (MODE_CONFIGS[mode].Fs, MODE_CONFIGS[mode].Rs):
        return []
    return ["--fs", str(cfg.Fs), "--rs", str(cfg.Rs)]


def phase_stream(cfg, mode: str, secs: float, workdir: str):
    """Live stream through `rx`: a flight capture of numbered text
    messages as a cu8 file, decoded in 2 s windows by the exact-FSM
    Receiver.  Every packet wholly inside the file is decoded, and the
    router logs the sent messages in order."""
    from wenet_tpu.ops import capture
    raw, sent = capture.flight_capture(
        cfg, secs, EBNO_DB, SEED, mode,
        payload_fn=lambda i: text_payload(mode, i))
    path = os.path.join(workdir, f"stream_{mode}.cu8")
    raw.tofile(path)
    log_dir = os.path.join(workdir, f"log_{mode}")
    summary = run_rx([path, "--format", "cu8", "--mode", mode, "--no-udp",
                      "--image-dir", os.path.join(workdir, f"img_{mode}"),
                      "--log-dir", log_dir] + rate_args(cfg, mode))
    m = re.search(r"crc_ok=(\d+)", summary)
    require(m is not None, f"no crc_ok in rx output: {summary!r}")
    n_bits = (len(raw) // 2) * cfg.Rs // cfg.Fs
    expect = capture.decodable_packets(n_bits, len(sent), mode)
    crc_ok = int(m.group(1))
    require(crc_ok == expect, f"{mode}: crc_ok={crc_ok}, expected {expect}")
    logged = logged_texts(log_dir)
    require(logged == sent_texts(sent)[:expect],
            f"{mode}: {len(logged)} logged messages differ from the "
            f"{expect} sent")
    return {"mode": mode, "seconds": len(raw) / 2 / cfg.Fs,
            "packets_sent": len(sent), "decodable": expect,
            "crc_ok": crc_ok, "messages_logged": len(logged)}


def phase_fused(cfg, secs: float, n_chunks: int, prefix_secs: float,
                prefix_chunks: int, mode: str = "v2"):
    """Whole-capture fused path: every sent packet decoded; on the
    capture's prefix the fused payloads equal the exact-FSM Receiver's,
    byte for byte."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.ops import capture
    from wenet_tpu.rx import pipeline

    raw, sent = capture.flight_capture(cfg, secs, EBNO_DB, SEED, mode)
    walls = []
    for _ in range(2):                  # cold (compiles), then warm
        t0 = time.perf_counter()
        got = pipeline.decode_iq_fused(raw, mode, cfg, n_chunks=n_chunks,
                                       input_format="cu8")
        walls.append(time.perf_counter() - t0)
    require(got == sent, f"fused: {len(got)} payloads, {len(sent)} sent, "
            f"{len(set(got) & set(sent))} in common")

    prefix = raw[: 2 * int(prefix_secs * cfg.Fs)]
    fused_p = pipeline.decode_iq_fused(prefix, mode, cfg,
                                       n_chunks=prefix_chunks,
                                       input_format="cu8")
    fsm_p = pipeline.Receiver(mode=mode, cfg=cfg,
                              input_format="cu8").decode_iq(prefix)
    require(fused_p == fsm_p, f"prefix: fused {len(fused_p)} payloads, "
            f"exact FSM {len(fsm_p)}, equal={fused_p == fsm_p}")
    n_bits = (len(prefix) // 2) * cfg.Rs // cfg.Fs
    require(len(fsm_p) == capture.decodable_packets(n_bits, len(sent), mode),
            "prefix: exact FSM missed a packet")

    fn, data, starts, skips, _ = pipeline.fused_plan(raw, mode, cfg,
                                                     n_chunks)
    mem = fn.lower(jax.ShapeDtypeStruct(data.shape, data.dtype),
                   jnp.asarray(starts),
                   jnp.asarray(skips)).compile().memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    return {"mode": mode, "samples": len(raw) // 2, "cu8_bytes": len(raw),
            "n_chunks": n_chunks, "packets_sent": len(sent),
            "packets_decoded": len(got), "wall_cold_s": walls[0],
            "wall_warm_s": walls[1], "prefix_s": prefix_secs,
            "prefix_payloads_equal": len(fsm_p),
            "memory_analysis": {
                k: getattr(mem, k) for k in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "generated_code_size_in_bytes")},
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def compare_demod(gpu, cpu, iq, cfg):
    """fsk.demod_stream on both devices, same input: valid frames equal,
    soft-bit signs and magnitudes within the stated tolerances."""
    import jax
    from wenet_tpu.ops import fsk
    nf = cfg.num_frames(len(iq))
    fstep = fsk.default_frames_per_step()
    res = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        _, outs = fsk.demod_stream(cfg, jax.device_put(iq, dev), nf,
                                   frames_per_step=fstep)
        res[name] = (np.asarray(outs.soft), np.asarray(outs.valid))
    (sg, vg), (sc, vc) = res["gpu"], res["cpu"]
    require(np.array_equal(vg, vc), "demod: valid frames differ")
    sg, sc = sg[vc].ravel(), sc[vc].ravel()
    agree = float(np.mean(np.sign(sg) == np.sign(sc)))
    rel = float(np.median(np.abs(sg - sc) / np.maximum(np.abs(sc), 1e-12)))
    require(agree >= DEMOD_SIGN_AGREEMENT_MIN,
            f"demod: sign agreement {agree} < {DEMOD_SIGN_AGREEMENT_MIN}")
    require(rel <= DEMOD_MEDIAN_REL_ERR_MAX,
            f"demod: median relative error {rel} > "
            f"{DEMOD_MEDIAN_REL_ERR_MAX}")
    return {"soft_bits": int(sg.size), "sign_agreement": agree,
            "median_rel_err": rel}


def near_cliff_llrs(batch: int, seed: int = 1):
    """LLRs of random codewords at Es/N0 = 10^0.75 * 0.8, where BP needs
    many iterations and some codewords never converge."""
    import jax.numpy as jnp
    from wenet_tpu.ops import ldpc
    rng = np.random.default_rng(seed)
    ib = np.unpackbits(rng.integers(0, 256, (batch, 258), dtype=np.uint8),
                       axis=1)
    cw = np.concatenate([ib, ldpc.encode_bits_np(ib)], axis=1)
    esn0 = 10 ** 0.75 * 0.8
    sd = (1 - 2.0 * cw) + rng.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
    return np.asarray(ldpc.sd_to_llr(jnp.asarray(sd, jnp.float32)))


def compare_decodes(ref, other, what: str):
    """(bits, iters, parity_ok) pairs: the same bits wherever the
    reference converged, equal iteration counts for nearly all."""
    (rb, ri, rok), (ob, oi, _) = ([np.asarray(x) for x in r]
                                  for r in (ref, other))
    require(np.array_equal(rb[rok], ob[rok]),
            f"{what}: bits differ on codewords the reference decoded")
    same_iters = float(np.mean(ri == oi))
    require(same_iters >= LDPC_ITERS_AGREEMENT_MIN,
            f"{what}: iteration counts agree on {same_iters}")
    return {"codewords": int(len(rb)), "converged": int(rok.sum()),
            "iters_agreement": same_iters}


def compare_ldpc(gpu, cpu, batch: int = 2048):
    import jax
    from wenet_tpu.ops import ldpc
    llr = near_cliff_llrs(batch)
    cpu_out = ldpc.decode(jax.device_put(llr, cpu))
    gpu_out = ldpc.decode(jax.device_put(llr, gpu))
    return compare_decodes(cpu_out, gpu_out, "ldpc gpu vs cpu")


def compare_channelize(gpu, cpu, iq, n_channels: int):
    import jax
    from wenet_tpu.ops import channelizer
    g = np.asarray(channelizer.channelize(jax.device_put(iq, gpu),
                                          n_channels))
    c = np.asarray(channelizer.channelize(jax.device_put(iq, cpu),
                                          n_channels))
    rel = float(np.max(np.abs(g - c)) / np.max(np.abs(c)))
    require(rel <= CHANNELIZE_MAX_REL_ERR,
            f"channelize: max relative error {rel} > "
            f"{CHANNELIZE_MAX_REL_ERR}")
    return {"outputs": int(c.size), "max_rel_err": rel}


def check_argmax_ties(dev):
    """fsk.argmax_first resolves ties to the first index on `dev`."""
    import jax
    from wenet_tpu.ops import fsk
    x = np.array([[1, 3, 3, 2], [5, 5, 5, 5], [0, 0, 7, 7]], np.float32)
    v, i = fsk.argmax_first(jax.device_put(x, dev))
    require(np.array_equal(np.asarray(i), [1, 0, 2]) and
            np.array_equal(np.asarray(v), [3, 5, 7]),
            f"argmax_first ties: {np.asarray(i)}")
    return True


def phase_numerics(gpu, cpu):
    """Committed PER tables re-run on the card, and the plain-reference
    comparisons against the CPU."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import per_table
    from wenet_tpu.ops import capture, fsk
    out = {}
    for mode in ("v1", "v2"):
        table = per_table.sweep(mode)
        with open(os.path.join(REPO, "tests", "golden",
                               f"per_table_{mode}.json")) as f:
            fails = per_table.golden_failures(table, json.load(f))
        require(not fails, f"PER table: {fails}")
        out[f"per_{mode}"] = [r["packets_ok"] for r in table["rows"]]
    cfg = fsk.V2_CONFIG
    raw, _ = capture.flight_capture(cfg, 2.0, EBNO_DB, SEED)
    out["demod"] = compare_demod(gpu, cpu, fsk.iq_from_cu8(raw), cfg)
    out["ldpc"] = compare_ldpc(gpu, cpu)
    out["argmax_first_ties"] = check_argmax_ties(gpu)
    return out


def phase_wideband(cfg, n_channels: int, n_packets: int, workdir: str,
                   gpu, cpu):
    """`rx --channels N` on an N-channel capture of text messages: every
    channel's messages logged in order; channelize against the CPU."""
    from wenet_tpu.ops import capture
    wide, sent = capture.wideband_capture(
        cfg, n_channels, n_packets, EBNO_DB, SEED,
        payload_fn=lambda k, i: text_payload(f"ch{k}", i))
    path = os.path.join(workdir, "wideband.c64")
    wide.tofile(path)
    log_dir = os.path.join(workdir, "log_wideband")
    summary = run_rx([path, "--format", "c64", "--mode", "v2", "--no-udp",
                      "--channels", str(n_channels),
                      "--image-dir", os.path.join(workdir, "img_wideband"),
                      "--log-dir", log_dir] + rate_args(cfg, "v2"))
    m = re.search(r"(\d+) packets", summary)
    require(m is not None, f"no packet count in rx output: {summary!r}")
    n_sent = n_channels * n_packets
    require(int(m.group(1)) == n_sent,
            f"wideband: {m.group(1)} packets, {n_sent} sent")
    expect = sum((sent_texts(sent[k]) for k in range(n_channels)), [])
    require(logged_texts(log_dir) == expect,
            "wideband: logged messages differ from the sent ones")
    return {"channels": n_channels, "samples": len(wide),
            "packets": n_sent,
            "channelize": compare_channelize(gpu, cpu, wide, n_channels)}


def phase_four(devs, cfg, secs: float, trials: int, n_chunks: int,
               batch: int):
    """The multi-device paths on 4 devices, each against the same work on
    one device: the Monte-Carlo PER sweep over a `batch` mesh, the fused
    capture decode with its chunk axis sharded, and the 2x2 dp x tp LDPC
    decode."""
    import jax
    from jax.sharding import Mesh
    from wenet_tpu.ops import capture, ldpc
    from wenet_tpu.parallel import sharded_ldpc, sweep
    from wenet_tpu.rx import pipeline

    out = {}
    grid = [8.0, 9.0, 10.0]
    one = sweep.chain_per_sweep(cfg, grid, trials,
                                mesh=Mesh(np.array(devs[:1]), ("batch",)))
    four = sweep.chain_per_sweep(cfg, grid, trials,
                                 mesh=Mesh(np.array(devs), ("batch",)))
    require(np.array_equal(one["per"], four["per"]),
            f"sweep: PER {one['per']} on 1 card, {four['per']} on 4")
    out["sweep_per"] = [float(p) for p in four["per"]]

    raw, sent = capture.flight_capture(cfg, secs, EBNO_DB, SEED)
    with jax.default_device(devs[0]):
        got1 = pipeline.decode_iq_fused(raw, "v2", cfg, n_chunks=n_chunks)
    got4 = pipeline.decode_iq_fused(raw, "v2", cfg, n_chunks=n_chunks,
                                    mesh=Mesh(np.array(devs), ("batch",)))
    require(got1 == got4, f"fused: {len(got1)} payloads on 1 card, "
            f"{len(got4)} on 4")
    require(got4 == sent, "fused on 4 cards: not every sent packet")
    out["fused_packets"] = len(got4)

    llr = near_cliff_llrs(batch)
    mesh2 = Mesh(np.array(devs).reshape(2, 2), ("batch", "model"))
    ref = ldpc.decode(jax.device_put(llr, devs[0]))
    tp = jax.jit(lambda x: sharded_ldpc.decode_sharded(x, mesh2))(llr)
    out["ldpc_2x2"] = compare_decodes(ref, tp, "ldpc 2x2 vs 1 card")
    return out


def card_info():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on 4 cards")
    args = ap.parse_args(argv)

    import jax
    # the card first, the CPU for the reference comparisons; a missing
    # CUDA backend is an error here, not a quiet fall-back to the CPU
    jax.config.update("jax_platforms", "cuda,cpu")
    try:
        devs = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: no CUDA device: {e}")
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: default device is {devs[0]}, "
                         "not a GPU")
    want = 4 if args.four else 1
    if len(devs) < want:
        raise SystemExit(f"chip_smoke: {len(devs)} GPUs, need {want}")
    devs = devs[:want]
    cpu = jax.devices("cpu")[0]

    from wenet_tpu import native
    from wenet_tpu.ops import fsk
    from wenet_tpu.utils.jaxcache import enable_persistent_cache

    cache = enable_persistent_cache()
    meter = CompileMeter()
    meter.install()
    card = card_info()
    print(card, flush=True)
    print(json.dumps({"phase": "card", "nvidia_smi": card,
                      "device_kind": devs[0].device_kind,
                      "devices": len(devs), "jax": jax.__version__,
                      "compile_cache": cache,
                      "native_fsm": native.available()}), flush=True)

    def run(name, fn):
        c0 = meter.snapshot()
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
        secs, hits, misses = (a - b for a, b in zip(meter.snapshot(), c0))
        print(json.dumps({"phase": name, **res}, default=float), flush=True)
        print("bring-up observation, not a benchmark: " + json.dumps(
            {"phase": name, "wall_s": wall, "compile_s": secs,
             "cache_hits": hits, "cache_misses": misses}), flush=True)

    with tempfile.TemporaryDirectory() as work:
        if args.four:
            run("four", lambda: phase_four(devs, fsk.V2_CONFIG, 95.0, 256,
                                           128, 2048))
        else:
            run("stream_v2", lambda: phase_stream(fsk.V2_CONFIG, "v2",
                                                  22.0, work))
            run("stream_v1", lambda: phase_stream(fsk.V1_CONFIG, "v1",
                                                  12.0, work))
            run("fused_v2", lambda: phase_fused(fsk.V2_CONFIG, 95.0, 128,
                                                20.0, 16))
            run("numerics", lambda: phase_numerics(devs[0], cpu))
            run("wideband", lambda: phase_wideband(fsk.V2_CONFIG, 8, 12,
                                                   work, devs[0], cpu))
    print(card, flush=True)
    print(final_line(devs), flush=True)


if __name__ == "__main__":
    main()
