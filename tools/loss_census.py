"""Parity-band packet-loss census for the bench chain stage.

At Eb/N0 >= 10.5 dB the reference decodes "essentially complete"
(reference benchmarking/README.md:63-86).  This tool reruns the exact
stage_chain Monte-Carlo but keeps PER-PICK crc_ok + UW positions, then
classifies every miss by packet index within the 12-packet stream:

  - index 0            -> acquisition loss (estimator warmup over packet 0)
  - index n_packets-1  -> stream-boundary / flush loss
  - interior           -> real sensitivity miss
  - position -1 picks  -> top-k exhaustion (fewer placeable windows than k)

Usage: python tools/loss_census.py [--streams B] [--rounds R]
       [--ebno-min 10.5] [--ebno-max 15.0]
Runs on the default JAX device; JAX_PLATFORMS=cpu for the CPU.
CPU (8-dev mesh not needed): B=16 R=4 runs in a couple of minutes.
"""
import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--ebno-min", type=float, default=10.5)
    ap.add_argument("--ebno-max", type=float, default=15.0)
    ap.add_argument("--k", type=int, default=None,
                    help="deframe_topk k override (default: n_packets)")
    ap.add_argument("--warmup-packets", type=int, default=0,
                    help="prepend this many extra packets, excluded from "
                         "the census (acquisition guard experiment)")
    args = ap.parse_args()

    import numpy as np
    from wenet_tpu.utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()
    import jax
    import jax.numpy as jnp
    from wenet_tpu.ops import deframe, fsk
    from wenet_tpu.utils import compat
    from wenet_tpu.ops import capture
    from wenet_tpu.utils.rng import prng_key

    cfg = fsk.V2_CONFIG
    n_packets = 12 + args.warmup_packets
    rng = np.random.default_rng(0)
    bits, _ = capture.make_packet_bits(cfg, n_packets, rng)
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    var = float(np.mean(np.abs(sig) ** 2))
    sig_j = compat.put_complex(sig)
    nf = cfg.num_frames(len(sig))
    B, R = args.streams, args.rounds
    k = args.k or n_packets
    ebnos = jnp.linspace(args.ebno_min, args.ebno_max, B)
    pkt_cycle = capture.packet_cycle("v2")

    @jax.jit
    def chain(sig, keys, ebno_db):
        def one(key, e):
            nvar = var * cfg.Fs / (cfg.Rs * 10.0 ** (e / 10.0))
            z = jax.random.normal(key, (sig.shape[0], 2), jnp.float32)
            iq = sig + jnp.sqrt(nvar / 2) * jax.lax.complex(z[:, 0], z[:, 1])
            iq = iq / jnp.max(jnp.abs(iq))
            _, outs = fsk.demod_stream(cfg, iq, nf)
            _, ok, _, pos = deframe.deframe_topk(
                outs.soft.reshape(-1), mode="v2", k=k)
            return ok, pos
        def one_round(_, ks):
            return 0, jax.vmap(one)(ks, ebno_db)
        _, (oks, poss) = jax.lax.scan(one_round, 0, keys)
        return oks, poss          # (R, B, k) each

    keys = jax.random.split(prng_key(1), R * B).reshape(R, B, -1)
    oks, poss = jax.tree.map(np.asarray, chain(sig_j, keys, ebnos))
    lead = capture.LEAD_BITS

    # classify: which packet indices decoded, per (round, stream)
    ebnos_np = np.asarray(ebnos)
    miss_hist = collections.Counter()
    miss_by_ebno = collections.Counter()
    exhausted_picks = 0
    dup_picks = 0
    total_miss = 0
    first = args.warmup_packets          # census covers indices >= first
    for r in range(R):
        for b in range(B):
            ok, pos = oks[r, b], poss[r, b]
            got = set()
            for j in range(k):
                if pos[j] < 0:
                    exhausted_picks += 1
                    continue
                if ok[j]:
                    pi = int(round((pos[j] - lead) / pkt_cycle))
                    if pi in got:
                        dup_picks += 1
                    got.add(pi)
            for pi in range(first, n_packets):
                if pi not in got:
                    total_miss += 1
                    miss_hist[pi - first] += 1
                    miss_by_ebno[round(float(ebnos_np[b]), 1)] += 1

    n_census = (n_packets - first)
    sent = R * B * n_census
    out = {
        "streams": B, "rounds": R, "k": k, "n_packets": n_census,
        "warmup_packets": args.warmup_packets,
        "ebno_range": [args.ebno_min, args.ebno_max],
        "sent": sent, "ok": sent - total_miss,
        "loss_pct": round(100.0 * total_miss / sent, 3),
        "miss_by_packet_index": dict(sorted(miss_hist.items())),
        "miss_first_pct": round(100.0 * miss_hist[0] / max(total_miss, 1), 1),
        "miss_last_pct": round(
            100.0 * miss_hist[n_census - 1] / max(total_miss, 1), 1),
        "miss_interior": int(sum(v for i, v in miss_hist.items()
                                 if 0 < i < n_census - 1)),
        "exhausted_picks": exhausted_picks,
        "duplicate_position_picks": dup_picks,
        "miss_by_ebno": {str(k_): v for k_, v in
                         sorted(miss_by_ebno.items())},
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
