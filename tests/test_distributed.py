"""Multi-process distributed bring-up: the one previously-untested entry
point (parallel/mesh.init_distributed -> jax.distributed.initialize).

Spawns 2 REAL processes (CPU backend, 4 virtual devices each -> 8 global),
builds the process-ordered (batch, model) mesh in each, and psum-reduces sweep
counters across processes — the multi-host sweep communication pattern
(SURVEY.md §2.3 distributed backend row) executed end-to-end.  Skips
cleanly where jax.distributed is unsupported."""
import json
import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4")
sys.path.insert(0, os.environ["WENET_REPO"])
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from wenet_tpu.parallel import mesh as M

pid = int(sys.argv[1])
nprocs = int(sys.argv[2])
coord = sys.argv[3]

jax.config.update("jax_platforms", "cpu")
n = M.init_distributed(coordinator=coord, num_processes=nprocs,
                       process_id=pid)
assert n == nprocs, f"process_count {n} != {nprocs}"
assert jax.device_count() == 4 * nprocs
assert jax.local_device_count() == 4

m = M.make_hybrid_mesh(tp=2)            # (batch=4, model=2) over 8 devices
assert m.devices.shape == (4, 2)

# psum sweep counters across the whole mesh (the ldpc_ber_sweep reduction
# pattern, sweep.py:75-81): each device contributes its local count; every
# process must see the same global total
from functools import partial
from jax.experimental import multihost_utils

local = (np.arange(jax.local_device_count() * 2, dtype=np.int32)
         .reshape(-1, 2) + 100 * pid)
arr = multihost_utils.host_local_array_to_global_array(
    local, m, P("batch", "model"))


@jax.jit
@partial(jax.shard_map, mesh=m, in_specs=P("batch", "model"),
         out_specs=P())
def count(x):
    return jax.lax.psum(jnp.sum(x, dtype=jnp.int32), ("batch", "model"))


total = count(arr)
got = int(np.asarray(multihost_utils.process_allgather(
    total, tiled=True)).ravel()[0])
n_local = jax.local_device_count() * 2
expect = sum(int(np.arange(n_local).sum() + 100 * p * n_local)
             for p in range(nprocs))
assert got == expect

# --- the PRODUCTION fused path, truly multi-process (VERDICT r4 #6):
# decode_iq_fused with the chunk axis sharded across BOTH processes'
# devices.  The capture replicates (identical on every host — SPMD);
# each process demodulates/deframes its own chunk shards; the packed
# packet results allgather so every host emits the same payload list.
from wenet_tpu.core import framing
from wenet_tpu.ops import channel, fsk, ldpc
from wenet_tpu.rx import pipeline

CFG = fsk.FSKConfig(Fs=96000, Rs=9600)
rng = np.random.default_rng(42)
payloads, bits = [], [rng.integers(0, 2, CFG.Nbits * 4).astype(np.uint8)]
for _ in range(10):
    pkt = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
    payloads.append(pkt)
    bits.append(framing.frame_to_bits(
        framing.frame_packet(pkt, ldpc.encode_bytes, "v2"), "v2"))
    bits.append(rng.integers(0, 2, 200).astype(np.uint8))
stream = np.concatenate(bits)
stream = np.concatenate(
    [stream, np.zeros((-len(stream)) % CFG.Nbits, np.uint8)])
sig, _ = fsk.fsk_mod_np(CFG, stream, 2 * CFG.Rs, CFG.Rs)
iq = channel.add_awgn(sig.astype(np.complex64), 13.0, CFG.Fs, CFG.Rs,
                      rng=rng)
raw = fsk.iq_to_cu8(iq / (np.abs(iq).max() + 1e-9))

fused = pipeline.decode_iq_fused(raw, "v2", CFG, n_chunks=8,
                                 input_format="cu8", mesh=m)
n_ok = sum(1 for p in fused if p in payloads)
print(json.dumps({"pid": pid, "got": got, "expect": expect,
                  "fused_ok": n_ok, "fused_sent": len(payloads)}),
      flush=True)
assert n_ok >= len(payloads) - 1, (n_ok, len(payloads))
"""


def test_init_distributed_two_processes(tmp_path):
    # free port for the coordinator
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"

    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ,
               WENET_REPO=os.path.join(os.path.dirname(__file__), ".."))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", coord],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("jax.distributed coordinator timed out on this host")
    for rc, out, err in outs:
        if rc != 0 and ("unimplemented" in err.lower()
                        or "not supported" in err.lower()):
            pytest.skip(f"jax.distributed unsupported: {err[-200:]}")
        assert rc == 0, f"worker failed: {err[-800:]}"
    results = [json.loads(out.strip().splitlines()[-1])
               for _, out, _ in outs]
    assert results[0]["got"] == results[0]["expect"]
    assert results[1]["got"] == results[1]["expect"]
    # fused production path: both processes decode the same payload count
    # from their chunk shards (>=9/10 asserted inside each worker)
    assert results[0]["fused_ok"] == results[1]["fused_ok"]
    assert results[0]["fused_sent"] == 10
