"""chip_smoke.py on the CPU: its refusal without a GPU, its last line, and
its phase functions at toy rates (Fs=96000, Rs=9600)."""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from wenet_tpu.ops import capture, fsk  # noqa: E402

CFG = fsk.FSKConfig(Fs=96000, Rs=9600)


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=120,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_final_line_format():
    devs = [SimpleNamespace(platform="gpu",
                            device_kind="NVIDIA H100 80GB HBM3")]
    line = chip_smoke.final_line(devs)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_stream_phase_decodes_every_packet(mode, tmp_path):
    out = chip_smoke.phase_stream(CFG, mode, 4.0, str(tmp_path))
    assert out["crc_ok"] == out["decodable"] == out["packets_sent"] > 0
    assert out["messages_logged"] == out["packets_sent"]


def test_fused_phase_equals_stream_payloads():
    out = chip_smoke.phase_fused(CFG, 4.0, 4, 2.0, 2)
    assert out["packets_decoded"] == out["packets_sent"]
    n_bits = int(2.0 * CFG.Fs) * CFG.Rs // CFG.Fs
    assert out["prefix_payloads_equal"] == capture.decodable_packets(
        n_bits, out["packets_sent"]) > 0


def test_wideband_phase(tmp_path):
    cpu = jax.devices("cpu")[0]
    out = chip_smoke.phase_wideband(CFG, 4, 3, str(tmp_path), cpu, cpu)
    assert out["packets"] == 12
    assert out["channelize"]["max_rel_err"] == 0.0


def test_four_phase_on_virtual_devices():
    """The --four paths on four virtual CPU devices (tests run with 8)."""
    out = chip_smoke.phase_four(jax.devices("cpu")[:4], CFG, 3.0, 8, 8, 8)
    assert out["fused_packets"] > 0
    assert out["ldpc_2x2"]["codewords"] == 8


def test_reference_comparisons_accept_identical_runs():
    """CPU against itself: every comparison passes at its tolerance."""
    cpu = jax.devices("cpu")[0]
    raw, _ = capture.flight_capture(CFG, 1.0, 12.0, 3)
    d = chip_smoke.compare_demod(cpu, cpu, fsk.iq_from_cu8(raw), CFG)
    assert d["sign_agreement"] == 1.0 and d["soft_bits"] > 0
    ld = chip_smoke.compare_ldpc(cpu, cpu, batch=32)
    assert ld["iters_agreement"] == 1.0
    assert chip_smoke.check_argmax_ties(cpu)


def test_reference_comparisons_reject_a_mismatch():
    ref = (jax.numpy.zeros((2, 4)), jax.numpy.array([1, 1]),
           jax.numpy.array([True, True]))
    other = (jax.numpy.ones((2, 4)), jax.numpy.array([1, 1]),
             jax.numpy.array([True, True]))
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare_decodes(ref, other, "mismatch")
