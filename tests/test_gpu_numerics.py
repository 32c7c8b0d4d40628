"""The card against the CPU on the same inputs: demod, LDPC decode,
first-index argmax, channelizer.  The same functions run as phases 4 and 5
of chip_smoke.py.  Marked `gpu`: they skip where JAX has no GPU.

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from wenet_tpu.ops import capture, fsk  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def devices():
    try:
        gpu = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX "
                    "(JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)")
    return gpu, jax.devices("cpu")[0]


def test_demod_gpu_matches_cpu(devices):
    cfg = fsk.V2_CONFIG
    raw, _ = capture.flight_capture(cfg, 2.0, chip_smoke.EBNO_DB,
                                    chip_smoke.SEED)
    chip_smoke.compare_demod(*devices, fsk.iq_from_cu8(raw), cfg)


def test_ldpc_gpu_matches_cpu(devices):
    chip_smoke.compare_ldpc(*devices)


def test_argmax_first_ties_on_gpu(devices):
    assert chip_smoke.check_argmax_ties(devices[0])


def test_channelize_gpu_matches_cpu(devices):
    wide, _ = capture.wideband_capture(fsk.V2_CONFIG, 8, 2,
                                       chip_smoke.EBNO_DB, chip_smoke.SEED)
    chip_smoke.compare_channelize(*devices, wide, 8)
