"""Test configuration: an 8-device virtual CPU mesh so sharding tests run
anywhere.  JAX_PLATFORMS, when set, wins (the `gpu`-marked tests run with
JAX_PLATFORMS=cuda,cpu on a machine with a card); otherwise tests run on
the CPU.
"""
import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(__file__))
