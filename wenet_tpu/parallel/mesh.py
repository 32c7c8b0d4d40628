"""Mesh construction helpers."""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "batch") -> Mesh:
    """1-D data-parallel mesh over the first n_devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh_2d(dp: int, tp: int, axes=("batch", "model")) -> Mesh:
    """2-D mesh: data-parallel x tensor-parallel (for sharded BP decode)."""
    devs = np.array(jax.devices()[: dp * tp]).reshape(dp, tp)
    return Mesh(devs, axes)


def make_hybrid_mesh(tp: int = 1, axes=("batch", "model")) -> Mesh:
    """2-D (batch, model) mesh over every device of every process.

    jax.devices() is ordered by process, so the reshape keeps each
    tensor-parallel group of `tp` devices inside one process whenever tp
    divides the per-process device count: the per-BP-iteration psums of
    the model axis then stay within a host.
    """
    n = len(jax.devices())
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    return Mesh(np.array(jax.devices()).reshape(n // tp, tp), axes)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Multi-process bring-up (`jax.distributed.initialize`) for sweeps
    over several hosts: capture batches and Monte-Carlo points are sharded
    over the global mesh.  A no-op for one process.  Returns the process
    count."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_count()
