"""PRNG key construction from an integer seed.

A legacy threefry key is a uint32[2] array holding the seed's high and low
words; building it directly keeps the seed in 32-bit integers end to end
and gives the same key as `jax.random.PRNGKey(seed)`."""
from __future__ import annotations

import jax.numpy as jnp


def prng_key(seed: int) -> jnp.ndarray:
    """uint32[2] threefry key equal to jax.random.PRNGKey(seed)."""
    seed = int(seed)
    return jnp.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                     dtype=jnp.uint32)
