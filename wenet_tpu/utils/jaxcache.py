"""Persistent XLA compilation cache for entry points.

The streaming Receiver compiles a handful of shape buckets at start-up,
and the fused whole-capture program is large, so every CLI entry point
enables JAX's persistent compilation cache: a restarted receiver (systemd
Restart=always, the reference's supervision model) reloads its programs
from disk instead of recompiling.

The cache lives where `JAX_COMPILATION_CACHE_DIR` says when that is set
(JAX reads it itself), and otherwise at the fixed path `<repo>/.jax_cache`:
the path is part of the cache key, so it must not move between runs.
"""
from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_persistent_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    With JAX_COMPILATION_CACHE_DIR set, nothing is configured here and
    that directory is returned.  Otherwise the cache goes to
    `<repo>/.jax_cache`.  Idempotent.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return REPO_CACHE_DIR
