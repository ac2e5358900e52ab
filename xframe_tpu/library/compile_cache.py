"""Persistent XLA compilation cache.

Compiling the tutorial- and production-scale phasing programs takes tens of
seconds per process; the persistent cache amortizes that across processes.
Each compiled executable is written to disk as it finishes, so even an
interrupted run leaves the next one warmer. The directory is part of the
cache key, so it must not move between runs: `JAX_COMPILATION_CACHE_DIR` when
the environment sets it (JAX reads that variable itself), otherwise the fixed
`<checkout>/.jax_cache`. Call `enable()` before the first jit compilation
(importing jax is fine).
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory compiled programs persist in."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn on the JAX persistent compilation cache (idempotent) → its
    directory. With JAX_COMPILATION_CACHE_DIR set, JAX already uses that
    directory and no other is set here."""
    import jax

    path = cache_dir()
    if path == DEFAULT_DIR:
        os.makedirs(path, exist_ok=True)
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
