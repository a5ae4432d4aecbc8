"""Persistent XLA compilation cache.

Compiling the serving graphs for a GPU takes tens of seconds; the
persistent cache makes a restart start warm (the serving equivalent of
the reference caching its CrossEncoder weights to disk,
``classical.py:82-99``).

Where it lives: ``JAX_COMPILATION_CACHE_DIR`` when that is set — JAX
reads it itself, and nothing here overrides it — otherwise the fixed
``.jax_cache`` directory at the root of the checkout.  The path is
part of the cache key, so it must not move between runs.  The cache
stays off on the CPU: compiles there are cheap, and CPU executables
are machine-feature-fragile (SIGILL risk when reused across hosts).
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> bool:
    """Turn the persistent cache on for a GPU process (idempotent).
    Returns whether it is on."""
    import jax

    from qrag_tpu.platform import on_gpu

    if not on_gpu():
        return False
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return True
