"""Persistent XLA compilation cache wiring.

First compiles of the sweep programs take seconds to minutes; JAX's
persistent compilation cache lets every process that drives hpfx
(bench.py, chip_smoke.py, the tests) reuse executables across processes.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads that variable itself, and hpfx then sets no other directory);
otherwise the fixed ``<repo>/.jax_cache`` (gitignored).  A fixed path
matters: the path is part of the cache's key.
"""
import os

import jax

#: cache location when JAX_COMPILATION_CACHE_DIR is unset:
#: <repo>/.jax_cache (gitignored)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory :func:`enable_persistent_cache` compiles into."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.

    Call before the first compilation of interest (any time after import
    is fine).  ``min_compile_secs`` skips caching trivial programs so the
    cache stays small; the sweep programs all compile in >1 s.  Returns
    the cache directory.
    """
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path
