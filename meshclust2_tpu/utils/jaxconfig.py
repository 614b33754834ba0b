"""Process-wide JAX configuration for the device compute paths.

Every device program is shape-bucketed so the compile set is small and
reusable; JAX's persistent compilation cache keeps those compiles across
processes, so a repeat `--device gpu` run skips them (the analog of the
reference binary being compiled once, ahead of time).

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads
it itself), else the fixed directory `<repo>/.jax_cache`.  The path is part
of the cache key, so it never depends on a temp name, a pid or the time.
"""
from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compilation_cache_dir(environ=os.environ) -> str:
    """The persistent compilation cache directory for `environ`."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def ensure_compilation_cache() -> None:
    """Point JAX's persistent compilation cache at compilation_cache_dir().

    Call before the first compilation.  With JAX_COMPILATION_CACHE_DIR set
    JAX already uses that directory and nothing is changed here."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
