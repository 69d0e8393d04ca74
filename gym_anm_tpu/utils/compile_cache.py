"""Persistent (on-disk) XLA compilation cache.

A second process that compiles a program this checkout has already
compiled (the same shapes, the same code) loads the executable from disk
instead of compiling again.  The cache lives where
``JAX_COMPILATION_CACHE_DIR`` says when it is set; otherwise in one fixed
directory inside the checkout (:data:`DEFAULT_DIR`, git-ignored).  A
fixed path matters: it is part of the cache's key, so a directory that
moves between runs never hits.
"""

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str:
    """Enable JAX's on-disk compilation cache (idempotent).

    Returns the cache directory in use, or None on the CPU backend.
    """
    import jax

    # JAX reads JAX_COMPILATION_CACHE_DIR itself; a directory configured
    # that way (or by the caller) is used as it is, with no other setting.
    configured = jax.config.jax_compilation_cache_dir
    if configured:
        return configured
    # CPU runs (the tests) skip the cache: XLA:CPU compiles are fast, and
    # on reload its AOT loader reports every cached executable as built
    # for other machine features than the host's ("could lead to ...
    # SIGILL"), even on the host that wrote it
    # (tests/test_compile_cache.py reproduces it).
    # Checked from the configured platform list WITHOUT initializing a
    # backend (that would pin the platform before callers configure it).
    platforms = str(jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", ""))
    if platforms.split(",")[0].strip().lower() == "cpu":
        return None
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_DIR
