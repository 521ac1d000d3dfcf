"""Where the program keeps what it caches between runs: JAX's persistent
compilation cache and the rendered benchmark sequence. Both live in the
checkout, found from this file's location, unless the environment names
the compile cache's directory."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def checkout_path(name: str) -> str:
    """``<checkout>/<name>``."""
    return os.path.join(CHECKOUT, name)


def compile_cache_dir() -> str:
    """The directory JAX's compile cache uses: ``$JAX_COMPILATION_CACHE_DIR``
    when set, otherwise ``<checkout>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or checkout_path(".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and this
    sets nothing. Otherwise the cache goes to ``<checkout>/.jax_cache`` and
    keeps every entry, however quick its compile."""
    import jax

    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
