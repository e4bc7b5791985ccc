"""JAX's persistent compilation cache for this checkout's scripts.

Entry scripts (``chip_smoke.py``, ``bench.py``, ``tools/*.py``) call
:func:`enable_compile_cache` before their first compile; importing
``ldpc_tpu`` never touches the cache. The cache path is part of the
cache's key, so it is fixed: ``JAX_COMPILATION_CACHE_DIR`` when set
(JAX reads that variable itself), else ``<checkout>/.jax_cache``.
"""

import os

import jax

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
