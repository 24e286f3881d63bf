"""Where compiled programs are cached between processes.

Every entry point (the CLI, ``serve``, ``bench.py``, ``chip_smoke.py``)
calls :func:`configure_compile_cache` before it compiles anything. When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here; otherwise the cache lives in ``.jax_cache`` at the root of the
checkout that holds this package, a fixed path, so repeated runs from one
checkout hit it.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``, derived from this package's location."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def configure_compile_cache(environ=None) -> str:
    """Point JAX's persistent compile cache at its directory and return it.

    ``environ`` defaults to ``os.environ``."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV_VAR):
        return environ[ENV_VAR]
    import jax

    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
