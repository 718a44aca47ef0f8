"""JAX's persistent compilation cache for the scripts that drive the device.

``bench.py``, ``chip_smoke.py`` and the scripts under ``benchmarks/`` call
``enable_compile_cache()`` before their first compile, so a second run of the
same shapes skips XLA compilation.  Where ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX already reads it and nothing here overrides it; otherwise the cache
lives at the fixed ``<repo>/.jax_cache`` (listed in ``.gitignore``).  A fixed
path matters: the directory is part of what a later run looks up.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The directory the persistent cache uses: ``$JAX_COMPILATION_CACHE_DIR``
    when set and non-empty, else ``<repo>/.jax_cache``."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return its directory."""
    import jax
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return compile_cache_dir()
