"""One place that decides where JAX keeps its persistent compilation cache."""
import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    is set here.  Otherwise the cache is ``<checkout>/.jax_cache`` (listed in
    .gitignore): one fixed directory, so every process of this checkout finds
    what an earlier one compiled.  Entry points call this before their first
    compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return str(DEFAULT_CACHE_DIR)
