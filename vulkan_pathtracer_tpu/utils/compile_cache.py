"""Persistent XLA compile cache location.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
left alone.  Otherwise compiled programs are kept in a fixed
directory inside the checkout (listed in ``.gitignore``), so repeated
runs from one checkout skip recompiles.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
