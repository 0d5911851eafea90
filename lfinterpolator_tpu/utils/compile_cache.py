"""Where compiled programs persist between processes.

Every entry point (the CLI, `chip_smoke.py`, `bench.py`, the scripts)
calls `enable()` before its first compile, so all of them share one
persistent XLA compilation cache. `JAX_COMPILATION_CACHE_DIR` wins when it
is set; otherwise the cache lives at `<checkout>/.jax_cache`, a fixed path
(the path is part of what a later process looks up, so it must not move).
"""

from __future__ import annotations

import os

#: The checkout root: the directory that holds the package.
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    """The compilation cache directory this process should use."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def enable() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`; returns it."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
