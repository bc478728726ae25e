"""Where JAX keeps its persistent compilation cache."""

import os

# fixed, git-ignored directory in the checkout: the path is part of the
# cache key, so it must not move between runs
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def use_compile_cache() -> str:
    """Use JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself)
    and set no other; else point the cache at CHECKOUT_CACHE. Returns the
    directory in use."""
    import jax

    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = CHECKOUT_CACHE
        jax.config.update("jax_compilation_cache_dir", d)
    return d
