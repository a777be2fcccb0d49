"""Persistent JAX compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache goes to ``.jax_cache`` at the
root of the checkout: a fixed path, so a later run of the same checkout
finds what an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"

_done = False


def cache_dir() -> str:
    """The directory compiled programs are cached in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT_CACHE)


def enable() -> None:
    global _done
    if _done:
        return
    _done = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
