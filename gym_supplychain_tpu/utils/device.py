"""Process set-up for runs on the GPU: compile cache, device checks, card info.

Nothing here runs at import; entry points call these from ``main``.
"""
from __future__ import annotations

import os
import subprocess

import jax

__all__ = ["use_compile_cache", "require_gpu", "card_name_and_power_limit"]

# <checkout>/.jax_cache (listed in .gitignore): a fixed path, so the cache's
# keys stay valid from one process to the next
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache() -> str:
    """Keep compiled programs in JAX's persistent cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing; otherwise the cache goes to ``<checkout>/.jax_cache``.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """Fail unless JAX's default backend is the GPU; returns the devices."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"needs a GPU, but JAX's default backend is "
                         f"{backend!r}")
    return jax.devices()


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
