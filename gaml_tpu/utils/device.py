"""Which implementation the JAX platform runs, and where compiled
programs are cached.

One rule for every device route: the ``gpu`` platform (CUDA) runs the
Pallas kernels, ``cpu`` runs the plain jax.numpy formulations (the same
math, and the tests' reference), and any other platform is an error.
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def platform() -> str:
    """``"gpu"`` or ``"cpu"``; raises for a platform with no route."""
    import jax

    p = jax.devices()[0].platform
    if p not in ("gpu", "cpu"):
        raise RuntimeError(f"no device route for JAX platform {p!r}: "
                           f"gaml-tpu runs on 'gpu' (CUDA) or 'cpu'")
    return p


def use_kernel() -> bool:
    """True where the Pallas kernels run (the ``gpu`` platform)."""
    return platform() == "gpu"


def enable_compile_cache():
    """Point JAX's persistent compilation cache at ``<repo>/.jax_cache``
    unless JAX_COMPILATION_CACHE_DIR already names a directory (JAX reads
    that variable itself).  Called once by each entry point.  It only sets
    configuration, so a run that never touches the device starts no
    backend and reserves no device memory.  Returns the cache directory
    in use, or None where JAX is pinned to the CPU (JAX_PLATFORMS=cpu):
    its compiles are short, and XLA:CPU warns on every reload of a cached
    executable."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.config.jax_platforms == "cpu":
        return None
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
