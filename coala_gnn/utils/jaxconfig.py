"""Shared JAX runtime configuration for the entry points.

``setup`` selects the platform and refuses to run anywhere else: a
measurement that silently fell back to the CPU would report CPU numbers
under device names. It also enables the persistent compilation cache so
the first-compile cost of the train step / cache kernels is paid once per
cache directory, not once per process.
"""

from __future__ import annotations

import os

# Fixed, checkout-relative default: the path is part of the cache key, so a
# directory that moves between runs never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup(platform: str = "gpu") -> None:
    """Run JAX on ``platform`` ("gpu" or "cpu") or raise.

    ``JAX_PLATFORMS`` in the environment wins over ``platform`` (it is what
    JAX itself reads); a mismatch between the two is an error, not a
    fallback. ``COALA_CPU_DEVICES`` sets the virtual CPU device count."""
    import jax

    if not os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", platform)
    n_cpu = os.environ.get("COALA_CPU_DEVICES")
    if platform == "cpu" and n_cpu:
        jax.config.update("jax_num_cpu_devices", int(n_cpu))
    found = jax.devices()[0].platform
    if found != platform:
        raise RuntimeError(
            f"requested platform {platform!r} but JAX runs on {found!r} "
            f"(JAX_PLATFORMS={os.environ.get('JAX_PLATFORMS')!r}); pass "
            "--platform cpu (BENCH_PLATFORM=cpu) for a CPU rehearsal")
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
