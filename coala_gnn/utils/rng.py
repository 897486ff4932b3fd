"""PRNG-impl-agnostic key plumbing.

The fused-window trainers thread RNG keys through ``lax.scan`` (and across
``shard_map`` boundaries) as raw ``key_data`` uint32 buffers — typed key
arrays cannot always cross those seams, and raw buffers stack/shard like
any other array. ``jax.random.wrap_key_data`` defaults to the *config
default* impl (threefry2x32), which silently pins the whole sampling path
to threefry even when the caller seeded with a cheaper generator.

``wrap_key_any`` rewraps raw key data under the impl it was minted with,
recovered statically from the trailing data shape: threefry2x32 keys carry
``[2]`` uint32 words, the rbg family ``[4]`` (JAX key-impl registry). The
branch is trace-time (shape-static), so jit specializes per impl exactly
as it already specializes per dtype of a typed key argument.

Why this matters: threefry2x32 is ~20 ALU rounds per 32 random bits;
``impl="rbg"`` lowers to the XLA RngBitGenerator HLO, which the backend
may implement more cheaply. ``examples/profile_sampling.py`` carries
``*_rbg`` variants to measure the delta; adoption is a root-key flip
(``jax.random.key(seed, impl="rbg")`` at the trainer/bench entry), never a
code change — the distinction the reference cannot express (its sampler
RNG is whatever DGL's CUDA sampler hardcodes).

Note rbg and threefry draw DIFFERENT random streams: training parity
tests pin the default threefry; rbg is a perf knob, not a parity mode.
"""

import jax


def wrap_key_any(kdata: jax.Array) -> jax.Array:
    """Rewrap raw ``key_data`` under the impl that minted it (by shape)."""
    impl = "threefry2x32" if kdata.shape[-1] == 2 else "rbg"
    return jax.random.wrap_key_data(kdata, impl=impl)


def make_root_key(seed: int, impl: str = "") -> jax.Array:
    """Root key for a trainer/bench entry; ``impl=''`` = config default."""
    if impl:
        return jax.random.key(seed, impl=impl)
    return jax.random.key(seed)
