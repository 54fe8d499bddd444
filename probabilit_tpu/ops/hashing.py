"""Shared integer avalanche mixers (murmur3 finalizer family).

The hand-rolled uint32 mixers behind ``ops/qmc.py``'s LHS jitter.
``ops/correlation.py`` keeps its own shortened splitmix-style pad-filler
mixer ON PURPOSE — padded column-sharded results are bitwise-pinned to
it, so it must not follow changes here.  All ops are plain jnp on
uint32.

``fmix32`` is exactly the murmur3 32-bit finalizer (full avalanche: every
input bit flips each output bit with probability ~1/2).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["fmix32", "keyed_mix32", "GOLDEN32"]

GOLDEN32 = 0x9E3779B9  # 2^32 / golden ratio; odd, so * is a bijection


def fmix32(h):
    """murmur3 finalizer of a uint32 scalar or vector."""
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> jnp.uint32(16))


def keyed_mix32(x, k):
    """Keyed avalanche: ``fmix32((x + k) * GOLDEN32)`` on uint32.

    The odd multiplier is a bijection of Z/2^32, so distinct (x + k)
    values never collide before the finalizer.
    """
    return fmix32((x + k) * jnp.uint32(GOLDEN32))
