"""Native multivariate sampling kernels.

The reference samples multivariate distributions through scipy ``.rvs``
with a seed derived from the node's first quantile
(``modeling.py:808-812``).  These kernels keep that seeding contract —
``key = PRNGKey(floor(q[0] * 2^20))`` — but draw on-device with
``jax.random``, so Dirichlet / multivariate-normal / multinomial nodes
fuse into the compiled program instead of bouncing through a host
callback.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from probabilit_tpu import config

__all__ = ["lookup"]

_REGISTRY = {}


def _register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def lookup(name):
    return _REGISTRY.get(name)


def _key_from_q(q):
    """PRNG key as a pure function of the node's quantile column.

    Same CONTRACT as the reference's multivariate seeding (one seed
    derived from the column, ``modeling.py:811``) but with ~48 bits of
    key space: the reference's literal ``floor(q[0] * 2^20)`` gives only
    2^20 distinct keys, which collides at the birthday rate across
    streamed blocks (measured: 5 bitwise-duplicate 64-sample blocks out
    of 4096 — silently correlated draws at exactly the sizes streaming
    exists for).  Folding the raw float bits of the first TWO quantiles
    keeps determinism per (seed, block) while making collisions
    negligible (~B^2 / 2^49).
    """
    q32 = jnp.asarray(q, jnp.float32)
    b0 = jax.lax.bitcast_convert_type(q32[0], jnp.uint32)
    b1 = jax.lax.bitcast_convert_type(q32[min(1, q32.shape[0] - 1)], jnp.uint32)
    return jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(0x51D5EED), b0), b1
    )


@_register("multivariate_normal")
def multivariate_normal(q, shape, mean=None, cov=None, **_):
    n, d = shape
    dtype = config.float_dtype()
    mean = jnp.zeros((d,), dtype) if mean is None else jnp.asarray(mean, dtype)
    cov = jnp.eye(d, dtype=dtype) if cov is None else jnp.asarray(cov, dtype)
    # float32 matmul precision: the GPU's DEFAULT TF32 rounds f32 inputs
    # (~1e-3 relative error on every sample's recoloring).
    with jax.default_matmul_precision("float32"):
        L = jnp.linalg.cholesky(cov)
        z = jax.random.normal(_key_from_q(q), (n, d), dtype)
        return mean + z @ L.T


@_register("dirichlet")
def dirichlet(q, shape, alpha, **_):
    n, d = shape
    dtype = config.float_dtype()
    alpha = jnp.asarray(alpha, dtype)
    return jax.random.dirichlet(_key_from_q(q), alpha, (n,), dtype)


@_register("multinomial")
def multinomial(q, shape, n=1, p=None, **_):
    rows, d = shape
    dtype = config.float_dtype()
    p = np.full(d, 1.0 / d) if p is None else p
    logits = jnp.log(jnp.asarray(p, dtype))
    # n independent categorical draws per row, counted per category.
    draws = jax.random.categorical(_key_from_q(q), logits, shape=(rows, int(n)))
    one_hot = jax.nn.one_hot(draws, d, dtype=dtype)
    return jnp.sum(one_hot, axis=1)
