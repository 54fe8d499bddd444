"""Global configuration for probabilit-tpu.

The reference implementation computes everything in NumPy float64 on
host.  Here the default sample dtype is float32 and float64 is opt-in, so
the framework carries an explicit sample dtype.  The H100 runs float64
natively, at a lower rate than float32.  The correctness contract versus
the reference is *statistical* (summary statistics to rtol ~1e-6 with
enough samples), not bitwise.

Set ``PROBABILIT_TPU_X64=1`` (before import) or call ``set_dtype`` to use
float64 (useful on CPU when validating against SciPy).

``enable_compile_cache`` turns on JAX's persistent compilation cache for
scripts that run on the accelerator; the library never calls it itself.
"""

from __future__ import annotations

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

_FLOAT_DTYPE = None

# A fixed path at the root of the checkout: the persistent cache only
# hits when the same directory comes back, so it is never built from a
# pid, the time or a temporary name.
_CHECKOUT_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def _default_dtype():
    if os.environ.get("PROBABILIT_TPU_X64", "0") == "1":
        jax.config.update("jax_enable_x64", True)
        return jnp.float64
    if jax.config.read("jax_enable_x64"):
        return jnp.float64
    return jnp.float32


def float_dtype():
    """The dtype used for sample arrays and quantiles."""
    global _FLOAT_DTYPE
    if _FLOAT_DTYPE is None:
        _FLOAT_DTYPE = _default_dtype()
    return _FLOAT_DTYPE


def set_dtype(dtype):
    """Set the global sample dtype (float32 or float64)."""
    global _FLOAT_DTYPE
    dtype = jnp.dtype(dtype)
    if dtype not in (jnp.dtype(jnp.float32), jnp.dtype(jnp.float64)):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    # Keep jax_enable_x64 in lockstep both ways: leaving it on after a
    # float64 session would make JAX's default dtypes (python literals,
    # dtype-less arange) disagree with float_dtype()/int_dtype().
    jax.config.update("jax_enable_x64", dtype == jnp.dtype(jnp.float64))
    _FLOAT_DTYPE = dtype
    return dtype


def int_dtype():
    """Integer dtype matched to the float dtype width."""
    return jnp.int64 if float_dtype() == jnp.dtype(jnp.float64) else jnp.int32


def np_float_dtype():
    return np.dtype(float_dtype())


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left alone.  Otherwise the cache goes to ``.jax_cache`` at the root of
    the checkout.  Every program is cached, however short its compile.
    Call it before the first compile; the library never calls it.
    """
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(_CHECKOUT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return jax.config.jax_compilation_cache_dir
