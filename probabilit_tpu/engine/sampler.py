"""Sampling orchestration: the public ``.sample()`` entry point.

Mirrors the reference driver (``modeling.py:431-614``) but executes one
compiled XLA program (see ``engine/compile.py``):

1. resolve the RNG key and draw/construct the ``(size, d)`` quantile matrix
   (counter-based PRNG or index-addressable QMC — both mesh-shape
   invariant), sharded over the active mesh's sample axis;
2. run the jitted program -> kept node outputs + finite flags;
3. host side: apply output finalizers (e.g. string-categorical gathers),
   raise on non-finite samples, assign ``.samples_`` to kept nodes.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

import jax
import jax.numpy as jnp

from probabilit_tpu import config
from probabilit_tpu.engine import compile as _compile
from probabilit_tpu.ops import qmc as _qmc
from probabilit_tpu.parallel import mesh as _mesh

__all__ = ["sample", "sample_from_quantiles", "resolve_key"]


def resolve_key(random_state):
    """Map reference-style ``random_state`` values onto a JAX PRNG key.

    None -> fresh entropy; int -> PRNGKey(int); numpy Generator/RandomState
    -> seed drawn from it (mutating it, like ``check_random_state`` use in
    the reference); a JAX key passes through.
    """
    if random_state is None:
        seed = int(np.random.SeedSequence().entropy % (2**63))
        return jax.random.PRNGKey(seed)
    if isinstance(random_state, (int, np.integer)):
        return jax.random.PRNGKey(int(random_state))
    if isinstance(random_state, np.random.Generator):
        return jax.random.PRNGKey(int(random_state.integers(2**63)))
    if isinstance(random_state, np.random.RandomState):
        return jax.random.PRNGKey(int(random_state.randint(2**31)))
    if isinstance(random_state, jax.Array):
        return random_state
    raise TypeError(f"Cannot interpret random_state: {random_state!r}")


def sample(
    sink,
    size=None,
    random_state=None,
    method=None,
    correlator="imanconover",
    gc_strategy=None,
):
    size = 1 if size is None else int(size)
    plan = _compile.get_plan(sink)
    key = resolve_key(random_state)
    if method is None:
        # Fast path: uniforms are generated inside the compiled program so
        # random bits fuse straight into the ppf kernels (no (n, d) HBM
        # quantile buffer, no host->device transfer).
        return _execute(plan, key, correlator, gc_strategy, rng_inline_n=size)
    # Under a mesh, index-addressable methods generate per-shard (each chip
    # computes its own rows); otherwise on the default device.  Width is
    # d_total: multi-column nodes (paths) consume their own slab of
    # dimensions so QMC structure reaches every driver.
    quantiles = _qmc.generate_sharded(
        method, key, size, plan.d_total, dtype=config.float_dtype()
    )
    return _execute(plan, quantiles, correlator, gc_strategy)


def sample_from_quantiles(sink, quantiles, correlator="imanconover", gc_strategy=None):
    """Sample the graph from an explicit ``(n, d)`` quantile matrix.

    Quantiles are clamped to the open unit interval before the ppf
    kernels (ops/qmc.clamp_open_unit): exact 0/1 endpoints — whether
    user-written (``np.linspace(0, 1, n)``) or produced by f64->f32
    rounding — would hit ppf singularities and trip the non-finite guard
    with an opaque error.  An endpoint therefore yields the most extreme
    finite draw (~±5.3 sigma for a normal in float32), the same value the
    RNG path's most extreme uniform produces.
    """
    plan = _compile.get_plan(sink)
    quantiles = _qmc.clamp_open_unit(jnp.asarray(quantiles, config.float_dtype()))
    if quantiles.ndim != 2:
        raise ValueError("`quantiles` must have shape (num_samples, dimensionality)")
    _, n_dim = quantiles.shape
    if n_dim != plan.d_total:
        extra = (
            ""
            if plan.d_total == plan.d
            else (
                f" ({plan.d} scalar columns + "
                f"{plan.d_total - plan.d} path-driver columns)"
            )
        )
        raise ValueError(
            f"`quantiles` has {n_dim} columns but the graph has "
            f"{plan.d_total} sampling dimensions{extra}."
        )
    return _execute(plan, quantiles, correlator, gc_strategy)


def _execute(plan, program_input, correlator, gc_strategy, rng_inline_n=None):
    from probabilit_tpu.utils import profiling

    timer = profiling.PhaseTimer() if profiling.profiling_enabled() else None

    # Clear any stale samples in the graph (``modeling.py:513-515``).
    for node in plan.topo:
        if hasattr(node, "samples_"):
            delattr(node, "samples_")

    if gc_strategy is None:
        keep_ids = frozenset(node._id for node in plan.topo)
    else:
        keep_ids = frozenset({plan.sink._id} | {node._id for node in gc_strategy})

    with timer.phase("build+compile") if timer else contextlib.nullcontext():
        program = _compile.get_program(
            plan, correlator, keep_ids, rng_inline_n=rng_inline_n
        )

    with timer.phase("execute") if timer else contextlib.nullcontext():
        if rng_inline_n is None:
            program_input = _mesh.shard_samples(program_input)
        outputs, all_finite = program(program_input)

    # Non-finite guard (``modeling.py:600-606``). Narrow keep-sets carry a
    # fused in-program flag; wide keep-sets (no flag emitted, to keep XLA
    # compile time bounded) are scanned host-side unconditionally.
    with timer.phase("host") if timer else contextlib.nullcontext():
        wide_keep = len(keep_ids) > _compile._INLINE_FINITE_CHECK_MAX
        flag_tripped = all_finite is not None and not bool(jax.device_get(all_finite))
        if flag_tripped or wide_keep:
            by_id = {node._id: node for node in plan.topo}
            for nid, value in outputs.items():
                if value is None:
                    continue
                arr = np.asarray(value)
                if np.issubdtype(arr.dtype, np.inexact) and not np.isfinite(arr).all():
                    raise ValueError(
                        f"Sampling this node gave non-finite values: "
                        f"{by_id[nid]}\n{arr}"
                    )
            if flag_tripped:
                raise ValueError("Sampling produced non-finite values.")

        # Host finalizers (string-valued categoricals etc.).
        for nid, fn in plan.finalizers.items():
            if nid in outputs:
                outputs[nid] = fn(outputs[nid])

        for node in plan.topo:
            if node._id in outputs:
                node.samples_ = outputs[node._id]

    if timer is not None:
        print(
            f"[probabilit-tpu profile] sample() phases:\n{timer.report()}",
            file=sys.stderr,
        )
    return plan.sink.samples_
