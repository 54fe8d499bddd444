"""Sort primitives: batched row-wise sorts, bounded memory.

On the accelerator this library was first built for, one XLA sort of
1e7 f32 elements had a large fixed cost and a small per-row marginal,
while per-element gather/scatter over the same data cost several times a
sort.  Two consequences drive the design here (decided there; not
re-measured on the H100):

1. batch sorts across rows (statistical *columns* live on the leading
   axis, sorting along the lane-aligned last axis), chunked only to bound
   workspace memory;
2. never scatter or gather: applying or inverting a permutation is
   expressed as a variadic sort with the permutation as integer key —
   ``sort((perm, payload))`` places ``payload[j]`` at position ``perm[j]``,
   which IS the scatter, at sort cost instead of scatter cost.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "rowsort_with_order",
    "apply_inverse_permutation_rows",
    "row_chunk_count",
    "sort_with_order",
    "argsort_columns",
    "invert_permutation",
]

# Elements allowed live inside one variadic sort call (~4 buffers of this
# many f32/i32 elements live inside a 2-operand sort): 1.6e8 -> ~2.5 GB
# sort workspace.  16-row chunks of 1e7-row sorts were the fastest width
# on the earlier accelerator (per-sort cost grew superlinearly beyond
# ~16 rows); the constant is untuned on the H100.
_DEFAULT_CHUNK_ELEMS = 160_000_000


def row_chunk_count(n_rows, n_cols, chunk_elems=_DEFAULT_CHUNK_ELEMS):
    rows_per_chunk = max(1, int(chunk_elems // max(n_cols, 1)))
    return min(rows_per_chunk, n_rows)


def _row_chunks(n_rows, c):
    return [(i, min(i + c, n_rows)) for i in range(0, n_rows, c)]


def rowsort_with_order(XT, chunk_elems=_DEFAULT_CHUNK_ELEMS, stable=False):
    """Sort each ROW of ``XT`` (K, N); returns (sorted, order), chunked.

    One variadic sort per chunk produces sorted values and the sorting
    permutation together.
    """
    K, N = XT.shape
    c = row_chunk_count(K, N, chunk_elems)
    iota = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (c, N))
    sorted_parts, order_parts = [], []
    for lo, hi in _row_chunks(K, c):
        block = XT[lo:hi]
        # Unstable by default: cheaper than a stable sort, and safe for
        # callers that resolve ties by value
        # (average-rank scores).  Callers that promise position-determined
        # tie order (ordinal ranks) pass stable=True.
        s, o = jax.lax.sort(
            (block, iota[: hi - lo]), dimension=1, num_keys=1, is_stable=stable
        )
        sorted_parts.append(s)
        order_parts.append(o)
    if len(sorted_parts) == 1:
        return sorted_parts[0], order_parts[0]
    return (
        jnp.concatenate(sorted_parts, axis=0),
        jnp.concatenate(order_parts, axis=0),
    )


def apply_inverse_permutation_rows(order, payload, chunk_elems=_DEFAULT_CHUNK_ELEMS):
    """Rowwise "unsort": out[k, order[k, j]] = payload[k, j], without scatter.

    ``order`` rows are permutations of 0..N-1; sorting (order, payload) by
    the integer key restores payload entries to their pre-sort positions.
    """
    K, N = order.shape
    c = row_chunk_count(K, N, chunk_elems)
    parts = []
    for lo, hi in _row_chunks(K, c):
        # Permutation keys are unique, so an unstable sort is exact.
        _, restored = jax.lax.sort(
            (order[lo:hi], payload[lo:hi]), dimension=1, num_keys=1, is_stable=False
        )
        parts.append(restored)
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)


# ---------------------------------------------------------------------
# Column-axis wrappers (statistical (N, K) layout)
# ---------------------------------------------------------------------


def sort_with_order(X, chunk_elems=_DEFAULT_CHUNK_ELEMS):
    """(X_sorted, order) along axis 0 of an (N, K) matrix."""
    s, o = rowsort_with_order(X.T, chunk_elems)
    return s.T, o.T


def argsort_columns(X, chunk_elems=_DEFAULT_CHUNK_ELEMS):
    """Column-chunked argsort along axis 0."""
    _, order = rowsort_with_order(X.T, chunk_elems)
    return order.T


def invert_permutation(order):
    """Per-column inverse permutation: inv[order[j], k] = j."""
    n = order.shape[0]
    iota = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], order.shape)
    return apply_inverse_permutation_rows(order.T, iota.T).T
