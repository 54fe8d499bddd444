"""Block-streamed sampling for sample counts beyond HBM capacity.

The reference's only memory-scaling mechanism is deleting intermediate
``samples_`` arrays (``garbage_collector.py``); the sample axis itself must
fit in host memory.  The device-native equivalent of blockwise processing
(SURVEY §5, "long-context" analogue): split the sample axis into blocks,
run the compiled sampling program once per block (one compile, counter-based
per-block keys), and either

* stream kept-node outputs to host (``sample_streaming``) — full sample
  vectors of any size, device memory bounded by one block; or
* fold each block into a running reduction (``estimate``) — Monte Carlo
  estimates at 1e10+ draws with O(1) memory and no host transfer of
  samples at all.

Correlated graphs stream too (method=None only — something the reference
cannot do at any size, since its Iman-Conover needs every sample in
memory, correlation.py:388-425): the sort-free Gaussian-copula induction
recolors each block's scores to EXACTLY the target correlation using the
block's own empirical moments, so every streamed block — and therefore
the pooled stream, up to the between-block mean jitter of O(1/n_block) —
carries the declared correlation with exact marginals.  Streamed QMC
keeps the correlation-free restriction: its contract is bitwise equality
with a single-shot run, which per-block recoloring cannot satisfy.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from probabilit_tpu.engine import compile as _compile
from probabilit_tpu.engine.sampler import resolve_key

__all__ = ["sample_streaming", "estimate", "estimate_many"]

_ESTIMATE_CACHE = {}

# Incremented once per (re)trace of an estimate() whole-run program;
# regression tests assert a size sweep does not retrace.
_TRACE_COUNT = 0


def _quantile_accumulators(quantiles, block_size, cvar=()):
    """(qsum_full, qsum_partial): per-block quantile/CVaR numerators.

    Shared by ``estimate`` and ``estimate_many``.  ``qsum_full(x)`` is a
    FULL block's contribution to the count-weighted numerator vector —
    ``len(quantiles)`` quantile entries followed by ``len(cvar)``
    expected-shortfall entries; ``qsum_partial(x, mask, cnt)`` handles
    the final block with a traced valid count.  Levels within 1/2^17 of
    the endpoints fall back to one exact full-block sort (ADVICE r2: a
    q=0.999999 request must not silently estimate ~q=0.999992).

    CVaR (expected shortfall) at level q uses the Rockafellar-Uryasev
    identity ``ES_q = v + E[max(X - v, 0)] / (1 - q)`` with ``v`` the
    same linearly-interpolated empirical quantile the quantile entries
    report — one extra relu-sum per level over the ALREADY-sorted data,
    so CVaR rides the quantile sorts for free.
    """
    cols = 1 << 17
    levels = tuple(quantiles) + tuple(cvar)
    rows_ok = (
        bool(levels)
        and block_size % cols == 0
        and block_size > cols
        and all(1.0 / cols <= q <= 1.0 - 1.0 / cols for q in levels)
    )

    def qsum_full(x):
        # np.quantile 'linear' convention: rank q*(m-1), interpolated
        # between the bracketing statistics — flooring to a bare index
        # would quantize the level to a 1/m rank grid (a 53%
        # tail-probability error at q=0.99999 with 2^17 rows).
        if not levels:
            return jnp.zeros((0,), jnp.float32)
        if rows_ok:
            xs = jax.lax.sort(
                x.reshape(block_size // cols, cols),
                dimension=1,
                is_stable=False,
            )
            out = []
            for i, q in enumerate(levels):
                pos = q * (cols - 1)
                lo = min(int(pos), cols - 2)
                frac = jnp.float32(pos - lo)
                a = xs[:, lo]
                b = xs[:, lo + 1]
                v = a + frac * (b - a)
                if i < len(quantiles):
                    out.append(jnp.sum(v) * cols)
                else:
                    tail = jnp.sum(jnp.maximum(xs - v[:, None], 0.0), axis=1)
                    es = v + tail / jnp.float32(cols * (1.0 - q))
                    out.append(jnp.sum(es) * cols)
            return jnp.stack(out)
        xs = jax.lax.sort(x, is_stable=False)
        m = block_size
        out = []
        for i, q in enumerate(levels):
            pos = q * (m - 1)
            lo = min(int(pos), m - 2) if m > 1 else 0
            frac = jnp.float32(pos - lo)
            a = xs[lo]
            b = xs[min(lo + 1, m - 1)]
            v = a + frac * (b - a)
            if i < len(quantiles):
                out.append(v * m)
            else:
                es = v + jnp.sum(jnp.maximum(xs - v, 0.0)) / jnp.float32(
                    m * (1.0 - q)
                )
                out.append(es * m)
        return jnp.stack(out)

    def qsum_partial(x, mask, cnt):
        # Final-block contribution: invalid lanes sort to +inf, full
        # rows use the static positions, the boundary row interpolates
        # at traced positions.  With CVaR levels the final block always
        # takes the exact full-sort branch: the +inf pad lanes would
        # poison per-row relu tail sums, and one extra full sort per RUN
        # is noise.
        if not levels:
            return jnp.zeros((0,), jnp.float32)
        xinf = jnp.where(mask, x, jnp.float32(jnp.inf))
        if rows_ok and not cvar:
            nrows = block_size // cols
            xs = jax.lax.sort(
                xinf.reshape(nrows, cols), dimension=1, is_stable=False
            )
            n_full = cnt // cols
            rem = cnt - n_full * cols
            remf = rem.astype(jnp.float32)
            full_rows = jnp.arange(nrows, dtype=jnp.int32) < n_full
            brow = jax.lax.dynamic_slice_in_dim(
                xs, jnp.minimum(n_full, nrows - 1), 1, axis=0
            )[0]
            out = []
            for q in quantiles:
                pos = q * (cols - 1)
                lo = min(int(pos), cols - 2)
                frac = jnp.float32(pos - lo)
                a = xs[:, lo]
                b = xs[:, lo + 1]
                # Select, not multiply: invalid rows hold +inf and
                # inf * 0 would poison the sum with NaN.
                full_sum = (
                    jnp.sum(jnp.where(full_rows, a + frac * (b - a), 0.0))
                    * cols
                )
                bpos = q * (remf - 1.0)
                blo = jnp.clip(jnp.floor(bpos).astype(jnp.int32), 0, cols - 2)
                bfrac = bpos - blo.astype(jnp.float32)
                ba = jax.lax.dynamic_index_in_dim(brow, blo, keepdims=False)
                bb = jax.lax.dynamic_index_in_dim(
                    brow,
                    jnp.minimum(blo + 1, jnp.maximum(rem - 1, 0)),
                    keepdims=False,
                )
                bq = ba + bfrac * (bb - ba)
                out.append(
                    full_sum + jnp.where(rem > 0, bq * remf, jnp.float32(0.0))
                )
            return jnp.stack(out)
        xs = jax.lax.sort(xinf, is_stable=False)
        cntf = cnt.astype(jnp.float32)
        valid = jnp.arange(block_size, dtype=jnp.int32) < cnt
        out = []
        for i, q in enumerate(levels):
            pos = q * (cntf - 1.0)
            lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, block_size - 2)
            frac = pos - lo.astype(jnp.float32)
            a = jax.lax.dynamic_index_in_dim(xs, lo, keepdims=False)
            b = jax.lax.dynamic_index_in_dim(
                xs, jnp.minimum(lo + 1, cnt - 1), keepdims=False
            )
            v = a + frac * (b - a)
            if i < len(quantiles):
                out.append(v * cntf)
            else:
                # Position mask, not value mask: the pad lanes sorted to
                # +inf and max(inf - v, 0) would poison the tail sum.
                tail = jnp.sum(
                    jnp.where(valid, jnp.maximum(xs - v, 0.0), 0.0)
                )
                es = v + tail / (cntf * jnp.float32(1.0 - q))
                out.append(es * cntf)
        return jnp.stack(out)

    return qsum_full, qsum_partial


_HISTOGRAM_MAX_BINS = 512


def _histogram_accumulators(histogram):
    """(hist_full, hist_partial): per-block fixed-bin count vectors.

    ``histogram=(lo, hi, bins)`` buckets each block into ``bins`` equal
    bins over ``[lo, hi)`` plus underflow/overflow slots — layout
    ``[underflow, bin_0 .. bin_{bins-1}, overflow]`` (values ``>= hi``
    count as overflow; half-open bins, unlike ``np.histogram``'s closed
    last bin).  Counts come from ``bins + 2`` fused compare-and-reduce
    passes over the block — per-element scatter-add (``bincount`` /
    ``segment_sum`` shapes) cost 2-4x a full SORT on the earlier
    accelerator, so no scatter is ever emitted (not re-measured on the
    H100).
    """
    if histogram is None:
        empty = jnp.zeros((0,), jnp.float32)
        return (lambda x, mask=None: empty), (lambda x, mask: empty)
    lo, hi, bins = histogram
    scale = bins / (hi - lo)

    def counts(x, mask=None):
        # clip BEFORE the int cast: 1e38 * scale overflows int32.
        idx = (
            jnp.clip(jnp.floor((x - lo) * scale), -1.0, float(bins)).astype(
                jnp.int32
            )
            + 1
        )
        # NaN survives the clip and its int cast is implementation-
        # defined (lands in bin_0 on some backends): exclude NaN lanes from
        # every slot.  +/-inf clip to finite under/overflow indices and
        # count there as intended.
        not_nan = jnp.logical_not(jnp.isnan(x))
        out = []
        for j in range(bins + 2):
            eq = jnp.logical_and(idx == j, not_nan)
            if mask is not None:
                # Mask the COUNT, not the input: off-mask lanes may be
                # NaN by design under where= and their int cast is
                # implementation-defined garbage.
                eq = jnp.logical_and(eq, mask)
            out.append(jnp.sum(eq.astype(jnp.float32)))
        return jnp.stack(out)

    return counts, counts


_UNION_SINK_CACHE = {}


def _union_sink(sink, extras):
    """Cached NoOp rooting ``sink`` and out-of-graph extras in one plan.

    Cached per (ids, mutation epoch): a fresh NoOp per call would give
    every call a fresh plan signature and defeat the whole-run program
    caches.
    """
    from probabilit_tpu.models import graph as _graph
    from probabilit_tpu.models.graph import NoOp

    key = (
        sink._id,
        tuple(node._id for node in extras),
        _graph.Node._mutation_epoch,
    )
    node = _UNION_SINK_CACHE.get(key)
    if node is None:
        if len(_UNION_SINK_CACHE) > 64:
            _UNION_SINK_CACHE.pop(next(iter(_UNION_SINK_CACHE)))
        node = NoOp(sink, *extras)
        _UNION_SINK_CACHE[key] = node
    return node



def _quantile_accumulators_many(quantiles, block_size, cvar=()):
    """Batched (M, block) variants of ``_quantile_accumulators``.

    ONE sort per block covers every node: XLA sorts cost ~230 ms fixed
    per call at 1e7 elements plus ~11 ms per extra batched row
    (CLAUDE.md), so M per-node sorts in the hot fori_loop body would pay
    the fixed cost M times.  Returns (qsum_full_many(y) -> (M, L),
    qsum_partial_many(y, mask, cnt) -> (M, L)) with L =
    ``len(quantiles) + len(cvar)`` — CVaR columns ride the same sorts
    via Rockafellar-Uryasev, exactly as in ``_quantile_accumulators``.
    """
    cols = 1 << 17
    levels = tuple(quantiles) + tuple(cvar)
    rows_ok = (
        bool(levels)
        and block_size % cols == 0
        and block_size > cols
        and all(1.0 / cols <= q <= 1.0 - 1.0 / cols for q in levels)
    )

    def qsum_full_many(y):
        m = y.shape[0]
        if not levels:
            return jnp.zeros((m, 0), jnp.float32)
        if rows_ok:
            nrows = block_size // cols
            xs = jax.lax.sort(
                y.reshape(m * nrows, cols), dimension=1, is_stable=False
            )
            out = []
            for i, q in enumerate(levels):
                pos = q * (cols - 1)
                lo = min(int(pos), cols - 2)
                frac = jnp.float32(pos - lo)
                v = xs[:, lo] + frac * (xs[:, lo + 1] - xs[:, lo])
                if i < len(quantiles):
                    out.append(jnp.sum(v.reshape(m, nrows), axis=1) * cols)
                else:
                    tail = jnp.sum(jnp.maximum(xs - v[:, None], 0.0), axis=1)
                    es = v + tail / jnp.float32(cols * (1.0 - q))
                    out.append(jnp.sum(es.reshape(m, nrows), axis=1) * cols)
            return jnp.stack(out, axis=1)
        xs = jax.lax.sort(y, dimension=1, is_stable=False)
        out = []
        for i, q in enumerate(levels):
            pos = q * (block_size - 1)
            lo = min(int(pos), block_size - 2) if block_size > 1 else 0
            frac = jnp.float32(pos - lo)
            a = xs[:, lo]
            b = xs[:, min(lo + 1, block_size - 1)]
            v = a + frac * (b - a)
            if i < len(quantiles):
                out.append(v * block_size)
            else:
                tail = jnp.sum(jnp.maximum(xs - v[:, None], 0.0), axis=1)
                es = v + tail / jnp.float32(block_size * (1.0 - q))
                out.append(es * block_size)
        return jnp.stack(out, axis=1)

    def qsum_partial_many(y, mask, cnt):
        # With CVaR levels the final block always takes the exact
        # full-sort branch (as in the single-sink version): +inf pad
        # lanes would poison per-row relu tail sums.
        m = y.shape[0]
        if not levels:
            return jnp.zeros((m, 0), jnp.float32)
        yinf = jnp.where(mask[None, :], y, jnp.float32(jnp.inf))
        cntf = cnt.astype(jnp.float32)
        if rows_ok and not cvar:
            nrows = block_size // cols
            xs = jax.lax.sort(
                yinf.reshape(m * nrows, cols), dimension=1, is_stable=False
            ).reshape(m, nrows, cols)
            n_full = cnt // cols
            rem = cnt - n_full * cols
            remf = rem.astype(jnp.float32)
            full_rows = jnp.arange(nrows, dtype=jnp.int32) < n_full
            brow = jax.lax.dynamic_slice_in_dim(
                xs, jnp.minimum(n_full, nrows - 1), 1, axis=1
            )[:, 0, :]
            out = []
            for q in quantiles:
                pos = q * (cols - 1)
                lo = min(int(pos), cols - 2)
                frac = jnp.float32(pos - lo)
                v = xs[:, :, lo] + frac * (xs[:, :, lo + 1] - xs[:, :, lo])
                full_sum = (
                    jnp.sum(jnp.where(full_rows[None, :], v, 0.0), axis=1)
                    * cols
                )
                bpos = q * (remf - 1.0)
                blo = jnp.clip(jnp.floor(bpos).astype(jnp.int32), 0, cols - 2)
                bfrac = bpos - blo.astype(jnp.float32)
                ba = jax.lax.dynamic_slice_in_dim(brow, blo, 1, axis=1)[:, 0]
                bb = jax.lax.dynamic_slice_in_dim(
                    brow,
                    jnp.minimum(blo + 1, jnp.maximum(rem - 1, 0)),
                    1,
                    axis=1,
                )[:, 0]
                bq = ba + bfrac * (bb - ba)
                out.append(
                    full_sum + jnp.where(rem > 0, bq * remf, jnp.float32(0.0))
                )
            return jnp.stack(out, axis=1)
        xs = jax.lax.sort(yinf, dimension=1, is_stable=False)
        valid = (jnp.arange(block_size, dtype=jnp.int32) < cnt)[None, :]
        out = []
        for i, q in enumerate(levels):
            pos = q * (cntf - 1.0)
            lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, block_size - 2)
            frac = pos - lo.astype(jnp.float32)
            a = jax.lax.dynamic_slice_in_dim(xs, lo, 1, axis=1)[:, 0]
            b = jax.lax.dynamic_slice_in_dim(
                xs, jnp.minimum(lo + 1, cnt - 1), 1, axis=1
            )[:, 0]
            v = a + frac * (b - a)
            if i < len(quantiles):
                out.append(v * cntf)
            else:
                # Position mask, not value mask: the pad lanes sorted to
                # +inf and max(inf - v, 0) would poison the tail sum.
                tail = jnp.sum(
                    jnp.where(valid, jnp.maximum(xs - v[:, None], 0.0), 0.0),
                    axis=1,
                )
                es = v + tail / (cntf * jnp.float32(1.0 - q))
                out.append(es * cntf)
        return jnp.stack(out, axis=1)

    return qsum_full_many, qsum_partial_many


def _histogram_accumulators_many(histogram):
    """Batched (M, block) variant of ``_histogram_accumulators``.

    Returns one ``counts(y, mask=None) -> (M, bins + 2)`` function used
    for both full and partial blocks; ``mask`` is a shared (block,)
    valid/condition mask applied to every node's counts.
    """
    if histogram is None:
        def empty(y, mask=None):
            return jnp.zeros((y.shape[0], 0), jnp.float32)

        return empty
    lo, hi, bins = histogram
    scale = bins / (hi - lo)

    def counts(y, mask=None):
        idx = (
            jnp.clip(jnp.floor((y - lo) * scale), -1.0, float(bins)).astype(
                jnp.int32
            )
            + 1
        )
        not_nan = jnp.logical_not(jnp.isnan(y))
        out = []
        for j in range(bins + 2):
            eq = jnp.logical_and(idx == j, not_nan)
            if mask is not None:
                eq = jnp.logical_and(eq, mask[None, :])
            out.append(jnp.sum(eq.astype(jnp.float32), axis=1))
        return jnp.stack(out, axis=1)

    return counts


def _find_key_seeded(plan):
    """First node whose randomness comes from a q[0]-seeded PRNG key.

    Copula nodes declare ``_key_seeded``; multivariate scipy families
    use the same q[0]-seeding contract inside their emit.  Path nodes
    used to qualify but now consume per-driver quantile slabs in
    quantile mode (``_q_width``), so QMC methods reach them.
    """
    from probabilit_tpu.models.distributions import (
        Distribution,
        _scipy_is_multivariate,
    )

    for node in plan.topo:
        if getattr(node, "_key_seeded", False):
            return node
        if isinstance(node, Distribution) and _scipy_is_multivariate(node.distr):
            return node
    return None


def _block_program(
    sink,
    block_size,
    method=None,
    total_size=None,
    correlator="imanconover",
    extra=None,
):
    """(plan, run): ``run(b, key) -> (sink block, extra block(s) or None)``.

    ``extra`` (a node — or tuple of nodes — in the sink's graph) is
    materialised alongside the sink from the SAME draws: the
    control-variates path needs the joint stream, and ``estimate_many``
    needs every requested node per block; neither can come from two
    independent runs.

    ``method="sobol"/"halton"/"lhs"/"antithetic"`` streams one long
    point sequence: block ``b`` generates points ``[b*block_size,
    (b+1)*block_size)`` via the generators' index addressability, so the
    concatenated stream equals a single-shot ``sample(method=...)`` of
    the same total size exactly.  Two carve-outs: graphs containing
    key-seeded nodes (copulas/multivariate) are REJECTED under a
    method — their randomness cannot satisfy the bitwise contract (and
    QMC/antithetic structure never reaches key-based draws; path nodes
    are fine — they consume per-driver quantile slabs); and XLA's
    incomplete-beta primitive iterates with a batch-GLOBAL convergence
    test, so beta-class families with endpoint pdf singularities — a or
    b < 1 — can drift ~2e-6 between batch compositions inside XLA
    itself (our own Newton loops freeze per-lane and are
    batch-independent).
    """
    if getattr(sink, "_vector_valued", False):
        raise ValueError(
            f"Cannot stream vector-valued node {sink!r}; stream scalar "
            "marginals/functionals of it instead (e.g. path.terminal())."
        )
    out_sink = sink
    plan = _compile.get_plan(sink)
    single_extra = extra is not None and not isinstance(extra, (tuple, list))
    extras = () if extra is None else (extra,) if single_extra else tuple(extra)
    if extras and not all(
        any(node is req for node in plan.topo) for req in extras
    ):
        # A control variate is often a SIBLING of the sink (e.g. the
        # vanilla call controlling an Asian option — both children of
        # one path node): root them under a shared (cached, so programs
        # stay cached too) NoOp so one plan drives both from the same
        # draws.  A control adding NEW distribution nodes changes the
        # column layout (and therefore the sink's draws vs a plain run)
        # but stays unbiased.
        sink = _union_sink(out_sink, extras)
        plan = _compile.get_plan(sink)
    if method is not None:
        seeded = _find_key_seeded(plan)
        if seeded is not None:
            raise ValueError(
                f"Streamed method={method!r} promises bitwise equality "
                f"with a single-shot run, but {seeded!r} draws from a "
                "column-seeded PRNG key whose per-block value differs "
                "from the single-shot column (and low-discrepancy/"
                "antithetic structure cannot reach key-based draws "
                "anyway). Use method=None for this graph."
            )
    if plan.corr_matrix is not None and method is not None:
        # The streamed-QMC contract is bitwise equality with a single-shot
        # run; correlation induction recolors per block (empirical moments
        # over the block, not the whole stream), which cannot satisfy it.
        raise ValueError(
            "Streamed QMC sampling requires a correlation-free graph; "
            "use method=None for streamed correlated sampling "
            "(per-block recoloring) or a single-shot sample()."
        )
    keep = frozenset({out_sink._id}) | {node._id for node in extras}

    def _pair(outputs):
        if extra is None:
            return (outputs[out_sink._id], None)
        if single_extra:
            return (outputs[out_sink._id], outputs[extras[0]._id])
        return (outputs[out_sink._id], tuple(outputs[n._id] for n in extras))

    if method is not None:
        from probabilit_tpu import config
        from probabilit_tpu.ops import qmc as _qmc

        name = method.lower().strip()
        if name not in ("sobol", "halton", "lhs", "antithetic"):
            raise ValueError(
                "Streamed sampling requires an index-addressable method "
                f"('sobol', 'halton', 'lhs' or 'antithetic'), got {method!r}."
            )
        # Point indices are 32-bit: Sobol direction numbers span 2^32
        # points (uint32 index math), Halton's digit loop is int32 (2^31),
        # LHS strata come from a uint32 Feistel permutation (2^32), and
        # antithetic pairs are threefry-keyed by a uint32 index.  Past
        # the cap the stream would silently wrap and repeat points.
        cap = 2**31 if name == "halton" else 2**32
        if total_size is not None and total_size > cap:
            raise ValueError(
                f"Streamed {name} supports at most 2^{cap.bit_length() - 1} "
                f"points, got {total_size}. Use the PRNG stream "
                "(method=None) beyond that."
            )
        program = _compile.get_program(plan, correlator, keep, check_finite=False)
        dtype = config.float_dtype()
        # LHS stratifies over the WHOLE run: block b draws rows
        # [b*block, b*block + block) of the total_size-point global
        # stratification (the keyed-Feistel permutation makes any block
        # computable without the rest).
        total = total_size if name == "lhs" else None

        def run(b, key):
            offset = jnp.asarray(b, jnp.uint32) * jnp.uint32(block_size)
            q = _qmc.generate(
                name, key, block_size, plan.d_total, dtype, offset=offset, total=total
            )
            outputs, _ = program(q)
            return _pair(outputs)

        return plan, run

    program = _compile.get_program(
        plan, correlator, keep, check_finite=False, rng_inline_n=block_size
    )

    def run(b, key):
        outputs, _ = program(jax.random.fold_in(key, b))
        return _pair(outputs)

    return plan, run


def sample_streaming(
    sink,
    size,
    block_size=16_777_216,
    random_state=None,
    method=None,
    correlator="imanconover",
):
    """Sample ``size`` draws of ``sink`` in device-sized blocks.

    Returns a host ndarray of length ``size``; device memory is bounded by
    one block regardless of ``size``.  ``method="sobol"/"halton"/"lhs"/
    "antithetic"`` streams one long point sequence (equal to a
    single-shot run of the same size — bitwise, except beta-class
    marginals with a or b < 1; see ``_block_program``).
    """
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}.")
    plan, run = _block_program(
        sink, block_size, method, total_size=size, correlator=correlator
    )
    key = resolve_key(random_state)

    n_blocks = -(-size // block_size)
    out = None
    for b in range(n_blocks):
        block = np.asarray(run(b, key)[0])
        if out is None:
            out = np.empty((size,), dtype=block.dtype)
        lo = b * block_size
        hi = min(size, lo + block_size)
        out[lo:hi] = block[: hi - lo]
        # Same safety contract as sample(): streamed runs must not return
        # non-finite samples silently.
        if np.issubdtype(block.dtype, np.inexact) and not np.isfinite(
            out[lo:hi]
        ).all():
            raise ValueError(
                f"Sampling produced non-finite values (block {b})."
            )
    # Host finalizers (string-valued categoricals etc.): same output
    # contract as sample() — the reference returns actual values from
    # every sampling entry point (modeling.py:893-895, 916-927).
    finalize = plan.finalizers.get(sink._id)
    return out if finalize is None else finalize(out)


def estimate(
    sink,
    size,
    block_size=16_777_216,
    random_state=None,
    method=None,
    quantiles=None,
    cvar=None,
    histogram=None,
    replicates=None,
    correlator="imanconover",
    control=None,
    where=None,
    target_sem=None,
    target_rel_sem=None,
    max_size=None,
    moments=False,
    checkpoint=None,
    checkpoint_every=None,
):
    """Streaming Monte Carlo estimate: mean/var/min/max of ``sink``.

    ``where=node`` restricts every statistic to the samples where the
    condition node is nonzero — conditional estimation
    (``E[sink | where]``) in one streamed program, with the sink's
    values OUTSIDE the condition never inspected (so e.g.
    ``estimate(log(x), where=(x > 0))`` is finite-guard-clean even
    though ``log(x)`` is NaN off-condition).  ``n`` becomes the
    accepted count, ``n_total`` the draw count, and ``acceptance``
    their ratio; ``sem`` is the conditional ``std/sqrt(n)``.  Composes
    with ``method=`` and ``replicates=``; not with ``quantiles`` or
    ``control`` (the row-sort quantile estimator and the control
    regression both assume unmasked blocks — an explicit error).

    ``control=(node, known_mean)`` applies a regression control variate:
    ``node`` (any node of the same graph, sharing the sink's draws) is
    accumulated jointly with the sink and the mean estimate becomes
    ``mean(x) - beta * (mean(y) - known_mean)`` with the empirically
    optimal ``beta = Cov(x,y)/Var(y)`` — the mean's variance shrinks by
    ``1 - rho^2`` at no extra sampling cost (one more kept output in
    the same compiled program).  ``sem`` is scaled accordingly and the
    diagnostics ``control_beta``/``control_rho``/``control_mean`` are
    reported; ``var``/``std``/``min``/``max``/quantiles stay properties
    of the OUTPUT distribution, not of the estimator.  Composes with
    ``replicates``: each replicate adjusts with its own beta and ``sem``
    comes from the spread of the adjusted means.

    Numerically stable parallel-merge of per-block moments (Chan et al.);
    runs entirely on device, transferring only a handful of scalars per
    block.  Supports arbitrary ``size`` (e.g. 1e11) with O(block) memory.
    ``method="sobol"/"halton"`` folds one long QMC sequence instead of
    the PRNG stream (QMC error decay at sizes beyond HBM);
    ``method="antithetic"`` folds pair-reflected uniforms (first-order
    variance reduction for monotone statistics).

    ``quantiles`` (e.g. ``(0.5, 0.95, 0.99)`` for a VaR profile) adds
    streamed quantile estimates: each block is split into 2^17-sample
    rows, the requested order statistic of every sorted row is linearly
    interpolated (np.quantile 'linear' convention), and the row values
    are count-weighted averaged across rows and blocks.  Rows of an iid
    block are iid themselves, so row averaging is the same estimator one
    level down, and batched row sorts ran ~5x faster than one giant 1-D
    sort on the earlier accelerator (not re-measured on the H100).
    Levels within 1/2^17 of 0 or 1 would saturate at the row min/max, so
    those fall back to one exact full-block sort per block instead
    (slower, unbiased at any level).  Either way each
    block-level estimate is unbiased to O(1/n_row), carrying ~1e-4
    relative sampling error at the default block size — far below Monte
    Carlo noise at any size worth streaming.  (The NumPy/SciPy reference
    cannot produce quantiles at these sizes at all: it must materialise
    every sample.)

    ``cvar`` (e.g. ``(0.95, 0.99)``) adds streamed expected-shortfall
    estimates ``cvar<level>`` — the mean of the samples ABOVE the level
    quantile (upper-tail CVaR, the loss convention: pass the negated
    sink for the lower tail).  Each level is evaluated through the
    Rockafellar-Uryasev identity ``ES_q = v_q + E[max(X - v_q, 0)]
    / (1 - q)`` on the same per-row sorts the quantile path uses, so
    requesting CVaR alongside quantiles costs one relu-reduction per
    level and zero extra sorts.  Same estimator caveats as
    ``quantiles`` (row-averaged, O(1/n_row) bias; endpoint levels fall
    back to exact full-block sorts); same composition rules (not with
    ``where=``).

    ``histogram=(lo, hi, bins)`` (bins <= 512) accumulates an exact
    fixed-bin histogram of the sink across the whole stream: ``bins``
    equal bins on ``[lo, hi)`` plus underflow/overflow, returned as
    ``stats["histogram"] = {"edges", "counts", "underflow",
    "overflow"}``.  Unlike quantiles it composes with ``where=``
    (off-condition samples are simply not counted).  Counts carry as
    two f32 words per bin (hi/lo split at 2^23), so totals are exact
    integers up to 2^47 per bin for any ``block_size <= 2^24``; NaN
    samples are excluded from every slot, while +/-inf count as
    underflow/overflow.

    ``moments=True`` adds streamed skewness and excess kurtosis
    (``stats["skew"]``/``stats["kurt"]``, scipy conventions: biased
    ``g1 = M3/n / (M2/n)^1.5`` and Fisher ``g2 = M4/n / (M2/n)^2 - 3``)
    by carrying third and fourth central moments through the same
    Chan-style fold (the pairwise M3/M4 merge of Pébay 2008).  Two more
    fused block reductions when on; when off, the M3/M4 merge updates
    are not emitted at all (trace-time gate — zeros just ride the
    carry).
    Composes with everything, including ``where=`` (conditional shape)
    and ``target_sem`` rounds.  f32 caveat: per-block sums of
    ``(x - mean)^4`` overflow f32 when ``|x - mean|`` exceeds ~1e9 —
    standardize extreme-scale sinks first.

    ``target_sem=tol`` (or ``target_rel_sem=tol``, relative to the
    running ``|mean|``; give both and the tighter one wins) turns the
    call SEQUENTIAL: ``size`` becomes the pilot-round size and sampling
    continues in independently-keyed rounds — each sized from the
    pooled variance estimate, ``n_needed = n * (sem/target)^2``, with a
    20% inflation for the noise in that estimate and a 4x-per-round
    growth cap — until ``sem <= target`` or ``max_size`` total draws
    (default ``64 * size``).  All rounds Chan-merge into one pooled
    estimate; every round reuses the one cached compiled program, so
    the adaptive loop costs no extra compiles.  Composes with
    ``quantiles``/``cvar``/``histogram``/``where``/``control`` (with a
    control variate the stopping rule prices the control-ADJUSTED sem).
    ``method="antithetic"`` is allowed without replicates: its iid sem
    is conservative, so the rule stops late, never early.  Under a QMC
    ``method=`` the iid sem is NOT a valid error bar, so sequential
    stopping requires ``replicates=R``: the run then maintains R
    independently randomised streams (fresh scrambles per replicate,
    per-round fresh randomisations), each round adds draws to every
    replicate, and the stopping statistic — and the reported ``sem`` —
    is the between-replicate standard error of the pooled replicate
    means, the standard randomised-QMC error estimate.
    ``target_sem`` + ``replicates`` works for any method (it is simply
    a sem-targeted replicated run); plain ``replicates=`` at a fixed
    size needs no target.  The returned dict gains ``rounds`` and
    ``converged``; note the classic sequential-stopping caveat —
    stopping on an estimated sem biases coverage by O(1/n), negligible
    at streaming sizes (Chow & Robbins 1965).

    ``checkpoint=path`` makes the fold resumable: the run is segmented
    at fixed block boundaries (``checkpoint_every`` draws per segment,
    default 64 blocks' worth), each segment's carry is appended to an
    atomic ``.npz`` checkpoint, and a re-run with the SAME arguments
    resumes at the first unfinished segment — bitwise-identical to the
    uninterrupted (checkpointed) run, because segment boundaries,
    per-block keys, and QMC offsets are all absolute.  A parameter or
    graph change is detected via fingerprint and refused.  The file is
    removed on successful completion.  Composes with ``method=``/
    ``quantiles``/``cvar``/``histogram``/``where``/``control``/
    ``moments``; not with ``replicates=``/``target_sem`` (checkpoint
    the fixed-size run those schemes decompose into instead).

    The compiled whole-run program is cached across calls (keyed on graph
    structure, block size, quantile levels, and method — NOT on
    ``size``, which is a traced loop bound: a size sweep reuses one
    program).  Up to 32 programs are retained for the life of the
    process, each holding its plan's node graph and device executable;
    the oldest entry is evicted past that.

    Returns a dict with n, mean, var, std, sem, min, max (+ one
    ``q<level>`` entry per requested quantile).  ``sem`` is the standard
    error of the mean: with the default ``replicates=None`` it is
    ``std/sqrt(n)`` — exact for iid draws (``method=None``), a
    conservative overestimate for ``method="antithetic"`` (pair members
    are negatively correlated), and NOT meaningful for the QMC methods
    (their points are deliberately dependent; the iid formula ignores
    the faster convergence).  For a valid QMC/antithetic error bar pass
    ``replicates=R`` (R >= 2, dividing ``size``): the run splits into R
    independently randomised streams — fresh Owen scrambles / rotations
    / threefry keys per replicate, the standard randomised-QMC error
    estimate — and ``sem`` becomes the empirical
    ``std(replicate means)/sqrt(R)``, unbiased for every method.  All R
    streams reuse the same compiled program (the block program is
    size-agnostic), so replication costs no extra compiles.
    """
    quantiles = tuple(float(q) for q in quantiles) if quantiles else ()
    for q in quantiles:
        if not 0.0 < q < 1.0:
            raise ValueError(f"Quantile levels must be in (0, 1), got {q}.")
    cvar = tuple(float(q) for q in cvar) if cvar else ()
    for q in cvar:
        if not 0.0 < q < 1.0:
            raise ValueError(f"CVaR levels must be in (0, 1), got {q}.")
    if histogram is not None:
        try:
            h_lo, h_hi, h_bins = histogram
        except (TypeError, ValueError):
            raise ValueError(
                "histogram must be a (lo, hi, bins) triple, e.g. "
                "histogram=(-5.0, 5.0, 100)."
            ) from None
        h_lo, h_hi, h_bins = float(h_lo), float(h_hi), int(h_bins)
        if not (np.isfinite(h_lo) and np.isfinite(h_hi) and h_lo < h_hi):
            raise ValueError(
                f"histogram range must be finite with lo < hi, got "
                f"({h_lo}, {h_hi})."
            )
        if not 1 <= h_bins <= _HISTOGRAM_MAX_BINS:
            # Each bin is one fused compare-and-reduce pass over every
            # block; the cap keeps the program size and HBM traffic sane.
            raise ValueError(
                f"histogram bins must be in [1, {_HISTOGRAM_MAX_BINS}], "
                f"got {h_bins}."
            )
        histogram = (h_lo, h_hi, h_bins)
    if size < 1:
        # size=0 would send block index -1 (uint32-wrapped) into the
        # final masked block and fabricate statistics of unrequested
        # samples under n=0.
        raise ValueError(f"size must be >= 1, got {size}.")
    if where is not None:
        from probabilit_tpu.models.graph import Node as _Node

        if not isinstance(where, _Node):
            raise ValueError(f"where must be a graph node, got {where!r}.")
        if getattr(where, "_vector_valued", False):
            raise ValueError(
                f"where condition {where!r} is vector-valued; condition "
                "on a scalar functional of it instead (e.g. "
                "path.terminal() > k)."
            )
        if quantiles or cvar:
            raise ValueError(
                "where= does not compose with quantiles=/cvar= (the "
                "row-sort estimators assume unmasked blocks); estimate "
                "the conditional quantiles from sample_streaming output."
            )
        if control is not None:
            raise ValueError(
                "where= does not compose with control= (the control "
                "regression assumes unmasked blocks)."
            )
    control_node, control_mu = None, None
    if control is not None:
        from probabilit_tpu.models.graph import Node

        try:
            control_node, control_mu = control
        except (TypeError, ValueError):
            raise ValueError(
                "control must be a (node, known_mean) pair, e.g. "
                "control=(cheap_part, analytic_mean)."
            ) from None
        if not isinstance(control_node, Node):
            raise ValueError(
                f"control[0] must be a graph node, got {control_node!r}."
            )
        control_mu = float(control_mu)
    key = resolve_key(random_state)
    if checkpoint is not None and (
        replicates is not None
        or target_sem is not None
        or target_rel_sem is not None
    ):
        raise ValueError(
            "checkpoint= composes with fixed-size single-stream runs "
            "only; checkpoint the fixed-size runs a replicated or "
            "sequential scheme decomposes into instead."
        )
    if checkpoint is None and checkpoint_every is not None:
        raise ValueError("checkpoint_every= needs checkpoint=path.")
    if target_sem is not None or target_rel_sem is not None:
        qmc = (method or "").lower().strip()
        if qmc in ("sobol", "halton", "lhs") and replicates is None:
            raise ValueError(
                f"target_sem with method={method!r} needs replicates=R "
                "(e.g. replicates=8): the iid sem is not a valid QMC "
                "error bar; the between-replicate sem of R independently "
                "randomised streams is the valid stopping statistic."
            )
        for name, t in (
            ("target_sem", target_sem),
            ("target_rel_sem", target_rel_sem),
        ):
            if t is not None and not (float(t) > 0.0):
                raise ValueError(f"{name} must be > 0, got {t}.")
        max_size = 64 * size if max_size is None else int(max_size)
        if max_size < size:
            raise ValueError(
                f"max_size ({max_size}) must be >= the pilot size "
                f"({size})."
            )
        if replicates is not None:
            reps = int(replicates)
            if reps < 2:
                raise ValueError(
                    f"replicates must be >= 2 (got {reps}): a single "
                    "stream has no between-replicate variance to "
                    "estimate sem from."
                )
            return _estimate_sequential_replicated(
                sink,
                size,
                block_size,
                key,
                method,
                quantiles,
                correlator,
                control_node,
                control_mu,
                where,
                cvar,
                histogram,
                None if target_sem is None else float(target_sem),
                None if target_rel_sem is None else float(target_rel_sem),
                max_size,
                moments,
                reps,
            )
        return _estimate_sequential(
            sink,
            size,
            block_size,
            key,
            method,
            quantiles,
            correlator,
            control_node,
            control_mu,
            where,
            cvar,
            histogram,
            None if target_sem is None else float(target_sem),
            None if target_rel_sem is None else float(target_rel_sem),
            max_size,
            moments,
        )
    if checkpoint is not None:
        return _estimate_checkpointed(
            sink,
            size,
            block_size,
            key,
            method,
            quantiles,
            correlator,
            control_node,
            control_mu,
            where,
            cvar,
            histogram,
            moments,
            str(checkpoint),
            checkpoint_every,
        )
    if replicates is not None:
        reps = int(replicates)
        if reps < 2:
            raise ValueError(
                f"replicates must be >= 2 (got {reps}): a single stream "
                "has no between-replicate variance to estimate sem from."
            )
        if size % reps:
            raise ValueError(
                f"size ({size}) must be divisible by replicates ({reps}) "
                "so every randomisation carries equal weight."
            )
        sub = size // reps
        carries = [
            jax.device_get(
                _estimate_carry(
                    sink,
                    sub,
                    block_size,
                    jax.random.fold_in(key, r),
                    method,
                    quantiles,
                    correlator,
                    control_node,
                    where,
                    cvar=cvar,
                    histogram=histogram,
                    moments=moments,
                )
            )
            for r in range(reps)
        ]
        merged, rep_means = _merge_carries(carries, control_mu)
        stats = _finalize_estimate(
            merged, size, quantiles, control_mu, where, cvar, histogram,
            moments,
        )
        rep = np.asarray(rep_means, np.float64)
        if rep.size < 2:
            # Only possible under where=: zero-accept replicates carry no
            # mean and are excluded from the spread.
            raise ValueError(
                f"Only {rep.size} of {reps} replicates accepted any "
                "samples; the between-replicate sem needs >= 2. Loosen "
                "the where condition, raise size, or drop replicates=."
            )
        stats["sem"] = float(rep.std(ddof=1) / np.sqrt(rep.size))
        if control_mu is not None:
            # The between-replicate spread of the ADJUSTED means already
            # prices the control; report their average as the estimate
            # (equal-weight replicates, per-replicate betas).
            stats["mean"] = float(rep.mean())
        stats["replicates"] = reps
        return stats
    carry = _estimate_carry(
        sink,
        size,
        block_size,
        key,
        method,
        quantiles,
        correlator,
        control_node,
        where,
        cvar=cvar,
        histogram=histogram,
        moments=moments,
    )
    return _finalize_estimate(
        carry, size, quantiles, control_mu, where, cvar, histogram, moments
    )


def _merge_carries(carries, control_mu=None):
    """Chan-merge replicate moment carries host-side (float64).

    Returns the pooled carry plus the per-replicate means (the
    randomised-QMC error estimator needs them, not just the pool).
    With a control variate, the per-replicate means are the
    CONTROL-ADJUSTED means (each replicate uses its own empirical beta),
    so the between-replicate sem prices the adjusted estimator.
    """
    total, mean, m2, m3, m4 = 0.0, 0.0, 0.0, 0.0, 0.0
    my, m2y, cxy = 0.0, 0.0, 0.0
    vmin, vmax, finite = float("inf"), float("-inf"), True
    qsum, hsum = None, None
    rep_means = []
    for t_, m_, m2_, lo_, hi_, f_, q_, my_, m2y_, cxy_, h_, m3_, m4_ in carries:
        t, m = float(t_), float(m_)
        if t <= 0.0:
            # A zero-accept replicate (possible under where= with a rare
            # condition) has NO mean; its never-updated 0.0 init must not
            # enter the between-replicate sem.  The pooled merge below is
            # a no-op for it anyway.
            continue
        if control_mu is None:
            rep_means.append(m)
        else:
            adj, _, _, _ = _control_adjust(
                m, float(m2_), float(my_), float(m2y_), float(cxy_), control_mu
            )
            rep_means.append(adj)
        nn = total + t
        nn_div = nn if nn else 1.0  # zero-accept prefix under where=
        delta = m - mean
        delta_y = float(my_) - my
        w = total * t / nn_div
        # Pebay (2008) pairwise M3/M4 merges; must read the OLD m2/m3.
        m4 += (
            float(m4_)
            + delta**4 * w * (total * total - total * t + t * t) / nn_div**2
            + 6.0 * delta**2
            * (total * total * float(m2_) + t * t * m2) / nn_div**2
            + 4.0 * delta * (total * float(m3_) - t * m3) / nn_div
        )
        m3 += (
            float(m3_)
            + delta**3 * w * (total - t) / nn_div
            + 3.0 * delta * (total * float(m2_) - t * m2) / nn_div
        )
        mean += delta * t / nn_div
        m2 += float(m2_) + delta * delta * w
        my += delta_y * t / nn_div
        m2y += float(m2y_) + delta_y * delta_y * w
        cxy += float(cxy_) + delta * delta_y * w
        total = nn
        vmin = min(vmin, float(lo_))
        vmax = max(vmax, float(hi_))
        finite = finite and bool(f_)
        q = np.asarray(q_, np.float64)
        qsum = q if qsum is None else qsum + q
        h = np.asarray(h_, np.float64)
        hsum = h if hsum is None else hsum + h
    return (
        (total, mean, m2, vmin, vmax, finite, qsum, my, m2y, cxy, hsum, m3, m4),
        rep_means,
    )


def _estimate_sequential(
    sink,
    pilot,
    block_size,
    key,
    method,
    quantiles,
    correlator,
    control_node,
    control_mu,
    where,
    cvar,
    histogram,
    target_sem,
    target_rel_sem,
    max_size,
    moments=False,
):
    """Sequential (precision-targeted) streamed estimation.

    Classic two-stage / Chow-Robbins sampling on top of the streamed
    moment fold: independently-keyed rounds Chan-merge host-side until
    the pooled ``sem`` meets the target.  Round sizes come from the
    pooled variance estimate (``n_needed = n * (sem/target)^2``,
    inflated 20% for the noise in that estimate, growth capped at 4x
    per round).  Every round hits the ONE cached block program — size
    is a traced scalar — so adaptivity costs no recompiles.
    """
    carries = []
    drawn, rounds = 0, 0
    chunk = pilot
    while True:
        carry = jax.device_get(
            _estimate_carry(
                sink,
                chunk,
                block_size,
                jax.random.fold_in(key, rounds),
                method,
                quantiles,
                correlator,
                control_node,
                where,
                cvar=cvar,
                histogram=histogram,
                moments=moments,
            )
        )
        carries.append(carry)
        drawn += chunk
        rounds += 1
        merged, _ = _merge_carries(carries)
        if where is not None and merged[0] <= 0.0:
            # A rare condition can zero out the whole pilot.  Keep
            # doubling until a sample lands or the cap ends the run (the
            # finalizer raises the canonical never-held error then).
            if drawn >= max_size:
                _finalize_estimate(
                    merged, drawn, quantiles, control_mu, where, cvar,
                    histogram, moments,
                )
            chunk = min(drawn, max_size - drawn)
            continue
        stats = _finalize_estimate(
            merged, drawn, quantiles, control_mu, where, cvar, histogram,
            moments,
        )
        sem = stats["sem"]
        tgt = np.inf
        if target_sem is not None:
            tgt = min(tgt, target_sem)
        if target_rel_sem is not None:
            tgt = min(tgt, target_rel_sem * abs(stats["mean"]))
        converged = bool(np.isfinite(sem) and sem <= tgt)
        if converged or drawn >= max_size or rounds >= 64:
            stats["rounds"] = rounds
            stats["converged"] = converged
            return stats
        if np.isfinite(sem) and sem > 0.0 and np.isfinite(tgt) and tgt > 0.0:
            chunk = drawn * (sem / tgt) ** 2 * 1.2 - drawn
        else:
            # tgt == 0 happens under target_rel_sem with mean == 0: no
            # finite n satisfies it, so march to the cap geometrically.
            chunk = drawn
        chunk = int(min(chunk, 3.0 * drawn, max_size - drawn))
        chunk = max(chunk, 1)


def _round_chunk(chunk, method, budget):
    """Size one sequential round's per-replicate chunk, LHS-aware.

    The LHS block program bakes the round's total size into the
    compiled program (the Feistel stratification domain is part of the
    cache key), so every DISTINCT chunk size costs a fresh XLA compile.
    Rounding LHS chunks up to
    powers of two caps the number of distinct compiled programs at
    log2(max_size) and lets rounds that land on the same scale reuse
    the cache outright.  sobol/halton/antithetic/None programs are
    size-agnostic (size is a traced scalar), so their chunks pass
    through untouched.  ``budget`` clamps the final round to the draws
    actually remaining — that round may compile once more, which is
    unavoidable.
    """
    chunk = max(int(chunk), 1)
    if method is not None and method.lower().strip() == "lhs":
        chunk = 1 << (chunk - 1).bit_length()
    return max(1, min(chunk, int(budget)))


def _estimate_sequential_replicated(
    sink,
    pilot,
    block_size,
    key,
    method,
    quantiles,
    correlator,
    control_node,
    control_mu,
    where,
    cvar,
    histogram,
    target_sem,
    target_rel_sem,
    max_size,
    moments,
    reps,
):
    """Sequential stopping on the between-replicate sem (QMC-valid).

    R independently randomised streams (fresh scrambles/keys per
    replicate AND per round) each grow round by round; the stopping
    statistic is the empirical standard error of the R pooled replicate
    means — the randomised-QMC error estimate, valid for any
    ``method=`` including sobol/halton/lhs (each round is a fresh
    randomisation, so pooling rounds within a replicate keeps the
    replicate mean unbiased and replicates independent).  Round sizing
    follows ``_estimate_sequential``'s Chow-Robbins rule on the
    replicated sem.  sobol/halton/antithetic rounds all share the one
    cached block program (size is a traced scalar); LHS programs are
    size-specific, so LHS chunks are quantised to powers of two
    (``_round_chunk``) to bound the distinct compiles at log2(max_size).
    """
    carries = [[] for _ in range(reps)]
    drawn, rounds = 0, 0
    chunk = _round_chunk(pilot // reps, method, max(1, max_size // reps))
    while True:
        for r in range(reps):
            rk = jax.random.fold_in(jax.random.fold_in(key, r), rounds)
            carries[r].append(
                jax.device_get(
                    _estimate_carry(
                        sink,
                        chunk,
                        block_size,
                        rk,
                        method,
                        quantiles,
                        correlator,
                        control_node,
                        where,
                        cvar=cvar,
                        histogram=histogram,
                        moments=moments,
                    )
                )
            )
        drawn += chunk * reps
        rounds += 1
        merged, _ = _merge_carries([c for lst in carries for c in lst])
        rep_means = []
        for lst in carries:
            pooled_r, _ = _merge_carries(lst)
            if pooled_r[0] <= 0.0:
                continue  # zero-accept replicate under where=
            if control_mu is None:
                rep_means.append(pooled_r[1])
            else:
                rep_means.append(
                    _control_adjust(
                        pooled_r[1], pooled_r[2], pooled_r[7],
                        pooled_r[8], pooled_r[9], control_mu,
                    )[0]
                )
        if where is not None and (merged[0] <= 0.0 or len(rep_means) < 2):
            if drawn >= max_size:
                if merged[0] <= 0.0:
                    # Raises the canonical never-held error.
                    _finalize_estimate(
                        merged, drawn, quantiles, control_mu, where,
                        cvar, histogram, moments,
                    )
                raise ValueError(
                    f"Only {len(rep_means)} of {reps} replicates "
                    "accepted any samples within max_size; the "
                    "between-replicate sem needs >= 2. Loosen the where "
                    "condition or raise max_size."
                )
            chunk = _round_chunk(
                min(drawn // reps, (max_size - drawn) // reps),
                method,
                max(1, (max_size - drawn) // reps),
            )
            continue
        stats = _finalize_estimate(
            merged, drawn, quantiles, control_mu, where, cvar, histogram,
            moments,
        )
        rm = np.asarray(rep_means, np.float64)
        sem = float(rm.std(ddof=1) / np.sqrt(rm.size))
        stats["sem"] = sem
        if control_mu is not None:
            stats["mean"] = float(rm.mean())
        tgt = np.inf
        if target_sem is not None:
            tgt = min(tgt, target_sem)
        if target_rel_sem is not None:
            tgt = min(tgt, target_rel_sem * abs(stats["mean"]))
        converged = bool(np.isfinite(sem) and sem <= tgt)
        if converged or drawn >= max_size or rounds >= 64:
            stats["rounds"] = rounds
            stats["converged"] = converged
            stats["replicates"] = reps
            return stats
        if np.isfinite(sem) and sem > 0.0 and np.isfinite(tgt) and tgt > 0.0:
            need = drawn * (sem / tgt) ** 2 * 1.2 - drawn
        else:
            need = drawn
        need = min(need, 3.0 * drawn, float(max_size - drawn))
        chunk = _round_chunk(
            int(need) // reps, method, max(1, (max_size - drawn) // reps)
        )


def _stream_fingerprint(
    sink, size, block_size, seg_blocks, key, method, quantiles,
    cvar, histogram, moments, correlator, control_node, where_node,
):
    """Cross-process-stable identity of a checkpointable streamed run.

    Everything that changes the draws or the carry layout participates:
    the graph structure (via ``engine.checkpoint.graph_fingerprint``),
    every sizing/method/feature argument, the resolved correlator, the
    control/where graphs, the dtype, and the raw PRNG key — resuming
    under ANY difference would splice statistics of two different runs.
    """
    import hashlib

    from probabilit_tpu import config as _config
    from probabilit_tpu.engine import checkpoint as _ckpt

    parts = [
        _ckpt.graph_fingerprint(sink),
        repr(
            (
                int(size),
                int(block_size),
                int(seg_blocks),
                method,
                tuple(quantiles),
                tuple(cvar),
                histogram,
                bool(moments),
                _compile.correlator_token(_compile.resolve_correlator(correlator)),
                jnp.dtype(_config.float_dtype()).name,
                _compile._active_mesh_key(),
            )
        ),
        "" if control_node is None else _ckpt.graph_fingerprint(control_node),
        "" if where_node is None else "w" + _ckpt.graph_fingerprint(where_node),
        np.asarray(jax.random.key_data(key)).tobytes().hex(),
    ]
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()


def _save_stream_checkpoint(path, fingerprint, carries):
    """Atomically persist the per-segment carry list (tmp + replace)."""
    import os

    sc = np.array(
        [
            [c[0], c[1], c[2], c[3], c[4], c[7], c[8], c[9], c[11], c[12]]
            for c in carries
        ],
        np.float64,
    )
    fin = np.array([bool(c[5]) for c in carries])
    q = np.stack([np.asarray(c[6], np.float64) for c in carries])
    h = np.stack([np.asarray(c[10], np.float64) for c in carries])
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(
            fh,
            fingerprint=np.asarray(fingerprint),
            scalars=sc,
            finite=fin,
            qsum=q,
            hsum=h,
        )
    os.replace(tmp, path)


def _load_stream_checkpoint(path, fingerprint):
    """-> the saved carry list; refuses a mismatched run."""
    with np.load(path, allow_pickle=False) as data:
        saved_fp = str(data["fingerprint"])
        if saved_fp != fingerprint:
            raise ValueError(
                f"Checkpoint {path!r} belongs to a different run (graph, "
                "size, block/segment layout, method, features, or key "
                "differ); delete it to start fresh."
            )
        sc, fin = data["scalars"], data["finite"]
        q, h = data["qsum"], data["hsum"]
    out = []
    for i in range(sc.shape[0]):
        t, m, m2, lo, hi, my, m2y, cxy, m3, m4 = sc[i]
        out.append(
            (t, m, m2, lo, hi, bool(fin[i]), q[i], my, m2y, cxy, h[i], m3, m4)
        )
    return out


def _estimate_checkpointed(
    sink,
    size,
    block_size,
    key,
    method,
    quantiles,
    correlator,
    control_node,
    control_mu,
    where,
    cvar,
    histogram,
    moments,
    path,
    every,
):
    """Resumable streamed estimation: fixed-boundary segments + carries.

    The run is cut at FIXED block boundaries (independent of where a
    crash lands), each segment folds on device through the one cached
    program (absolute block indices, so per-block keys and QMC offsets
    are those of the uninterrupted run), and completed segment carries
    persist after every segment.  Resuming re-runs only unfinished
    segments; the final host-side float64 Chan merge over the identical
    segment carry sequence makes the resumed result bitwise-identical
    to the same checkpointed run left uninterrupted.
    """
    import os

    n_blocks = -(-size // block_size)
    last = size - (n_blocks - 1) * block_size
    seg_blocks = 64 if every is None else max(1, int(every) // block_size)
    n_segs = -(-n_blocks // seg_blocks)
    fp = _stream_fingerprint(
        sink, size, block_size, seg_blocks, key, method,
        quantiles, cvar, histogram, moments, correlator, control_node,
        where,
    )
    carries = _load_stream_checkpoint(path, fp) if os.path.exists(path) else []
    for s in range(len(carries), n_segs):
        lo = s * seg_blocks
        nb = min(seg_blocks, n_blocks - lo)
        lc = last if lo + nb == n_blocks else block_size
        carries.append(
            jax.device_get(
                _estimate_carry(
                    sink,
                    size,
                    block_size,
                    key,
                    method,
                    quantiles,
                    correlator,
                    control_node,
                    where,
                    cvar=cvar,
                    histogram=histogram,
                    moments=moments,
                    block_lo=lo,
                    n_blocks=nb,
                    last_count=lc,
                )
            )
        )
        _save_stream_checkpoint(path, fp, carries)
    merged, _ = _merge_carries(carries)
    stats = _finalize_estimate(
        merged, size, quantiles, control_mu, where, cvar, histogram, moments
    )
    try:
        os.remove(path)
    except OSError:
        pass
    return stats


def _save_many_checkpoint(path, fingerprint, carries):
    """Atomically persist per-segment (M,)-vector carries."""
    import os

    scalars = np.array(
        [[c[0], c[7], c[8]] for c in carries], np.float64
    )  # t, my, m2y
    fin = np.array([bool(c[5]) for c in carries])
    vecs = np.stack(
        [
            np.stack(
                [np.asarray(c[i], np.float64) for i in (1, 2, 3, 4, 9, 11, 12)]
            )
            for c in carries
        ]
    )  # (S, 7, M): m, m2, lo, hi, cxy, m3, m4
    q = np.stack([np.asarray(c[6], np.float64) for c in carries])
    h = np.stack([np.asarray(c[10], np.float64) for c in carries])
    csum = np.stack([np.asarray(c[13], np.float64) for c in carries])
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(
            fh,
            fingerprint=np.asarray(fingerprint),
            scalars=scalars,
            finite=fin,
            vecs=vecs,
            qsum=q,
            hsum=h,
            csum=csum,
        )
    os.replace(tmp, path)


def _load_many_checkpoint(path, fingerprint):
    with np.load(path, allow_pickle=False) as data:
        if str(data["fingerprint"]) != fingerprint:
            raise ValueError(
                f"Checkpoint {path!r} belongs to a different run (graph, "
                "size, block/segment layout, method, features, or key "
                "differ); delete it to start fresh."
            )
        scalars, fin = data["scalars"], data["finite"]
        vecs, q, h, csum = data["vecs"], data["qsum"], data["hsum"], data["csum"]
    out = []
    for i in range(scalars.shape[0]):
        t, my, m2y = scalars[i]
        m, m2, lo, hi, cxy, m3, m4 = vecs[i]
        out.append(
            (t, m, m2, lo, hi, bool(fin[i]), q[i], my, m2y, cxy, h[i], m3, m4, csum[i])
        )
    return out


def _estimate_many_checkpointed(
    nodes,
    size,
    block_size,
    key,
    method,
    quantiles,
    cvar,
    histogram,
    correlator,
    control_node,
    control_mu,
    where,
    moments,
    covariance,
    path,
    every,
):
    """Resumable multi-node streamed estimation (see ``_estimate_checkpointed``)."""
    import os

    from probabilit_tpu.engine import checkpoint as _ckpt

    n_blocks = -(-size // block_size)
    last = size - (n_blocks - 1) * block_size
    seg_blocks = 64 if every is None else max(1, int(every) // block_size)
    n_segs = -(-n_blocks // seg_blocks)
    # The node LIST participates in the identity: resuming with nodes in
    # a different order would splice statistics across nodes.
    node_fps = "|".join(_ckpt.graph_fingerprint(n_) for n_ in nodes)
    base_fp = _stream_fingerprint(
        nodes[0], size, block_size, seg_blocks, key, method,
        quantiles, cvar, histogram, moments, correlator, control_node,
        where,
    )
    import hashlib

    fp = hashlib.sha256(
        (base_fp + node_fps + repr(bool(covariance))).encode()
    ).hexdigest()
    carries = _load_many_checkpoint(path, fp) if os.path.exists(path) else []
    for s in range(len(carries), n_segs):
        lo = s * seg_blocks
        nb = min(seg_blocks, n_blocks - lo)
        lc = last if lo + nb == n_blocks else block_size
        carries.append(
            jax.device_get(
                _many_carry(
                    nodes,
                    size,
                    block_size,
                    key,
                    method,
                    quantiles,
                    cvar,
                    histogram,
                    correlator,
                    control_node,
                    where,
                    moments=moments,
                    covariance=covariance,
                    block_lo=lo,
                    n_blocks=nb,
                    last_count=lc,
                )
            )
        )
        _save_many_checkpoint(path, fp, carries)
    merged, _ = _merge_many_carries(carries)
    out = _finalize_many(
        nodes, merged, size, quantiles, cvar, histogram, control_mu, where,
        moments, covariance,
    )
    try:
        os.remove(path)
    except OSError:
        pass
    return out


def _estimate_carry(
    sink,
    size,
    block_size,
    key,
    method,
    quantiles,
    correlator="imanconover",
    control_node=None,
    where_node=None,
    cvar=(),
    histogram=None,
    moments=False,
    block_lo=0,
    n_blocks=None,
    last_count=None,
):
    """One randomised stream's raw moment carry (device values).

    Everything cacheable lives here: the jitted whole-run program is
    keyed on block structure — not ``size`` or ``key`` — so replicate
    loops and size sweeps hit one compiled program.

    ``block_lo``/``n_blocks``/``last_count`` select a WINDOW of the
    run's absolute block range (checkpointed segments): block indices —
    and therefore per-block keys and QMC sequence offsets — are
    absolute, so the concatenation of window carries Chan-merges to the
    same statistics as one uninterrupted fold over the same stream.
    ``size`` stays the run's TOTAL size (LHS stratifies over it).  All
    three are traced scalars of the one cached program.
    """
    aux_node = control_node if control_node is not None else where_node
    where_mode = where_node is not None
    plan, run = _block_program(
        sink,
        block_size,
        method,
        total_size=size,
        correlator=correlator,
        extra=aux_node,
    )
    if plan.finalizers.get(sink._id) is not None:
        # e.g. a string-valued DiscreteDistribution: its device output is
        # an index array, and mean/var/quantiles of indices are not
        # statistics of the actual values.  The reference returns real
        # values from every sampling entry point (modeling.py:893-895).
        raise ValueError(
            "estimate() requires a numeric sink; this node produces "
            "non-numeric values (e.g. a string-valued "
            "DiscreteDistribution). Use sample_streaming() instead."
        )
    if n_blocks is None:
        n_blocks = -(-size // block_size)
    if last_count is None:
        last_count = size - (-(-size // block_size) - 1) * block_size

    # Cache the jitted whole-run program across estimate() calls AND
    # across sizes: a fresh closure per call would retrace and pay a
    # remote recompile each time (measured: ~17 s/call for the
    # sort-bearing quantile variant vs ~2.5 s of actual execution at 1e9
    # draws).  ``n_blocks``/``last_count`` are traced scalars, so a size
    # sweep (1e8 -> 1e9 -> 1e10) hits one compiled program.
    from probabilit_tpu import config as _config

    # LHS closes over the run's TOTAL size (its global stratification),
    # so its block program is size-specific — unlike sobol/halton/None,
    # whose run() is size-independent.  Without this key component a
    # size sweep would silently reuse the wrong stratification domain.
    lhs_total = (
        size
        if method is not None and method.lower().strip() == "lhs"
        else None
    )
    cache_key = (
        plan.signature(),
        block_size,
        quantiles,
        cvar,
        histogram,
        method,
        lhs_total,
        _compile.correlator_token(_compile.resolve_correlator(correlator)),
        None if control_node is None else control_node._id,
        None if where_node is None else ("where", where_node._id),
        jnp.dtype(_config.float_dtype()).name,
        _compile._active_mesh_key(),
        bool(moments),
    )
    cached = _ESTIMATE_CACHE.get(cache_key)
    if cached is not None:
        return cached(key, block_lo, n_blocks, last_count)

    qsum_full, qsum_partial = _quantile_accumulators(quantiles, block_size, cvar)
    hist_full, hist_partial = _histogram_accumulators(histogram)
    hist_len = 0 if histogram is None else histogram[2] + 2

    @jax.jit
    def all_blocks(key, block_lo, n_blocks, last_count):
        # One dispatch for the whole run: lax.fori_loop folds every block
        # into the running (mean, M2, min, max); only a handful of
        # scalars ever reach the host.  Counts carried in f32 (exact
        # merge weights are unnecessary; relative 2^-24 is far below MC
        # noise).  Full blocks fold UNMASKED (no per-element valid tests
        # in the hot loop — 1-D iota/select chains cost a pass each); the
        # final block always runs the masked path, outside the loop, with
        # its valid count as a traced scalar.
        global _TRACE_COUNT
        _TRACE_COUNT += 1

        zero = jnp.float32(0.0)

        def merge(
            carry, bn, bm, bm2, bmin, bmax, bfinite, bqsum, bctl, bhsum,
            bm3, bm4,
        ):
            (
                n_prev, mean, m2, vmin, vmax, finite, qsum, my, m2y, cxy,
                hsum, m3, m4,
            ) = carry
            # Histogram counts carry as TWO f32 words per bin (hi in
            # units of 2^23, lo < 2^23): a single f32 total loses
            # integer exactness past 2^24 counts/bin.  Per-block counts
            # are <= block_size <= 2^24 so every add/floor below is
            # exact; the pair stays exact to 2^47 counts per bin.
            hC = jnp.float32(2.0**23)
            bc = jnp.floor(bhsum / hC)
            lo_new = hsum[1] + (bhsum - bc * hC)
            c2 = jnp.floor(lo_new / hC)
            hsum = jnp.stack([hsum[0] + bc + c2, lo_new - c2 * hC])
            bmy, bm2y, bcxy = bctl
            delta = bm - mean
            delta_y = bmy - my
            nn = n_prev + bn
            # Under where= a block (or the whole prefix) can hold ZERO
            # accepted samples; every numerator is 0 then, so a clamped
            # denominator yields the correct no-op merge instead of NaN.
            nn_div = jnp.maximum(nn, 1.0) if where_mode else nn
            w = n_prev * bn / nn_div
            # Pebay (2008) pairwise M3/M4; reads the OLD m2/m3.  Gated on
            # the trace-time flag: m3/m4 are loop-carried outputs XLA
            # cannot dead-code-eliminate, so with moments off the update
            # must not be emitted at all (the zeros just ride the carry).
            if moments:
                m4 = m4 + bm4 + (
                    delta**4 * w
                    * (n_prev * n_prev - n_prev * bn + bn * bn) / nn_div**2
                    + 6.0 * delta**2
                    * (n_prev * n_prev * bm2 + bn * bn * m2) / nn_div**2
                    + 4.0 * delta * (n_prev * bm3 - bn * m3) / nn_div
                )
                m3 = m3 + bm3 + (
                    delta**3 * w * (n_prev - bn) / nn_div
                    + 3.0 * delta * (n_prev * bm2 - bn * m2) / nn_div
                )
            mean = mean + delta * bn / nn_div
            m2 = m2 + bm2 + delta * delta * w
            # Bivariate Chan merge: the cross co-moment picks up the same
            # between-part correction with delta_x * delta_y.
            my = my + delta_y * bn / nn_div
            m2y = m2y + bm2y + delta_y * delta_y * w
            cxy = cxy + bcxy + delta * delta_y * w
            vmin = jnp.minimum(vmin, bmin)
            vmax = jnp.maximum(vmax, bmax)
            return (
                nn,
                mean,
                m2,
                vmin,
                vmax,
                finite & bfinite,
                qsum + bqsum,
                my,
                m2y,
                cxy,
                hsum,
                m3,
                m4,
            )

        def hi_moments(x, bm, mask=None):
            # Central 3rd/4th power-sum block reductions; the where()
            # runs BEFORE the powers so off-mask NaN lanes never enter.
            if not moments:
                return zero, zero
            d = x - bm if mask is None else jnp.where(mask, x - bm, 0.0)
            d2 = d * d
            return jnp.sum(d2 * d), jnp.sum(d2 * d2)

        def ctl_full(x, y, bm):
            if y is None:
                return (zero, zero, zero)
            y = y.astype(jnp.float32)
            bmy = jnp.mean(y)
            return (
                bmy,
                jnp.sum(jnp.square(y - bmy)),
                jnp.sum((x - bm) * (y - bmy)),
            )

        def ctl_partial(x, y, mask, cntf, bm):
            if y is None:
                return (zero, zero, zero)
            y = y.astype(jnp.float32)
            bmy = jnp.sum(jnp.where(mask, y, 0.0)) / cntf
            return (
                bmy,
                jnp.sum(jnp.where(mask, jnp.square(y - bmy), 0.0)),
                jnp.sum(jnp.where(mask, (x - bm) * (y - bmy), 0.0)),
            )

        def masked_stats(x, mask):
            # Off-mask lanes are never inspected: the sink may be
            # NaN/inf outside the condition by design (x * mask would
            # poison sums through NaN * 0).
            cntf = jnp.sum(mask.astype(jnp.float32))
            safe = jnp.maximum(cntf, 1.0)
            bm = jnp.sum(jnp.where(mask, x, 0.0)) / safe
            bm2 = jnp.sum(jnp.where(mask, jnp.square(x - bm), 0.0))
            return (
                cntf,
                bm,
                bm2,
                jnp.min(jnp.where(mask, x, jnp.float32(jnp.inf))),
                jnp.max(jnp.where(mask, x, jnp.float32(-jnp.inf))),
                jnp.all(jnp.where(mask, jnp.isfinite(x), True)),
            )

        def body(b, carry):
            x, y = run(b, key)
            x = x.astype(jnp.float32)
            if where_mode:
                cond = y != 0
                bn, bm, bm2, bmin, bmax, bfin = masked_stats(x, cond)
                return merge(
                    carry, bn, bm, bm2, bmin, bmax, bfin,
                    qsum_full(x), ctl_full(x, None, bm), hist_full(x, cond),
                    *hi_moments(x, bm, cond),
                )
            bn = jnp.float32(block_size)
            bm = jnp.mean(x)
            bm2 = jnp.sum(jnp.square(x - bm))
            return merge(
                carry,
                bn,
                bm,
                bm2,
                jnp.min(x),
                jnp.max(x),
                jnp.all(jnp.isfinite(x)),
                qsum_full(x),
                ctl_full(x, y, bm),
                hist_full(x),
                *hi_moments(x, bm),
            )

        init = (
            zero,
            zero,
            zero,
            jnp.float32(jnp.inf),
            jnp.float32(-jnp.inf),
            jnp.bool_(True),
            jnp.zeros((len(quantiles) + len(cvar),), jnp.float32),
            zero,
            zero,
            zero,
            jnp.zeros((2, hist_len), jnp.float32),
            zero,
            zero,
        )
        lo = jnp.asarray(block_lo, jnp.int32)
        nb1 = lo + jnp.asarray(n_blocks, jnp.int32) - 1
        carry = jax.lax.fori_loop(lo, nb1, body, init)

        cnt = jnp.asarray(last_count, jnp.int32)
        x, y = run(nb1, key)
        x = x.astype(jnp.float32)
        mask = jnp.arange(block_size, dtype=jnp.int32) < cnt
        if where_mode:
            cond = mask & (y != 0)
            bn, bm, bm2, bmin, bmax, bfin = masked_stats(x, cond)
            return merge(
                carry, bn, bm, bm2, bmin, bmax, bfin,
                qsum_partial(x, mask, cnt), ctl_partial(x, None, mask, bn, bm),
                hist_partial(x, cond),
                *hi_moments(x, bm, cond),
            )
        cntf = cnt.astype(jnp.float32)
        bm = jnp.sum(jnp.where(mask, x, 0.0)) / cntf
        bm2 = jnp.sum(jnp.where(mask, jnp.square(x - bm), 0.0))
        return merge(
            carry,
            cntf,
            bm,
            bm2,
            jnp.min(jnp.where(mask, x, jnp.float32(jnp.inf))),
            jnp.max(jnp.where(mask, x, jnp.float32(-jnp.inf))),
            jnp.all(jnp.where(mask, jnp.isfinite(x), True)),
            qsum_partial(x, mask, cnt),
            ctl_partial(x, y, mask, cntf, bm),
            hist_partial(x, mask),
            *hi_moments(x, bm, mask),
        )

    if len(_ESTIMATE_CACHE) > 32:
        _ESTIMATE_CACHE.pop(next(iter(_ESTIMATE_CACHE)))
    _ESTIMATE_CACHE[cache_key] = all_blocks
    return all_blocks(key, block_lo, n_blocks, last_count)


def _control_adjust(mx, m2x, my, m2y, cxy, mu):
    """(adjusted mean, variance-reduction factor 1-rho^2, beta, rho).

    Classic regression control variate: ``mean - beta * (my - mu)`` with
    the empirically optimal ``beta = Cov(x,y)/Var(y)``; the mean's
    variance shrinks by ``1 - rho^2``.
    """
    if m2y <= 0.0:
        return mx, 1.0, 0.0, 0.0
    beta = cxy / m2y
    rho2 = (cxy * cxy) / (m2x * m2y) if m2x > 0.0 else 0.0
    rho2 = min(rho2, 1.0)
    rho = (rho2**0.5) if cxy >= 0 else -(rho2**0.5)
    return mx - beta * (my - mu), 1.0 - rho2, beta, rho


def _finalize_estimate(
    carry, size, quantiles, control_mu=None, where=None, cvar=(),
    histogram=None, moments=False,
):
    (
        total_,
        mean_,
        m2_,
        vmin_,
        vmax_,
        finite_,
        qsum_,
        my_,
        m2y_,
        cxy_,
        hsum_,
        m3_,
        m4_,
    ) = jax.device_get(carry)
    total, mean, m2, vmin, vmax = (
        float(total_),
        float(mean_),
        float(m2_),
        float(vmin_),
        float(vmax_),
    )
    if not bool(finite_):
        raise ValueError("Sampling produced non-finite values.")
    if where is not None and total <= 0:
        raise ValueError(
            f"where= condition never held across {size} draws; no "
            "conditional statistics exist. Loosen the condition or "
            "raise size."
        )
    var = m2 / total if total else float("nan")
    stats = {
        "n": int(round(total)) if where is not None else size,
        "mean": mean,
        "var": var,
        "std": var**0.5,
        # iid standard error of the mean; the replicates path overwrites
        # this with the (method-valid) between-replicate estimate.
        "sem": (var / total) ** 0.5 if total else float("nan"),
        "min": vmin,
        "max": vmax,
    }
    if moments:
        # scipy conventions: biased g1, Fisher (excess) g2.
        sd3 = var**1.5
        stats["skew"] = (
            float(m3_) / total / sd3 if total and sd3 else float("nan")
        )
        stats["kurt"] = (
            float(m4_) / total / var**2 - 3.0 if total and var else float("nan")
        )
    if where is not None:
        stats["n_total"] = size
        stats["acceptance"] = total / size
    if control_mu is not None:
        adj, factor, beta, rho = _control_adjust(
            mean, m2, float(my_), float(m2y_), float(cxy_), control_mu
        )
        # var/std/min/max/quantiles remain properties of the OUTPUT
        # distribution; the control variate improves only the estimator
        # of the mean.
        stats["mean"] = adj
        stats["sem"] = stats["sem"] * factor**0.5
        stats["control_beta"] = beta
        stats["control_rho"] = rho
        stats["control_mean"] = float(my_)
    tails = np.asarray(qsum_, np.float64)
    for level, qs in zip(quantiles, tails[: len(quantiles)]):
        stats[f"q{level:g}"] = float(qs / total)
    for level, es in zip(cvar, tails[len(quantiles) :]):
        stats[f"cvar{level:g}"] = float(es / total)
    if histogram is not None:
        h_lo, h_hi, h_bins = histogram
        pair = np.asarray(hsum_, np.float64)
        counts = np.rint(pair[0] * 2.0**23 + pair[1]).astype(np.int64)
        stats["histogram"] = {
            "edges": np.linspace(h_lo, h_hi, h_bins + 1),
            "counts": counts[1:-1],
            "underflow": int(counts[0]),
            "overflow": int(counts[-1]),
        }
    return stats


_MANY_CACHE = {}


def estimate_many(
    nodes,
    size,
    block_size=16_777_216,
    random_state=None,
    method=None,
    correlator="imanconover",
    quantiles=None,
    cvar=None,
    histogram=None,
    replicates=None,
    control=None,
    where=None,
    target_sem=None,
    target_rel_sem=None,
    max_size=None,
    moments=False,
    covariance=False,
    checkpoint=None,
    checkpoint_every=None,
):
    """One-pass streamed moments for SEVERAL nodes of one model.

    Returns ``{node: {n, mean, var, std, sem, min, max}}`` where every
    node's statistics come from the SAME joint draws — a portfolio's
    desks and its total, say, all consistent with each other.  Running
    ``estimate()`` per node cannot do this (each sink gets its own
    column layout and therefore its own randomness), and the reference
    cannot do it at streaming sizes at all (it must materialise every
    node's samples).  One compiled program, one pass over the draws,
    O(block) memory; carries are (M,)-vector Chan merges, so cost is
    independent of how many nodes are watched.

    Every single-sink ``estimate()`` feature composes here, per node,
    from the same joint stream and under the same composition rules:

    - ``quantiles=(0.5, 0.95, ...)`` / ``cvar=(0.95, ...)``: streamed
      per-node quantile and expected-shortfall estimates (one batched
      row-sort per block covers every node and every level; CVaR rides
      the same sorts via Rockafellar-Uryasev).  A desk+total VaR/CVaR
      profile therefore comes internally consistent from one program.
    - ``histogram=(lo, hi, bins)``: one exact fixed-bin histogram per
      node (two-word f32 count carries, see ``estimate``).
    - ``where=node``: conditional statistics ``E[node_i | cond]`` with a
      SHARED condition — ``n`` is the accepted count, ``n_total``/
      ``acceptance`` reported per node.  Not with quantiles/cvar/control
      (same rule as ``estimate``).
    - ``control=(node, known_mean)``: one control variate regresses
      EVERY watched node's mean (per-node beta against the shared
      control, ``control_beta``/``control_rho`` per node).
    - ``replicates=R``: R independently randomised streams; each node's
      ``sem`` becomes its between-replicate spread — the valid QMC /
      antithetic error bar, jointly consistent across nodes because all
      R streams are shared.
    - ``moments=True``: per-node streamed skewness and excess kurtosis
      (``skew``/``kurt``, scipy conventions) via (M,)-vector M3/M4
      Chan/Pebay carries; the merge updates are not emitted when
      off (trace-time gate).
    - ``covariance=True``: the full M x M cross-node covariance and
      correlation of the joint stream — every node's dict gains
      ``cov``/``corr``, its (M,)-row of the joint matrix in ``nodes``
      order (``np.stack([out[n]["corr"] for n in nodes])`` rebuilds the
      matrix).  One small (M, block) x (block, M) matmul per block
      (f32-precision pinned), Chan-merged with outer-product
      corrections; composes with ``where=`` (conditional covariance)
      and the sequential/replicate paths.  This is the jointly
      consistent desk-correlation matrix at streaming sizes — per-node
      ``estimate()`` calls cannot produce it (each sink gets its own
      draws).
    - ``target_sem=tol`` / ``target_rel_sem=tol``: sequential stopping
      exactly as in ``estimate``, except the run continues until EVERY
      watched node meets its target (round sizes come from the worst
      node's sem), so the joint profile is reported at a uniform
      precision.  Under QMC add ``replicates=R`` — the per-node
      stopping statistic becomes the between-replicate sem of R
      independently randomised streams, the valid RQMC error bar (same
      rule as ``estimate``); every per-node dict gains ``rounds`` and
      ``converged``.
    - ``checkpoint=path`` / ``checkpoint_every=draws``: resumable
      fixed-boundary segmented folds exactly as in ``estimate`` (the
      node LIST participates in the fingerprint — resuming with
      reordered nodes is refused).

    ``sem`` without replicates is the iid formula per node (see
    ``estimate`` for when that is and is not meaningful).
    """
    from probabilit_tpu.models.graph import Node

    nodes = list(nodes)
    if not nodes:
        raise ValueError("estimate_many needs at least one node.")
    seen = set()
    for node in nodes:
        if not isinstance(node, Node):
            raise ValueError(f"estimate_many takes graph nodes, got {node!r}.")
        if getattr(node, "_vector_valued", False):
            raise ValueError(
                f"Cannot estimate vector-valued node {node!r}; request "
                "scalar marginals/functionals of it instead."
            )
        if node._id in seen:
            raise ValueError(f"{node!r} appears twice.")
        seen.add(node._id)
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}.")
    quantiles = tuple(float(q) for q in quantiles) if quantiles else ()
    for q in quantiles:
        if not 0.0 < q < 1.0:
            raise ValueError(f"Quantile levels must be in (0, 1), got {q}.")
    cvar = tuple(float(q) for q in cvar) if cvar else ()
    for q in cvar:
        if not 0.0 < q < 1.0:
            raise ValueError(f"CVaR levels must be in (0, 1), got {q}.")
    if histogram is not None:
        try:
            h_lo, h_hi, h_bins = histogram
        except (TypeError, ValueError):
            raise ValueError(
                "histogram must be a (lo, hi, bins) triple, e.g. "
                "histogram=(-5.0, 5.0, 100)."
            ) from None
        h_lo, h_hi, h_bins = float(h_lo), float(h_hi), int(h_bins)
        if not (np.isfinite(h_lo) and np.isfinite(h_hi) and h_lo < h_hi):
            raise ValueError(
                f"histogram range must be finite with lo < hi, got "
                f"({h_lo}, {h_hi})."
            )
        if not 1 <= h_bins <= _HISTOGRAM_MAX_BINS:
            raise ValueError(
                f"histogram bins must be in [1, {_HISTOGRAM_MAX_BINS}], "
                f"got {h_bins}."
            )
        histogram = (h_lo, h_hi, h_bins)
    if where is not None:
        if not isinstance(where, Node):
            raise ValueError(f"where must be a graph node, got {where!r}.")
        if getattr(where, "_vector_valued", False):
            raise ValueError(
                f"where condition {where!r} is vector-valued; condition "
                "on a scalar functional of it instead."
            )
        if quantiles or cvar:
            raise ValueError(
                "where= does not compose with quantiles=/cvar= (the "
                "row-sort estimators assume unmasked blocks); estimate "
                "the conditional quantiles from sample_streaming output."
            )
        if control is not None:
            raise ValueError(
                "where= does not compose with control= (the control "
                "regression assumes unmasked blocks)."
            )
    control_node, control_mu = None, None
    if control is not None:
        try:
            control_node, control_mu = control
        except (TypeError, ValueError):
            raise ValueError(
                "control must be a (node, known_mean) pair, e.g. "
                "control=(cheap_part, analytic_mean)."
            ) from None
        if not isinstance(control_node, Node):
            raise ValueError(
                f"control[0] must be a graph node, got {control_node!r}."
            )
        control_mu = float(control_mu)
    key = resolve_key(random_state)
    if checkpoint is not None and (
        replicates is not None
        or target_sem is not None
        or target_rel_sem is not None
    ):
        raise ValueError(
            "checkpoint= composes with fixed-size single-stream runs "
            "only; checkpoint the fixed-size runs a replicated or "
            "sequential scheme decomposes into instead."
        )
    if checkpoint is None and checkpoint_every is not None:
        raise ValueError("checkpoint_every= needs checkpoint=path.")
    if target_sem is not None or target_rel_sem is not None:
        qmc = (method or "").lower().strip()
        if qmc in ("sobol", "halton", "lhs") and replicates is None:
            raise ValueError(
                f"target_sem with method={method!r} needs replicates=R "
                "(e.g. replicates=8): the iid sem is not a valid QMC "
                "error bar; the between-replicate sem of R independently "
                "randomised streams is the valid stopping statistic."
            )
        for name, t in (
            ("target_sem", target_sem),
            ("target_rel_sem", target_rel_sem),
        ):
            if t is not None and not (float(t) > 0.0):
                raise ValueError(f"{name} must be > 0, got {t}.")
        max_size = 64 * size if max_size is None else int(max_size)
        if max_size < size:
            raise ValueError(
                f"max_size ({max_size}) must be >= the pilot size "
                f"({size})."
            )
        if replicates is not None:
            reps = int(replicates)
            if reps < 2:
                raise ValueError(
                    f"replicates must be >= 2 (got {reps}): a single "
                    "stream has no between-replicate variance to "
                    "estimate sem from."
                )
            return _estimate_sequential_many_replicated(
                nodes,
                size,
                block_size,
                key,
                method,
                quantiles,
                cvar,
                histogram,
                correlator,
                control_node,
                control_mu,
                where,
                None if target_sem is None else float(target_sem),
                None if target_rel_sem is None else float(target_rel_sem),
                max_size,
                moments,
                covariance,
                reps,
            )
        return _estimate_sequential_many(
            nodes,
            size,
            block_size,
            key,
            method,
            quantiles,
            cvar,
            histogram,
            correlator,
            control_node,
            control_mu,
            where,
            None if target_sem is None else float(target_sem),
            None if target_rel_sem is None else float(target_rel_sem),
            max_size,
            moments,
            covariance,
        )
    if replicates is not None:
        reps = int(replicates)
        if reps < 2:
            raise ValueError(
                f"replicates must be >= 2 (got {reps}): a single stream "
                "has no between-replicate variance to estimate sem from."
            )
        if size % reps:
            raise ValueError(
                f"size ({size}) must be divisible by replicates ({reps}) "
                "so every randomisation carries equal weight."
            )
        sub = size // reps
        carries = [
            jax.device_get(
                _many_carry(
                    nodes,
                    sub,
                    block_size,
                    jax.random.fold_in(key, r),
                    method,
                    quantiles,
                    cvar,
                    histogram,
                    correlator,
                    control_node,
                    where,
                    moments=moments,
                    covariance=covariance,
                )
            )
            for r in range(reps)
        ]
        merged, rep_means = _merge_many_carries(carries, control_mu)
        out = _finalize_many(
            nodes, merged, size, quantiles, cvar, histogram, control_mu,
            where, moments, covariance,
        )
        rep = np.asarray(rep_means, np.float64)  # (R_kept, M)
        if rep.ndim != 2 or rep.shape[0] < 2:
            raise ValueError(
                f"Only {0 if rep.ndim != 2 else rep.shape[0]} of {reps} "
                "replicates accepted any samples; the between-replicate "
                "sem needs >= 2. Loosen the where condition, raise size, "
                "or drop replicates=."
            )
        for i, node in enumerate(nodes):
            out[node]["sem"] = float(
                rep[:, i].std(ddof=1) / np.sqrt(rep.shape[0])
            )
            if control_mu is not None:
                out[node]["mean"] = float(rep[:, i].mean())
            out[node]["replicates"] = reps
        return out
    if checkpoint is not None:
        return _estimate_many_checkpointed(
            nodes,
            size,
            block_size,
            key,
            method,
            quantiles,
            cvar,
            histogram,
            correlator,
            control_node,
            control_mu,
            where,
            moments,
            covariance,
            str(checkpoint),
            checkpoint_every,
        )
    carry = _many_carry(
        nodes,
        size,
        block_size,
        key,
        method,
        quantiles,
        cvar,
        histogram,
        correlator,
        control_node,
        where,
        moments=moments,
        covariance=covariance,
    )
    return _finalize_many(
        nodes, carry, size, quantiles, cvar, histogram, control_mu, where,
        moments, covariance,
    )


def _many_carry(
    nodes,
    size,
    block_size,
    key,
    method,
    quantiles,
    cvar,
    histogram,
    correlator,
    control_node,
    where_node,
    moments=False,
    covariance=False,
    block_lo=0,
    n_blocks=None,
    last_count=None,
):
    """One randomised stream's (M,)-vector moment carry (device values).

    The multi-node analogue of ``_estimate_carry``: carries are
    vectorised over the M watched nodes — (M,) mean/M2/min/max/cxy,
    (M, L) quantile+CVaR numerators, (2, M, bins+2) two-word histogram
    counts — while the count, control moments, and finite flag stay
    scalar (the condition and control are SHARED across nodes).

    ``block_lo``/``n_blocks``/``last_count`` select an absolute block
    window exactly as in ``_estimate_carry`` (checkpointed segments).
    """
    from probabilit_tpu import config as _config
    from probabilit_tpu.models import graph as _graph
    from probabilit_tpu.models.graph import NoOp

    m = len(nodes)
    aux_node = control_node if control_node is not None else where_node
    where_mode = where_node is not None
    if n_blocks is None:
        n_blocks = -(-size // block_size)
    if last_count is None:
        last_count = size - (-(-size // block_size) - 1) * block_size

    lhs_total = (
        size if method is not None and method.lower().strip() == "lhs" else None
    )
    cache_key = (
        tuple(node._id for node in nodes),
        # Graph mutations (a later correlate(), say) must not hit a
        # stale compiled program; the coarse global epoch is the same
        # signal the per-sink Plan cache uses (models/graph.py).
        _graph.Node._mutation_epoch,
        block_size,
        method,
        quantiles,
        cvar,
        histogram,
        lhs_total,
        _compile.correlator_token(_compile.resolve_correlator(correlator)),
        None if control_node is None else control_node._id,
        None if where_node is None else ("where", where_node._id),
        jnp.dtype(_config.float_dtype()).name,
        _compile._active_mesh_key(),
        bool(moments),
        bool(covariance),
    )
    cached = _MANY_CACHE.get(cache_key)
    if cached is not None:
        return cached(key, block_lo, n_blocks, last_count)

    # A NoOp roots all requested nodes in ONE plan (the reference's own
    # multi-variable trick, inspection.py:35-36); its output is None and
    # ignored — the block runner returns the kept extras.
    extras = tuple(nodes) + (() if aux_node is None else (aux_node,))
    sink = NoOp(*extras)
    plan, run = _block_program(
        sink,
        block_size,
        method,
        total_size=size,
        correlator=correlator,
        extra=extras,
    )
    for node in nodes:
        if plan.finalizers.get(node._id) is not None:
            raise ValueError(
                f"{node!r} produces non-numeric values (host finalizer); "
                "estimate_many needs numeric nodes. Use sample_streaming()."
            )

    qsum_full_many, qsum_partial_many = _quantile_accumulators_many(
        quantiles, block_size, cvar
    )
    hist_many = _histogram_accumulators_many(histogram)
    hist_len = 0 if histogram is None else histogram[2] + 2
    n_levels = len(quantiles) + len(cvar)

    @jax.jit
    def all_blocks(key, block_lo, n_blocks, last_count):
        global _TRACE_COUNT
        _TRACE_COUNT += 1

        zero = jnp.float32(0.0)
        czeros = jnp.zeros((m,), jnp.float32)

        def merge(
            carry, bn, bm, bm2, bmin, bmax, bfinite, bqsum, bctl, bhsum,
            bm3, bm4, bcov,
        ):
            (
                n_prev, mean, m2, vmin, vmax, finite, qsum, my, m2y, cxy,
                hsum, m3, m4, csum,
            ) = carry
            bmy, bm2y, bcxy = bctl
            delta = bm - mean
            delta_y = bmy - my
            nn = n_prev + bn
            nn_div = jnp.maximum(nn, 1.0) if where_mode else nn
            w = n_prev * bn / nn_div
            # Pebay (2008) pairwise M3/M4 over the (M,) node axis; reads
            # the OLD m2/m3.  Gated at trace time: these are loop-carried
            # outputs XLA cannot eliminate, so the updates must not be
            # emitted when the feature is off (zeros ride the carry).
            if moments:
                m4 = m4 + bm4 + (
                    delta**4 * w
                    * (n_prev * n_prev - n_prev * bn + bn * bn) / nn_div**2
                    + 6.0 * delta**2
                    * (n_prev * n_prev * bm2 + bn * bn * m2) / nn_div**2
                    + 4.0 * delta * (n_prev * bm3 - bn * m3) / nn_div
                )
                m3 = m3 + bm3 + (
                    delta**3 * w * (n_prev - bn) / nn_div
                    + 3.0 * delta * (n_prev * bm2 - bn * m2) / nn_div
                )
            # Cross-node covariance: same Chan correction, outer product.
            # Same trace-time gating — the O(M^2) correction would
            # otherwise run every block with covariance off.
            if covariance:
                csum = csum + bcov + delta[:, None] * delta[None, :] * w
            mean = mean + delta * bn / nn_div
            m2 = m2 + bm2 + delta * delta * w
            my = my + delta_y * bn / nn_div
            m2y = m2y + bm2y + delta_y * delta_y * w
            cxy = cxy + bcxy + delta * delta_y * w
            # Two-word exact histogram counts (see _estimate_carry).
            hC = jnp.float32(2.0**23)
            bc = jnp.floor(bhsum / hC)
            lo_new = hsum[1] + (bhsum - bc * hC)
            c2 = jnp.floor(lo_new / hC)
            hsum = jnp.stack([hsum[0] + bc + c2, lo_new - c2 * hC])
            return (
                nn,
                mean,
                m2,
                jnp.minimum(vmin, bmin),
                jnp.maximum(vmax, bmax),
                finite & bfinite,
                qsum + bqsum,
                my,
                m2y,
                cxy,
                hsum,
                m3,
                m4,
                csum,
            )

        def cross_cov(y, bm, mask=None):
            # (M, M) per-block central cross-product sums.  The GPU's
            # default runs f32 matmuls in TF32: a statistics-bearing
            # Gram needs the full-precision pin.
            if not covariance:
                return jnp.zeros((m, m), jnp.float32)
            d = y - bm[:, None]
            if mask is not None:
                d = jnp.where(mask if mask.ndim == 2 else mask[None, :], d, 0.0)
            with jax.default_matmul_precision("float32"):
                return d @ d.T

        def hi_moments(y, bm, mask=None):
            # (M,) central 3rd/4th power sums; where() BEFORE the powers
            # so off-mask NaN lanes never enter.
            if not moments:
                return czeros, czeros
            d = y - bm[:, None]
            if mask is not None:
                d = jnp.where(mask if mask.ndim == 2 else mask[None, :], d, 0.0)
            d2 = d * d
            return jnp.sum(d2 * d, axis=1), jnp.sum(d2 * d2, axis=1)

        def ctl_full(y, yc, bm):
            if yc is None:
                return (zero, zero, czeros)
            yc = yc.astype(jnp.float32)
            bmy = jnp.mean(yc)
            return (
                bmy,
                jnp.sum(jnp.square(yc - bmy)),
                jnp.sum((y - bm[:, None]) * (yc - bmy)[None, :], axis=1),
            )

        def ctl_partial(y, yc, mask, cntf, bm):
            if yc is None:
                return (zero, zero, czeros)
            yc = yc.astype(jnp.float32)
            bmy = jnp.sum(jnp.where(mask, yc, 0.0)) / cntf
            return (
                bmy,
                jnp.sum(jnp.where(mask, jnp.square(yc - bmy), 0.0)),
                jnp.sum(
                    jnp.where(
                        mask[None, :],
                        (y - bm[:, None]) * (yc - bmy)[None, :],
                        0.0,
                    ),
                    axis=1,
                ),
            )

        def masked_stats(y, cond):
            # Off-condition lanes are never inspected (NaN by design is
            # allowed there, as in the single-sink path).
            condM = cond[None, :]
            cntf = jnp.sum(cond.astype(jnp.float32))
            safe = jnp.maximum(cntf, 1.0)
            bm = jnp.sum(jnp.where(condM, y, 0.0), axis=1) / safe
            bm2 = jnp.sum(
                jnp.where(condM, jnp.square(y - bm[:, None]), 0.0), axis=1
            )
            return (
                cntf,
                bm,
                bm2,
                jnp.min(jnp.where(condM, y, jnp.float32(jnp.inf)), axis=1),
                jnp.max(jnp.where(condM, y, jnp.float32(-jnp.inf)), axis=1),
                jnp.all(jnp.where(condM, jnp.isfinite(y), True)),
            )

        def split(ys):
            y = jnp.stack([v.astype(jnp.float32) for v in ys[:m]])
            aux = ys[m] if aux_node is not None else None
            return y, aux

        def body(b, carry):
            _, ys = run(b, key)
            y, aux = split(ys)
            if where_mode:
                cond = aux != 0
                bn, bm, bm2, bmin, bmax, bfin = masked_stats(y, cond)
                return merge(
                    carry, bn, bm, bm2, bmin, bmax, bfin,
                    qsum_full_many(y), (zero, zero, czeros),
                    hist_many(y, cond),
                    *hi_moments(y, bm, cond[None, :]),
                    cross_cov(y, bm, cond[None, :]),
                )
            bm = jnp.mean(y, axis=1)
            bm2 = jnp.sum(jnp.square(y - bm[:, None]), axis=1)
            return merge(
                carry,
                jnp.float32(block_size),
                bm,
                bm2,
                jnp.min(y, axis=1),
                jnp.max(y, axis=1),
                jnp.all(jnp.isfinite(y)),
                qsum_full_many(y),
                ctl_full(y, aux, bm),
                hist_many(y),
                *hi_moments(y, bm),
                cross_cov(y, bm),
            )

        init = (
            jnp.float32(0.0),
            jnp.zeros((m,), jnp.float32),
            jnp.zeros((m,), jnp.float32),
            jnp.full((m,), jnp.inf, jnp.float32),
            jnp.full((m,), -jnp.inf, jnp.float32),
            jnp.bool_(True),
            jnp.zeros((m, n_levels), jnp.float32),
            jnp.float32(0.0),
            jnp.float32(0.0),
            jnp.zeros((m,), jnp.float32),
            jnp.zeros((2, m, hist_len), jnp.float32),
            jnp.zeros((m,), jnp.float32),
            jnp.zeros((m,), jnp.float32),
            jnp.zeros((m, m), jnp.float32),
        )
        lo = jnp.asarray(block_lo, jnp.int32)
        nb1 = lo + jnp.asarray(n_blocks, jnp.int32) - 1
        carry = jax.lax.fori_loop(lo, nb1, body, init)

        cnt = jnp.asarray(last_count, jnp.int32)
        _, ys = run(nb1, key)
        y, aux = split(ys)
        mask = jnp.arange(block_size, dtype=jnp.int32) < cnt
        if where_mode:
            cond = mask & (aux != 0)
            bn, bm, bm2, bmin, bmax, bfin = masked_stats(y, cond)
            return merge(
                carry, bn, bm, bm2, bmin, bmax, bfin,
                qsum_partial_many(y, mask, cnt), (zero, zero, czeros),
                hist_many(y, cond),
                *hi_moments(y, bm, cond[None, :]),
                cross_cov(y, bm, cond[None, :]),
            )
        maskM = mask[None, :]
        cntf = cnt.astype(jnp.float32)
        bm = jnp.sum(jnp.where(maskM, y, 0.0), axis=1) / cntf
        bm2 = jnp.sum(
            jnp.where(maskM, jnp.square(y - bm[:, None]), 0.0), axis=1
        )
        return merge(
            carry,
            cntf,
            bm,
            bm2,
            jnp.min(jnp.where(maskM, y, jnp.float32(jnp.inf)), axis=1),
            jnp.max(jnp.where(maskM, y, jnp.float32(-jnp.inf)), axis=1),
            jnp.all(jnp.where(maskM, jnp.isfinite(y), True)),
            qsum_partial_many(y, mask, cnt),
            ctl_partial(y, aux, mask, cntf, bm),
            hist_many(y, mask),
            *hi_moments(y, bm, maskM),
            cross_cov(y, bm, maskM),
        )

    if len(_MANY_CACHE) > 32:
        _MANY_CACHE.pop(next(iter(_MANY_CACHE)))
    _MANY_CACHE[cache_key] = all_blocks
    return all_blocks(key, block_lo, n_blocks, last_count)


def _merge_many_carries(carries, control_mu=None):
    """Chan-merge replicate (M,)-vector carries host-side (float64).

    The multi-node analogue of ``_merge_carries``: returns the pooled
    carry plus the per-replicate (M,) mean vectors (control-adjusted
    when a control is active, so the between-replicate sem prices the
    adjusted estimator per node).
    """
    total, my, m2y = 0.0, 0.0, 0.0
    mean = m2 = m3 = m4 = cxy = csum = vmin = vmax = qsum = hsum = None
    finite = True
    rep_means = []
    for (
        t_, m_, m2_, lo_, hi_, f_, q_, my_, m2y_, cxy_, h_, m3_, m4_, c_,
    ) in carries:
        t = float(t_)
        if t <= 0.0:
            continue
        mv = np.asarray(m_, np.float64)
        m2v = np.asarray(m2_, np.float64)
        m3v = np.asarray(m3_, np.float64)
        m4v = np.asarray(m4_, np.float64)
        cxyv = np.asarray(cxy_, np.float64)
        cv = np.asarray(c_, np.float64)
        if mean is None:
            mean = np.zeros_like(mv)
            m2 = np.zeros_like(mv)
            m3 = np.zeros_like(mv)
            m4 = np.zeros_like(mv)
            cxy = np.zeros_like(mv)
            csum = np.zeros_like(cv)
            vmin = np.full_like(mv, np.inf)
            vmax = np.full_like(mv, -np.inf)
        if control_mu is None:
            rep_means.append(mv)
        else:
            rep_means.append(
                np.array(
                    [
                        _control_adjust(
                            mv[i], m2v[i], float(my_), float(m2y_),
                            cxyv[i], control_mu,
                        )[0]
                        for i in range(mv.size)
                    ]
                )
            )
        nn = total + t
        delta = mv - mean
        delta_y = float(my_) - my
        w = total * t / nn
        # Pebay (2008) pairwise M3/M4 (vector over nodes; OLD m2/m3).
        m4 = m4 + m4v + (
            delta**4 * w * (total * total - total * t + t * t) / nn**2
            + 6.0 * delta**2 * (total * total * m2v + t * t * m2) / nn**2
            + 4.0 * delta * (total * m3v - t * m3) / nn
        )
        m3 = m3 + m3v + (
            delta**3 * w * (total - t) / nn
            + 3.0 * delta * (total * m2v - t * m2) / nn
        )
        csum = csum + cv + delta[:, None] * delta[None, :] * w
        mean = mean + delta * t / nn
        m2 = m2 + m2v + delta * delta * w
        my += delta_y * t / nn
        m2y += float(m2y_) + delta_y * delta_y * w
        cxy = cxy + cxyv + delta * delta_y * w
        total = nn
        vmin = np.minimum(vmin, np.asarray(lo_, np.float64))
        vmax = np.maximum(vmax, np.asarray(hi_, np.float64))
        finite = finite and bool(f_)
        q = np.asarray(q_, np.float64)
        qsum = q if qsum is None else qsum + q
        h = np.asarray(h_, np.float64)
        hsum = h if hsum is None else hsum + h
    return (
        (
            total, mean, m2, vmin, vmax, finite, qsum, my, m2y, cxy, hsum,
            m3, m4, csum,
        ),
        rep_means,
    )


def _estimate_sequential_many(
    nodes,
    pilot,
    block_size,
    key,
    method,
    quantiles,
    cvar,
    histogram,
    correlator,
    control_node,
    control_mu,
    where,
    target_sem,
    target_rel_sem,
    max_size,
    moments=False,
    covariance=False,
):
    """Sequential stopping for ``estimate_many``: run until EVERY node
    meets its target.  Round sizes come from the worst node's sem (see
    ``_estimate_sequential``); all rounds share one compiled program.
    """
    carries = []
    drawn, rounds = 0, 0
    chunk = pilot
    while True:
        carries.append(
            jax.device_get(
                _many_carry(
                    nodes,
                    chunk,
                    block_size,
                    jax.random.fold_in(key, rounds),
                    method,
                    quantiles,
                    cvar,
                    histogram,
                    correlator,
                    control_node,
                    where,
                    moments=moments,
                    covariance=covariance,
                )
            )
        )
        drawn += chunk
        rounds += 1
        merged, _ = _merge_many_carries(carries)
        if where is not None and float(merged[0]) <= 0.0:
            if drawn >= max_size:
                raise ValueError(
                    f"where= condition never held across {drawn} draws; "
                    "no conditional statistics exist. Loosen the "
                    "condition or raise size."
                )
            chunk = min(drawn, max_size - drawn)
            continue
        out = _finalize_many(
            nodes, merged, drawn, quantiles, cvar, histogram, control_mu,
            where, moments, covariance,
        )
        # The binding node: the largest sem/target ratio decides both
        # convergence and the next round's size.
        worst = 0.0
        for node in nodes:
            sem = out[node]["sem"]
            tgt = np.inf
            if target_sem is not None:
                tgt = min(tgt, target_sem)
            if target_rel_sem is not None:
                tgt = min(tgt, target_rel_sem * abs(out[node]["mean"]))
            if not np.isfinite(sem):
                worst = np.inf
            elif tgt > 0.0:
                worst = max(worst, sem / tgt)
            else:
                worst = np.inf  # rel target with a zero mean
        converged = bool(np.isfinite(worst) and worst <= 1.0)
        if converged or drawn >= max_size or rounds >= 64:
            for node in nodes:
                out[node]["rounds"] = rounds
                out[node]["converged"] = converged
            return out
        if np.isfinite(worst) and worst > 0.0:
            chunk = drawn * worst**2 * 1.2 - drawn
        else:
            chunk = drawn
        chunk = int(min(chunk, 3.0 * drawn, max_size - drawn))
        chunk = max(chunk, 1)


def _estimate_sequential_many_replicated(
    nodes,
    pilot,
    block_size,
    key,
    method,
    quantiles,
    cvar,
    histogram,
    correlator,
    control_node,
    control_mu,
    where,
    target_sem,
    target_rel_sem,
    max_size,
    moments,
    covariance,
    reps,
):
    """Replicated sequential stopping for ``estimate_many`` (QMC-valid).

    The multi-node analogue of ``_estimate_sequential_replicated``: R
    independently randomised streams grow round by round, the per-node
    stopping statistic is the between-replicate sem of each node's
    pooled replicate means, and the run continues until EVERY watched
    node meets its target (the worst node sizes the next round).  LHS
    chunks are power-of-two quantised (``_round_chunk``) so the
    size-specific LHS program compiles at most log2(max_size) times.
    """
    carries = [[] for _ in range(reps)]
    drawn, rounds = 0, 0
    chunk = _round_chunk(pilot // reps, method, max(1, max_size // reps))
    while True:
        for r in range(reps):
            rk = jax.random.fold_in(jax.random.fold_in(key, r), rounds)
            carries[r].append(
                jax.device_get(
                    _many_carry(
                        nodes,
                        chunk,
                        block_size,
                        rk,
                        method,
                        quantiles,
                        cvar,
                        histogram,
                        correlator,
                        control_node,
                        where,
                        moments=moments,
                        covariance=covariance,
                    )
                )
            )
        drawn += chunk * reps
        rounds += 1
        merged, _ = _merge_many_carries([c for lst in carries for c in lst])
        rep_means = []
        for lst in carries:
            pr, _ = _merge_many_carries(lst)
            if pr[1] is None or float(pr[0]) <= 0.0:
                continue
            mv = np.asarray(pr[1], np.float64)
            if control_mu is None:
                rep_means.append(mv)
            else:
                m2v = np.asarray(pr[2], np.float64)
                cxyv = np.asarray(pr[9], np.float64)
                my_, m2y_ = float(pr[7]), float(pr[8])
                rep_means.append(
                    np.array(
                        [
                            _control_adjust(
                                mv[i], m2v[i], my_, m2y_, cxyv[i],
                                control_mu,
                            )[0]
                            for i in range(mv.size)
                        ]
                    )
                )
        if where is not None and (
            float(merged[0]) <= 0.0 or len(rep_means) < 2
        ):
            if drawn >= max_size:
                if float(merged[0]) <= 0.0:
                    raise ValueError(
                        f"where= condition never held across {drawn} "
                        "draws; no conditional statistics exist. Loosen "
                        "the condition or raise size."
                    )
                raise ValueError(
                    f"Only {len(rep_means)} of {reps} replicates "
                    "accepted any samples within max_size; the "
                    "between-replicate sem needs >= 2."
                )
            chunk = _round_chunk(
                min(drawn // reps, (max_size - drawn) // reps),
                method,
                max(1, (max_size - drawn) // reps),
            )
            continue
        out = _finalize_many(
            nodes, merged, drawn, quantiles, cvar, histogram, control_mu,
            where, moments, covariance,
        )
        rm = np.stack(rep_means)  # (R_kept, M)
        sems = rm.std(axis=0, ddof=1) / np.sqrt(rm.shape[0])
        worst = 0.0
        for i, node in enumerate(nodes):
            out[node]["sem"] = float(sems[i])
            if control_mu is not None:
                out[node]["mean"] = float(rm[:, i].mean())
            tgt = np.inf
            if target_sem is not None:
                tgt = min(tgt, target_sem)
            if target_rel_sem is not None:
                tgt = min(tgt, target_rel_sem * abs(out[node]["mean"]))
            if not np.isfinite(sems[i]):
                worst = np.inf
            elif tgt > 0.0:
                worst = max(worst, sems[i] / tgt)
            else:
                worst = np.inf
        converged = bool(np.isfinite(worst) and worst <= 1.0)
        if converged or drawn >= max_size or rounds >= 64:
            for node in nodes:
                out[node]["rounds"] = rounds
                out[node]["converged"] = converged
                out[node]["replicates"] = reps
            return out
        if np.isfinite(worst) and worst > 0.0:
            need = drawn * worst**2 * 1.2 - drawn
        else:
            need = drawn
        need = min(need, 3.0 * drawn, float(max_size - drawn))
        chunk = _round_chunk(
            int(need) // reps, method, max(1, (max_size - drawn) // reps)
        )


def _finalize_many(
    nodes,
    carry,
    size,
    quantiles=(),
    cvar=(),
    histogram=None,
    control_mu=None,
    where=None,
    moments=False,
    covariance=False,
):
    (
        total_,
        mean_,
        m2_,
        vmin_,
        vmax_,
        finite_,
        qsum_,
        my_,
        m2y_,
        cxy_,
        hsum_,
        m3_,
        m4_,
        csum_,
    ) = jax.device_get(carry)
    if not bool(finite_):
        raise ValueError("Sampling produced non-finite values.")
    total = float(total_)
    if where is not None and total <= 0:
        raise ValueError(
            f"where= condition never held across {size} draws; no "
            "conditional statistics exist. Loosen the condition or "
            "raise size."
        )
    qsum = np.asarray(qsum_, np.float64)
    if histogram is not None:
        pair = np.asarray(hsum_, np.float64)  # (2, M, bins + 2)
        all_counts = np.rint(pair[0] * 2.0**23 + pair[1]).astype(np.int64)
    if covariance:
        cov = np.asarray(csum_, np.float64) / total if total else None
        if cov is not None:
            sd = np.sqrt(np.maximum(np.diag(cov), 0.0))
            denom = np.outer(sd, sd)
            with np.errstate(invalid="ignore", divide="ignore"):
                corr = np.where(denom > 0.0, cov / denom, np.nan)
            # The diagonal is 1 by construction up to f32 rounding.
            np.fill_diagonal(corr, 1.0)
    out = {}
    for i, node in enumerate(nodes):
        var = float(np.asarray(m2_)[i]) / total if total else float("nan")
        stats = {
            "n": int(round(total)) if where is not None else size,
            "mean": float(np.asarray(mean_)[i]),
            "var": var,
            "std": var**0.5,
            "sem": (var / total) ** 0.5 if total else float("nan"),
            "min": float(np.asarray(vmin_)[i]),
            "max": float(np.asarray(vmax_)[i]),
        }
        if moments:
            sd3 = var**1.5
            stats["skew"] = (
                float(np.asarray(m3_)[i]) / total / sd3
                if total and sd3
                else float("nan")
            )
            stats["kurt"] = (
                float(np.asarray(m4_)[i]) / total / var**2 - 3.0
                if total and var
                else float("nan")
            )
        if covariance:
            stats["cov"] = (
                cov[i].copy() if cov is not None else np.full(len(nodes), np.nan)
            )
            stats["corr"] = (
                corr[i].copy()
                if cov is not None
                else np.full(len(nodes), np.nan)
            )
        if where is not None:
            stats["n_total"] = size
            stats["acceptance"] = total / size
        if control_mu is not None:
            adj, factor, beta, rho = _control_adjust(
                stats["mean"],
                float(np.asarray(m2_)[i]),
                float(my_),
                float(m2y_),
                float(np.asarray(cxy_)[i]),
                control_mu,
            )
            stats["mean"] = adj
            stats["sem"] = stats["sem"] * factor**0.5
            stats["control_beta"] = beta
            stats["control_rho"] = rho
            stats["control_mean"] = float(my_)
        for j, level in enumerate(quantiles):
            stats[f"q{level:g}"] = float(qsum[i, j] / total)
        for j, level in enumerate(cvar):
            stats[f"cvar{level:g}"] = float(
                qsum[i, len(quantiles) + j] / total
            )
        if histogram is not None:
            h_lo, h_hi, h_bins = histogram
            counts = all_counts[i]
            stats["histogram"] = {
                "edges": np.linspace(h_lo, h_hi, h_bins + 1),
                "counts": counts[1:-1],
                "underflow": int(counts[0]),
                "overflow": int(counts[-1]),
            }
        out[node] = stats
    return out
