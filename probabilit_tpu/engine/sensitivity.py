"""Parameter sensitivities: ``jax.grad`` through the sampling program.

A capability with no counterpart in the reference (which drives scipy's
``.ppf`` per node, ``modeling.py:805-812`` — opaque to autodiff): because
the whole model here compiles to ONE traced JAX function of its inputs
(``engine/compile.py:build_body``), swapping a distribution's numeric
parameters for traced scalars and differentiating the resulting statistic
gives exact pathwise (reparameterization) derivatives

    d/dtheta  E[ statistic(sink) ],    samples = f(theta, U),  U fixed

at the cost of one extra compiled program — no finite-difference re-runs,
no common-random-number plumbing, and the gradient program runs on the device
like any other.  The estimator is the standard pathwise one: unbiased for
``statistic="mean"``, consistent for smooth functionals; all draws are
common random numbers by construction (the quantile matrix is a function
of the key only).

Supported parameters: numeric scalar ``args``/``kwargs`` of continuous
``Distribution`` nodes with native inverse-CDF kernels (``ops/ppf.py``).
Discrete families are rejected (their ppf is a step function — the
pathwise gradient is zero almost everywhere and would silently misreport
the true sensitivity), as are host-callback fallback families (a
``pure_callback`` has no JVP).
"""

from __future__ import annotations

import numbers

import numpy as np

import jax
import jax.numpy as jnp

from probabilit_tpu import config
from probabilit_tpu.engine import compile as _compile
from probabilit_tpu.engine.sampler import resolve_key
from probabilit_tpu.ops import ppf as _ppf
from probabilit_tpu.ops.qmc import clamp_open_unit

__all__ = [
    "sensitivity",
    "SensitivityResult",
    "sobol_indices",
    "SobolIndices",
]

_GRAD_CACHE = {}
_SOBOL_CACHE = {}
_CACHE_LIMIT = 64

_STATISTICS = {
    "mean": jnp.mean,
    "var": lambda x: jnp.var(x, ddof=1),
    "std": lambda x: jnp.std(x, ddof=1),
}


def _resolve_statistic(statistic):
    """-> (callable, hashable cache key); raises on unknown statistics."""
    if isinstance(statistic, str):
        fn = _STATISTICS.get(statistic)
        if fn is not None:
            return fn, statistic
        if len(statistic) > 4 and statistic.startswith("cvar"):
            # "cvar0.95": expected shortfall via the Rockafellar-Uryasev
            # form ``v + E[max(X - v, 0)] / (1 - q)`` with ``v`` the
            # empirical level quantile — the same ESTIMATOR FAMILY as
            # estimate()'s cvar<level> keys (which apply RU per 2^17-
            # sample row and count-weight the rows, so the two entry
            # points' finite-sample values agree to the row-averaging
            # error, not bitwise).  Its
            # pathwise derivative is the Hong-Liu tail-conditional
            # gradient: the relu's subgradient fixes the tail mask, the
            # indicator's own derivative vanishes a.e., and the dv/dtheta
            # terms cancel to O(1/n) because the tail fraction estimates
            # ``1 - q`` itself.
            try:
                level = float(statistic[4:])
            except ValueError:
                level = None
            if level is not None and 0.0 < level < 1.0:

                def es(x, _level=level):
                    v = jnp.quantile(x, _level)
                    return v + jnp.mean(jnp.maximum(x - v, 0.0)) / (
                        1.0 - _level
                    )

                return es, statistic
        if len(statistic) > 1 and statistic[0] == "q":
            # "q0.95": quantile/VaR level, matching streaming's result keys.
            # jnp.quantile linearly interpolates order statistics, so its
            # pathwise derivative flows through the sort permutation — the
            # standard quantile-sensitivity estimator.
            try:
                level = float(statistic[1:])
            except ValueError:
                level = None
            if level is not None and 0.0 < level < 1.0:
                return (lambda x: jnp.quantile(x, level)), statistic
    elif callable(statistic):
        return statistic, id(statistic)
    raise ValueError(
        f"statistic must be one of {sorted(_STATISTICS)}, 'q<level>' "
        f"(e.g. 'q0.95'), 'cvar<level>' (e.g. 'cvar0.95'), or a callable; "
        f"got {statistic!r}."
    )


class SensitivityResult:
    """Statistic value + gradients, keyed by ``(node, parameter)``.

    ``gradients`` maps ``(node, name_or_position)`` to the float
    derivative of the statistic with respect to that parameter.  With
    ``replicates=R``, ``sems`` holds the between-replicate standard
    error of each gradient (the valid error bar under QMC/antithetic
    streams) and ``value_sem`` that of the statistic itself; both are
    ``None`` otherwise.
    """

    def __init__(self, value, gradients, sems=None, value_sem=None):
        self.value = value
        self.gradients = gradients
        self.sems = sems
        self.value_sem = value_sem

    def __getitem__(self, key):
        return self.gradients[key]

    def __repr__(self):
        rows = ", ".join(
            f"d/d({node!r}, {slot!r})={g:.6g}"
            for (node, slot), g in self.gradients.items()
        )
        return f"SensitivityResult(value={self.value:.6g}, {rows})"


def _is_path_node(node):
    from probabilit_tpu.models.processes import PathDistribution

    return isinstance(node, PathDistribution)


def _numeric_slots(node):
    """The numeric scalar parameter slots of a Distribution/path node."""
    if _is_path_node(node):
        # Named float attributes declared differentiable by the family
        # (jump_rate & co. are excluded there — discrete inner draws
        # have zero pathwise derivative).  Joint multi-asset families
        # list INDEXED slots ("s0[0]", ...) over their parameter vectors.
        return list(node._param_slots)
    slots = []
    for i, a in enumerate(node.args):
        if isinstance(a, numbers.Real) and not isinstance(a, bool):
            slots.append(i)
    for k in node.kwargs:
        v = node.kwargs[k]
        if isinstance(v, numbers.Real) and not isinstance(v, bool):
            slots.append(k)
    return slots


def _validate_family(node):
    from probabilit_tpu.models.distributions import (
        Distribution,
        _scipy_is_multivariate,
    )

    if _is_path_node(node):
        if not node._param_slots:
            raise ValueError(
                f"{type(node).__name__} declares no differentiable "
                "parameters (discrete-valued randomness has zero pathwise "
                "derivative a.e.)."
            )
        return
    if not isinstance(node, Distribution):
        raise TypeError(
            "sensitivity(wrt=...) targets parametric Distribution nodes "
            "or stochastic-process path nodes; "
            f"got {type(node).__name__}."
        )
    name = node.distr
    if _scipy_is_multivariate(name):
        raise ValueError(
            f'"{name}" is multivariate; parameter sensitivities are '
            "supported for univariate continuous families."
        )
    import scipy.stats as sps

    frozen = getattr(sps, name, None)
    if isinstance(frozen, sps.rv_discrete) or isinstance(
        getattr(frozen, "dist", None), sps.rv_discrete
    ):
        raise ValueError(
            f'"{name}" is discrete: its inverse CDF is a step function, so '
            "the pathwise derivative is zero almost everywhere and does not "
            "estimate the true parameter sensitivity (use a smoothed "
            "relaxation or score-function estimator instead)."
        )
    if _ppf.lookup(name) is None:
        raise ValueError(
            f'"{name}" samples through the host scipy fallback, which has '
            "no derivative; sensitivities need a native ppf kernel "
            "(ops/ppf.py)."
        )


def _normalize_wrt(plan, wrt):
    """-> list of (node, slot) pairs, validated against the plan."""
    from probabilit_tpu.models.graph import Node

    if isinstance(wrt, Node):
        wrt = [wrt]
    if isinstance(wrt, dict):
        items = [(node, list(slots)) for node, slots in wrt.items()]
    else:
        items = [(node, None) for node in wrt]

    topo_ids = {n._id for n in plan.topo}
    pairs = []
    for node, slots in items:
        _validate_family(node)
        if node._id not in topo_ids:
            raise ValueError(f"{node!r} is not an ancestor of the sampled node.")
        available = _numeric_slots(node)
        if slots is None:
            slots = available
            if not slots:
                raise ValueError(
                    f"{node!r} has no numeric scalar parameters to "
                    "differentiate (Node-valued parameters are part of the "
                    "graph: target their own leaf distributions instead)."
                )
        for slot in slots:
            if slot not in available:
                raise ValueError(
                    f"{node!r} has no numeric scalar parameter {slot!r}; "
                    f"available: {available}."
                )
            pairs.append((node, slot))
    if not pairs:
        raise ValueError("wrt is empty.")
    return pairs


def _parse_slot(slot):
    """-> (attribute name, element index or None) of a path-node slot.

    Joint multi-asset nodes expose INDEXED slots over their per-asset
    parameter vectors (``"s0[1]"`` is asset 1's spot) — a basket delta
    is one ``sensitivity`` call over d indexed slots.
    """
    if isinstance(slot, str) and slot.endswith("]") and "[" in slot:
        name, idx = slot[:-1].split("[", 1)
        return name, int(idx)
    return slot, None


def _read_slot(node, slot):
    if _is_path_node(node):
        name, idx = _parse_slot(slot)
        attr = getattr(node, name)
        return attr if idx is None else attr[idx]
    if isinstance(slot, int):
        return node.args[slot]
    return node.kwargs[slot]


def _write_slot(node, slot, value):
    if _is_path_node(node):
        name, idx = _parse_slot(slot)
        if idx is None:
            setattr(node, name, value)
        else:
            # Element swap on a vector parameter: functional .at update
            # so several indexed slots of one attribute compose (each
            # write reads the previous traced array).
            cur = getattr(node, name)
            setattr(node, name, jnp.asarray(cur).at[idx].set(value))
    elif isinstance(slot, int):
        args = list(node.args)
        args[slot] = value
        node.args = tuple(args)
    else:
        node.kwargs[slot] = value


def _save_slots(pairs):
    """Original attribute objects to restore after a traced swap.

    Indexed vector slots mutate a SHARED array attribute element-wise
    during the trace; restoring elements would write floats back into a
    traced array, so path-node saves capture the whole original object
    (deduped per attribute) and restore swaps it back verbatim —
    leaving numpy parameter arrays numpy, so static signatures
    (``.tobytes()``) stay valid after the trace.
    """
    saved, seen = [], set()
    for node, slot in pairs:
        if _is_path_node(node):
            name, _ = _parse_slot(slot)
            key = (node._id, name)
            if key not in seen:
                seen.add(key)
                saved.append((node, name, True, getattr(node, name)))
        else:
            saved.append((node, slot, False, _read_slot(node, slot)))
    return saved


def _restore_slots(saved):
    for node, name_or_slot, is_attr, value in saved:
        if is_attr:
            setattr(node, name_or_slot, value)
        else:
            _write_slot(node, name_or_slot, value)


_QMC_METHODS = ("sobol", "halton", "lhs", "antithetic")


def sensitivity(
    sink,
    wrt,
    size=65536,
    random_state=None,
    statistic="mean",
    correlator="imanconover",
    method=None,
    block_size=None,
    replicates=None,
    checkpoint=None,
    checkpoint_every=None,
):
    """Pathwise derivative of ``statistic(sink samples)`` w.r.t. parameters.

    Parameters
    ----------
    sink : Node
        The quantity of interest (any node of the model graph).
    wrt : Distribution | PathDistribution | list | dict[node, list]
        Which parameters to differentiate: whole nodes (all numeric scalar
        parameters) or an explicit per-node list of parameter names /
        positional indices (e.g. ``{x: ["loc", "scale"]}``).  Path nodes
        expose their family's differentiable attributes (GBM: s0/mu/sigma
        — i.e. pathwise Greeks of any path functional; jump counts are
        excluded, their pathwise derivative is zero a.e.).
    size : int
        Monte Carlo sample size for the estimate.
    random_state : None | int | numpy Generator/RandomState | jax key
        Same contract as ``sample()``; fixed draws make the gradient
        deterministic given a seed.
    statistic : "mean" | "var" | "std" | "q<level>" | "cvar<level>" | callable
        Scalar functional of the sink's sample vector.  ``"q0.95"``
        differentiates the 95% quantile (VaR sensitivity); ``"cvar0.95"``
        the expected shortfall above it (CVaR Greeks via the Hong-Liu
        pathwise tail-conditional estimator).  A callable
        receives the traced ``(size,)`` array and must return a scalar
        (it is differentiated through, so it must be jax-traceable).
    correlator : str | Correlator class
        Correlation-induction method for graphs with declared
        correlations, as in ``sample()``.
    method : None | "sobol" | "halton" | "lhs" | "antithetic"
        Quantile generator for the underlying draws.  QMC gradients
        converge like QMC means for smooth sinks; pair with
        ``replicates`` for a valid error bar.
    block_size : None | int
        Streamed gradients: fold the run in device-sized blocks, exactly
        as ``estimate()`` does, accumulating per-block ``jax.vjp``
        cotangents, so ``size`` may be 1e9+.  ``statistic="mean"``
        streams the count-weighted mean of block gradients (exact);
        ``"var"``/``"std"`` stream the bivariate cross co-moment
        ``d Var = 2 sum (x - xbar)(dx - dxbar) / (n-1)`` through the
        same Chan merge (exact); ``"q<level>"``/``"cvar<level>"`` run a
        two-pass scheme — pass 1 streams the level quantile, pass 2
        streams the Hong-Liu conditional gradient mean over the tail
        (CVaR) or a narrow quantile band (VaR) — consistent estimators
        matching the single-shot values at overlapping sizes.  Arbitrary
        callables cannot stream (they need the full sample vector).
        Correlated graphs stream through the generated sort-free
        recoloring (same per-block induction streamed correlated
        ``estimate()`` uses), so the merged gradient is the exact
        gradient of the streamed correlated estimator; this needs a
        correlator with score recoloring (ImanConover/StudentTCopula)
        over monotone inverse-CDF variables.  Device memory stays
        O(block_size); each fold is ONE jitted program with ``size`` a
        traced loop bound, so size sweeps reuse one compiled program.
    replicates : None | int
        Split the run into R independently randomised streams (fresh
        Owen scrambles / rotations / keys) and report the
        between-replicate standard error of every gradient — the valid
        QMC/antithetic error bar (``result.sems``, ``result.value_sem``);
        the reported value/gradients become the replicate averages.
        ``size`` must be divisible by R.
    checkpoint : None | str
        Make a streamed gradient fold resumable (``estimate()``'s
        checkpoint semantics): the run is segmented at fixed block
        boundaries (``checkpoint_every`` draws per segment, default
        64 blocks), each completed segment's raw carry persists to an
        atomic ``.npz``, and a re-run with the SAME model, parameter
        values, sizing and key resumes from the last completed segment
        — finalizing bitwise-identically to the uninterrupted
        (checkpointed) run, because segment block indices are absolute
        and the float64 host merge sees the identical carry sequence.
        Requires ``block_size=`` and ``statistic="mean"/"var"/"std"``
        (the single-pass folds; the two-pass VaR/CVaR scheme re-derives
        its pass-1 quantile from the whole stream), and not
        ``replicates=`` (checkpoint the per-replicate runs instead).
    checkpoint_every : None | int
        Segment length in draws for ``checkpoint=`` (rounded down to
        whole blocks; default 64 blocks).

    Returns
    -------
    SensitivityResult
        ``.value`` — the statistic estimate; ``.gradients`` — dict of
        ``(node, slot) -> d statistic / d parameter``; ``.sems`` /
        ``.value_sem`` — between-replicate standard errors (with
        ``replicates`` only).

    >>> import probabilit_tpu as pt
    >>> x = pt.Distribution("norm", loc=2.0, scale=3.0)
    >>> y = 5 * x + 1
    >>> res = sensitivity(y, wrt=x, size=20000, random_state=0)
    >>> abs(res[(x, "loc")] - 5.0) < 1e-3
    True
    """
    plan = _compile.get_plan(sink)
    pairs = _normalize_wrt(plan, wrt)
    if plan.finalizers.get(sink._id) is not None:
        raise ValueError(
            "The sampled node produces host-finalized (non-numeric) output; "
            "sensitivities need a numeric sink."
        )
    size = int(size)
    if size <= max(1, len(plan.corr_vars)):
        raise ValueError(f"size={size} is too small to estimate a statistic.")

    stat_fn, stat_key = _resolve_statistic(statistic)
    method_name = None if method is None else str(method).lower().strip()
    if method_name is not None:
        if method_name not in _QMC_METHODS:
            raise ValueError(
                f"method must be one of {_QMC_METHODS} or None, got "
                f"{method!r}."
            )
        from probabilit_tpu.engine.streaming import _find_key_seeded

        seeded = _find_key_seeded(plan)
        if seeded is not None:
            raise ValueError(
                f"method={method!r} drives the run from an explicit "
                f"quantile matrix, but {seeded!r} draws from a "
                "column-seeded PRNG key; use method=None for this graph."
            )
        if plan.corr_matrix is not None:
            raise ValueError(
                "QMC sensitivities require a correlation-free graph "
                "(low-discrepancy structure does not survive correlation "
                "induction); use method=None."
            )
    if replicates is not None:
        reps = int(replicates)
        if reps < 2:
            raise ValueError(
                f"replicates must be >= 2 (got {reps}): a single stream "
                "has no between-replicate variance to estimate sems from."
            )
        if size % reps:
            raise ValueError(
                f"size ({size}) must be divisible by replicates ({reps})."
            )
        sub = size // reps
    else:
        reps, sub = None, size

    if checkpoint is not None:
        if block_size is None:
            raise ValueError(
                "checkpoint= applies to streamed gradients only; pass "
                "block_size= (a single-shot program has no mid-run state "
                "worth persisting)."
            )
        if reps is not None:
            raise ValueError(
                "checkpoint= composes with single-stream runs only; "
                "checkpoint the fixed-size runs a replicated scheme "
                "decomposes into instead."
            )
        if statistic not in ("mean", "var", "std"):
            raise ValueError(
                "checkpoint= supports statistic='mean'/'var'/'std' (the "
                "single-pass streamed folds); the two-pass VaR/CVaR "
                "scheme re-derives its pass-1 quantile from the whole "
                "stream and cannot resume from partial carries."
            )
    elif checkpoint_every is not None:
        raise ValueError("checkpoint_every= needs checkpoint=path.")

    correlator_cls = _compile.resolve_correlator(correlator)
    slot_key = tuple((node._id, slot) for node, slot in pairs)
    dtype = config.float_dtype()
    theta0 = jnp.asarray([float(_read_slot(n, s)) for n, s in pairs], dtype)
    key = resolve_key(random_state)

    if block_size is not None:
        block_size = int(block_size)
        tail_kind = None
        tail_level = None
        if isinstance(stat_key, str) and stat_key not in _STATISTICS:
            if stat_key.startswith("cvar"):
                tail_kind, tail_level = "cvar", float(stat_key[4:])
            elif stat_key.startswith("q"):
                tail_kind, tail_level = "q", float(stat_key[1:])
        if stat_key not in ("mean", "var", "std") and tail_kind is None:
            raise ValueError(
                "block_size= (streamed gradients) supports statistic="
                "'mean'/'var'/'std' (exact blockwise Chan folds) and "
                "'q<level>'/'cvar<level>' (two-pass Hong-Liu tail "
                "streams); an arbitrary callable needs the full sample "
                "vector — drop block_size for it."
            )
        if plan.corr_matrix is not None and not _stream_corr_eligible(
            plan, correlator_cls
        ):
            raise ValueError(
                "Streamed sensitivities on a correlated graph run through "
                "the generated sort-free recoloring, which needs a "
                "correlator with per-block score recoloring "
                "(ImanConover/StudentTCopula) over variables with "
                "monotone inverse CDFs; this graph/correlator pair is "
                "not eligible — drop block_size= to differentiate the "
                "single-shot correlated program."
            )
        lhs_total = sub if method_name == "lhs" else None
        n_blocks = -(-sub // block_size)
        last_count = sub - (n_blocks - 1) * block_size
        corr_tok = _compile.correlator_token(correlator_cls)

        if tail_kind is None:
            cache_key = (
                plan.signature(),
                slot_key,
                "stream-" + stat_key,
                block_size,
                method_name,
                lhs_total,
                corr_tok,
                jnp.dtype(dtype).name,
                _compile._active_mesh_key(),
            )
            grad_fn = _GRAD_CACHE.get(cache_key)
            if grad_fn is None:
                if stat_key == "mean":
                    grad_fn = _build_stream_grad_fn(
                        plan, pairs, block_size, method_name, lhs_total,
                        correlator_cls,
                    )
                else:
                    grad_fn = _build_stream_varstd_grad_fn(
                        plan, pairs, block_size, method_name, lhs_total,
                        correlator_cls, stat_key,
                    )
                if len(_GRAD_CACHE) >= _CACHE_LIMIT:
                    _GRAD_CACHE.pop(next(iter(_GRAD_CACHE)))
                _GRAD_CACHE[cache_key] = grad_fn

            if checkpoint is None:

                def run_one(k):
                    carry = jax.device_get(
                        grad_fn(theta0, k, 0, n_blocks, last_count)
                    )
                    return _finalize_stream_grad(stat_key, [carry])

            else:
                import os as _os

                path = str(checkpoint)
                seg_blocks = (
                    64
                    if checkpoint_every is None
                    else max(1, int(checkpoint_every) // block_size)
                )
                n_segs = -(-n_blocks // seg_blocks)
                n_scalars = 2 if stat_key == "mean" else 3

                def run_one(k):
                    fp = _grad_stream_fingerprint(
                        sink, pairs, theta0, sub, block_size, seg_blocks,
                        k, method_name, stat_key, correlator_cls,
                    )
                    carries = (
                        _load_grad_checkpoint(path, fp)
                        if _os.path.exists(path)
                        else []
                    )
                    for s in range(len(carries), n_segs):
                        lo = s * seg_blocks
                        nb = min(seg_blocks, n_blocks - lo)
                        lc = (
                            last_count
                            if lo + nb == n_blocks
                            else block_size
                        )
                        carries.append(
                            tuple(
                                np.asarray(v, np.float64)
                                for v in jax.device_get(
                                    grad_fn(theta0, k, lo, nb, lc)
                                )
                            )
                        )
                        _save_grad_checkpoint(path, fp, carries, n_scalars)
                    out = _finalize_stream_grad(stat_key, carries)
                    try:
                        _os.remove(path)
                    except OSError:
                        pass
                    return out

        else:
            # Two-pass VaR/CVaR stream.  Pass 1 reuses the streamed
            # quantile machinery (estimate()'s whole-run fold, same key
            # and draw tags, so both passes see the same stream); pass 2
            # streams the Hong-Liu band/tail-conditional gradient mean.
            level = tail_level
            if tail_kind == "q":
                # Conditional band around the level: E[g | X = VaR] is
                # estimated over the samples between the (level +/- band)
                # quantiles.  Band width trades O(band) bias against
                # O(1/sqrt(n * band)) noise: the preferred half-width is
                # +/-0.005 of probability, but a ~1000-expected-sample
                # FLOOR (band >= 500/n) takes precedence at small sizes
                # — below ~100k draws the band widens past 0.005 because
                # a noisy conditional mean is worse than the O(band)
                # smoothing bias there.  Either way the band never
                # reaches past halfway to the nearer tail.
                half = min(level / 2.0, (1.0 - level) / 2.0)
                band = min(max(min(0.005, half), 500.0 / sub), half)
                q_levels = (level - band, level, level + band)
                cvar_levels = ()
            else:
                q_levels = (level,)
                cvar_levels = (level,)
            tail_key = (
                plan.signature(),
                slot_key,
                "stream-tail",
                block_size,
                method_name,
                lhs_total,
                corr_tok,
                jnp.dtype(dtype).name,
                _compile._active_mesh_key(),
            )
            tail_fn = _GRAD_CACHE.get(tail_key)
            if tail_fn is None:
                tail_fn = _build_stream_tail_grad_fn(
                    plan, pairs, block_size, method_name, lhs_total,
                    correlator_cls,
                )
                if len(_GRAD_CACHE) >= _CACHE_LIMIT:
                    _GRAD_CACHE.pop(next(iter(_GRAD_CACHE)))
                _GRAD_CACHE[tail_key] = tail_fn

            from probabilit_tpu.engine import streaming as _streaming

            def run_one(k):
                carry = jax.device_get(
                    _streaming._estimate_carry(
                        sink,
                        sub,
                        block_size,
                        k,
                        method_name,
                        q_levels,
                        correlator_cls,
                        cvar=cvar_levels,
                    )
                )
                # Called for its validation only (the fused finite-flag
                # check); pass-1 quantiles are read POSITIONALLY from
                # the raw carry below — the dict's "q%g"-formatted keys
                # collide when the band is narrower than 6 significant
                # digits (e.g. q0.999999 +/- 5e-7), which would silently
                # collapse the conditioning band to a point.
                _streaming._finalize_estimate(
                    carry, sub, q_levels, None, None, cvar_levels
                )
                tails = np.asarray(carry[6], np.float64) / float(carry[0])
                if tail_kind == "q":
                    v_lo, value, v_hi = (float(t) for t in tails[:3])
                else:
                    v_lo = float(tails[0])
                    v_hi = float("inf")
                    value = float(tails[1])
                cnt, gsum = tail_fn(
                    theta0,
                    k,
                    n_blocks,
                    last_count,
                    jnp.asarray(v_lo, jnp.float32),
                    jnp.asarray(v_hi, jnp.float32),
                )
                cnt = float(cnt)
                if cnt <= 0.0:
                    raise ValueError(
                        f"No samples landed in the {stat_key} "
                        "conditioning band/tail; the level is too extreme "
                        "for this size."
                    )
                return value, gsum / cnt

    else:
        cache_key = (
            plan.signature(),
            slot_key,
            stat_key,
            sub,
            method_name,
            _compile.correlator_token(correlator_cls),
            jnp.dtype(dtype).name,
            _compile._active_mesh_key(),
        )
        grad_fn = _GRAD_CACHE.get(cache_key)
        if grad_fn is None:
            grad_fn = _build_grad_fn(
                plan, pairs, stat_fn, sub, correlator_cls, method_name
            )
            if len(_GRAD_CACHE) >= _CACHE_LIMIT:
                _GRAD_CACHE.pop(next(iter(_GRAD_CACHE)))
            _GRAD_CACHE[cache_key] = grad_fn

        def run_one(k):
            return grad_fn(theta0, k)

    try:
        if reps is None:
            value, grads = run_one(key)
            value = float(value)
            grads = np.asarray(grads, np.float64)
            sems, value_sem = None, None
        else:
            vs, gs = [], []
            for r in range(reps):
                v, g = run_one(jax.random.fold_in(key, r))
                vs.append(float(v))
                gs.append(np.asarray(g, np.float64))
            vs = np.asarray(vs)
            gs = np.stack(gs)  # (R, P)
            value = float(vs.mean())
            grads = gs.mean(axis=0)
            value_sem = float(vs.std(ddof=1) / np.sqrt(reps))
            gsem = gs.std(axis=0, ddof=1) / np.sqrt(reps)
            sems = {
                pair: float(s) for pair, s in zip(pairs, gsem)
            }
    except jax.errors.TracerBoolConversionError as exc:  # pragma: no cover
        raise ValueError(
            "A targeted parameter reaches a ppf kernel that branches on its "
            "concrete value, so it cannot be traced for differentiation: "
            f"{exc}"
        ) from None
    if not np.all(np.isfinite(grads)) or not np.isfinite(value):
        raise FloatingPointError(
            "Non-finite sensitivity estimate (value "
            f"{value}, gradients {grads.tolist()}); the statistic or a ppf "
            "kernel is not differentiable at the current parameters."
        )
    return SensitivityResult(
        value,
        {pair: float(g) for pair, g in zip(pairs, grads)},
        sems=sems,
        value_sem=value_sem,
    )


def _build_grad_fn(plan, pairs, stat_fn, size, correlator_cls, method_name=None):
    """Jitted ``value_and_grad`` of the statistic over the sampling body."""
    from probabilit_tpu.ops import qmc as _qmc
    from probabilit_tpu.parallel import mesh as _par_mesh

    sink_id = plan.sink._id
    generated_ok = _compile.recolor_eligible(plan, correlator_cls)
    body = _compile.build_body(
        plan,
        correlator_cls,
        keep_ids=frozenset([sink_id]),
        check_finite=False,
        generated_ok=generated_ok,
    )
    sharding = _par_mesh.sample_sharding(ndim=2)
    d = plan.d
    d_total = plan.d_total
    lhs_total = size if method_name == "lhs" else None

    def value_of(theta, rng_key):
        # Swap the targeted parameters for traced scalars for the duration
        # of the trace (jit caches the traced program, so this Python-level
        # mutation runs once per compilation, never per call) and restore
        # them on every exit path.
        saved = _save_slots(pairs)
        try:
            for (node, slot), th in zip(pairs, theta):
                _write_slot(node, slot, th)
            if method_name is None:
                # Identical draw semantics to sample(method=None)'s
                # in-program RNG path (compile.get_program): same fold_in
                # tag, so the correlated fast path sees the same stream.
                gen_key = jax.random.fold_in(rng_key, 0x0D0E5)
                quantiles = clamp_open_unit(
                    jax.random.uniform(
                        rng_key, (size, d), dtype=config.float_dtype()
                    )
                )
            else:
                # QMC quantile matrix spans d_total so path-node driver
                # slabs are consumed in quantile mode (as in sample()).
                gen_key = None
                quantiles = _qmc.generate(
                    method_name,
                    rng_key,
                    size,
                    d_total,
                    config.float_dtype(),
                    total=lhs_total,
                )
            if sharding is not None:
                quantiles = jax.lax.with_sharding_constraint(quantiles, sharding)
            outputs, _ = body(quantiles, gen_key=gen_key)
            samples = outputs[sink_id]
            if not jnp.issubdtype(samples.dtype, jnp.inexact):
                raise ValueError(
                    "The sampled node is integer-valued; its statistic has "
                    "no parameter derivative."
                )
            return stat_fn(samples)
        finally:
            _restore_slots(saved)

    return jax.jit(jax.value_and_grad(value_of, argnums=0))


def _stream_corr_eligible(plan, correlator_cls):
    """Can this correlated plan stream gradients via generated recoloring?

    Streamed correlated ``estimate()`` recolors every block's scores to
    the exact target with the block's own moments (the sort-free
    Gaussian-copula fast path, ``compile.build_body``); the gradient of
    each recolored block mean is an ordinary per-block VJP, and the
    count-weighted Chan merge of block gradients is the exact gradient
    of the streamed estimator — so the same eligibility rule applies:
    ``compile.recolor_eligible``, single-sourced across entry points.
    """
    return _compile.recolor_eligible(plan, correlator_cls)


def _make_block_sampler(plan, pairs, block_size, method_name, lhs_total, body):
    """``sample_block(theta, key, b) -> (block,) f32 sink samples``.

    The shared draw machinery of every streamed-gradient builder: draw
    semantics match ``estimate()`` exactly (per-block
    threefry folds with ``compile.get_program``'s tags for
    ``method=None``; index-addressable sequence slices at block offsets
    for QMC/antithetic), so streamed values and pass-1/pass-2 splits are
    consistent with the estimation entry points at the same key.
    """
    from probabilit_tpu.ops import qmc as _qmc
    from probabilit_tpu.parallel import mesh as _par_mesh

    sink_id = plan.sink._id
    sharding = _par_mesh.sample_sharding(ndim=2)
    d = plan.d
    d_total = plan.d_total

    def sample_block(theta, key, b):
        saved = _save_slots(pairs)
        try:
            for (node, slot), th in zip(pairs, theta):
                _write_slot(node, slot, th)
            dtype = config.float_dtype()
            if method_name is None:
                rk = jax.random.fold_in(key, b)
                gen_key = jax.random.fold_in(rk, 0x0D0E5)
                q = clamp_open_unit(
                    jax.random.uniform(rk, (block_size, d), dtype=dtype)
                )
            else:
                gen_key = None
                offset = jnp.asarray(b, jnp.uint32) * jnp.uint32(block_size)
                q = _qmc.generate(
                    method_name,
                    key,
                    block_size,
                    d_total,
                    dtype,
                    offset=offset,
                    total=lhs_total,
                )
            if sharding is not None:
                q = jax.lax.with_sharding_constraint(q, sharding)
            outputs, _ = body(q, gen_key=gen_key)
            s = outputs[sink_id]
            if not jnp.issubdtype(s.dtype, jnp.inexact):
                raise ValueError(
                    "The sampled node is integer-valued; its statistic has "
                    "no parameter derivative."
                )
            return s.astype(jnp.float32)
        finally:
            _restore_slots(saved)

    return sample_block


def _build_stream_varstd_grad_fn(
    plan, pairs, block_size, method_name, lhs_total, correlator_cls, stat_key
):
    """Jitted streamed ``(var_or_std, grad)`` fold over blocks.

    The variance gradient decomposes exactly across blocks: with
    ``g_i = d x_i / d theta``,

        d Var / d theta = 2 * sum_i (x_i - xbar)(g_i - gbar) / (n - 1)

    is a bivariate cross co-moment of ``(x, g)`` — the same Chan merge
    ``estimate()``'s control variates carry (streaming.py ``merge``),
    vectorised over the P parameters.  Each block runs ONE forward pass
    plus two VJP pulls (cotangents ``1`` for ``sum g`` and ``x`` for
    ``sum x g``); the carry is ``(n, mean_x, M2_x, mean_g, C_xg)`` with
    the vector entries shaped ``(P,)``.  ``std`` transforms at the end
    (``d std = d var / (2 std)``).  Exact at any size, O(block) memory.
    """
    generated_ok = _stream_corr_eligible(plan, correlator_cls)
    body = _compile.build_body(
        plan,
        correlator_cls,
        keep_ids=frozenset([plan.sink._id]),
        check_finite=False,
        generated_ok=generated_ok,
    )
    sample_block = _make_block_sampler(
        plan, pairs, block_size, method_name, lhs_total, body
    )
    n_pairs = len(pairs)

    def block_stats(theta, key, b, cnt):
        x, vjp = jax.vjp(lambda th: sample_block(th, key, b), theta)
        mask = jnp.arange(block_size, dtype=jnp.int32) < cnt
        maskf = mask.astype(jnp.float32)
        cntf = cnt.astype(jnp.float32)
        # jnp.where, not multiplication: a non-finite draw in an
        # EXCLUDED lane of the final partial block (draws the
        # single-shot estimator never takes) must not poison the fold
        # via 0 * inf = NaN — the streamed-mean path uses the same
        # construction.
        xm = jnp.where(mask, x, 0.0)
        bm = jnp.sum(xm) / cntf
        bm2 = jnp.sum(jnp.where(mask, jnp.square(x - bm), 0.0))
        (gsum,) = vjp(maskf)
        (xg,) = vjp(xm)
        bmg = gsum / cntf
        # sum_valid (x - bm) g  ==  sum_valid (x - bm)(g - bmg).
        bcxg = xg - bm * gsum
        return cntf, bm, bm2, bmg, bcxg

    @jax.jit
    def run(theta, key, block_lo, n_blocks, last_count):
        # ``block_lo``/``n_blocks``/``last_count`` select a WINDOW of
        # the run's absolute block range (checkpointed segments —
        # ``_estimate_carry`` semantics): block indices, and therefore
        # per-block keys and QMC offsets, are absolute, so concatenated
        # window carries Chan-merge to the uninterrupted fold's result.
        # Returns the RAW carry ``(n, mean, M2, mean_g, C_xg)``;
        # ``_finalize_stream_grad`` turns merged carries into the
        # statistic and gradient in float64 host-side.
        def fold(carry, bn, bm, bm2, bmg, bcxg):
            n_prev, mean, m2, mg, cxg = carry
            nn = n_prev + bn
            delta = bm - mean
            delta_g = bmg - mg
            w = n_prev * bn / nn
            return (
                nn,
                mean + delta * bn / nn,
                m2 + bm2 + delta * delta * w,
                mg + delta_g * bn / nn,
                cxg + bcxg + delta * delta_g * w,
            )

        full = jnp.int32(block_size)

        def body_fn(b, carry):
            return fold(carry, *block_stats(theta, key, b, full))

        init = (
            jnp.float32(0.0),
            jnp.float32(0.0),
            jnp.float32(0.0),
            jnp.zeros((n_pairs,), theta.dtype),
            jnp.zeros((n_pairs,), theta.dtype),
        )
        lo = jnp.asarray(block_lo, jnp.int32)
        nb1 = lo + jnp.asarray(n_blocks, jnp.int32) - 1
        carry = jax.lax.fori_loop(lo, nb1, body_fn, init)
        cnt = jnp.asarray(last_count, jnp.int32)
        return fold(carry, *block_stats(theta, key, nb1, cnt))

    return run


def _merge_grad_carries(stat_key, carries):
    """Host-side float64 Chan merge of streamed-gradient window carries.

    The same pairwise merge the device fold applies per block, over the
    per-segment carries of a checkpointed run — identical update, so a
    resumed run finalizes from the identical float64 carry sequence.
    """
    it = iter(carries)
    first = [np.asarray(v, np.float64) for v in next(it)]
    if stat_key == "mean":
        n, mv, mg = first
        for c in it:
            bn, bv, bg = (np.asarray(v, np.float64) for v in c)
            nn = n + bn
            mv = mv + (bv - mv) * bn / nn
            mg = mg + (bg - mg) * bn / nn
            n = nn
        return n, mv, mg
    total, mean, m2, mg, cxg = first
    for c in it:
        bn, bm, bm2, bmg, bcxg = (np.asarray(v, np.float64) for v in c)
        nn = total + bn
        d = bm - mean
        dg = bmg - mg
        w = total * bn / nn
        mean = mean + d * bn / nn
        m2 = m2 + bm2 + d * d * w
        mg = mg + dg * bn / nn
        cxg = cxg + bcxg + d * dg * w
        total = nn
    return total, mean, m2, mg, cxg


def _finalize_stream_grad(stat_key, carries):
    """``(value, (P,) float64 gradient)`` from raw window carries."""
    merged = _merge_grad_carries(stat_key, carries)
    if stat_key == "mean":
        _, mv, mg = merged
        return float(mv), np.asarray(mg, np.float64)
    n, _, m2, _, cxg = merged
    var = float(m2) / (float(n) - 1.0)
    dvar = 2.0 * np.asarray(cxg, np.float64) / (float(n) - 1.0)
    if stat_key == "std":
        sd = float(np.sqrt(var))
        return sd, dvar / (2.0 * sd)
    return var, dvar


def _grad_stream_fingerprint(
    sink, pairs, theta0, size, block_size, seg_blocks, key, method_name,
    stat_key, correlator_cls,
):
    """Cross-process identity of a checkpointable streamed-gradient run.

    Everything that changes the draws, the targeted parameters, or the
    carry layout participates — including the CURRENT parameter values
    (``theta0``): resuming after editing a distribution's parameters
    would splice gradients of two different models.  Targeted pairs are
    encoded by each node's own graph fingerprint + slot name (node ids
    are process-local).
    """
    import hashlib

    from probabilit_tpu import config as _config
    from probabilit_tpu.engine import checkpoint as _ckpt

    parts = [
        _ckpt.graph_fingerprint(sink),
        repr(
            [
                (_ckpt.graph_fingerprint(node), str(slot))
                for node, slot in pairs
            ]
        ),
        repr(
            (
                int(size),
                int(block_size),
                int(seg_blocks),
                method_name,
                stat_key,
                _compile.correlator_token(correlator_cls),
                jnp.dtype(_config.float_dtype()).name,
                _compile._active_mesh_key(),
            )
        ),
        np.asarray(theta0, np.float64).tobytes().hex(),
        np.asarray(jax.random.key_data(key)).tobytes().hex(),
    ]
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()


def _save_grad_checkpoint(path, fingerprint, carries, n_scalars):
    """Atomically persist the per-segment carry list (tmp + replace)."""
    import os

    sc = np.array(
        [[float(c[i]) for i in range(n_scalars)] for c in carries],
        np.float64,
    )
    vec = np.stack(
        [
            np.stack(
                [
                    np.asarray(c[i], np.float64)
                    for i in range(n_scalars, len(c))
                ]
            )
            for c in carries
        ]
    )
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(fh, fingerprint=np.asarray(fingerprint), scalars=sc, vecs=vec)
    os.replace(tmp, path)


def _load_grad_checkpoint(path, fingerprint):
    """-> the saved carry list; refuses a mismatched run."""
    with np.load(path, allow_pickle=False) as data:
        if str(data["fingerprint"]) != fingerprint:
            raise ValueError(
                f"Checkpoint {path!r} belongs to a different run (graph, "
                "targeted parameters or their current values, sizing, "
                "method, statistic, or key differ); delete it to start "
                "fresh."
            )
        sc, vec = data["scalars"], data["vecs"]
    return [
        tuple(sc[i]) + tuple(vec[i]) for i in range(sc.shape[0])
    ]


def _build_stream_tail_grad_fn(
    plan, pairs, block_size, method_name, lhs_total, correlator_cls
):
    """Jitted streamed band/tail gradient sums for VaR/CVaR pass 2.

    ``run(theta, key, n_blocks, last_count, v_lo, v_hi) ->
    (band_count, sum_of_gradients_in_band)``: one VJP pull per block
    with the band indicator ``1{v_lo <= x <= v_hi}`` as the cotangent.
    With ``(v_lo, v_hi) = (VaR_level, +inf)`` the ratio is the Hong-Liu
    tail-conditional gradient mean ``E[dX/dtheta | X >= VaR]`` — the
    pathwise CVaR derivative; a narrow quantile band around the level
    gives the conditional-band estimator of the VaR derivative
    ``E[dX/dtheta | X = VaR]`` (Hong 2009, kernel-free band variant).
    """
    generated_ok = _stream_corr_eligible(plan, correlator_cls)
    body = _compile.build_body(
        plan,
        correlator_cls,
        keep_ids=frozenset([plan.sink._id]),
        check_finite=False,
        generated_ok=generated_ok,
    )
    sample_block = _make_block_sampler(
        plan, pairs, block_size, method_name, lhs_total, body
    )
    n_pairs = len(pairs)

    @jax.jit
    def run(theta, key, n_blocks, last_count, v_lo, v_hi):
        def block_tail(b, cnt):
            x, vjp = jax.vjp(lambda th: sample_block(th, key, b), theta)
            valid = jnp.arange(block_size, dtype=jnp.int32) < cnt
            band = (
                valid & (x >= v_lo) & (x <= v_hi)
            ).astype(jnp.float32)
            (gsum,) = vjp(band)
            return jnp.sum(band), gsum

        full = jnp.int32(block_size)

        def body_fn(b, carry):
            c, g = carry
            bc, bg = block_tail(b, full)
            return (c + bc, g + bg)

        init = (jnp.float32(0.0), jnp.zeros((n_pairs,), theta.dtype))
        nb1 = jnp.asarray(n_blocks, jnp.int32) - 1
        c, g = jax.lax.fori_loop(0, nb1, body_fn, init)
        bc, bg = block_tail(nb1, jnp.asarray(last_count, jnp.int32))
        return c + bc, g + bg

    return run


def _build_stream_grad_fn(
    plan, pairs, block_size, method_name, lhs_total, correlator_cls
):
    """Jitted streamed ``(mean, grad)`` fold over device-sized blocks.

    The gradient of a Chan-merged mean is the count-weighted mean of the
    per-block gradients, so each loop iteration runs ``jax.value_and_grad``
    of the BLOCK mean (reverse-mode differentiation never crosses the
    ``fori_loop`` boundary — which XLA could not differentiate with a
    traced trip count) and the merge itself is plain arithmetic.  Exact
    for ``statistic="mean"`` at any ``size``; memory stays O(block).

    Draw semantics match ``estimate()`` exactly:
    ``method=None`` folds per-block threefry keys through the same
    ``fold_in`` tags as ``compile.get_program``'s in-program RNG, QMC
    methods slice the index-addressable sequence at block offsets — so
    streamed values agree with ``estimate()`` and streamed QMC gradients
    at overlapping sizes are bitwise-consistent with single-shot QMC runs
    of the same prefix.

    Correlated graphs stream through the generated sort-free recolor
    (``compile.build_body``'s fast path), exactly like streamed
    correlated ``estimate()``: each block's VJP differentiates through
    its own recoloring, so the merged gradient is the exact gradient of
    the streamed correlated estimator.
    """
    generated_ok = _stream_corr_eligible(plan, correlator_cls)
    body = _compile.build_body(
        plan,
        correlator_cls,
        keep_ids=frozenset([plan.sink._id]),
        check_finite=False,
        generated_ok=generated_ok,
    )
    sample_block = _make_block_sampler(
        plan, pairs, block_size, method_name, lhs_total, body
    )
    n_pairs = len(pairs)

    def block_mean(theta, key, b, cnt):
        s = sample_block(theta, key, b)
        mask = jnp.arange(block_size, dtype=jnp.int32) < cnt
        return jnp.sum(jnp.where(mask, s, 0.0)) / cnt.astype(jnp.float32)

    vg = jax.value_and_grad(block_mean, argnums=0)

    @jax.jit
    def run(theta, key, block_lo, n_blocks, last_count):
        # Absolute-index window semantics, as in the var/std builder.
        # Returns the RAW carry ``(n, mean, mean_grad)`` for host-side
        # float64 merging/finalizing (``_finalize_stream_grad``).
        def fold(carry, bn, bv, bg):
            n_prev, mv, mg = carry
            nn = n_prev + bn
            return (nn, mv + (bv - mv) * bn / nn, mg + (bg - mg) * bn / nn)

        full = jnp.int32(block_size)

        def body_fn(b, carry):
            bv, bg = vg(theta, key, b, full)
            return fold(carry, jnp.float32(block_size), bv, bg)

        init = (
            jnp.float32(0.0),
            jnp.float32(0.0),
            jnp.zeros((n_pairs,), theta.dtype),
        )
        lo = jnp.asarray(block_lo, jnp.int32)
        nb1 = lo + jnp.asarray(n_blocks, jnp.int32) - 1
        carry = jax.lax.fori_loop(lo, nb1, body_fn, init)
        cnt = jnp.asarray(last_count, jnp.int32)
        bv, bg = vg(theta, key, nb1, cnt)
        return fold(carry, cnt.astype(jnp.float32), bv, bg)

    return run


# =====================================================================
# Variance-based global sensitivity: Sobol' indices
# =====================================================================


class SobolIndices:
    """First-order and total Sobol' indices, keyed by variable node.

    ``first_order[node]`` is the fraction of the sink's variance explained
    by that variable alone; ``total_order[node]`` includes every
    interaction the variable participates in.  Estimates are Monte Carlo
    (may fall slightly outside [0, 1] at small sizes).
    """

    def __init__(
        self,
        variables,
        first_order,
        total_order,
        mean,
        variance,
        size,
        second_order=None,
    ):
        self.variables = list(variables)
        self.first_order = dict(zip(variables, first_order))
        self.total_order = dict(zip(variables, total_order))
        self.mean = mean
        self.variance = variance
        self.size = size
        # Pure pairwise interactions S_ij, keyed by BOTH (a, b) and
        # (b, a); None unless requested (second_order=True).
        self.second_order = second_order

    def __getitem__(self, node):
        return (self.first_order[node], self.total_order[node])

    def __repr__(self):
        rows = ", ".join(
            f"{node!r}: S={self.first_order[node]:.4f} "
            f"ST={self.total_order[node]:.4f}"
            for node in self.variables
        )
        extra = ""
        if self.second_order:
            seen, parts = set(), []
            for (a, b), v in self.second_order.items():
                key = frozenset((id(a), id(b)))
                if key in seen:
                    continue
                seen.add(key)
                parts.append(f"S({a!r},{b!r})={v:.4f}")
            extra = ", " + ", ".join(parts)
        return f"SobolIndices(variance={self.variance:.6g}, {rows}{extra})"


def sobol_indices(
    sink,
    wrt=None,
    size=8192,
    random_state=None,
    method="sobol",
    second_order=False,
):
    """Variance-based global sensitivity of ``sink`` to its variables.

    Pick-freeze (Saltelli) estimation: with base quantile matrices A and
    B, the sink is evaluated on A, B, and on A with variable ``i``'s
    quantile column replaced from B — all ``(2 + k) * size`` model
    evaluations batched into ONE compiled XLA program (the same traced
    body ``sample()`` runs, ``engine/compile.py:build_body``).  First-order
    indices use the Sobol'-Saltelli covariance estimator
    ``S_i = mean(f(B) * (f(AB_i) - f(A))) / Var`` and total indices the
    Jansen estimator ``ST_i = mean((f(A) - f(AB_i))^2) / (2 Var)``
    (Saltelli et al. 2010's recommended pair).  The reference has no
    global-sensitivity capability at all — and at scipy speeds a
    (2+k)-fold evaluation sweep would be prohibitive.

    Parameters
    ----------
    sink : Node
        Quantity of interest.  Must be numeric and must not declare
        correlations (Sobol' indices assume independent inputs; use
        ``sensitivity()`` for parameter derivatives of correlated models).
    wrt : None | Node | list[Node]
        Which variables to attribute variance to.  Default: every initial
        sampling node.  A composite distribution node may also be passed —
        its index then measures its OWN innovation column (the fresh
        randomness it adds), with parameter randomness attributed to its
        ancestor variables.
    size : int
        Evaluations per matrix; total model evaluations = (2 + k) * size.
    random_state : None | int | numpy Generator/RandomState | jax key
        Same contract as ``sample()``.
    method : "sobol" | "halton" | "lhs" | None
        Base-matrix generator.  QMC (default) pairs A and B as the first
        and second halves of one 2d-dimensional low-discrepancy sequence;
        ``None`` uses independent PRNG uniforms.
    second_order : bool
        Also estimate the pure pairwise interactions ``S_ij`` (Saltelli
        2002 closed-pair design: k(k-1)/2 extra frozen matrices join the
        SAME batched program, so total evaluations become
        ``(2 + k + k(k-1)/2) * size``).  ``result.second_order[(a, b)]``
        is the variance fraction of the i-j interaction ALONE
        (``S_ij^closed - S_i - S_j``); as a difference of three Monte
        Carlo estimates it is noisier than S/ST — prefer QMC and
        size >= 2^13 for interactions below ~0.05.

    >>> import probabilit_tpu as pt
    >>> a = pt.Distribution("norm", loc=0.0, scale=2.0)
    >>> b = pt.Distribution("norm", loc=0.0, scale=1.0)
    >>> res = sobol_indices(a + b, size=4096, random_state=0)
    >>> abs(res.first_order[a] - 0.8) < 0.05   # var 4 of total 5
    True
    """
    from probabilit_tpu.models.graph import Node

    plan = _compile.get_plan(sink)
    if plan.corr_matrix is not None:
        raise ValueError(
            "sobol_indices requires independent inputs, but the model "
            "declares correlations; variance attribution under dependence "
            "is not identifiable with pick-freeze estimators."
        )
    if plan.finalizers.get(sink._id) is not None:
        raise ValueError(
            "The sampled node produces host-finalized (non-numeric) "
            "output; Sobol' indices need a numeric sink."
        )

    if wrt is None:
        variables = list(plan.isns)
        if not variables:
            raise ValueError("The model has no sampling nodes.")
    else:
        variables = [wrt] if isinstance(wrt, Node) else list(wrt)
        if not variables:
            raise ValueError("wrt is empty.")
        seen = set()
        for v in variables:
            if v._id not in plan.col_of:
                raise ValueError(
                    f"{v!r} is not a distribution node of the sampled "
                    "graph; Sobol' indices attribute variance to sampling "
                    "nodes (transforms are deterministic given those)."
                )
            if v._id in seen:
                raise ValueError(f"{v!r} appears twice in wrt.")
            seen.add(v._id)
    cols = tuple(plan.columns_of(v) for v in variables)

    size = int(size)
    if size < 4:
        raise ValueError(f"size={size} is too small to estimate variances.")
    method_name = None if method is None else str(method).lower().strip()

    pair_positions = ()
    if second_order:
        k = len(cols)
        if k < 2:
            raise ValueError(
                "second_order needs at least two variables to interact."
            )
        pair_positions = tuple(
            (i, j) for i in range(k) for j in range(i + 1, k)
        )

    fn = _build_sobol_fn(plan, cols, size, method_name, pair_positions)
    key = resolve_key(random_state)
    mean, variance, first, total, closed = (
        np.asarray(v, np.float64) for v in fn(key)
    )
    if not np.isfinite(variance) or variance <= 0.0:
        raise FloatingPointError(
            f"Sink variance estimate is {variance}; Sobol' indices are "
            "undefined for a constant (or non-finite) quantity."
        )
    second = None
    if second_order:
        second = {}
        for (i, j), c in zip(pair_positions, closed):
            s_ij = float(c - first[i] - first[j])
            second[(variables[i], variables[j])] = s_ij
            second[(variables[j], variables[i])] = s_ij
    return SobolIndices(
        variables,
        [float(s) for s in first],
        [float(t) for t in total],
        float(mean),
        float(variance),
        size,
        second_order=second,
    )


def _build_sobol_fn(plan, col_sets, size, method_name, pair_positions=()):
    """Jitted ``key -> (mean, var, S, ST, closed_pairs)`` pick-freeze program.

    ``col_sets[i]`` is variable i's FULL set of quantile columns
    (``Plan.columns_of``): one column for a scalar node, the scalar
    column plus the driver slab for a path node — every column of a
    factor swaps together, and the matrices span ``plan.d_total`` so
    graphs containing path nodes evaluate in quantile mode correctly.
    """
    from probabilit_tpu.ops import qmc as _qmc
    from probabilit_tpu.parallel import mesh as _par_mesh

    cache_key = (
        plan.signature(),
        col_sets,
        size,
        method_name,
        pair_positions,
        jnp.dtype(config.float_dtype()).name,
        _compile._active_mesh_key(),
    )
    cached = _SOBOL_CACHE.get(cache_key)
    if cached is not None:
        return cached

    correlator_cls = _compile.resolve_correlator("imanconover")
    sink_id = plan.sink._id
    body = _compile.build_body(
        plan,
        correlator_cls,
        keep_ids=frozenset([sink_id]),
        check_finite=False,
        generated_ok=False,
    )
    sharding = _par_mesh.sample_sharding(ndim=2)
    d = plan.d_total
    k = len(col_sets)
    hot_np = np.zeros((k, 1, d), np.float32)
    for i, cs in enumerate(col_sets):
        hot_np[i, 0, list(cs)] = 1.0

    def run(key):
        dtype = config.float_dtype()
        if method_name is None:
            ka, kb = jax.random.split(key)
            A = clamp_open_unit(jax.random.uniform(ka, (size, d), dtype=dtype))
            B = clamp_open_unit(jax.random.uniform(kb, (size, d), dtype=dtype))
        else:
            # One 2d-dimensional low-discrepancy stream: dimension j of A
            # pairs with dimension d+j of B, the standard Saltelli design
            # (keeps the A/B pairing itself low-discrepancy).
            AB = _qmc.generate(method_name, key, size, 2 * d, dtype=dtype)
            A, B = AB[:, :d], AB[:, d:]
        # (k, size, d): copy i replaces variable i's column set with B's.
        hot = jnp.asarray(hot_np, dtype)
        AB_i = A[None, :, :] * (1.0 - hot) + B[None, :, :] * hot
        parts = [A[None], B[None], AB_i]
        n_pairs = len(pair_positions)
        if n_pairs:
            # Saltelli-2002 closed pairs: A with BOTH variables' column
            # sets taken from B, appended to the same batched program.
            hot2_np = np.zeros((n_pairs, 1, d), np.float32)
            for row, (i, j) in enumerate(pair_positions):
                hot2_np[row, 0, list(col_sets[i]) + list(col_sets[j])] = 1.0
            hot2 = jnp.asarray(hot2_np, dtype)
            parts.append(A[None, :, :] * (1.0 - hot2) + B[None, :, :] * hot2)
        stacked = jnp.concatenate(parts, axis=0)
        stacked = stacked.reshape((2 + k + n_pairs) * size, d)
        if sharding is not None:
            stacked = jax.lax.with_sharding_constraint(stacked, sharding)
        outputs, _ = body(stacked)
        y = outputs[sink_id]
        if not jnp.issubdtype(y.dtype, jnp.inexact):
            y = y.astype(dtype)
        y = y.reshape(2 + k + n_pairs, size)
        fA, fB, fAB = y[0], y[1], y[2 : 2 + k]
        both = jnp.concatenate([fA, fB])
        mean = jnp.mean(both)
        variance = jnp.var(both, ddof=1)
        first = jnp.mean(fB[None, :] * (fAB - fA[None, :]), axis=1) / variance
        total = 0.5 * jnp.mean((fA[None, :] - fAB) ** 2, axis=1) / variance
        if n_pairs:
            fABij = y[2 + k :]
            closed = (
                jnp.mean(fB[None, :] * (fABij - fA[None, :]), axis=1) / variance
            )
        else:
            closed = jnp.zeros((0,), dtype)
        return mean, variance, first, total, closed

    fn = jax.jit(run)
    if len(_SOBOL_CACHE) >= _CACHE_LIMIT:
        _SOBOL_CACHE.pop(next(iter(_SOBOL_CACHE)))
    _SOBOL_CACHE[cache_key] = fn
    return fn
