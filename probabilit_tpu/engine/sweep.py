"""Batched scenario sweeps: many parameterizations, ONE compiled program.

Stress testing and what-if analysis evaluate the SAME model under a grid
of parameter scenarios (spot ladders, vol shocks, rate bumps).  The
reference re-runs its whole scipy sampling loop per scenario
(modeling.py:805-812 — every ``.sample()`` is a fresh host pass); here
the scenario axis becomes a ``jax.vmap`` batch dimension over the traced
sampling body (``engine/compile.py:build_body``) with the targeted
parameters swapped for traced scalars (the ``engine/sensitivity.py``
slot machinery), so S scenarios x N draws run as one XLA program whose
inner reductions batch on the device — no per-scenario dispatch, no
per-scenario compile.

Common random numbers are the default: every scenario consumes the SAME
quantile matrix, so scenario-to-scenario differences are smooth in the
parameters (the standard CRN argument — differences of estimates have
variance O(delta^2), not O(1)), ladders are monotone where the model is,
and the draws are generated once.  ``common_random_numbers=False`` gives
each scenario an independently keyed stream instead (fresh Owen
scrambles under QMC), at (S, size, d) quantile memory.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from probabilit_tpu import config
from probabilit_tpu.engine import compile as _compile
from probabilit_tpu.engine.sampler import resolve_key
from probabilit_tpu.engine.sensitivity import (
    _QMC_METHODS,
    _normalize_wrt,
    _resolve_statistic,
    _restore_slots,
    _save_slots,
    _write_slot,
)
from probabilit_tpu.ops import qmc as _qmc
from probabilit_tpu.ops.qmc import clamp_open_unit

__all__ = ["sweep", "SweepResult"]

_SWEEP_CACHE = {}
_CACHE_LIMIT = 64


class SweepResult:
    """Per-scenario statistics, keyed by statistic name.

    ``result["mean"]`` is the ``(S,)`` array of scenario means in input
    order; ``result.scenarios`` maps each ``(node, slot)`` pair to its
    ``(S,)`` value vector; ``result.n`` is the scenario count.  When
    ``"mean"`` is among the requested statistics, ``result["sem"]`` holds
    each scenario's iid standard error (under CRN, scenario DIFFERENCES
    are far more accurate than these marginal bars suggest).  Under
    ``method="sobol"/"halton"/"lhs"`` the iid formula is not a valid
    error bar and ``"sem"`` is omitted unless ``replicates=`` supplies
    the between-replicate estimate (``"antithetic"`` keeps the iid sem
    as a conservative overestimate).
    """

    def __init__(self, stats, scenarios, size):
        self.stats = stats
        self.scenarios = scenarios
        self.n = len(next(iter(scenarios.values())))
        self.size = size

    def __getitem__(self, key):
        return self.stats[key]

    def keys(self):
        return self.stats.keys()

    def __repr__(self):
        names = ", ".join(self.stats)
        return (
            f"SweepResult({self.n} scenarios x {self.size} draws; "
            f"statistics: {names})"
        )


def _normalize_scenarios(plan, scenarios):
    """-> (pairs in canonical order, (S, P) float64 value matrix)."""
    if not isinstance(scenarios, dict) or not scenarios:
        raise ValueError(
            "scenarios must be a non-empty dict: {(node, slot): values} "
            "or {node: {slot: values}}."
        )
    flat = {}

    def put(pair, vals):
        # The two accepted key forms ((node, slot) tuples and nested
        # {node: {slot: ...}}) can name the same parameter; silently
        # letting the later entry win would sweep different values than
        # the user wrote down.
        if pair in flat:
            raise ValueError(
                f"scenario parameter {pair} is specified more than once "
                "(mixing the (node, slot) and {node: {slot: ...}} forms?)."
            )
        flat[pair] = vals

    for k, v in scenarios.items():
        if isinstance(k, tuple) and len(k) == 2:
            put(k, v)
        elif isinstance(v, dict):
            for slot, vals in v.items():
                put((k, slot), vals)
        else:
            raise ValueError(
                "scenario keys must be (node, slot) tuples, or node keys "
                "with {slot: values} dict values; got "
                f"{type(k).__name__}: {type(v).__name__}."
            )
    wrt = {}
    for node, slot in flat:
        wrt.setdefault(node, []).append(slot)
    pairs = _normalize_wrt(plan, wrt)  # validates nodes/slots, canonical order
    cols, lengths = [], set()
    for pair in pairs:
        vals = np.atleast_1d(np.asarray(flat[pair], np.float64))
        if vals.ndim != 1:
            raise ValueError(
                f"scenario values for {pair} must be scalar or 1-D, got "
                f"shape {vals.shape}."
            )
        if not np.all(np.isfinite(vals)):
            raise ValueError(f"scenario values for {pair} contain non-finite entries.")
        cols.append(vals)
        if vals.size > 1:
            lengths.add(vals.size)
    if len(lengths) > 1:
        raise ValueError(
            f"scenario value vectors disagree on length: {sorted(lengths)}. "
            "Broadcast your grid first (np.meshgrid(...) then .ravel())."
        )
    s = lengths.pop() if lengths else 1
    theta = np.stack([np.broadcast_to(c, (s,)) for c in cols], axis=1)
    return pairs, theta


def sweep(
    sink,
    scenarios,
    size=65536,
    random_state=None,
    statistics="mean",
    correlator="imanconover",
    method=None,
    common_random_numbers=True,
    block_size=None,
    replicates=None,
    target_sem=None,
    max_size=None,
):
    """Evaluate statistics of ``sink`` under S parameter scenarios at once.

    Parameters
    ----------
    sink : Node
        The quantity of interest.
    scenarios : dict
        ``{(node, slot): values}`` or ``{node: {slot: values}}`` — each
        ``values`` a length-S vector (scalars broadcast).  Slots are the
        same numeric parameter slots ``sensitivity()`` accepts, including
        indexed multi-asset slots (``"s0[1]"``).  For a full grid over
        several slots, ravel a meshgrid:
        ``np.meshgrid(spots, vols)`` then pass the ``.ravel()``ed arrays.
    size : int
        Draws per scenario.
    random_state : None | int | Generator | jax key
        Same contract as ``sample()``.
    statistics : str | callable | sequence of those
        Any mix of ``"mean"``/``"var"``/``"std"``/``"q<level>"``/
        ``"cvar<level>"`` (expected shortfall above the level) or
        jax-traceable callables of the ``(size,)`` sample vector.  When
        ``"mean"`` is requested, a per-scenario ``"sem"`` rides along —
        except under ``method="sobol"/"halton"/"lhs"`` without
        ``replicates=``, where the iid formula is not a valid error bar
        and no ``"sem"`` key is returned (use ``replicates=R`` for
        between-replicate ``<stat>_sem`` bars instead).
    correlator : str | Correlator class
        As in ``sample()`` for graphs with declared correlations.
    method : None | "sobol" | "halton" | "lhs" | "antithetic"
        Quantile generator.  Single-shot QMC composes with correlated
        graphs exactly as ``sample(method=...)`` does (the correlator
        consumes the low-discrepancy quantile matrix inside the same
        program); STREAMED QMC (``block_size=``) requires a
        correlation-free graph.
    common_random_numbers : bool
        True (default): all scenarios share ONE quantile matrix — the
        variance-optimal choice for scenario differences/ladders, and
        O(size * d) memory.  False: independent streams per scenario
        (fresh keys; fresh randomizations under QMC) at (S, size, d)
        memory — use for strictly independent per-scenario error bars.
    block_size : None | int
        Streamed sweeps: fold each scenario's statistics through
        blocked Chan carries (``estimate()``'s machinery, vmapped over
        scenarios), so ``size`` may be 1e8+ per scenario with device
        memory O(S * block_size).  Supports ``"mean"``/``"var"``/
        ``"std"`` (exact streamed moments) and ``"q<level>"``/
        ``"cvar<level>"`` (per-block batched row sorts, the same
        row-averaged estimator ``estimate(quantiles=...)`` uses, with
        one row per block per scenario); callables cannot stream.
        CRN still holds per block (every scenario consumes the same
        per-block draws), so scenario differences stay
        bitwise-deterministic given the key.  The whole fold is ONE
        jitted program with ``size`` a traced loop bound.
    replicates : None | int
        Split the run into R independently randomised streams (fresh
        scrambles/keys; each replicate is CRN across scenarios) and
        report between-replicate standard errors: every requested
        statistic ``name`` gains a ``name + "_sem"`` entry — the valid
        error bar under QMC/antithetic — and the reported statistics
        become replicate averages.  ``"sem"`` aliases ``"mean_sem"``
        when ``"mean"`` is requested.  ``size`` must be divisible by R.
    target_sem : None | float
        Sequential (precision-targeted) sweeping: keep adding rounds of
        ``size`` draws per scenario until the between-replicate sem of
        EVERY requested statistic at EVERY scenario is ``<= target_sem``
        (the worst column sizes the next batch of rounds,
        Chow-Robbins-style).  Requires ``replicates=R`` — the replicate
        bar is the error estimate that stays valid under every
        ``method=`` including QMC — and named statistics (pooling
        averages equal-size round estimates, exact for ``"mean"``/
        ``"var"`` and the same round-averaged estimator the streamed
        quantile/cvar path already uses; a callable's statistic need
        not decompose that way).  Every round reuses the ONE compiled
        program — the round size never changes, so even the
        size-specific LHS program compiles once.  The result gains
        ``.rounds`` / ``.converged`` attributes and reports
        per-scenario totals in ``.size``.
    max_size : None | int
        Per-scenario draw budget for ``target_sem=`` (default
        ``64 * size``); the run stops unconverged at the cap.

    Returns
    -------
    SweepResult
        ``result[stat_name]`` -> ``(S,)`` numpy array, scenario order
        preserved.

    >>> import numpy as np, probabilit_tpu as pt
    >>> x = pt.Distribution("norm", loc=0.0, scale=1.0)
    >>> y = 2.0 * x + 1.0
    >>> res = pt.sweep(y, {(x, "loc"): np.array([-1.0, 0.0, 1.0])},
    ...                size=4096, random_state=0)
    >>> bool(np.all(np.diff(res["mean"]) > 0))
    True
    """
    plan = _compile.get_plan(sink)
    if plan.finalizers.get(sink._id) is not None:
        raise ValueError(
            "The swept node produces host-finalized (non-numeric) output; "
            "sweeps need a numeric sink."
        )
    pairs, theta_np = _normalize_scenarios(plan, scenarios)
    size = int(size)
    if size <= max(1, len(plan.corr_vars)):
        raise ValueError(f"size={size} is too small to estimate a statistic.")

    if isinstance(statistics, str) or callable(statistics):
        statistics = (statistics,)
    stat_fns, stat_keys = [], []
    for s in statistics:
        fn, k = _resolve_statistic(s)
        stat_fns.append(fn)
        stat_keys.append(k)
    names = [k if isinstance(k, str) else f"stat{i}" for i, k in enumerate(stat_keys)]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate statistics requested: {names}.")

    method_name = None if method is None else str(method).lower().strip()
    # The iid sem formula is not a valid error bar for low-discrepancy
    # points (their deliberate dependence makes std/sqrt(n) meaningless —
    # the same reason estimate() rejects sem-based stopping under QMC), so
    # it is omitted for those methods; for "antithetic" it is reported as
    # a conservative overestimate.  QMC error bars come from replicates=.
    with_sem = "mean" in names and method_name not in ("sobol", "halton", "lhs")
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
        if plan.corr_matrix is not None and block_size is not None:
            # Single-shot QMC + correlation works exactly as
            # sample(method=...) does (quantile-driven correlator inside
            # the same program); the STREAMED variant would recolor per
            # block and break the one-long-sequence contract.
            raise ValueError(
                "Streamed QMC sweeps require a correlation-free graph; "
                "use method=None for streamed correlated sweeps or drop "
                "block_size=."
            )

    correlator_cls = _compile.resolve_correlator(correlator)
    dtype = config.float_dtype()
    slot_key = tuple((node._id, slot) for node, slot in pairs)
    crn = bool(common_random_numbers)
    key = resolve_key(random_state)
    theta = jnp.asarray(theta_np, dtype)

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
    inner_sem = with_sem and reps is None

    if target_sem is not None:
        if not (float(target_sem) > 0.0):
            raise ValueError(f"target_sem must be > 0, got {target_sem}.")
        if reps is None:
            raise ValueError(
                "target_sem needs replicates=R (e.g. replicates=8): the "
                "between-replicate sem of R independently randomised CRN "
                "streams is the stopping statistic that stays valid for "
                "every statistic and every method= (including QMC)."
            )
        if any(not isinstance(k, str) for k in stat_keys):
            raise ValueError(
                "target_sem supports named statistics only ('mean'/'var'/"
                "'std'/'q<level>'/'cvar<level>'): sequential rounds pool "
                "by averaging equal-size round estimates, which a "
                "callable's statistic need not permit."
            )
        max_size = 64 * size if max_size is None else int(max_size)
        if max_size < size:
            raise ValueError(
                f"max_size ({max_size}) must be >= the per-round size "
                f"({size})."
            )
    elif max_size is not None:
        raise ValueError("max_size= only applies with target_sem=.")

    if block_size is not None:
        block_size = int(block_size)
        if plan.corr_matrix is not None and not _compile.recolor_eligible(
            plan, correlator_cls
        ):
            raise ValueError(
                "Streamed sweeps on a correlated graph need the generated "
                "sort-free recoloring (ImanConover/StudentTCopula over "
                "monotone inverse-CDF variables); drop block_size= for "
                "the single-shot correlated program."
            )
        q_levels, cvar_levels = [], []
        for k in stat_keys:
            if not isinstance(k, str):
                raise ValueError(
                    "Streamed sweeps (block_size=) support named "
                    "statistics only ('mean'/'var'/'std'/'q<level>'/"
                    "'cvar<level>'); a callable needs the full sample "
                    "vector — drop block_size for it."
                )
            if k in ("mean", "var", "std"):
                continue
            if k.startswith("cvar"):
                cvar_levels.append(float(k[4:]))
            else:  # validated by _resolve_statistic: q<level>
                q_levels.append(float(k[1:]))
        q_levels, cvar_levels = tuple(q_levels), tuple(cvar_levels)
        lhs_total = sub if method_name == "lhs" else None
        n_blocks = -(-sub // block_size)
        last_count = sub - (n_blocks - 1) * block_size
        cache_key = (
            plan.signature(),
            slot_key,
            "stream",
            q_levels,
            cvar_levels,
            block_size,
            method_name,
            lhs_total,
            crn,
            _compile.correlator_token(correlator_cls),
            jnp.dtype(dtype).name,
            _compile._active_mesh_key(),
        )
        run = _SWEEP_CACHE.get(cache_key)
        if run is None:
            run = _build_stream_sweep_fn(
                plan, pairs, block_size, method_name, lhs_total,
                correlator_cls, crn, q_levels, cvar_levels,
            )
            if len(_SWEEP_CACHE) >= _CACHE_LIMIT:
                _SWEEP_CACHE.pop(next(iter(_SWEEP_CACHE)))
            _SWEEP_CACHE[cache_key] = run

        def run_stats(k):
            n_, mean_, var_, tails_ = (
                np.asarray(v, np.float64)
                for v in jax.device_get(run(theta, k, n_blocks, last_count))
            )
            cols = {}
            for name in names:
                if name == "mean":
                    cols[name] = mean_
                elif name == "var":
                    cols[name] = var_
                elif name == "std":
                    cols[name] = np.sqrt(var_)
                elif name.startswith("cvar"):
                    j = len(q_levels) + cvar_levels.index(float(name[4:]))
                    cols[name] = tails_[:, j]
                else:
                    cols[name] = tails_[:, q_levels.index(float(name[1:]))]
            if inner_sem:
                cols["sem"] = np.sqrt(var_ / n_)
            return cols

    else:
        cache_key = (
            plan.signature(),
            slot_key,
            tuple(stat_keys),
            inner_sem,
            sub,
            theta_np.shape[0],
            method_name,
            crn,
            _compile.correlator_token(correlator_cls),
            jnp.dtype(dtype).name,
            _compile._active_mesh_key(),
        )
        run = _SWEEP_CACHE.get(cache_key)
        if run is None:
            run = _build_sweep_fn(
                plan, pairs, stat_fns, inner_sem, sub, correlator_cls,
                method_name, crn,
            )
            if len(_SWEEP_CACHE) >= _CACHE_LIMIT:
                _SWEEP_CACHE.pop(next(iter(_SWEEP_CACHE)))
            _SWEEP_CACHE[cache_key] = run

        def run_stats(k):
            out = jax.device_get(run(theta, k))
            return {
                name: np.asarray(col, np.float64)
                for name, col in zip(
                    names + (["sem"] if inner_sem else []), out
                )
            }

    seq_rounds, seq_converged = None, None
    if target_sem is not None:
        # Sequential sweep: rounds of R replicate streams (each CRN
        # across scenarios), pooled per replicate by plain averaging —
        # exact for mean/var over equal-size rounds, and the same
        # round-averaged estimator the streamed path uses for
        # quantiles/cvar.  The round size is FIXED so every round hits
        # the one compiled program (the LHS program is size-specific —
        # growing round sizes would recompile per round); Chow-Robbins
        # on the worst statistic column decides how many rounds to add.
        per = [[] for _ in range(reps)]
        rounds_done, add = 0, 1
        max_rounds = min(max_size // size, 64)
        while True:
            for _ in range(add):
                for r in range(reps):
                    rk = jax.random.fold_in(
                        jax.random.fold_in(key, r), rounds_done
                    )
                    per[r].append(run_stats(rk))
                rounds_done += 1
            rep_cols = [
                {
                    name: np.mean(
                        np.stack([d[name] for d in lst]), axis=0
                    )
                    for name in lst[0]
                }
                for lst in per
            ]
            stats = {}
            worst = 0.0
            for name in rep_cols[0]:
                arr = np.stack([c[name] for c in rep_cols])
                stats[name] = arr.mean(axis=0)
                sem_col = arr.std(axis=0, ddof=1) / np.sqrt(reps)
                stats[name + "_sem"] = sem_col
                if np.all(np.isfinite(sem_col)):
                    worst = max(
                        worst, float(sem_col.max()) / float(target_sem)
                    )
                else:
                    worst = np.inf
            if "mean" in stats:
                stats["sem"] = stats["mean_sem"]
            converged = bool(np.isfinite(worst) and worst <= 1.0)
            if converged or rounds_done >= max_rounds:
                break
            if np.isfinite(worst) and worst > 0.0:
                need = rounds_done * worst * worst * 1.2 - rounds_done
            else:
                need = rounds_done
            add = int(
                min(
                    max(need, 1.0),
                    3.0 * rounds_done,
                    max_rounds - rounds_done,
                )
            )
            add = max(add, 1)
        seq_rounds, seq_converged = rounds_done, converged
        size = size * rounds_done  # per-scenario total actually drawn
    elif reps is None:
        stats = run_stats(key)
    else:
        # R independently randomised streams, each CRN across scenarios:
        # the between-replicate spread is the valid error bar for EVERY
        # requested statistic, under any method (incl. QMC).
        per = [run_stats(jax.random.fold_in(key, r)) for r in range(reps)]
        stats = {}
        for name in per[0]:
            arr = np.stack([p[name] for p in per])
            stats[name] = arr.mean(axis=0)
            stats[name + "_sem"] = arr.std(axis=0, ddof=1) / np.sqrt(reps)
        if "mean" in stats:
            stats["sem"] = stats["mean_sem"]
    bad = {k: v for k, v in stats.items() if not np.all(np.isfinite(v))}
    if bad:
        raise FloatingPointError(
            "Non-finite sweep statistics for "
            f"{sorted(bad)}; a scenario pushed a parameter outside its "
            "family's valid domain (e.g. a non-positive scale)."
        )
    res = SweepResult(
        stats,
        {pair: theta_np[:, j].copy() for j, pair in enumerate(pairs)},
        size,
    )
    if seq_rounds is not None:
        res.rounds = seq_rounds
        res.converged = seq_converged
    return res


def _build_sweep_fn(
    plan, pairs, stat_fns, with_sem, size, correlator_cls, method_name, crn
):
    """Jitted ``(theta (S,P), key) -> tuple of (S,) statistic arrays``."""
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
    sharding = _par_mesh.sample_sharding(ndim=2) if crn else None
    d = plan.d
    d_total = plan.d_total
    lhs_total = size if method_name == "lhs" else None

    def make_quantiles(rng_key):
        if method_name is None:
            gen_key = jax.random.fold_in(rng_key, 0x0D0E5)
            q = clamp_open_unit(
                jax.random.uniform(rng_key, (size, d), dtype=config.float_dtype())
            )
            return q, gen_key
        return (
            _qmc.generate(
                method_name, rng_key, size, d_total,
                config.float_dtype(), total=lhs_total,
            ),
            None,
        )

    def stats_of(theta, quantiles, gen_key):
        # Traced parameter swap exactly as sensitivity()'s value_of: the
        # Python-level mutation runs once per TRACE, restored on exit.
        saved = _save_slots(pairs)
        try:
            for (node, slot), th in zip(pairs, theta):
                _write_slot(node, slot, th)
            outputs, _ = body(quantiles, gen_key=gen_key)
            samples = outputs[sink_id]
            if not jnp.issubdtype(samples.dtype, jnp.inexact):
                raise ValueError(
                    "The swept node is integer-valued; cast it "
                    "(node * 1.0) to sweep real-valued statistics."
                )
            vals = tuple(f(samples) for f in stat_fns)
            if with_sem:
                vals = vals + (
                    jnp.std(samples, ddof=1) / jnp.sqrt(jnp.float32(size)),
                )
            return vals
        finally:
            _restore_slots(saved)

    if crn:

        @jax.jit
        def run(theta, key):
            quantiles, gen_key = make_quantiles(key)
            if sharding is not None:
                quantiles = jax.lax.with_sharding_constraint(quantiles, sharding)
            return jax.vmap(stats_of, in_axes=(0, None, None))(
                theta, quantiles, gen_key
            )

    else:

        @jax.jit
        def run(theta, key):
            keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
                jnp.arange(theta.shape[0], dtype=jnp.uint32)
            )

            def one(th, k):
                quantiles, gen_key = make_quantiles(k)
                return stats_of(th, quantiles, gen_key)

            return jax.vmap(one)(theta, keys)

    return run


def _build_stream_sweep_fn(
    plan, pairs, block_size, method_name, lhs_total, correlator_cls, crn,
    q_levels, cvar_levels,
):
    """Jitted streamed sweep fold: scenarios vmapped, blocks Chan-merged.

    ``run(theta (S,P), key, n_blocks, last_count) -> (n, mean (S,),
    var (S,), tails (S, L))`` with ``L = len(q_levels) + len(cvar_levels)``.
    Each block evaluates every scenario on the SAME draws (CRN; or
    per-scenario keyed streams with ``crn=False``) and folds per-scenario
    means/M2s through the scalar Chan merge; quantile/CVaR levels ride
    one batched row sort per block over the ``(S, block)`` matrix — the
    row-averaged estimator of ``estimate(quantiles=...)`` with one row
    per block per scenario (``_quantile_accumulators_many`` with the
    scenario axis playing the node axis).  ``size`` enters only through
    the traced loop bounds, so size sweeps reuse one compiled program.
    """
    from probabilit_tpu.engine.streaming import _quantile_accumulators_many
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
    sharding = _par_mesh.sample_sharding(ndim=2) if crn else None
    d = plan.d
    d_total = plan.d_total
    qacc_full, qacc_partial = _quantile_accumulators_many(
        q_levels, block_size, cvar_levels
    )
    n_levels = len(q_levels) + len(cvar_levels)

    def block_quantiles(rng_key, b):
        if method_name is None:
            rk = jax.random.fold_in(rng_key, b)
            gen_key = jax.random.fold_in(rk, 0x0D0E5)
            q = clamp_open_unit(
                jax.random.uniform(
                    rk, (block_size, d), dtype=config.float_dtype()
                )
            )
            return q, gen_key
        offset = jnp.asarray(b, jnp.uint32) * jnp.uint32(block_size)
        return (
            _qmc.generate(
                method_name, rng_key, block_size, d_total,
                config.float_dtype(), offset=offset, total=lhs_total,
            ),
            None,
        )

    def eval_one(th, quantiles, gen_key):
        saved = _save_slots(pairs)
        try:
            for (node, slot), t in zip(pairs, th):
                _write_slot(node, slot, t)
            outputs, _ = body(quantiles, gen_key=gen_key)
            s = outputs[sink_id]
            if not jnp.issubdtype(s.dtype, jnp.inexact):
                raise ValueError(
                    "The swept node is integer-valued; cast it "
                    "(node * 1.0) to sweep real-valued statistics."
                )
            return s.astype(jnp.float32)
        finally:
            _restore_slots(saved)

    if crn:

        def sample_all(theta, key, b):
            q, gk = block_quantiles(key, b)
            if sharding is not None:
                q = jax.lax.with_sharding_constraint(q, sharding)
            return jax.vmap(eval_one, in_axes=(0, None, None))(theta, q, gk)

    else:

        def sample_all(theta, key, b):
            idx = jnp.arange(theta.shape[0], dtype=jnp.uint32)

            def one(th, i):
                q, gk = block_quantiles(jax.random.fold_in(key, i), b)
                return eval_one(th, q, gk)

            return jax.vmap(one)(theta, idx)

    @jax.jit
    def run(theta, key, n_blocks, last_count):
        s = theta.shape[0]

        def merge(carry, bn, bm, bm2, bq):
            n, mean, m2, qsum = carry
            nn = n + bn
            delta = bm - mean
            w = n * bn / nn
            return (
                nn,
                mean + delta * bn / nn,
                m2 + bm2 + delta * delta * w,
                qsum + bq,
            )

        def body_fn(b, carry):
            y = sample_all(theta, key, b)
            bm = jnp.mean(y, axis=1)
            bm2 = jnp.sum(jnp.square(y - bm[:, None]), axis=1)
            return merge(
                carry, jnp.float32(block_size), bm, bm2, qacc_full(y)
            )

        init = (
            jnp.float32(0.0),
            jnp.zeros((s,), jnp.float32),
            jnp.zeros((s,), jnp.float32),
            jnp.zeros((s, n_levels), jnp.float32),
        )
        nb1 = jnp.asarray(n_blocks, jnp.int32) - 1
        carry = jax.lax.fori_loop(0, nb1, body_fn, init)
        cnt = jnp.asarray(last_count, jnp.int32)
        y = sample_all(theta, key, nb1)
        mask = jnp.arange(block_size, dtype=jnp.int32) < cnt
        cntf = cnt.astype(jnp.float32)
        maskM = mask[None, :]
        bm = jnp.sum(jnp.where(maskM, y, 0.0), axis=1) / cntf
        bm2 = jnp.sum(jnp.where(maskM, jnp.square(y - bm[:, None]), 0.0), axis=1)
        n, mean, m2, qsum = merge(
            carry, cntf, bm, bm2, qacc_partial(y, mask, cnt)
        )
        return n, mean, m2 / (n - 1.0), qsum / n

    return run
