"""Least-squares Monte Carlo for American/Bermudan exercise (LSMC).

Framework extension (no counterpart in the reference).  Prices optimal-
stopping payoffs on any path node (models/processes.py, levy.py,
stochvol.py, sde.py) with the Longstaff-Schwartz algorithm
(Longstaff & Schwartz 2001, "Valuing American options by simulation"):
backward induction where each exercise date's continuation value is a
polynomial regression of the discounted future cashflow on the current
state, fitted over in-the-money paths.

Device shape: the whole backward induction is ONE ``lax.scan`` over
reversed time whose body is a ``(B, n) @ (n, B)`` Gram matmul, a
``B x B`` ridge solve (B = the polynomial basis size, trivially small
while the matmuls run as dense products), and elementwise exercise selects on
the ``(n,)`` value carry — no per-date Python, no host round trips.
The regression state is STANDARDISED per date over the ITM paths
(fit-time mean/std travel with the weights), which keeps the monomial
Gram well-conditioned in float32 — raw ``s/s0`` monomials were measured
to leave the LU solve backend-divergent and to bias the two-pass bound
low on an accelerator; all statistics-bearing matmuls are pinned to
float32 precision (the GPU's default runs float32 matmuls in TF32).

Estimation is two-pass by default: pass 1 fits the per-date regression
weights, pass 2 applies the fitted exercise POLICY to an independent
path sample (one forward scan) — removing the foresight (look-ahead)
bias of in-sample LSMC, so the reported price is a genuine lower-bound
estimator with a valid standard error.

Multi-factor nodes regress on their FULL per-date Markov state by
default: Heston exposes ``(asset, variance)`` through
``_state_paths_from_increments`` and the continuation fit uses all
total-degree monomials of the standardised joint state — with a hidden
variance factor the asset-only basis is strictly coarser than the true
state and its two-pass lower bound is systematically loose.  Pass
``state="asset"`` for the classical single-factor basis, or a callable
for arbitrary per-date feature tuples.

``american_greeks`` differentiates the two-pass value pathwise with the
exercise policy FROZEN (weights/means/stds as constants): by the
envelope argument the value is first-order insensitive to shifts of an
(approximately) optimal boundary, so the frozen-policy pathwise
delta/vega/rho is consistent; the indicator's jump contributes only on
a measure-zero boundary set for continuous path laws.

>>> from probabilit_tpu import GeometricBrownianMotion
>>> import jax.numpy as jnp
>>> gbm = GeometricBrownianMotion(s0=36.0, mu=0.06, sigma=0.2, T=1.0, steps=50)
>>> res = american_price(gbm, lambda s: jnp.maximum(40.0 - s, 0.0),
...                      rate=0.06, size=2**16, random_state=0)
>>> bool(abs(res["price"] - 4.478) < 0.08)   # FD benchmark (LS 2001, tab. 1)
True
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from probabilit_tpu import config

__all__ = ["american_price", "american_greeks"]

# Jitted (fit, evaluate) pairs cached across calls: a fresh closure per
# call would retrace the 2x steps-long scan each time (seconds of
# XLA compile per price).  Keyed on everything trace-relevant; payoff
# enters by identity like every user callable in this package.
_FN_CACHE = {}
_GREEK_CACHE = {}


def _monomial_powers(n_states, degree):
    """Exponent tuples of all total-degree-<= ``degree`` monomials.

    One state: ``(0,), (1,), ..., (degree,)`` — the classical LSM basis.
    Two states at degree 3: ten terms ``1, s, v, s^2, s v, v^2, ...`` —
    the standard joint basis for stochastic-volatility LSMC.
    """
    out = []

    def rec(prefix, remaining, budget):
        if remaining == 0:
            out.append(tuple(prefix))
            return
        for p in range(budget + 1):
            rec(prefix + [p], remaining - 1, budget - p)

    rec([], n_states, degree)
    out.sort(key=lambda t: (sum(t), tuple(-p for p in t)))
    return tuple(out)


def _basis(x, powers):
    """Monomial features ``(n, B)`` of the standardised ``(n, S)`` state."""
    feats = []
    for pw in powers:
        f = jnp.ones_like(x[:, 0])
        for j, p in enumerate(pw):
            if p:
                f = f * x[:, j] ** p
        feats.append(f)
    return jnp.stack(feats, axis=1)


def _resolve_state(node, state):
    """-> (mode tag for the cache key, feature-select callable)."""
    if state in (None, "auto", "joint"):
        return "joint", None
    if state == "asset":
        return "asset", None
    if callable(state):
        return ("custom", id(state)), state
    raise ValueError(
        f"state must be 'auto'/'joint', 'asset', or a callable mapping "
        f"the node's state tuple to feature paths; got {state!r}."
    )


def _sample_states(node, key, n, dtype, method, mode, state_fn):
    """(payoff paths (n, steps, P), features (n, steps, S)) from the node.

    ``P = node._payoff_arity`` (1 for scalar path nodes; d for joint
    multi-asset nodes, whose payoff receives one per-asset slice per
    argument).

    ``method="sobol"/...`` drives the node through its quantile-slab
    constructor (Brownian-bridge ordering for Gaussian drivers, exactly
    as engine QMC sampling does), with the scramble keyed by ``key`` —
    the fit and evaluation passes therefore get independent
    randomisations of the same low-discrepancy sequence.

    Under an active mesh the sample axis is pinned per chip (key-based
    draws have no data dependence that would otherwise stop the SPMD
    partitioner from replicating the matrix); the per-date Gram matmuls
    then reduce with XLA-inserted psums and the backward induction runs
    fully sharded.
    """
    from probabilit_tpu.parallel import mesh as _mesh

    if method is None:
        inc = node._increments(key, n, dtype)
    else:
        from probabilit_tpu.ops import qmc as _qmc

        q = _qmc.generate(method, key, n, node._q_width, dtype=dtype)
        inc = node._increments_from_slab(q, dtype)
    states = node._state_paths_from_increments(inc)
    p_arity = getattr(node, "_payoff_arity", 1)
    pay = jnp.stack(states[:p_arity], axis=2)  # (n, steps, P)
    if state_fn is not None:
        feats = tuple(state_fn(*states))
    elif mode == "asset":
        feats = states[:p_arity]
    else:
        feats = states
    stacked = jnp.stack(feats, axis=2)  # (n, steps, S)
    sharding3 = _mesh.sample_sharding(ndim=3)
    if sharding3 is not None:
        pay = jax.lax.with_sharding_constraint(pay, sharding3)
        stacked = jax.lax.with_sharding_constraint(stacked, sharding3)
    return pay, stacked


def _call_payoff(payoff, p_k):
    """Apply the user payoff to a per-date ``(n, P)`` slice.

    One positional argument per payoff path: scalar nodes keep the
    classic ``payoff(s)``; joint nodes get ``payoff(s1, ..., sd)``.
    """
    return payoff(*(p_k[:, j] for j in range(p_k.shape[1])))


def _standardize(s_k, itm, dtype):
    """Per-date ITM mean/std of each state dim (guarded against empty ITM).

    Standardising the regression state per exercise date is what keeps
    the monomial Gram matrix well-conditioned in float32: raw monomials
    of s/s0 produced backend-dependent LU solutions (measured: the SAME
    paths gave materially different weights on an accelerator and on the
    CPU, and a systematically lower two-pass bound on the accelerator);
    powers of a zero-mean
    unit-variance state bring the condition number down to O(10).
    """
    cnt = jnp.maximum(itm.sum(), 1.0)
    mu = (s_k * itm[:, None]).sum(axis=0) / cnt
    var = (itm[:, None] * (s_k - mu[None, :]) ** 2).sum(axis=0) / cnt
    sd = jnp.sqrt(var + jnp.asarray(1e-12, dtype))
    return mu, jnp.maximum(sd, jnp.asarray(1e-6, dtype))


def _fit_weights(pay, feats, payoff, powers, disc, ridge):
    """Backward induction -> per-date ``(weights, means, stds)``.

    The carry is the value vector "cashflow discounted to the CURRENT
    date"; each scan step regresses it (ITM-weighted) on the basis of
    the per-date STANDARDISED state, then replaces it where immediate
    exercise beats the fitted continuation.  Scanned over reversed
    interior dates; the terminal date exercises intrinsically and seeds
    the carry.  The fit-time (means, stds) travel with the weights — the
    policy's features are defined relative to them.
    """
    dtype = pay.dtype
    nb = len(powers)
    v = _call_payoff(payoff, pay[:, -1, :])
    eye = jnp.eye(nb, dtype=dtype)

    def step(v, inp):
        p_k, s_k = inp  # (n, P), (n, S)
        v = disc * v
        ex = _call_payoff(payoff, p_k)
        itm = (ex > 0).astype(dtype)
        mu, sd = _standardize(s_k, itm, dtype)
        phi = _basis((s_k - mu[None, :]) / sd[None, :], powers)
        phiw = phi * itm[:, None]
        with jax.default_matmul_precision("float32"):
            g = phiw.T @ phi
            g = g + (ridge * jnp.trace(g) / nb) * eye
            b = phiw.T @ (v * itm)
            w = jnp.linalg.solve(g, b)
            cont = phi @ w
        v = jnp.where((itm > 0) & (ex > cont), ex, v)
        return v, (w, mu, sd)

    # Interior dates steps-2 .. 0 (reverse time order).
    xs = (
        jnp.transpose(pay[:, :-1, :], (1, 0, 2))[::-1],
        jnp.transpose(feats[:, :-1, :], (1, 0, 2))[::-1],
    )
    _, (ws, mus, sds) = jax.lax.scan(step, v, xs)
    return ws[::-1], mus[::-1], sds[::-1]  # forward date order


def _apply_policy(pay, feats, payoff, powers, disc, fit):
    """Forward pass: exercise the FITTED policy on independent paths."""
    ws, mus, sds = fit
    n = pay.shape[0]

    def step(carry, inp):
        stopped, value, df = carry
        p_k, s_k, w, mu, sd = inp
        ex = _call_payoff(payoff, p_k)
        phi = _basis((s_k - mu[None, :]) / sd[None, :], powers)
        with jax.default_matmul_precision("float32"):
            cont = phi @ w
        take = (~stopped) & (ex > 0) & (ex > cont)
        value = jnp.where(take, df * ex, value)
        return (stopped | take, value, df * disc), None

    init = (
        jnp.zeros((n,), bool),
        jnp.zeros((n,), pay.dtype),
        jnp.asarray(disc, pay.dtype),
    )
    xs = (
        jnp.transpose(pay[:, :-1, :], (1, 0, 2)),
        jnp.transpose(feats[:, :-1, :], (1, 0, 2)),
        ws,
        mus,
        sds,
    )
    (stopped, value, df), _ = jax.lax.scan(step, init, xs)
    # Unexercised paths cash the terminal intrinsic value.
    value = jnp.where(stopped, value, df * _call_payoff(payoff, pay[:, -1, :]))
    return value, stopped


def _validate_common(node, payoff, degree, size, method):
    if method is not None and str(method).lower().strip() not in (
        "sobol",
        "halton",
        "lhs",
        "antithetic",
    ):
        raise ValueError(
            "method must be None, 'sobol', 'halton', 'lhs' or "
            f"'antithetic', got {method!r}."
        )
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}.")
    if size < 2 * (degree + 1):
        raise ValueError(f"size={size} is too small for degree {degree}.")
    if node.steps < 2:
        raise ValueError("American exercise needs a grid with steps >= 2.")


def _n_states(node, mode, state_fn):
    if state_fn is not None or mode == "joint":
        # Probe the state arity cheaply via abstract evaluation: one
        # tiny increment draw at trace level only.
        dtype = config.float_dtype()
        states = jax.eval_shape(
            lambda k: node._state_paths_from_increments(
                node._increments(k, 2, dtype)
            ),
            jax.ShapeDtypeStruct((2,), jnp.uint32),
        )
        n = len(states)
        if state_fn is not None:
            return None  # determined inside the trace
        return n
    return 1


def american_price(
    node,
    payoff,
    *,
    rate=0.0,
    size=1 << 17,
    degree=3,
    random_state=0,
    two_pass=True,
    ridge=1e-6,
    method=None,
    state="auto",
    replicates=None,
):
    """Longstaff-Schwartz price of ``payoff`` exercisable on the grid.

    ``node`` is any path node (its ``steps`` grid dates are the
    exercise dates; add dates by raising ``steps``); ``payoff`` maps a
    grid slice of the state to intrinsic value with jnp ops (e.g.
    ``lambda s: jnp.maximum(K - s, 0.0)``).  Joint multi-asset nodes
    (``CorrelatedGBM(...)[0].joint`` or the ``CorrelatedGBMPaths`` /
    ``CorrelatedMertonPaths`` / ``CorrelatedHestonPaths`` node itself)
    pass one per-asset slice per argument — a Bermudan max-call is
    ``lambda s1, s2: jnp.maximum(jnp.maximum(s1, s2) - K, 0.0)`` — and
    the continuation regression conditions on the full joint state (all
    assets, plus the variances for correlated Heston) with total-degree
    monomial cross terms.  ``rate`` is the
    continuously-compounded discount rate — price a RISK-NEUTRAL model
    by constructing the node with drift ``rate`` and discounting with
    the same ``rate``.

    ``two_pass=True`` (default) fits weights on one sample and applies
    the fitted policy to an independent second sample (foresight-free
    lower bound with a valid ``se``); ``two_pass=False`` reports the
    in-sample backward-induction estimate (slight upward foresight
    bias, half the cost).

    ``state`` selects the continuation-regression state: ``"auto"`` /
    ``"joint"`` (default) uses the node's full per-date Markov state —
    for Heston the (asset, variance) pair with all total-degree
    monomial cross terms; ``"asset"`` forces the classical asset-only
    basis; a callable receives the node's state paths (each
    ``(n, steps)``) and returns a tuple of feature paths (arbitrary
    user state, e.g. ``lambda s, v: (s, v, s * v)``).  The payoff
    always applies to the node's observable path.

    ``method="sobol"`` (or halton/lhs/antithetic) drives the paths with
    a low-discrepancy sequence through the node's Brownian-bridge slab
    constructor — fit and evaluation passes use independently keyed
    scrambles.  The reported ``se`` stays the iid formula, a
    conservative overestimate under QMC.

    ``replicates=R`` (requires ``two_pass=True``) applies the ONE
    fitted policy to R independently keyed evaluation samples of
    ``size`` paths each: ``price`` becomes the replicate average and
    ``se`` the between-replicate standard error — the valid error bar
    under QMC evaluation streams (each replicate gets a fresh
    scramble), and a pure policy-evaluation spread either way (the fit
    sample is shared, so fit noise is excluded by construction).

    Compiled programs are cached across calls, keyed on the node's
    static signature and the PAYOFF'S IDENTITY — pass the same function
    object when repricing (a fresh inline lambda per call recompiles
    the scan each time).

    Returns a dict: ``price`` (including immediate exercise at t=0),
    ``se`` (always the standard error OF the sample the price is
    computed from — the second pass when ``two_pass=True``),
    ``exercise_fraction`` (paths stopped before T), and ``weights``
    (per-date regression coefficients, forward order).
    """
    _validate_common(node, payoff, degree, size, method)
    mode, state_fn = _resolve_state(node, state)
    steps = node.steps
    dtype = config.float_dtype()
    dt = node.T / steps
    disc = math.exp(-float(rate) * dt)
    key = jax.random.PRNGKey(int(random_state))
    k_fit, k_eval = jax.random.split(key)
    method = None if method is None else str(method).lower().strip()

    x0 = None
    for attr in ("s0", "x0", "v0"):
        x0 = getattr(node, attr, None)
        if x0 is not None:
            break

    from probabilit_tpu.engine import compile as _compile

    cache_key = (
        node._static_signature(),
        id(payoff),
        size,
        degree,
        mode,
        float(rate),
        float(ridge),
        method,
        jnp.dtype(dtype).name,
        _compile._active_mesh_key(),
    )
    fns = _FN_CACHE.get(cache_key)
    if fns is None:

        @jax.jit
        def fit(k):
            pay, feats = _sample_states(
                node, k, size, dtype, method, mode, state_fn
            )
            powers = _monomial_powers(feats.shape[2], degree)
            fitted = _fit_weights(pay, feats, payoff, powers, disc, ridge)
            # In-sample estimate: the fitted policy on the SAME paths
            # (equals classic LSM, foresight bias included).
            value, stopped = _apply_policy(
                pay, feats, payoff, powers, disc, fitted
            )
            return fitted, value, stopped

        @jax.jit
        def evaluate(k, fitted):
            pay, feats = _sample_states(
                node, k, size, dtype, method, mode, state_fn
            )
            powers = _monomial_powers(feats.shape[2], degree)
            return _apply_policy(pay, feats, payoff, powers, disc, fitted)

        if len(_FN_CACHE) > 32:
            _FN_CACHE.pop(next(iter(_FN_CACHE)))
        fns = _FN_CACHE[cache_key] = (fit, evaluate)

    fit, evaluate = fns
    if replicates is not None:
        reps = int(replicates)
        if reps < 2:
            raise ValueError(
                f"replicates must be >= 2 (got {reps}): a single "
                "evaluation sample has no between-replicate spread."
            )
        if not two_pass:
            raise ValueError(
                "replicates= needs two_pass=True: it replicates the "
                "policy-evaluation pass (the in-sample estimate has no "
                "independent evaluation sample to replicate)."
            )
    fitted, value, stopped = fit(k_fit)
    rep_means = None
    if two_pass:
        if replicates is None:
            value, stopped = evaluate(k_eval, fitted)
        else:
            vals, stops = [], []
            for r in range(reps):
                v, s_ = evaluate(jax.random.fold_in(k_eval, r), fitted)
                vals.append(np.asarray(v))
                stops.append(np.asarray(s_))
            rep_means = np.array([v.mean() for v in vals])
            value = np.concatenate(vals)
            stopped = np.concatenate(stops)

    value = np.asarray(value)
    # Immediate exercise at t=0: one payoff argument per payoff path
    # (joint nodes carry a (d,) s0 vector — one t=0 level per asset).
    p_arity = getattr(node, "_payoff_arity", 1)
    x0_vals = (
        [0.0] * p_arity
        if x0 is None
        else list(np.ravel(np.asarray(x0, np.float64)))[:p_arity]
    )
    intrinsic0 = float(
        np.asarray(payoff(*[jnp.full((1,), v_, dtype) for v_ in x0_vals]))[0]
    )
    if rep_means is not None:
        se = float(rep_means.std(ddof=1) / math.sqrt(rep_means.size))
    else:
        se = float(value.std(ddof=1) / math.sqrt(value.shape[0]))
    out = {
        "price": max(float(value.mean()), intrinsic0),
        "se": se,
        "exercise_fraction": float(np.asarray(stopped).mean()),
        "weights": np.asarray(fitted[0]),
    }
    if rep_means is not None:
        out["replicates"] = int(rep_means.size)
    return out


def american_greeks(
    node,
    payoff,
    *,
    rate=0.0,
    wrt=None,
    size=1 << 17,
    degree=3,
    random_state=0,
    ridge=1e-6,
    method=None,
    state="auto",
    replicates=None,
):
    """Pathwise Greeks of the two-pass LSMC price under a FROZEN policy.

    Fits the exercise policy at the current parameters (pass 1, exactly
    as ``american_price``), freezes it (``stop_gradient`` on the
    per-date weights/means/stds), and differentiates the second-pass
    value — the fitted policy applied to an independent path sample —
    pathwise with respect to the node's differentiable parameters and
    the discount ``rate``.

    Validity: with the policy frozen, the two-pass value is an ordinary
    smooth pathwise expectation except on the measure-zero set where a
    path touches the exercise boundary; and by the envelope argument the
    price of an OPTIMALLY exercised claim is first-order insensitive to
    boundary perturbations, so freezing an approximately-optimal policy
    leaves the Greeks consistent to the same order as the price itself
    (the standard frozen-boundary argument for LSMC sensitivities).

    ``wrt`` defaults to every differentiable slot of the node
    (``_param_slots``: GBM s0/mu/sigma; Heston s0/mu/rho/v0) plus
    ``"rate"``.  Returns a dict ``{"price", "se", slot: gradient, ...}``
    where ``price`` is the two-pass mean (NO max with immediate
    exercise — the max kink has no derivative; compare against
    ``american_price``'s value when the option is deep ITM at t=0) and
    ``se`` is the standard error of the SAME second-pass sample the
    price comes from (internally consistent, unlike a pass-1 se).

    ``replicates=R`` runs R independently keyed evaluation passes of
    ``size`` paths each under the one frozen policy: every Greek gains
    a ``"<slot>_sem"`` between-replicate standard error (the valid
    error bar under QMC evaluation streams, shrinking ~1/sqrt(R)),
    ``price``/each Greek become replicate averages, and ``se`` becomes
    the between-replicate standard error of the price.

    >>> from probabilit_tpu import GeometricBrownianMotion
    >>> import jax.numpy as jnp
    >>> gbm = GeometricBrownianMotion(s0=40.0, mu=0.06, sigma=0.2, T=1.0,
    ...                               steps=16)
    >>> g = american_greeks(gbm, lambda s: jnp.maximum(40.0 - s, 0.0),
    ...                     rate=0.06, size=2**14, random_state=0)
    >>> bool(-1.0 < g["s0"] < 0.0)   # ATM American put delta
    True
    """
    _validate_common(node, payoff, degree, size, method)
    if replicates is not None and int(replicates) < 2:
        # Checked BEFORE the expensive pass-1 fit (minutes of remote
        # compile on first call) — american_price validates this argument
        # up front too.
        raise ValueError(
            f"replicates must be >= 2 (got {int(replicates)}): a single "
            "evaluation sample has no between-replicate spread."
        )
    mode, state_fn = _resolve_state(node, state)
    slots = list(getattr(node, "_param_slots", ()))
    if wrt is None:
        wrt = slots + ["rate"]
    wrt = list(wrt)
    if not wrt:
        raise ValueError("wrt is empty.")
    for s in wrt:
        if s != "rate" and s not in slots:
            raise ValueError(
                f"{type(node).__name__} has no differentiable parameter "
                f"{s!r}; available: {slots + ['rate']}."
            )
    steps = node.steps
    dtype = config.float_dtype()
    dt = node.T / steps
    key = jax.random.PRNGKey(int(random_state))
    k_fit, k_eval = jax.random.split(key)
    method = None if method is None else str(method).lower().strip()

    # Pass 1: fit the policy at the current parameters (shares
    # american_price's cached fit program via the same cache key shape).
    res = american_price(
        node,
        payoff,
        rate=rate,
        size=size,
        degree=degree,
        random_state=random_state,
        two_pass=False,
        ridge=ridge,
        method=method,
        state=state,
    )
    # Re-fit to obtain the full fitted tuple (weights/means/stds): the
    # cached fit program returns it without recompiling.
    from probabilit_tpu.engine import compile as _compile

    cache_key = (
        node._static_signature(),
        id(payoff),
        size,
        degree,
        mode,
        float(rate),
        float(ridge),
        method,
        jnp.dtype(dtype).name,
        _compile._active_mesh_key(),
    )
    fit, _ = _FN_CACHE[cache_key]
    fitted, _, _ = fit(k_fit)
    fitted = jax.tree_util.tree_map(jax.lax.stop_gradient, fitted)

    slot_key = tuple(wrt)
    gkey = cache_key + (slot_key, "greeks")
    vg = _GREEK_CACHE.get(gkey)
    if vg is None:

        def value_of(theta, k, fitted_in):
            from probabilit_tpu.engine.sensitivity import (
                _restore_slots,
                _save_slots,
                _write_slot,
            )

            saved = _save_slots([(node, s) for s in wrt if s != "rate"])
            try:
                rate_term = jnp.asarray(float(rate), dtype)
                for s, th in zip(wrt, theta):
                    if s == "rate":
                        rate_term = th
                    else:
                        _write_slot(node, s, th)
                pay, feats = _sample_states(
                    node, k, size, dtype, method, mode, state_fn
                )
                powers = _monomial_powers(feats.shape[2], degree)
                disc_t = jnp.exp(-rate_term * jnp.asarray(dt, dtype))
                value, _ = _apply_policy(
                    pay, feats, payoff, powers, disc_t, fitted_in
                )
                # The aux se belongs to THIS evaluation sample — the one
                # the reported price is the mean of.
                se = jnp.std(value, ddof=1) / jnp.sqrt(
                    jnp.asarray(value.shape[0], dtype)
                )
                return jnp.mean(value), se
            finally:
                _restore_slots(saved)

        vg = jax.jit(jax.value_and_grad(value_of, argnums=0, has_aux=True))
        if len(_GREEK_CACHE) > 32:
            _GREEK_CACHE.pop(next(iter(_GREEK_CACHE)))
        _GREEK_CACHE[gkey] = vg

    from probabilit_tpu.engine.sensitivity import _read_slot

    theta0 = jnp.asarray(
        [
            float(rate) if s == "rate" else float(_read_slot(node, s))
            for s in wrt
        ],
        dtype,
    )
    # `res` proved the fit pass (and its cached programs) is sound; its
    # in-sample se is NOT reported — the returned se comes from the
    # evaluation sample(s) the price is computed from.
    del res
    if replicates is None:
        (value, se_eval), grads = vg(theta0, k_eval, fitted)
        grads = np.asarray(grads, np.float64)
        if not np.all(np.isfinite(grads)):
            raise FloatingPointError(
                f"Non-finite American greeks: {grads.tolist()}."
            )
        out = {"price": float(value), "se": float(se_eval)}
        for s, g in zip(wrt, grads):
            out[s] = float(g)
        return out
    reps = int(replicates)  # >= 2, validated before the pass-1 fit
    vals, gs = [], []
    for r in range(reps):
        (v, _), g = vg(theta0, jax.random.fold_in(k_eval, r), fitted)
        vals.append(float(v))
        gs.append(np.asarray(g, np.float64))
    gs = np.stack(gs)  # (R, P)
    if not np.all(np.isfinite(gs)):
        raise FloatingPointError(
            f"Non-finite American greeks: {gs.tolist()}."
        )
    vals = np.asarray(vals)
    out = {
        "price": float(vals.mean()),
        "se": float(vals.std(ddof=1) / math.sqrt(reps)),
        "replicates": reps,
    }
    gmean = gs.mean(axis=0)
    gsem = gs.std(axis=0, ddof=1) / math.sqrt(reps)
    for s, g, e in zip(wrt, gmean, gsem):
        out[s] = float(g)
        out[s + "_sem"] = float(e)
    return out
