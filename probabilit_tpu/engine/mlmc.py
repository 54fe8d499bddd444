"""Multilevel Monte Carlo estimation for SDE path functionals.

Framework extension (no counterpart in the reference).  Standard Monte
Carlo of a discretised SDE pays O(eps^-2) samples TIMES O(eps^-1) steps
per sample for an RMS accuracy ``eps``; Giles' multilevel estimator
(Giles 2008, "Multilevel Monte Carlo path simulation") telescopes the
expectation across a geometric hierarchy of grids,

    E[P_L] = E[P_0] + sum_{l=1..L} E[P_l - P_{l-1}],

and samples each correction with COUPLED coarse/fine paths driven by
the same Brownian increments — the coarse grid's standard-normal
drivers are the renormalised sums of the fine grid's within each coarse
step, so ``Var[P_l - P_{l-1}] -> 0`` with level and almost all samples
run on the cheapest grids.  Total cost drops to O(eps^-2) for Milstein
(strong order 1) and O(eps^-2 log(eps)^2) for Euler.

Device shape: ONE jitted fixed-shape kernel per level — a
``(block, steps_l)`` normal draw, a reshape-sum for the coarse drivers,
the two ``lax.scan`` discretisations (reusing
``SDEPath._path_from_increments``, the same code the ``SDE`` node
compiles), the payoff, and masked scalar reductions (the sample count
is a traced scalar against a fixed block shape, so the adaptive loop
never retraces).  Blocks stream through the kernel, bounding the
per-dispatch footprint at any sample count; the adaptive outer loop
(optimal per-level allocation + weak-convergence level test) is
host-side Python on fetched scalars, exactly as in Giles' algorithm.

>>> import jax.numpy as jnp
>>> res = mlmc_estimate(
...     lambda t, x: 0.05 * x, lambda t, x: 0.2 * x,
...     lambda paths: jnp.maximum(paths[:, -1] - 100.0, 0.0),
...     x0=100.0, eps=0.15, random_state=0)
>>> bool(abs(res["mean"] - 10.986) < 0.45)   # e^{rT} x Black-Scholes 10.4506
True
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from probabilit_tpu import config

__all__ = ["mlmc_estimate"]


def _level_kernel(
    make_node, payoff, m0, refine, level, rows, method=None
):
    """Jitted ``(key, count, start) -> (sum, sum_sq, fine_sum, fine_sum_sq)``.

    Level 0 samples the coarsest grid alone; level l >= 1 samples the
    coupled correction P_l - P_{l-1}, the coarse drivers being the
    renormalised within-coarse-step sums of the fine drivers (a sum of
    ``refine`` iid N(0,1) over sqrt(refine) is the coarse step's exact
    standard-normal driver for the SAME Brownian path).  The block shape
    is static; ``count`` masks the active rows so every call reuses one
    compiled program.

    ``make_node(steps)`` builds the path node for a grid: a discretised
    ``SDEPath`` for the callable API, or an exact-law family regrid
    (``_regrid``) for node inputs — either way the z -> path map is the
    node's own ``_increments_from_normals`` + ``_path_from_increments``,
    so the kernel runs the same code the graph engine compiles.
    """
    steps_f = m0 * refine**level
    fine = make_node(steps_f)
    coarse = None if level == 0 else make_node(steps_f // refine)
    dtype = config.float_dtype()
    inv_sqrt_r = 1.0 / math.sqrt(refine)

    @jax.jit
    def run(key, count, start):
        from probabilit_tpu.parallel import mesh as _mesh

        if method is None:
            z = jax.random.normal(key, (rows, steps_f), dtype)
        else:
            # MLQMC (Giles-Waterhouse): one low-discrepancy sequence per
            # level (scramble keyed per level, ``start`` continuing the
            # stream across extend calls) through the Brownian-bridge, so
            # QMC dimension 0 drives the fine path's terminal point.  The
            # bridged z are the PHYSICAL iid increments, so the coarse
            # coupling below (renormalised sums) is untouched.
            from probabilit_tpu.ops import bridge as _bridge
            from probabilit_tpu.ops import qmc as _qmc

            u = _qmc.generate(method, key, rows, steps_f, dtype, offset=start)
            z = _bridge.normal_increments(u, dtype)
        # Under an active mesh each chip owns its rows (key-based draws
        # would otherwise replicate); reductions psum automatically.
        sharding = _mesh.sample_sharding(ndim=2)
        if sharding is not None:
            z = jax.lax.with_sharding_constraint(z, sharding)
        pf = payoff(
            fine._path_from_increments(fine._increments_from_normals(z, dtype))
        )
        if coarse is None:
            d = pf
        else:
            zc = z.reshape(rows, steps_f // refine, refine).sum(axis=2) * inv_sqrt_r
            pc = payoff(
                coarse._path_from_increments(
                    coarse._increments_from_normals(zc, dtype)
                )
            )
            d = pf - pc
        mask = (jnp.arange(rows) < count).astype(d.dtype)
        dm = d * mask
        pm = pf * mask
        return (
            jnp.sum(dm),
            jnp.sum(dm * d),
            jnp.sum(pm),
            jnp.sum(pm * pf),
        )

    return run, steps_f


class _LevelState:
    """Accumulated per-level sums (host floats) + the jitted kernel."""

    def __init__(self, kernel, steps, cost, rows):
        self.kernel = kernel
        self.steps = steps
        self.cost = cost  # work units per sample (fine + coarse steps)
        self.rows = rows
        self.n = 0
        self.s1 = 0.0
        self.s2 = 0.0
        self.f1 = 0.0
        self.f2 = 0.0

    def extend(self, key, extra):
        done = 0
        while done < extra:
            b = min(self.rows, extra - done)
            k = jax.random.fold_in(key, self.n + done)
            out = self.kernel(
                k,
                jnp.asarray(b, jnp.int32),
                jnp.asarray(self.n + done, jnp.uint32),
            )
            # One host sync per block fetches all four scalars.
            s1, s2, f1, f2 = (float(v) for v in np.asarray(jax.device_get(out)))
            self.s1 += s1
            self.s2 += s2
            self.f1 += f1
            self.f2 += f2
            done += b
        self.n += extra

    @property
    def mean(self):
        return self.s1 / self.n

    @property
    def var(self):
        m = self.mean
        return max(self.s2 / self.n - m * m, 0.0)

    @property
    def fine_var(self):
        m = self.f1 / self.n
        return max(self.f2 / self.n - m * m, 0.0)


def mlmc_estimate(
    drift,
    diffusion=None,
    payoff=None,
    *,
    x0=None,
    T=1.0,
    eps=1e-2,
    m0=4,
    refine=4,
    max_levels=12,
    n_initial=10_000,
    scheme="euler",
    random_state=0,
    block_rows=None,
    method=None,
):
    """Adaptive multilevel Monte Carlo estimate of ``E[payoff(paths)]``.

    Two calling conventions:

    ``mlmc_estimate(drift, diffusion, payoff, x0=..., ...)`` —
    ``drift``/``diffusion`` follow the ``SDE`` node contract
    (elementwise callables of ``(t, x)``).

    ``mlmc_estimate(node, payoff, eps=...)`` — ``node`` is a path node
    speaking the framework's modeling language: an ``SDE`` node (its
    drift/diffusion/x0/T/scheme are used directly; ``steps`` is ignored
    — the level hierarchy supplies the grids) or an exact-law
    Gaussian-driven family (``GeometricBrownianMotion`` /
    ``BrownianMotion`` / ``OrnsteinUhlenbeck``), which couples levels
    through SHARED bridged drivers with every grid carrying the exact
    marginal law — corrections then measure only the payoff functional's
    grid refinement (a terminal payoff's corrections are exactly zero;
    Asian/discretely-monitored functionals converge with no scheme
    bias on any level).

    ``payoff`` maps an ``(n, steps)`` path matrix to ``(n,)`` values
    with jnp ops and must be meaningful on every grid in the hierarchy
    (terminal values, averages, smooth functions thereof —
    discretely-monitored extrema carry their own grid bias, which
    multilevel cannot remove).

    Runs Giles' adaptive algorithm to RMS accuracy ``eps``: per-level
    sample counts minimise total cost subject to the variance budget
    ``sum_l V_l / N_l <= eps^2 / 2`` (``N_l ~ sqrt(V_l / C_l)``), and
    levels are appended until the weak-error proxy
    ``|Y_L| / (refine^alpha - 1) < eps / sqrt(2)`` (``alpha`` the
    observed weak rate, floored at 0.5) passes on the last level.

    ``method="sobol"/"halton"/"antithetic"`` switches each level to a
    per-level-scrambled low-discrepancy stream through the
    Brownian-bridge (MLQMC, Giles & Waterhouse 2009).  The allocation
    still treats points as iid (V_l is the iid variance), so QMC gains
    arrive as extra accuracy at equal cost rather than fewer samples —
    conservative by construction.

    Returns a dict: ``mean`` (the estimate), ``eps``, ``levels``,
    per-level ``n_per_level``/``means``/``variances``/``steps``,
    ``cost`` (total step-evaluations), and ``cost_mc`` (the projected
    cost of plain MC at the same accuracy on the finest grid — the
    speedup denominator).
    """
    from probabilit_tpu.models.processes import PathDistribution
    from probabilit_tpu.models.sde import SDEPath

    if isinstance(drift, PathDistribution):
        node = drift
        if payoff is None:
            payoff = diffusion  # mlmc_estimate(node, payoff, ...)
        if payoff is None:
            raise ValueError(
                "mlmc_estimate(node, payoff, ...): a payoff callable is "
                "required."
            )
        if x0 is not None:
            raise ValueError(
                "x0 comes from the node; do not pass it separately."
            )
        if isinstance(node, SDEPath):
            # The node carries the whole SDE spec; the level hierarchy
            # supplies the grids (node.steps is ignored).
            def make_path(steps):
                return node._regrid(steps)

            T = node.T
        else:
            # Exact-law coupling: _regrid raises a family-specific error
            # for non-Gaussian-driven nodes (Merton/CIR/Heston/...).
            probe = node._regrid(2)
            probe._increments_from_normals(
                jnp.zeros((1, 2), config.float_dtype()), config.float_dtype()
            )

            def make_path(steps):
                return node._regrid(steps)

            T = node.T
    else:
        if diffusion is None or payoff is None or x0 is None:
            raise ValueError(
                "mlmc_estimate(drift, diffusion, payoff, x0=...) needs all "
                "of drift, diffusion, payoff and x0 (or pass a path node "
                "as the first argument)."
            )

        def make_path(steps):
            return SDEPath(
                drift, diffusion, x0=x0, T=T, steps=steps, scheme=scheme
            )

    if method is not None:
        name = str(method).lower().strip()
        if name == "lhs":
            raise ValueError(
                "method='lhs' stratifies over a FIXED total count, which "
                "adaptive MLMC does not know upfront; use 'sobol', "
                "'halton' or 'antithetic'."
            )
        if name not in ("sobol", "halton", "antithetic"):
            raise ValueError(
                "method must be None, 'sobol', 'halton' or 'antithetic', "
                f"got {method!r}."
            )
        method = name
    if eps <= 0:
        raise ValueError(f"eps must be positive, got {eps}.")
    if refine < 2:
        raise ValueError(f"refine must be >= 2, got {refine}.")
    if m0 < 1:
        raise ValueError(f"m0 must be >= 1, got {m0}.")
    if max_levels < 2:
        raise ValueError(f"max_levels must be >= 2, got {max_levels}.")

    key = jax.random.PRNGKey(int(random_state))

    def make_level(level):
        steps_f = m0 * refine**level
        # Bounded per-dispatch footprint at ANY depth: rows * steps_f
        # stays ~2^22 elements (16 MB f32) — a 4096-row floor would grow
        # the block linearly with steps_f past 1024 steps and OOM at the
        # deep levels max_levels permits.  Rows stay a multiple of 64 so
        # the sample axis divides any practical mesh.
        rows = block_rows or max(64, ((1 << 22) // max(steps_f, 1)) // 64 * 64)
        kernel, steps_f = _level_kernel(
            make_path, payoff, m0, refine, level, rows, method=method
        )
        cost = steps_f + (steps_f // refine if level else 0)
        return _LevelState(kernel, steps_f, cost, rows)

    levels = [make_level(0), make_level(1)]
    for lv, st in enumerate(levels):
        st.extend(jax.random.fold_in(key, lv), n_initial)

    target_half = 0.5 * eps * eps  # variance budget: sum V_l / N_l
    for _ in range(200):  # bounded outer loop; every pass adds work
        # Optimal allocation: N_l proportional to sqrt(V_l / C_l).
        lam = sum(math.sqrt(st.var * st.cost) for st in levels) / target_half
        need_more = False
        for lv, st in enumerate(levels):
            n_opt = int(math.ceil(lam * math.sqrt(st.var / st.cost)))
            if n_opt > st.n:
                st.extend(jax.random.fold_in(key, lv), n_opt - st.n)
                need_more = True
        if need_more:
            continue
        # Weak convergence: observed weak rate from consecutive
        # CORRECTION means (level 0 is the full expectation, not a
        # correction — using it inflates the rate), floored at 0.5
        # against noisy small means and defaulting to 1.0 (Euler/
        # Milstein weak order) until two corrections exist.
        tail = [abs(st.mean) for st in levels[1:]][-3:]
        rates = [
            math.log(a / b) / math.log(refine)
            for a, b in zip(tail[:-1], tail[1:])
            if a > 0 and b > 0
        ]
        alpha = max(0.5, min(rates)) if rates else 1.0
        rem = abs(levels[-1].mean) / (refine**alpha - 1.0)
        if rem < eps / math.sqrt(2.0) or len(levels) >= max_levels:
            break
        levels.append(make_level(len(levels)))
        levels[-1].extend(jax.random.fold_in(key, len(levels) - 1), n_initial)

    total_cost = sum(st.n * st.cost for st in levels)
    # Plain-MC comparator: finest grid, N = 2 Var[P_fine] / eps^2.
    cost_mc = (2.0 * levels[-1].fine_var / (eps * eps)) * levels[-1].steps
    return {
        "mean": sum(st.mean for st in levels),
        "eps": eps,
        "levels": len(levels),
        "n_per_level": [st.n for st in levels],
        "means": [st.mean for st in levels],
        "variances": [st.var for st in levels],
        "steps": [st.steps for st in levels],
        "cost": total_cost,
        "cost_mc": cost_mc,
    }
