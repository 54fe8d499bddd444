"""Stochastic-process nodes: Brownian, GBM, OU, Poisson, Merton paths.

Framework extension (the reference models scalar draws only): a path
node samples an ``(n, steps)`` matrix of discretised process paths from
EXACT grid-increment laws — Gaussian cumulative sums (Brownian/GBM),
an affine associative scan (Ornstein-Uhlenbeck), Poisson increments
(counting process), and compound-Poisson-normal jump increments
(Merton) — so every time slice has the process's exact
finite-dimensional distribution (no Euler error for any of the five
families).  Path functionals (terminal value, running max/min, time
average, a time slice) project back to the scalar world where the rest
of the modeling language operates.

Device shape: increments are one ``(n, steps)`` normal draw and the path
is one associative-scan ``cumsum`` along the time axis; functionals are
axis reductions.  Everything fuses into the compiled sampling program,
streams (choose ``block_size`` so ``block * steps * 4`` bytes fits
comfortably — 2^20 rows x 252 steps is ~1 GB), and shards over a mesh
like any other node.  Randomness has two modes (engine/compile.py):
under ``method=None`` a path node consumes one quantile column and keys
its increments from the leading bits (the multivariate q[0]-seed
contract, reference ``modeling.py:808-812``); under a QMC/antithetic
``method=`` it owns one quantile column PER DRIVER (``_q_width``) and
builds Gaussian increments through the Brownian-bridge construction
(``ops/bridge.py``), so low-discrepancy structure reaches the path's
dominant features and streamed method= runs bitwise-equal single-shot
runs.

>>> gbm = GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2, T=1.0)
>>> gbm.terminal()
PathFunctional(GBMPath(s0=100, mu=0.05, sigma=0.2, T=1, steps=252), 'terminal')
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from probabilit_tpu import config
from probabilit_tpu.models.distributions import AbstractDistribution
from probabilit_tpu.models.graph import Transform

__all__ = [
    "BrownianMotion",
    "GeometricBrownianMotion",
    "OrnsteinUhlenbeck",
    "PoissonProcess",
    "MertonJumpDiffusion",
    "CorrelatedGBM",
    "CorrelatedMerton",
    "PathDistribution",
    "PathFunctional",
]


class PathFunctionalMixin:
    """Functional shortcuts shared by path leaves and asset views.

    Memoised per (op, index): repeated ``path.terminal()`` calls give
    the SAME node, so ``path.terminal().samples_`` after sampling any
    expression built from it behaves the way users expect.  Requires a
    ``steps`` attribute and an ``(n, steps)``-valued emission.
    """

    _is_path = True

    def _functional(self, op, index=None):
        cache = self.__dict__.setdefault("_functional_cache", {})
        key = (op, index)
        if key not in cache:
            cache[key] = PathFunctional(self, op, index=index)
        return cache[key]

    def terminal(self):
        """Value at time T."""
        return self._functional("terminal")

    def maximum(self):
        """Running maximum over the grid (discrete-time supremum)."""
        return self._functional("max")

    def minimum(self):
        """Running minimum over the grid."""
        return self._functional("min")

    def average(self):
        """Time average over the grid (Asian-option payoff ingredient)."""
        return self._functional("mean")

    def at(self, step):
        """Value at grid point ``step`` (time ``(step + 1) * T / steps``)."""
        step = int(step)
        if not 0 <= step < self.steps:
            raise ValueError(
                f"step must be in [0, {self.steps}), got {step}."
            )
        return self._functional("at", index=step)


class PathDistribution(PathFunctionalMixin, AbstractDistribution):
    """Base path node: ``(n, steps)`` sample paths on a uniform grid.

    Time grid is ``dt, 2*dt, ..., T`` with ``dt = T / steps`` (the start
    point is the deterministic ``x0``/``s0`` and is not stored).
    """

    is_leaf = True
    _vector_valued = True
    # Differentiable scalar parameters (pathwise sensitivities swap these
    # attributes for traced scalars; engine/sensitivity.py).  Empty means
    # the family has no valid pathwise derivative.
    _param_slots = ()

    def __init__(self, steps, T):
        steps = int(steps)
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}.")
        T = float(T)
        if not T > 0:
            raise ValueError(f"T must be positive, got {T}.")
        self.steps = steps
        self.T = T
        super().__init__()

    def get_parents(self):
        return iter(())

    def _rewire(self, update):
        # Called on the COPY during Node.copy(): drop the (shared, shallow
        # copied) functional memo — its nodes are parented to the ORIGINAL
        # path; fresh calls on the copy must build against the copy.
        self.__dict__.pop("_functional_cache", None)

    def _mv_dim(self):
        return self.steps

    @property
    def _q_width(self):
        """Quantile columns consumed in quantile mode (one per driver).

        Gaussian-driven families need one column per step; subclasses
        with extra drivers (Merton: jump counts + jump sizes) widen it.
        """
        return self.steps

    def _increments(self, key, n, dtype):
        raise NotImplementedError

    def _increments_from_slab(self, slab, dtype):
        raise NotImplementedError

    def _state_paths_from_increments(self, inc):
        """Full per-date Markov state: a tuple of ``(n, steps)`` arrays.

        Entry 0 is the node's observable path (what ``_emit`` returns).
        Multi-factor families override this to expose their hidden
        factors (Heston: the variance path) so state-aware consumers —
        the joint-basis LSMC regression in ``engine/american.py`` — can
        condition on the complete state instead of the asset alone.
        """
        return (self._path_from_increments(inc),)

    def _regrid(self, steps):
        """Same family/parameters on a ``steps``-point grid.

        Exact-law families override this (with ``_increments_from_normals``)
        so multilevel Monte Carlo (engine/mlmc.py) can couple grid
        hierarchies through shared Brownian drivers.
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not support grid refinement; "
            "multilevel estimation needs an SDE node or an exact-law "
            "Gaussian-driven family (Brownian/GBM/OU)."
        )

    def _increments_from_normals(self, z, dtype):
        """Per-step increments from iid N(0,1) drivers ``z`` (n, steps).

        The exact-law MLMC coupling hook: fine and coarse grids share
        one Brownian path by renormalised sums of ``z``.  Only defined
        for families whose per-step randomness is exactly one standard
        normal.
        """
        raise NotImplementedError(
            f"{type(self).__name__} is not driven by one standard normal "
            "per step; no exact-law grid coupling exists."
        )

    def _bridge_z(self, slab, dtype):
        """Uniform slab -> iid N(0,1) increments, Brownian-bridge ordered.

        QMC dimension 0 of the slab controls the path's terminal point,
        later dimensions refine coarse-to-fine (ops/bridge.py) — the
        standard effective-dimension reduction that makes RQMC converge
        on path-dependent payoffs.  The bridge matrix is orthogonal, so
        the increment law is untouched.
        """
        from probabilit_tpu.ops import bridge as _bridge

        return _bridge.normal_increments(slab, dtype)

    def _emit(self, ctx):
        dtype = config.float_dtype()
        if ctx.gen_key is None:
            # Quantile mode (QMC methods / sample_from_quantiles): the
            # node owns a (n, _q_width) slab of the quantile matrix, so
            # low-discrepancy / antithetic structure reaches every
            # driver, blocks of a streamed method= run bitwise-equal
            # slices of a single-shot run, and sharded runs inherit the
            # matrix's sample-axis sharding.
            inc = self._increments_from_slab(ctx.slab(self), dtype)
        else:
            from probabilit_tpu.ops import multivariate as mv
            from probabilit_tpu.parallel import mesh as _mesh

            # Engine-generated PRNG run: draw from a key seeded by the
            # node's own quantile column (the multivariate q[0]-seed
            # contract, reference modeling.py:808-812).
            q = ctx.column(self)
            key = mv._key_from_q(q)
            inc = self._increments(key, ctx.n, dtype)
            # Key-based draws have no data dependence on the (sharded)
            # quantile column, so without a constraint the SPMD
            # partitioner may materialise the full (n, steps) matrix
            # REPLICATED on every device; pin the sample axis so each
            # chip owns its rows.
            sharding = _mesh.sample_sharding(ndim=inc.ndim)
            if sharding is not None:
                inc = jax.lax.with_sharding_constraint(inc, sharding)
        return self._path_from_increments(inc)

class BrownianPath(PathDistribution):
    """Arithmetic Brownian motion ``x0 + drift*t + diffusion*W_t``.

    Every grid slice is EXACT: increments are iid
    ``N(drift*dt, diffusion^2*dt)`` and the path is their cumulative
    sum, so ``at(k) ~ N(x0 + drift*(k+1)dt, diffusion^2*(k+1)dt)``
    without discretisation error.
    """

    _param_slots = ("x0", "drift", "diffusion")

    def __init__(self, x0=0.0, drift=0.0, diffusion=1.0, T=1.0, steps=252):
        diffusion = float(diffusion)
        if not diffusion > 0:
            raise ValueError(f"diffusion must be positive, got {diffusion}.")
        self.x0 = float(x0)
        self.drift = float(drift)
        self.diffusion = diffusion
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"BrownianPath(x0={self.x0:g}, drift={self.drift:g}, "
            f"diffusion={self.diffusion:g}, T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "BrownianPath",
            self.x0,
            self.drift,
            self.diffusion,
            self.T,
            self.steps,
        )

    def _increments_from_normals(self, z, dtype):
        dt = self.T / self.steps
        return self.drift * dt + self.diffusion * (dt**0.5) * z

    def _regrid(self, steps):
        return BrownianPath(
            x0=self.x0, drift=self.drift, diffusion=self.diffusion,
            T=self.T, steps=steps,
        )

    def _increments(self, key, n, dtype):
        z = jax.random.normal(key, (n, self.steps), dtype)
        return self._increments_from_normals(z, dtype)

    def _increments_from_slab(self, slab, dtype):
        return self._increments_from_normals(self._bridge_z(slab, dtype), dtype)

    def _path_from_increments(self, inc):
        return self.x0 + jnp.cumsum(inc, axis=1)


class GBMPath(PathDistribution):
    """Geometric Brownian motion ``s0 * exp((mu - sigma^2/2) t + sigma W_t)``.

    Exact in distribution at every grid slice (the log-path is a
    Brownian cumulative sum), so ``terminal()`` is exactly lognormal
    with ``E[S_T] = s0 * exp(mu T)``.
    """

    _param_slots = ("s0", "mu", "sigma")

    def __init__(self, s0=1.0, mu=0.0, sigma=0.2, T=1.0, steps=252):
        s0 = float(s0)
        sigma = float(sigma)
        if not s0 > 0:
            raise ValueError(f"s0 must be positive, got {s0}.")
        if not sigma > 0:
            raise ValueError(f"sigma must be positive, got {sigma}.")
        self.s0 = s0
        self.mu = float(mu)
        self.sigma = sigma
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"GBMPath(s0={self.s0:g}, mu={self.mu:g}, sigma={self.sigma:g}, "
            f"T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return ("GBMPath", self.s0, self.mu, self.sigma, self.T, self.steps)

    def _increments_from_normals(self, z, dtype):
        dt = self.T / self.steps
        return (self.mu - 0.5 * self.sigma**2) * dt + self.sigma * (
            dt**0.5
        ) * z

    def _regrid(self, steps):
        return GBMPath(
            s0=self.s0, mu=self.mu, sigma=self.sigma, T=self.T, steps=steps
        )

    def _increments(self, key, n, dtype):
        z = jax.random.normal(key, (n, self.steps), dtype)
        return self._increments_from_normals(z, dtype)

    def _increments_from_slab(self, slab, dtype):
        return self._increments_from_normals(self._bridge_z(slab, dtype), dtype)

    def _path_from_increments(self, inc):
        return self.s0 * jnp.exp(jnp.cumsum(inc, axis=1))


class OUPath(PathDistribution):
    """Ornstein-Uhlenbeck: ``dX = theta (mu - X) dt + sigma dW`` — exact.

    The exact transition is the affine recurrence
    ``X_k = a X_{k-1} + b + c Z_k`` with ``a = exp(-theta dt)``,
    ``b = mu (1 - a)``, ``c = sigma sqrt((1 - a^2) / (2 theta))``; the
    whole path is one ``lax.associative_scan`` over affine maps
    ``(A, B) -> x  |->  A x + B`` along the time axis (log-depth,
    numerically stable: only products of ``a < 1`` appear).  Every
    grid slice is exactly
    ``N(mu + (x0 - mu) a^k, sigma^2 (1 - a^(2k)) / (2 theta))``.
    """

    _param_slots = ("x0", "theta", "mu", "sigma")

    def __init__(self, x0=0.0, theta=1.0, mu=0.0, sigma=1.0, T=1.0, steps=252):
        theta = float(theta)
        sigma = float(sigma)
        if not theta > 0:
            raise ValueError(f"theta must be positive, got {theta}.")
        if not sigma > 0:
            raise ValueError(f"sigma must be positive, got {sigma}.")
        self.x0 = float(x0)
        self.theta = theta
        self.mu = float(mu)
        self.sigma = sigma
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"OUPath(x0={self.x0:g}, theta={self.theta:g}, mu={self.mu:g}, "
            f"sigma={self.sigma:g}, T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "OUPath",
            self.x0,
            self.theta,
            self.mu,
            self.sigma,
            self.T,
            self.steps,
        )

    def _decay(self, dtype):
        # jnp (not numpy) so parameters may be TRACED scalars — the
        # pathwise-sensitivity machinery swaps them for tracers.
        theta = jnp.asarray(self.theta, dtype)
        return jnp.exp(-theta * (self.T / self.steps)), theta

    def _increments_from_normals(self, z, dtype):
        a, theta = self._decay(dtype)
        b = self.mu * (1.0 - a)
        c = self.sigma * jnp.sqrt((1.0 - a * a) / (2.0 * theta))
        return b + c * z

    def _regrid(self, steps):
        return OUPath(
            x0=self.x0, theta=self.theta, mu=self.mu, sigma=self.sigma,
            T=self.T, steps=steps,
        )

    def _increments(self, key, n, dtype):
        z = jax.random.normal(key, (n, self.steps), dtype)
        return self._increments_from_normals(z, dtype)

    def _increments_from_slab(self, slab, dtype):
        # Bridge ordering still helps: the OU path is a decay-weighted
        # accumulation of these iid innovations, so the terminal-first
        # ordering keeps most of the variance in the leading QMC dims.
        return self._increments_from_normals(self._bridge_z(slab, dtype), dtype)

    def _path_from_increments(self, inc):
        a, _ = self._decay(inc.dtype)
        A = jnp.broadcast_to(a, inc.shape)

        def compose(left, right):
            # Later map applied after earlier: A2 (A1 x + B1) + B2.
            return (left[0] * right[0], left[1] * right[0] + right[1])

        A_pref, B_pref = jax.lax.associative_scan(compose, (A, inc), axis=1)
        return A_pref * self.x0 + B_pref


class PoissonProcessPath(PathDistribution):
    """Homogeneous Poisson counting process ``N_t`` — exact increments.

    Grid increments are iid ``Poisson(rate * dt)`` (independent
    increments make the discretisation exact at the grid), drawn through
    the native poisson inverse-CDF kernel; the counting path is their
    cumulative sum, so ``at(k) ~ Poisson(rate * (k+1) * dt)`` exactly.
    """

    def __init__(self, rate=1.0, T=1.0, steps=252):
        rate = float(rate)
        if not rate > 0:
            raise ValueError(f"rate must be positive, got {rate}.")
        self.rate = rate
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"PoissonProcessPath(rate={self.rate:g}, T={self.T:g}, "
            f"steps={self.steps})"
        )

    def _static_signature(self):
        return ("PoissonProcessPath", self.rate, self.T, self.steps)

    def _increments(self, key, n, dtype):
        from probabilit_tpu.ops import ppf as _ppf
        from probabilit_tpu.ops.qmc import clamp_open_unit

        dt = self.T / self.steps
        u = clamp_open_unit(
            jax.random.uniform(key, (n, self.steps), dtype=dtype)
        )
        return _ppf.call("poisson", u, mu=self.rate * dt).astype(dtype)

    def _increments_from_slab(self, slab, dtype):
        from probabilit_tpu.ops import ppf as _ppf

        # Discrete increments take the uniforms directly (no bridge:
        # counts are not Gaussian); each step's count is the inverse-CDF
        # transform of its own QMC dimension.
        dt = self.T / self.steps
        return _ppf.call(
            "poisson", slab.astype(dtype), mu=self.rate * dt
        ).astype(dtype)

    def _path_from_increments(self, inc):
        return jnp.cumsum(inc, axis=1)


class MertonJumpPath(PathDistribution):
    """Merton jump-diffusion asset path — exact per grid step.

    ``log S`` increments per step of length ``dt``:

        (mu - sigma^2/2) dt + sigma sqrt(dt) Z
        + jump_mean * K + jump_std * sqrt(K) * Z'

    with ``K ~ Poisson(jump_rate * dt)``.  Conditional on the jump count
    the summed normal jumps are exactly ``N(K jump_mean, K jump_std^2)``,
    so each grid slice carries the process's exact law — no small-dt
    "at most one jump" approximation.  ``E[S_T] = s0 * exp(mu T +
    jump_rate T (exp(jump_mean + jump_std^2/2) - 1))`` (``mu`` is the
    continuous-part drift, uncompensated).
    """

    # jump_rate is EXCLUDED: it enters through the discrete Poisson
    # count, whose pathwise derivative is zero almost everywhere.
    _param_slots = ("s0", "mu", "sigma", "jump_mean", "jump_std")

    def __init__(
        self,
        s0=1.0,
        mu=0.0,
        sigma=0.2,
        jump_rate=1.0,
        jump_mean=0.0,
        jump_std=0.1,
        T=1.0,
        steps=252,
    ):
        s0, sigma = float(s0), float(sigma)
        jump_rate, jump_std = float(jump_rate), float(jump_std)
        if not s0 > 0:
            raise ValueError(f"s0 must be positive, got {s0}.")
        if not sigma > 0:
            raise ValueError(f"sigma must be positive, got {sigma}.")
        if not jump_rate > 0:
            raise ValueError(f"jump_rate must be positive, got {jump_rate}.")
        if not jump_std >= 0:
            raise ValueError(f"jump_std must be >= 0, got {jump_std}.")
        self.s0 = s0
        self.mu = float(mu)
        self.sigma = sigma
        self.jump_rate = jump_rate
        self.jump_mean = float(jump_mean)
        self.jump_std = jump_std
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"MertonJumpPath(s0={self.s0:g}, mu={self.mu:g}, "
            f"sigma={self.sigma:g}, jump_rate={self.jump_rate:g}, "
            f"jump_mean={self.jump_mean:g}, jump_std={self.jump_std:g}, "
            f"T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "MertonJumpPath",
            self.s0,
            self.mu,
            self.sigma,
            self.jump_rate,
            self.jump_mean,
            self.jump_std,
            self.T,
            self.steps,
        )

    @property
    def _q_width(self):
        # Three drivers per step: diffusion normal, jump-count uniform,
        # summed-jump normal.
        return 3 * self.steps

    def _increments(self, key, n, dtype):
        from probabilit_tpu.ops import ppf as _ppf
        from probabilit_tpu.ops.qmc import clamp_open_unit

        dt = self.T / self.steps
        kz, ku, kj = jax.random.split(key, 3)
        z = jax.random.normal(kz, (n, self.steps), dtype)
        u = clamp_open_unit(
            jax.random.uniform(ku, (n, self.steps), dtype=dtype)
        )
        k_jumps = _ppf.call("poisson", u, mu=self.jump_rate * dt).astype(dtype)
        zj = jax.random.normal(kj, (n, self.steps), dtype)
        return self._combine(z, k_jumps, zj, dt)

    def _increments_from_slab(self, slab, dtype):
        from probabilit_tpu.ops import bridge as _bridge
        from probabilit_tpu.ops import ppf as _ppf
        from probabilit_tpu.ops import special as _special

        # Slab layout [diffusion | jump counts | jump sizes]: the
        # diffusion normals get the leading QMC dimensions (most of the
        # variance for typical parameters) AND the bridge ordering; the
        # discrete counts and conditional jump sums consume their own
        # dimensions directly.
        dt = self.T / self.steps
        s = self.steps
        z = _bridge.normal_increments(slab[:, :s], dtype)
        k_jumps = _ppf.call(
            "poisson", slab[:, s : 2 * s].astype(dtype), mu=self.jump_rate * dt
        ).astype(dtype)
        zj = _special.ndtri_fast(slab[:, 2 * s :].astype(dtype))
        return self._combine(z, k_jumps, zj, dt)

    def _combine(self, z, k_jumps, zj, dt):
        diffusion = (self.mu - 0.5 * self.sigma**2) * dt + self.sigma * (
            dt**0.5
        ) * z
        jumps = self.jump_mean * k_jumps + self.jump_std * jnp.sqrt(k_jumps) * zj
        return diffusion + jumps

    def _path_from_increments(self, inc):
        return self.s0 * jnp.exp(jnp.cumsum(inc, axis=1))


class PathFunctional(Transform):
    """Scalar projection of a path node: terminal/max/min/mean/at."""

    _OPS = ("terminal", "max", "min", "mean", "at")

    def __init__(self, path, op, index=None):
        if not getattr(path, "_is_path", False):
            raise TypeError(
                "PathFunctional needs a SCALAR path node ((n, steps)-"
                f"valued; a PathDistribution or AssetPath view), got {path!r}."
            )
        if op not in self._OPS:
            raise ValueError(f"op must be one of {self._OPS}, got {op!r}.")
        if (op == "at") != (index is not None):
            raise ValueError("index is required for op='at' and only then.")
        self.path = path
        self.op = op
        self.index = index
        super().__init__()

    def __repr__(self):
        extra = f", {self.index}" if self.op == "at" else ""
        return f"{type(self).__name__}({self.path!r}, '{self.op}'{extra})"

    def get_parents(self):
        yield self.path

    def _rewire(self, update):
        self.path = update(self.path)

    def _static_signature(self):
        return ("PathFunctional", self.op, self.index)

    def _emit(self, ctx):
        paths = ctx.value(self.path)
        if self.op == "terminal":
            return paths[:, -1]
        if self.op == "max":
            return jnp.max(paths, axis=1)
        if self.op == "min":
            return jnp.min(paths, axis=1)
        if self.op == "mean":
            return jnp.mean(paths, axis=1)
        return paths[:, self.index]


def BrownianMotion(x0=0.0, drift=0.0, diffusion=1.0, T=1.0, steps=252):
    """Arithmetic Brownian path node; see :class:`BrownianPath`.

    >>> w = BrownianMotion(T=2.0, steps=8)
    >>> w.at(7)
    PathFunctional(BrownianPath(x0=0, drift=0, diffusion=1, T=2, steps=8), 'at', 7)
    """
    return BrownianPath(x0=x0, drift=drift, diffusion=diffusion, T=T, steps=steps)


def GeometricBrownianMotion(s0=1.0, mu=0.0, sigma=0.2, T=1.0, steps=252):
    """Geometric Brownian path node; see :class:`GBMPath`.

    >>> GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2).terminal()
    PathFunctional(GBMPath(s0=100, mu=0.05, sigma=0.2, T=1, steps=252), 'terminal')
    """
    return GBMPath(s0=s0, mu=mu, sigma=sigma, T=T, steps=steps)


def OrnsteinUhlenbeck(x0=0.0, theta=1.0, mu=0.0, sigma=1.0, T=1.0, steps=252):
    """Mean-reverting OU path node (rates/spreads); see :class:`OUPath`.

    >>> OrnsteinUhlenbeck(theta=2.0, mu=0.05, sigma=0.1, T=1.0, steps=4)
    OUPath(x0=0, theta=2, mu=0.05, sigma=0.1, T=1, steps=4)
    """
    return OUPath(x0=x0, theta=theta, mu=mu, sigma=sigma, T=T, steps=steps)


def PoissonProcess(rate=1.0, T=1.0, steps=252):
    """Poisson counting-process path node; see :class:`PoissonProcessPath`.

    >>> PoissonProcess(rate=3.0, T=2.0, steps=8).terminal()
    PathFunctional(PoissonProcessPath(rate=3, T=2, steps=8), 'terminal')
    """
    return PoissonProcessPath(rate=rate, T=T, steps=steps)


def MertonJumpDiffusion(
    s0=1.0,
    mu=0.0,
    sigma=0.2,
    jump_rate=1.0,
    jump_mean=0.0,
    jump_std=0.1,
    T=1.0,
    steps=252,
):
    """Merton jump-diffusion asset path node; see :class:`MertonJumpPath`.

    >>> MertonJumpDiffusion(s0=100, sigma=0.2, jump_rate=0.5, steps=4)
    MertonJumpPath(s0=100, mu=0, sigma=0.2, jump_rate=0.5, jump_mean=0, jump_std=0.1, T=1, steps=4)
    """
    return MertonJumpPath(
        s0=s0,
        mu=mu,
        sigma=sigma,
        jump_rate=jump_rate,
        jump_mean=jump_mean,
        jump_std=jump_std,
        T=T,
        steps=steps,
    )


def _recolor_assets(z, chol):
    """(n, steps, d) iid drivers -> correlated drivers along the asset axis.

    An unrolled lower-triangular mul-add chain rather than a
    ``(d, d)`` matmul: d is tiny, so a matmul pads to the matrix
    unit's tile and fuses worse than elementwise work.  Note the
    last-ULP caveat: the CPU backend contracts this chain's mul-adds
    shape-dependently inside the streaming fori_loop body, so joint
    nodes' streamed runs match single-shot runs to ~1 ULP rather than
    bitwise (scalar path nodes, with no cross-asset mixing, stay
    bitwise); mesh invariance IS bitwise because resharding does not
    change the compiled block shapes.
    """
    cols = []
    for i in range(chol.shape[0]):
        acc = z[:, :, 0] * float(chol[i, 0])
        for j in range(1, i + 1):
            if chol[i, j] != 0.0:
                acc = acc + z[:, :, j] * float(chol[i, j])
        cols.append(acc)
    return jnp.stack(cols, axis=2)


class JointAssetPaths(PathDistribution):
    """Base for joint multi-asset path nodes: ``(n, d, steps)`` emissions.

    A joint node samples all ``d`` assets from ONE coupled law (shared
    recolored drivers, common jump streams, ...); users never touch it
    directly — the family factories (``CorrelatedGBM``,
    ``CorrelatedMerton``, ``CorrelatedHeston``) return per-asset
    :class:`AssetPath` views, each carrying the full functional API.

    Subclasses validate their parameters through :meth:`_asset_params`
    (first axis = asset), produce per-step joint increments shaped
    ``(n, steps, d)`` (or any array whose leading two axes are
    sample/time), and by default build log-price paths
    ``s0 * exp(cumsum)``; families with a different path map (Heston's
    variance-conditioned scheme) override ``_path_from_increments``.
    """

    # NOT a scalar path surface: the emission is (n, d, steps), so
    # PathFunctional must reject it (a functional here would silently
    # reduce over the WRONG axis — op='terminal' would return the last
    # asset's whole path).  Use the per-asset AssetPath views.
    _is_path = False

    @staticmethod
    def _asset_params(name, s0, corr, **params):
        """Validated ``(d, corr, {name: (d,) float64 vector})``.

        ``s0`` fixes the asset count; every other parameter must either
        match its length or be a true scalar (which broadcasts — a
        LIST of length one does not, that is a length mismatch).
        """
        import numpy as np

        s0 = np.asarray(s0, np.float64).ravel()
        d = s0.shape[0]
        if d < 2:
            raise ValueError(f"{name} needs >= 2 assets, got {d}.")
        out = {"s0": s0}
        for k, v in params.items():
            a = np.asarray(v, np.float64)
            out[k] = np.full(d, float(a)) if a.ndim == 0 else a.ravel()
        if any(v.shape != (d,) for v in out.values()):
            raise ValueError(
                "/".join(out) + " must have equal lengths; got "
                + "/".join(str(v.shape[0]) for v in out.values()) + "."
            )
        corr = np.asarray(corr, np.float64)
        if corr.shape != (d, d):
            raise ValueError(f"corr must be ({d}, {d}), got {corr.shape}.")
        return d, corr, out

    def views(self):
        """One :class:`AssetPath` per asset, in parameter order."""
        return tuple(AssetPath(self, i) for i in range(self.d))

    @property
    def _payoff_arity(self):
        """How many leading state paths an LSMC payoff consumes.

        Scalar nodes expose 1 (the observable path); joint nodes expose
        d — ``american_price``'s payoff receives one per-asset slice per
        argument (``lambda s1, s2: jnp.maximum(jnp.maximum(s1, s2) - K,
        0.0)`` for a max-call).
        """
        return self.d

    def _state_paths_from_increments(self, inc):
        """Per-asset paths as the LSMC state tuple (d arrays (n, steps)).

        The joint emission is (n, d, steps); optimal stopping consumes
        per-date vectors, so the state tuple unstacks the asset axis.
        Families with hidden factors (CorrelatedHeston: the variance
        paths) extend the tuple beyond the payoff arity.
        """
        paths = self._path_from_increments(inc)
        return tuple(paths[:, i, :] for i in range(self.d))

    def _path_from_increments(self, inc):
        """(n, d, steps) price paths from (n, steps, d) log-increments."""
        logpath = jnp.cumsum(inc, axis=1)  # cumulative along time
        s0 = jnp.asarray(self.s0, inc.dtype)
        # (n, d, steps): asset-major so each view slices contiguously.
        return jnp.transpose(s0[None, None, :] * jnp.exp(logpath), (0, 2, 1))

    # The joint node's own functional API is ambiguous (which asset?);
    # use the per-asset views.
    def _functional(self, op, index=None):
        raise TypeError(
            "Apply functionals to a per-asset view (the factory's "
            "returned nodes), not the joint node."
        )


class CorrelatedGBMPaths(JointAssetPaths):
    """Joint (n, d, steps) geometric-Brownian paths with correlated drivers.

    The d assets' log-increments share a constant instantaneous
    correlation matrix: one (n, steps, d) standard-normal draw is
    recolored by the Cholesky factor of ``corr`` along the asset axis
    (one small matmul), then each asset runs the exact GBM cumsum.
    Log-terminal correlations therefore equal ``corr`` EXACTLY in
    distribution at every horizon — no discretisation error.

    Unpack per-asset views with the ``CorrelatedGBM`` factory; each view
    carries the full functional API (terminal/max/min/average/at).
    """

    @property
    def _param_slots(self):
        # Per-asset indexed slots (engine/sensitivity.py _parse_slot):
        # s0/mu/sigma enter only the smooth path map given the drivers.
        # corr is EXCLUDED — the Cholesky recolor factor is fixed at
        # construction, so a pathwise corr derivative holding it fixed
        # would be silently wrong.
        return tuple(
            f"{p}[{i}]" for p in ("s0", "mu", "sigma") for i in range(self.d)
        )

    def __init__(self, s0, mu, sigma, corr, T=1.0, steps=252):
        d, corr, p = self._asset_params(
            "CorrelatedGBM", s0, corr, mu=mu, sigma=sigma
        )
        s0, mu, sigma = p["s0"], p["mu"], p["sigma"]
        if not (s0 > 0).all():
            raise ValueError("Every s0 must be positive.")
        if not (sigma > 0).all():
            raise ValueError("Every sigma must be positive.")
        from probabilit_tpu.ops.copulas import corr_cholesky

        chol, _ = corr_cholesky(corr)
        self.s0 = s0
        self.mu = mu
        self.sigma = sigma
        self.corr = corr
        self._chol = chol
        self.d = d
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"CorrelatedGBMPaths(d={self.d}, T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "CorrelatedGBMPaths",
            self.s0.tobytes(),
            self.mu.tobytes(),
            self.sigma.tobytes(),
            self.corr.tobytes(),
            self.T,
            self.steps,
        )

    @property
    def _q_width(self):
        # One Gaussian driver per (asset, step); asset-major slab layout.
        return self.d * self.steps

    def _increments(self, key, n, dtype):
        dt = self.T / self.steps
        z = jax.random.normal(key, (n, self.steps, self.d), dtype)
        return self._recolor(z, dt, dtype)

    def _increments_from_slab(self, slab, dtype):
        from probabilit_tpu.ops import bridge as _bridge

        # Asset a owns slab columns [a*steps, (a+1)*steps), each block
        # bridge-ordered, so dims (0, steps, 2*steps, ...) — the best
        # QMC dimensions under the asset-major layout — control the
        # terminal levels that dominate basket/spread payoffs.
        z = jnp.stack(
            [
                _bridge.normal_increments(
                    slab[:, a * self.steps : (a + 1) * self.steps], dtype
                )
                for a in range(self.d)
            ],
            axis=2,
        )  # (n, steps, d)
        return self._recolor(z, self.T / self.steps, dtype)

    def _recolor(self, z, dt, dtype):
        zc = _recolor_assets(z, self._chol)
        drift = jnp.asarray((self.mu - 0.5 * self.sigma**2) * dt, dtype)
        vol = jnp.asarray(self.sigma * dt**0.5, dtype)
        return drift + vol * zc  # (n, steps, d) log-increments


class AssetPath(PathFunctionalMixin, Transform):
    """One asset's (n, steps) view of a joint correlated-paths node."""

    _vector_valued = True

    def __init__(self, joint, asset):
        if not isinstance(joint, JointAssetPaths):
            raise TypeError(
                "AssetPath views a joint multi-asset paths node "
                f"(CorrelatedGBM/CorrelatedMerton/CorrelatedHeston), got {joint!r}."
            )
        asset = int(asset)
        if not 0 <= asset < joint.d:
            raise ValueError(f"asset must be in [0, {joint.d}), got {asset}.")
        self.joint = joint
        self.asset = asset
        self.steps = joint.steps
        self.T = joint.T
        super().__init__()

    def __repr__(self):
        return f"AssetPath({self.joint!r}, asset={self.asset})"

    def get_parents(self):
        yield self.joint

    def _rewire(self, update):
        self.joint = update(self.joint)
        self.__dict__.pop("_functional_cache", None)

    def _static_signature(self):
        return ("AssetPath", self.asset)

    def _emit(self, ctx):
        return ctx.value(self.joint)[:, self.asset, :]


def CorrelatedGBM(s0, mu, sigma, corr, T=1.0, steps=252):
    """d correlated GBM asset paths sharing one exact joint draw.

    Returns one :class:`AssetPath` view per asset, each with the full
    functional API — basket, spread, and worst-of payoffs compose from
    them directly:

    >>> a, b = CorrelatedGBM([100, 50], [0.03, 0.02], [0.2, 0.3],
    ...                      [[1, 0.6], [0.6, 1]], steps=16)
    >>> basket = 0.5 * a.terminal() + 0.5 * b.terminal()
    """
    joint = CorrelatedGBMPaths(s0, mu, sigma, corr, T=T, steps=steps)
    return tuple(AssetPath(joint, i) for i in range(joint.d))


class CorrelatedMertonPaths(JointAssetPaths):
    """Joint (n, d, steps) Merton jump-diffusion paths — exact per step.

    Three independent exact layers build each grid step's log-increment
    vector (``dt = T / steps``):

    * **Correlated diffusion** — one ``(n, steps, d)`` standard-normal
      draw recolored by the Cholesky factor of ``corr`` along the asset
      axis (one small matmul), scaled per asset: the instantaneous
      Brownian correlation is ``corr`` exactly at every horizon.
    * **Idiosyncratic jumps** — per asset, ``K ~ Poisson(rate_i dt)``
      and the summed normal jumps exactly ``N(K jm_i, K js_i^2)`` given
      the count (the same conditioning as :class:`MertonJumpPath`: no
      small-``dt`` "at most one jump" approximation).  ``rate_i = 0``
      switches asset ``i``'s idiosyncratic jumps off.
    * **Common (systemic) jumps** — one SHARED count ``K_c ~
      Poisson(common_rate dt)`` with summed size ``X ~ N(K_c cm, K_c
      cs^2)`` hits asset ``i``'s log price as ``loadings_i * X``:
      simultaneous crashes across the book, the co-movement a diffusive
      correlation matrix cannot produce (Merton 1976's jump term made
      cross-sectional).

    Every grid slice carries the joint process's exact law, so the
    log-terminal moments are closed-form (and tested):

        E ln(S_Ti/s0_i) = [mu_i - sigma_i^2/2 + rate_i jm_i
                           + load_i cm common_rate] T
        Var ln S_Ti     = [sigma_i^2 + rate_i (jm_i^2 + js_i^2)
                           + load_i^2 common_rate (cm^2 + cs^2)] T
        Cov(ln S_Ti, ln S_Tj) = [sigma_i sigma_j corr_ij
                           + load_i load_j common_rate (cm^2 + cs^2)] T

    Use the ``CorrelatedMerton`` factory for per-asset views.
    """

    @property
    def _param_slots(self):
        # Indexed per-asset slots; jump_rate/common_rate enter through
        # discrete Poisson counts (zero pathwise derivative a.e.) and
        # corr through the fixed Cholesky factor — both excluded.
        slots = tuple(
            f"{p}[{i}]"
            for p in ("s0", "mu", "sigma", "jump_mean", "jump_std", "loadings")
            for i in range(self.d)
        )
        if self.common_rate > 0:
            slots = slots + ("common_mean", "common_std")
        return slots

    def __init__(
        self,
        s0,
        mu,
        sigma,
        corr,
        jump_rate=1.0,
        jump_mean=0.0,
        jump_std=0.1,
        common_rate=0.0,
        common_mean=0.0,
        common_std=0.0,
        loadings=1.0,
        T=1.0,
        steps=252,
    ):
        d, corr, p = self._asset_params(
            "CorrelatedMerton",
            s0,
            corr,
            mu=mu,
            sigma=sigma,
            jump_rate=jump_rate,
            jump_mean=jump_mean,
            jump_std=jump_std,
            loadings=loadings,
        )
        if not (p["s0"] > 0).all():
            raise ValueError("Every s0 must be positive.")
        if not (p["sigma"] > 0).all():
            raise ValueError("Every sigma must be positive.")
        if not (p["jump_rate"] >= 0).all():
            raise ValueError("Every jump_rate must be >= 0.")
        if not (p["jump_std"] >= 0).all():
            raise ValueError("Every jump_std must be >= 0.")
        common_rate, common_std = float(common_rate), float(common_std)
        if not common_rate >= 0:
            raise ValueError(f"common_rate must be >= 0, got {common_rate}.")
        if not common_std >= 0:
            raise ValueError(f"common_std must be >= 0, got {common_std}.")
        from probabilit_tpu.ops.copulas import corr_cholesky

        chol, _ = corr_cholesky(corr)
        self.s0 = p["s0"]
        self.mu = p["mu"]
        self.sigma = p["sigma"]
        self.jump_rate = p["jump_rate"]
        self.jump_mean = p["jump_mean"]
        self.jump_std = p["jump_std"]
        self.loadings = p["loadings"]
        self.common_rate = common_rate
        self.common_mean = float(common_mean)
        self.common_std = common_std
        self.corr = corr
        self._chol = chol
        self.d = d
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"CorrelatedMertonPaths(d={self.d}, common_rate="
            f"{self.common_rate:g}, T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "CorrelatedMertonPaths",
            self.s0.tobytes(),
            self.mu.tobytes(),
            self.sigma.tobytes(),
            self.jump_rate.tobytes(),
            self.jump_mean.tobytes(),
            self.jump_std.tobytes(),
            self.loadings.tobytes(),
            self.common_rate,
            self.common_mean,
            self.common_std,
            self.corr.tobytes(),
            self.T,
            self.steps,
        )

    @property
    def _q_width(self):
        # Per (asset, step): diffusion normal + jump-count uniform +
        # summed-jump normal; plus one shared count/size pair per step
        # when the common stream is on.
        w = 3 * self.d * self.steps
        return w + (2 * self.steps if self.common_rate > 0 else 0)

    def _idio_counts(self, u):
        """(n, steps, d) jump counts from per-asset Poisson inverse CDFs.

        Per-asset STATIC rates keep each inversion on the baked-CDF
        table fast path (ops/ppf.py poisson); zero-rate assets skip the
        draw entirely.
        """
        from probabilit_tpu.ops import ppf as _ppf

        dt = self.T / self.steps
        cols = []
        for a in range(self.d):
            rate = float(self.jump_rate[a])
            if rate == 0.0:
                cols.append(jnp.zeros(u.shape[:2], u.dtype))
            else:
                cols.append(
                    _ppf.call("poisson", u[:, :, a], mu=rate * dt).astype(u.dtype)
                )
        return jnp.stack(cols, axis=2)

    def _increments(self, key, n, dtype):
        from probabilit_tpu.ops import ppf as _ppf
        from probabilit_tpu.ops.qmc import clamp_open_unit

        dt = self.T / self.steps
        kz, ku, kj, kcu, kcz = jax.random.split(key, 5)
        z = jax.random.normal(kz, (n, self.steps, self.d), dtype)
        u = clamp_open_unit(
            jax.random.uniform(ku, (n, self.steps, self.d), dtype=dtype)
        )
        k_idio = self._idio_counts(u)
        zj = jax.random.normal(kj, (n, self.steps, self.d), dtype)
        if self.common_rate > 0:
            uc = clamp_open_unit(
                jax.random.uniform(kcu, (n, self.steps), dtype=dtype)
            )
            k_common = _ppf.call(
                "poisson", uc, mu=self.common_rate * dt
            ).astype(dtype)
            zc2 = jax.random.normal(kcz, (n, self.steps), dtype)
        else:
            k_common = zc2 = None
        return self._combine(z, k_idio, zj, k_common, zc2, dtype)

    def _increments_from_slab(self, slab, dtype):
        from probabilit_tpu.ops import bridge as _bridge
        from probabilit_tpu.ops import ppf as _ppf
        from probabilit_tpu.ops import special as _special

        # Slab layout [d bridged diffusion blocks | d count blocks |
        # d size blocks | common count | common size], asset-major
        # within each section: the diffusion normals carry most of the
        # variance for typical parameters, so they own the leading QMC
        # dimensions (each block bridge-ordered: dims 0, steps, ... set
        # the terminal levels basket payoffs care about).
        s, d = self.steps, self.d
        dt = self.T / s
        z = jnp.stack(
            [
                _bridge.normal_increments(slab[:, a * s : (a + 1) * s], dtype)
                for a in range(d)
            ],
            axis=2,
        )
        u = jnp.stack(
            [slab[:, (d + a) * s : (d + a + 1) * s].astype(dtype) for a in range(d)],
            axis=2,
        )
        k_idio = self._idio_counts(u)
        zj = jnp.stack(
            [
                _special.ndtri_fast(
                    slab[:, (2 * d + a) * s : (2 * d + a + 1) * s].astype(dtype)
                )
                for a in range(d)
            ],
            axis=2,
        )
        if self.common_rate > 0:
            off = 3 * d * s
            k_common = _ppf.call(
                "poisson",
                slab[:, off : off + s].astype(dtype),
                mu=self.common_rate * dt,
            ).astype(dtype)
            zc2 = _special.ndtri_fast(slab[:, off + s :].astype(dtype))
        else:
            k_common = zc2 = None
        return self._combine(z, k_idio, zj, k_common, zc2, dtype)

    def _combine(self, z, k_idio, zj, k_common, zc2, dtype):
        dt = self.T / self.steps
        zc = _recolor_assets(z, self._chol)
        drift = jnp.asarray((self.mu - 0.5 * self.sigma**2) * dt, dtype)
        vol = jnp.asarray(self.sigma * dt**0.5, dtype)
        jm = jnp.asarray(self.jump_mean, dtype)
        js = jnp.asarray(self.jump_std, dtype)
        inc = drift + vol * zc + jm * k_idio + js * jnp.sqrt(k_idio) * zj
        if k_common is not None:
            common = self.common_mean * k_common + self.common_std * jnp.sqrt(
                k_common
            ) * zc2  # (n, steps) summed systemic jump sizes
            inc = inc + jnp.asarray(self.loadings, dtype) * common[:, :, None]
        return inc  # (n, steps, d) log-increments


def CorrelatedMerton(
    s0,
    mu,
    sigma,
    corr,
    jump_rate=1.0,
    jump_mean=0.0,
    jump_std=0.1,
    common_rate=0.0,
    common_mean=0.0,
    common_std=0.0,
    loadings=1.0,
    T=1.0,
    steps=252,
):
    """d correlated Merton jump-diffusions sharing one exact joint draw.

    Correlated diffusive Brownians (``corr``), per-asset idiosyncratic
    compound-Poisson-normal jumps, and an optional COMMON systemic jump
    stream hitting every asset through ``loadings`` — see
    :class:`CorrelatedMertonPaths` for the exact per-step law and the
    closed-form log-terminal moments.  Returns one :class:`AssetPath`
    view per asset:

    >>> a, b = CorrelatedMerton([100, 50], [0.03, 0.02], [0.2, 0.3],
    ...                         [[1, 0.5], [0.5, 1]], jump_rate=[0.5, 1.0],
    ...                         jump_mean=-0.05, common_rate=0.2,
    ...                         common_mean=-0.1, common_std=0.05, steps=16)
    >>> basket = 0.5 * a.terminal() + 0.5 * b.terminal()
    """
    joint = CorrelatedMertonPaths(
        s0,
        mu,
        sigma,
        corr,
        jump_rate=jump_rate,
        jump_mean=jump_mean,
        jump_std=jump_std,
        common_rate=common_rate,
        common_mean=common_mean,
        common_std=common_std,
        loadings=loadings,
        T=T,
        steps=steps,
    )
    return joint.views()
