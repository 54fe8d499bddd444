"""Square-root-diffusion nodes: CIR variance paths and the Heston model.

Framework extension (the reference models scalar draws only; its closest
primitive is a scipy-backed scalar ``Distribution``, modeling.py:760-812).
The Cox-Ingersoll-Ross process has a CLOSED-FORM transition — a scaled
noncentral chi-square — so its grid path can be sampled EXACTLY, with no
Euler/Milstein error at any step size and no truncation tricks near
zero:

    V_{k+1} | V_k  =  c * ncx2(df, V_k * e / c),      e = exp(-kappa dt),
    c = sigma^2 (1 - e) / (4 kappa),   df = 4 kappa theta / sigma^2.

Device shape: the noncentral chi-square is decomposed as
``(Z + sqrt(lambda))^2 + Y`` with ``Z ~ N(0,1)`` and ``Y ~ chi2(df-1)``
(valid for ``df > 1``; weaker than the Feller condition ``df >= 2``).
Both driver matrices are pre-sampled OUTSIDE the time recursion — one
``(n, steps)`` normal draw plus one inverse-CDF chi-square transform —
so the unavoidable sequential part is a ``lax.scan`` whose body is four
elementwise ops on an ``(n,)`` carry.  Nothing in the loop draws
randomness or inverts CDFs; XLA streams the pre-sampled columns at
memory speed.

The Heston asset path rides the exact variance path with Andersen's
broken scheme (Andersen 2008, "Simple and efficient simulation of the
Heston stochastic volatility model", eq. 33): the variance integral
over a step is approximated by the trapezoid ``dt (V_k + V_{k+1}) / 2``
and the variance's own Brownian integral is recovered exactly from the
CIR dynamics, so the asset's conditional law given the variance path is
Gaussian with the correct leverage (rho) coupling.  Variance marginals
are exact at every grid time; the asset carries only the O(dt^2)-weak
trapezoid error — far smaller than full Euler, which also mangles the
variance near zero.

Randomness follows the path-node contract (models/processes.py): under
``method=None`` drivers come from a column-seeded PRNG key; under a
QMC/antithetic method the node owns ``_q_width`` quantile columns
(normals through ``ndtri``, chi-square through the native inverse CDF).

>>> v = CoxIngersollRoss(v0=0.04, kappa=2.0, theta=0.04, sigma=0.3)
>>> v.terminal()
PathFunctional(CIRPath(v0=0.04, kappa=2, theta=0.04, sigma=0.3, T=1, steps=252), 'terminal')
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from probabilit_tpu.models.processes import JointAssetPaths, PathDistribution

__all__ = [
    "CoxIngersollRoss",
    "Heston",
    "CorrelatedHeston",
    "CIRPath",
    "HestonPath",
    "CorrelatedHestonPaths",
]


def _cir_constants(kappa, theta, sigma, dt):
    """(e, c, df): exact-transition constants for one grid step."""
    e = math.exp(-kappa * dt)
    c = sigma * sigma * (1.0 - e) / (4.0 * kappa)
    df = 4.0 * kappa * theta / (sigma * sigma)
    return e, c, df


def _validate_cir(v0, kappa, theta, sigma, what="v0"):
    v0, kappa = float(v0), float(kappa)
    theta, sigma = float(theta), float(sigma)
    if not v0 > 0:
        raise ValueError(f"{what} must be positive, got {v0}.")
    if not kappa > 0:
        raise ValueError(f"kappa must be positive, got {kappa}.")
    if not theta > 0:
        raise ValueError(f"theta must be positive, got {theta}.")
    if not sigma > 0:
        raise ValueError(f"sigma must be positive, got {sigma}.")
    df = 4.0 * kappa * theta / (sigma * sigma)
    if not df > 1.0:
        raise ValueError(
            "Exact CIR sampling needs 4*kappa*theta/sigma^2 > 1 (the "
            "normal + central-chi-square decomposition of the noncentral "
            f"chi-square transition), got {df:.4g}. Increase kappa*theta "
            "or decrease sigma."
        )
    return v0, kappa, theta, sigma


def _cir_drivers_key(key, n, steps, df, dtype):
    """Pre-sampled (z, y) driver matrices from a PRNG key."""
    from probabilit_tpu.ops import ppf as _ppf
    from probabilit_tpu.ops.qmc import clamp_open_unit

    kz, ky = jax.random.split(key)
    z = jax.random.normal(kz, (n, steps), dtype)
    u = clamp_open_unit(jax.random.uniform(ky, (n, steps), dtype=dtype))
    y = _ppf.call("chi2", u, df=df - 1.0).astype(dtype)
    return z, y


def _cir_drivers_slab(u_z, u_y, df, dtype):
    """Pre-sampled (z, y) driver matrices from quantile slabs.

    No Brownian-bridge reorder: the CIR recursion is nonlinear in its
    innovations (each feeds a squared noncentrality), so the
    coarse-to-fine variance alignment that justifies the bridge for
    Gaussian cumulative sums does not apply; each step consumes its own
    QMC dimension directly.
    """
    from probabilit_tpu.ops import ppf as _ppf
    from probabilit_tpu.ops import special as _special

    z = _special.ndtri_fast(u_z.astype(dtype))
    y = _ppf.call("chi2", u_y.astype(dtype), df=df - 1.0).astype(dtype)
    return z, y


def _cir_scan(v0, e, c, z, y, dtype):
    """(n, steps) exact CIR paths from pre-sampled drivers.

    The only sequential dependence is the noncentrality
    ``lambda_k = V_k e / c``; the scan body is four elementwise ops on
    the ``(n,)`` carry (no RNG, no CDF inversion inside the loop — XLA
    loop iterations cannot fuse, so everything expensive is hoisted to
    the pre-sampled driver matrices).
    """
    e = jnp.asarray(e, dtype)
    c = jnp.asarray(c, dtype)
    ratio = e / c

    def step(v, zy):
        z_k, y_k = zy
        shifted = z_k + jnp.sqrt(v * ratio)
        v_next = c * (shifted * shifted + y_k)
        return v_next, v_next

    init = jnp.full((z.shape[0],), v0, dtype)
    # scan over the time axis: drivers laid out (steps, n).
    _, vs = jax.lax.scan(step, init, (z.T, y.T))
    return vs.T


class CIRPath(PathDistribution):
    """Cox-Ingersoll-Ross square-root diffusion — exact grid transitions.

    ``dV = kappa (theta - V) dt + sigma sqrt(V) dW`` sampled through the
    closed-form noncentral-chi-square transition law, so every grid
    slice is exact: ``at(k) ~ c_k * ncx2(df, v0 * e_k / c_k)`` with
    ``e_k = exp(-kappa t_k)``, ``c_k = sigma^2 (1 - e_k) / (4 kappa)``
    (the one-step constants composed to horizon ``t_k`` — the transition
    family is closed under composition).  Requires
    ``4 kappa theta / sigma^2 > 1``; paths are positive by construction
    (no truncation/reflection fixes).
    """

    # kappa/theta/sigma shape the chi-square DRIVER LAW (df), so
    # pathwise derivatives that hold the drivers fixed are invalid for
    # them; v0 enters only the smooth scan given the drivers.
    _param_slots = ("v0",)

    def __init__(self, v0=0.04, kappa=1.0, theta=0.04, sigma=0.2, T=1.0, steps=252):
        self.v0, self.kappa, self.theta, self.sigma = _validate_cir(
            v0, kappa, theta, sigma
        )
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"CIRPath(v0={self.v0:g}, kappa={self.kappa:g}, "
            f"theta={self.theta:g}, sigma={self.sigma:g}, T={self.T:g}, "
            f"steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "CIRPath",
            self.v0,
            self.kappa,
            self.theta,
            self.sigma,
            self.T,
            self.steps,
        )

    @property
    def _q_width(self):
        # Two drivers per step: transition normal + central chi-square.
        return 2 * self.steps

    def _constants(self):
        return _cir_constants(self.kappa, self.theta, self.sigma, self.T / self.steps)

    def _increments(self, key, n, dtype):
        _, _, df = self._constants()
        z, y = _cir_drivers_key(key, n, self.steps, df, dtype)
        return jnp.stack([z, y], axis=2)

    def _increments_from_slab(self, slab, dtype):
        _, _, df = self._constants()
        s = self.steps
        z, y = _cir_drivers_slab(slab[:, :s], slab[:, s:], df, dtype)
        return jnp.stack([z, y], axis=2)

    def _path_from_increments(self, inc):
        e, c, _ = self._constants()
        return _cir_scan(self.v0, e, c, inc[:, :, 0], inc[:, :, 1], inc.dtype)


class HestonPath(PathDistribution):
    """Heston stochastic-volatility asset path (exact-variance scheme).

    ``dS = mu S dt + sqrt(V) S dW_S``, ``dV = kappa (theta - V) dt +
    sigma sqrt(V) dW_V``, ``corr(dW_S, dW_V) = rho``.  The variance path
    is sampled EXACTLY (noncentral-chi-square transitions, see
    :class:`CIRPath`); the log-asset increment conditions on it through
    Andersen's broken scheme: with ``I_k = dt (V_k + V_{k+1}) / 2`` (the
    trapezoidal integrated variance, the scheme's only approximation)
    the variance's Brownian integral is recovered exactly from the CIR
    dynamics as ``A_k = (V_{k+1} - V_k - kappa theta dt + kappa I_k) /
    sigma``, and

        ln S_{k+1} = ln S_k + mu dt - I_k / 2 + rho A_k
                     + sqrt(1 - rho^2) sqrt(I_k) Z_k .

    Variance marginals carry zero discretisation error at every grid
    time; the asset's weak error is O(dt^2) from the trapezoid alone
    (Euler is O(dt) and needs ad-hoc fixes near V = 0).
    """

    # kappa/theta/sigma shape the chi-square DRIVER LAW (df) — no valid
    # pathwise derivative holding drivers fixed; s0/mu/rho/v0 enter only
    # the smooth path map given the drivers, so they ARE differentiable.
    _param_slots = ("s0", "mu", "rho", "v0")

    def __init__(
        self,
        s0=1.0,
        mu=0.0,
        v0=0.04,
        kappa=1.0,
        theta=0.04,
        sigma=0.2,
        rho=-0.5,
        T=1.0,
        steps=252,
    ):
        s0, rho = float(s0), float(rho)
        if not s0 > 0:
            raise ValueError(f"s0 must be positive, got {s0}.")
        if not -1.0 < rho < 1.0:
            raise ValueError(f"rho must be in (-1, 1), got {rho}.")
        self.s0 = s0
        self.mu = float(mu)
        self.rho = rho
        self.v0, self.kappa, self.theta, self.sigma = _validate_cir(
            v0, kappa, theta, sigma
        )
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"HestonPath(s0={self.s0:g}, mu={self.mu:g}, v0={self.v0:g}, "
            f"kappa={self.kappa:g}, theta={self.theta:g}, "
            f"sigma={self.sigma:g}, rho={self.rho:g}, T={self.T:g}, "
            f"steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "HestonPath",
            self.s0,
            self.mu,
            self.v0,
            self.kappa,
            self.theta,
            self.sigma,
            self.rho,
            self.T,
            self.steps,
        )

    @property
    def _q_width(self):
        # Three drivers per step: asset normal, variance normal,
        # variance central chi-square.
        return 3 * self.steps

    def _constants(self):
        return _cir_constants(self.kappa, self.theta, self.sigma, self.T / self.steps)

    def _increments(self, key, n, dtype):
        _, _, df = self._constants()
        ks, kv = jax.random.split(key)
        zs = jax.random.normal(ks, (n, self.steps), dtype)
        zv, y = _cir_drivers_key(kv, n, self.steps, df, dtype)
        return jnp.stack([zs, zv, y], axis=2)

    def _increments_from_slab(self, slab, dtype):
        from probabilit_tpu.ops import bridge as _bridge

        _, _, df = self._constants()
        s = self.steps
        # The asset normals enter a cumulative sum, so they take the
        # LEADING slab columns with the Brownian-bridge reorder (QMC
        # dimension 0 drives the terminal log-return given the variance
        # path); the variance drivers feed the nonlinear CIR recursion
        # and consume their dimensions directly.
        zs = _bridge.normal_increments(slab[:, :s], dtype)
        zv, y = _cir_drivers_slab(slab[:, s : 2 * s], slab[:, 2 * s :], df, dtype)
        return jnp.stack([zs, zv, y], axis=2)

    def _state_paths_from_increments(self, inc):
        """(asset, variance) — the complete per-date Markov state.

        The joint-basis LSMC regression (engine/american.py) conditions
        on BOTH: with a hidden variance factor, an asset-only
        continuation regression is strictly coarser than the true
        Markov state and its two-pass lower bound is systematically
        loose (Longstaff-Schwartz 2001 §8 discuss the state choice).
        """
        dtype = inc.dtype
        dt = self.T / self.steps
        e, c, _ = self._constants()
        zs = inc[:, :, 0]
        v = _cir_scan(self.v0, e, c, inc[:, :, 1], inc[:, :, 2], dtype)
        v_prev = jnp.concatenate(
            [jnp.full((v.shape[0], 1), self.v0, dtype), v[:, :-1]], axis=1
        )
        integral = (0.5 * dt) * (v_prev + v)
        brownian_v = (
            v - v_prev - self.kappa * self.theta * dt + self.kappa * integral
        ) / self.sigma
        # jnp (not math) sqrt: rho is a differentiable slot and may be a
        # traced scalar under sensitivity()/american_greeks().
        dlog = (
            self.mu * dt
            - 0.5 * integral
            + self.rho * brownian_v
            + jnp.sqrt(1.0 - self.rho * self.rho) * jnp.sqrt(integral) * zs
        )
        return (self.s0 * jnp.exp(jnp.cumsum(dlog, axis=1)), v)

    def _path_from_increments(self, inc):
        return self._state_paths_from_increments(inc)[0]


def CoxIngersollRoss(v0=0.04, kappa=1.0, theta=0.04, sigma=0.2, T=1.0, steps=252):
    """Exact CIR square-root diffusion path node; see :class:`CIRPath`.

    >>> CoxIngersollRoss(v0=0.03, kappa=2.0, theta=0.04, sigma=0.3, steps=4)
    CIRPath(v0=0.03, kappa=2, theta=0.04, sigma=0.3, T=1, steps=4)
    """
    return CIRPath(v0=v0, kappa=kappa, theta=theta, sigma=sigma, T=T, steps=steps)


def Heston(
    s0=1.0,
    mu=0.0,
    v0=0.04,
    kappa=1.0,
    theta=0.04,
    sigma=0.2,
    rho=-0.5,
    T=1.0,
    steps=252,
):
    """Heston stochastic-volatility asset path node; see :class:`HestonPath`.

    >>> Heston(s0=100, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7,
    ...        steps=4).terminal()
    PathFunctional(HestonPath(s0=100, mu=0, v0=0.04, kappa=2, theta=0.04, sigma=0.3, rho=-0.7, T=1, steps=4), 'terminal')
    """
    return HestonPath(
        s0=s0,
        mu=mu,
        v0=v0,
        kappa=kappa,
        theta=theta,
        sigma=sigma,
        rho=rho,
        T=T,
        steps=steps,
    )


def _cir_scan_multi(v0, e, c, z, y, dtype):
    """(n, steps, d) exact CIR paths, one parameter set per asset.

    The per-asset transition constants broadcast along the trailing
    asset axis of the ``(n, d)`` carry; the scan body is the same four
    elementwise ops as the scalar :func:`_cir_scan`.
    """
    e = jnp.asarray(e, dtype)  # (d,)
    c = jnp.asarray(c, dtype)
    ratio = e / c

    def step(v, zy):
        z_k, y_k = zy  # (n, d)
        shifted = z_k + jnp.sqrt(v * ratio)
        v_next = c * (shifted * shifted + y_k)
        return v_next, v_next

    init = jnp.broadcast_to(
        jnp.asarray(v0, dtype), (z.shape[0], z.shape[2])
    )
    # scan over the time axis: drivers laid out (steps, n, d).
    _, vs = jax.lax.scan(
        step, init, (jnp.moveaxis(z, 1, 0), jnp.moveaxis(y, 1, 0))
    )
    return jnp.moveaxis(vs, 0, 1)  # (n, steps, d)


class CorrelatedHestonPaths(JointAssetPaths):
    """Joint (n, d, steps) Heston assets with correlated price drivers.

    Each asset runs its own EXACT CIR variance path (noncentral
    chi-square transitions, independent variance drivers across assets)
    and Andersen's broken scheme conditional on it, exactly as the
    single-asset :class:`HestonPath` — the per-asset marginal law is
    identical to ``Heston(...)`` with the same parameters.  Cross-asset
    dependence targets ``corr(dW_Si, dW_Sj) = corr_ij`` for the ASSET
    Brownians: splitting ``W_Si = rho_i B_i + sqrt(1 - rho_i^2) Z_i``
    (``B_i`` the variance driver, ``Z_i`` idiosyncratic) and recoloring
    the idiosyncratic block with

        Q_ij = corr_ij / sqrt((1 - rho_i^2)(1 - rho_j^2)),   Q_ii = 1

    gives ``corr(W_Si, W_Sj) = corr_ij`` exactly, because the variance
    drivers are mutually independent.  Feasibility therefore requires
    ``Q`` positive definite — in particular ``|corr_ij| <
    sqrt((1 - rho_i^2)(1 - rho_j^2))``: strong leverage caps how much
    diffusive cross-correlation the model can carry (the remainder is
    exactly the co-movement a common-variance-driver extension would
    add).  The joint construction raises an informative error outside
    the feasible set.

    Log-terminal correlation is the conditional-Gaussian mixture
    ``corr_ij * E[sum_k sqrt(I_ki I_kj)] / sqrt(E[sum I_i] E[sum I_j])``
    (``I`` the per-step integrated variances): exactly ``corr_ij`` in
    the deterministic-variance limit and Cauchy-Schwarz-attenuated
    below it for finite vol-of-vol.

    ``var_corr=lambda`` (0 <= lambda < 1, default 0) adds a COMMON
    variance factor: each asset's per-step variance-innovation normal
    decomposes as ``z_a = sqrt(lambda) g + sqrt(1 - lambda) eps_a``
    with one shared ``g`` per (path, step), so variance shocks co-move
    — the vol-of-vol systemic channel (market-wide variance events)
    that independent variance drivers cannot express.  Guarantees:

    * every per-asset MARGINAL law is exactly unchanged (``z_a`` stays
      standard normal; the chi-square remainders ``y_a`` stay
      independent), so single-asset parity tests keep passing;
    * the one-step conditional variance covariance has the closed form
      ``Cov(v_i', v_j' | v) = c_i c_j (2 lambda^2 + 4 lambda
      sqrt(v_i e_i / c_i) sqrt(v_j e_j / c_j))`` (the tested contract);
    * realized ASSET correlation gains approximately
      ``rho_i rho_j corr(B_i, B_j)`` on top of the idiosyncratic
      recolor's target — with same-sign leverage this ADDS correlation
      beyond the independent-driver feasibility bound above (the
      co-movement channel that bound could not carry).  The recolor
      target ``Q`` is left at its ``var_corr=0`` form (conservative and
      exact there; with ``var_corr > 0`` the stated ``corr`` becomes
      the idiosyncratic-channel floor rather than the exact total).

    Use the ``CorrelatedHeston`` factory for per-asset views.
    """

    @property
    def _param_slots(self):
        # Indexed per-asset slots: s0/mu/v0 enter only the smooth path
        # map given the drivers (as in the single-asset HestonPath).
        # rho is EXCLUDED here, unlike HestonPath: the recolor factor
        # chol(Q) depends on rho and is fixed at construction, so a
        # pathwise rho derivative holding it fixed would silently drop
        # the cross-correlation channel.  kappa/theta/sigma shape the
        # chi-square driver law and stay excluded as always.
        return tuple(
            f"{p}[{i}]" for p in ("s0", "mu", "v0") for i in range(self.d)
        )

    def __init__(
        self, s0, mu, v0, kappa, theta, sigma, rho, corr, T=1.0, steps=252,
        var_corr=0.0,
    ):
        import numpy as np

        var_corr = float(var_corr)
        if not 0.0 <= var_corr < 1.0:
            raise ValueError(
                f"var_corr must be in [0, 1), got {var_corr} (1 would "
                "make every asset's variance innovations identical)."
            )
        d, corr, p = self._asset_params(
            "CorrelatedHeston",
            s0,
            corr,
            mu=mu,
            v0=v0,
            kappa=kappa,
            theta=theta,
            sigma=sigma,
            rho=rho,
        )
        if not (p["s0"] > 0).all():
            raise ValueError("Every s0 must be positive.")
        if not (np.abs(p["rho"]) < 1).all():
            raise ValueError("Every rho must be in (-1, 1).")
        for a in range(d):
            _validate_cir(
                p["v0"][a], p["kappa"][a], p["theta"][a], p["sigma"][a],
                what=f"v0[{a}]",
            )
        from probabilit_tpu.ops.copulas import corr_cholesky

        # corr must be a valid correlation matrix in its own right...
        corr_cholesky(corr)
        # ...AND the implied idiosyncratic correlation must be one too.
        scale = np.sqrt(1.0 - p["rho"] ** 2)
        Q = corr / np.outer(scale, scale)
        np.fill_diagonal(Q, 1.0)
        try:
            chol_q = np.linalg.cholesky(Q)
        except np.linalg.LinAlgError:
            raise ValueError(
                "corr is infeasible with these leverage rhos: with "
                "independent per-asset variance drivers the idiosyncratic "
                "drivers must carry Q_ij = corr_ij / "
                "sqrt((1-rho_i^2)(1-rho_j^2)), which must be positive "
                "definite (in particular |corr_ij| < "
                "sqrt((1-rho_i^2)(1-rho_j^2))).  Weaken corr or the rhos."
            ) from None
        self.s0 = p["s0"]
        self.mu = p["mu"]
        self.v0 = p["v0"]
        self.kappa = p["kappa"]
        self.theta = p["theta"]
        self.sigma = p["sigma"]
        self.rho = p["rho"]
        self.corr = corr
        self._chol_q = chol_q
        self.d = d
        self.var_corr = var_corr
        super().__init__(steps, T)

    def __repr__(self):
        extra = f", var_corr={self.var_corr:g}" if self.var_corr else ""
        return (
            f"CorrelatedHestonPaths(d={self.d}, T={self.T:g}, "
            f"steps={self.steps}{extra})"
        )

    def _static_signature(self):
        return (
            "CorrelatedHestonPaths",
            self.s0.tobytes(),
            self.mu.tobytes(),
            self.v0.tobytes(),
            self.kappa.tobytes(),
            self.theta.tobytes(),
            self.sigma.tobytes(),
            self.rho.tobytes(),
            self.corr.tobytes(),
            self.T,
            self.steps,
            self.var_corr,
        )

    @property
    def _q_width(self):
        # Per (asset, step): asset normal + variance normal + variance
        # central chi-square, like the single-asset HestonPath; one
        # extra steps-wide block for the common variance factor g when
        # var_corr > 0.
        return (3 * self.d + (1 if self.var_corr else 0)) * self.steps

    def _constants(self):
        import numpy as np

        dt = self.T / self.steps
        e = np.exp(-self.kappa * dt)
        c = self.sigma**2 * (1.0 - e) / (4.0 * self.kappa)
        df = 4.0 * self.kappa * self.theta / (self.sigma**2)
        return e, c, df

    def _mix_common_var(self, zv, g):
        """Blend the common factor into the per-asset variance normals.

        ``z_a := sqrt(lam) g + sqrt(1 - lam) eps_a`` keeps every z_a
        standard normal (marginal laws untouched) with
        ``corr(z_a, z_b) = lam`` across assets.
        """
        lam = self.var_corr
        return (lam**0.5) * g[:, :, None] + ((1.0 - lam) ** 0.5) * zv

    def _increments(self, key, n, dtype):
        _, _, df = self._constants()
        ks, kv = jax.random.split(key)
        zs = jax.random.normal(ks, (n, self.steps, self.d), dtype)
        zv, y = [], []
        for a, ka in enumerate(jax.random.split(kv, self.d)):
            z_a, y_a = _cir_drivers_key(ka, n, self.steps, float(df[a]), dtype)
            zv.append(z_a)
            y.append(y_a)
        zv = jnp.stack(zv, axis=2)
        if self.var_corr:
            kg = jax.random.fold_in(key, 0xC0F)
            g = jax.random.normal(kg, (n, self.steps), dtype)
            zv = self._mix_common_var(zv, g)
        return jnp.stack(
            [zs, zv, jnp.stack(y, axis=2)], axis=2
        )  # (n, steps, 3, d)

    def _increments_from_slab(self, slab, dtype):
        from probabilit_tpu.ops import bridge as _bridge

        # Slab layout [d bridged asset-normal blocks | d variance-normal
        # blocks | d chi-square blocks], asset-major within each section
        # — the leading d*steps dimensions control the terminal levels
        # (given the variance paths) that basket payoffs care about,
        # mirroring the single-asset HestonPath layout per asset.
        _, _, df = self._constants()
        s, d = self.steps, self.d
        zs = jnp.stack(
            [
                _bridge.normal_increments(slab[:, a * s : (a + 1) * s], dtype)
                for a in range(d)
            ],
            axis=2,
        )
        zv, y = [], []
        for a in range(d):
            z_a, y_a = _cir_drivers_slab(
                slab[:, (d + a) * s : (d + a + 1) * s],
                slab[:, (2 * d + a) * s : (2 * d + a + 1) * s],
                float(df[a]),
                dtype,
            )
            zv.append(z_a)
            y.append(y_a)
        zv = jnp.stack(zv, axis=2)
        if self.var_corr:
            from probabilit_tpu.ops import special as _special

            # Trailing steps-wide block: the common variance factor
            # (plain per-step dimensions, like the variance drivers —
            # no bridge; see _cir_drivers_slab).
            g = _special.ndtri_fast(
                slab[:, 3 * d * s : (3 * d + 1) * s].astype(dtype)
            )
            zv = self._mix_common_var(zv, g)
        return jnp.stack(
            [zs, zv, jnp.stack(y, axis=2)], axis=2
        )

    def _state_paths_from_increments(self, inc):
        """(asset_0..asset_{d-1}, var_0..var_{d-1}) — the full Markov state.

        The LSMC payoff consumes the first ``d`` (``_payoff_arity``)
        entries; the joint-basis continuation regression conditions on
        the variances too, exactly as the single-asset HestonPath does
        (asset-only bases are strictly coarser under stochastic vol).
        """
        paths, v = self._paths_and_variances(inc)
        return tuple(paths[:, i, :] for i in range(self.d)) + tuple(
            v[:, :, i] for i in range(self.d)
        )

    def _paths_and_variances(self, inc):
        dtype = inc.dtype
        dt = self.T / self.steps
        e, c, _ = self._constants()
        zs = inc[:, :, 0, :]  # (n, steps, d)
        v = _cir_scan_multi(self.v0, e, c, inc[:, :, 1, :], inc[:, :, 2, :], dtype)
        v0 = jnp.asarray(self.v0, dtype)
        v_prev = jnp.concatenate(
            [jnp.broadcast_to(v0, (v.shape[0], 1, self.d)), v[:, :-1, :]], axis=1
        )
        integral = (0.5 * dt) * (v_prev + v)
        kappa = jnp.asarray(self.kappa, dtype)
        theta = jnp.asarray(self.theta, dtype)
        sigma = jnp.asarray(self.sigma, dtype)
        rho = jnp.asarray(self.rho, dtype)
        brownian_v = (v - v_prev - kappa * theta * dt + kappa * integral) / sigma
        # Recolor the idiosyncratic asset normals so the ASSET Brownians
        # carry corr exactly (deterministic unrolled chain — see
        # processes._recolor_assets).
        from probabilit_tpu.models.processes import _recolor_assets

        zsc = _recolor_assets(zs, self._chol_q)
        dlog = (
            jnp.asarray(self.mu, dtype) * dt
            - 0.5 * integral
            + rho * brownian_v
            + jnp.sqrt(1.0 - rho * rho) * jnp.sqrt(integral) * zsc
        )
        s0 = jnp.asarray(self.s0, dtype)
        paths = jnp.transpose(
            s0[None, None, :] * jnp.exp(jnp.cumsum(dlog, axis=1)), (0, 2, 1)
        )
        return paths, v

    def _path_from_increments(self, inc):
        return self._paths_and_variances(inc)[0]


def CorrelatedHeston(
    s0, mu, v0, kappa, theta, sigma, rho, corr, T=1.0, steps=252,
    var_corr=0.0,
):
    """d correlated Heston assets sharing one exact joint draw.

    Per-asset exact CIR variance + Andersen scheme (marginals identical
    in law to the single-asset ``Heston``), asset Brownians correlated
    by ``corr`` exactly; ``var_corr=lambda`` adds a common variance
    factor (systemic vol-of-vol co-movement) with marginals still
    exactly preserved — see :class:`CorrelatedHestonPaths` for the
    construction, its feasibility constraint, and the common-factor
    contract.  Returns one :class:`AssetPath` view per asset:

    >>> a, b = CorrelatedHeston([100, 50], [0.0, 0.0], v0=0.04, kappa=2.0,
    ...                         theta=0.04, sigma=0.3, rho=[-0.5, -0.3],
    ...                         corr=[[1, 0.6], [0.6, 1]], steps=16)
    >>> basket = 0.5 * a.terminal() + 0.5 * b.terminal()
    """
    joint = CorrelatedHestonPaths(
        s0, mu, v0, kappa, theta, sigma, rho, corr, T=T, steps=steps,
        var_corr=var_corr,
    )
    return joint.views()
