"""Archimedean copula samplers (Clayton, Gumbel, Frank) — XLA-native.

A dependence-modeling capability beyond the reference (whose only
dependence tools are correlation-matrix correlators,
``correlation.py:161-425``): Archimedean copulas express asymmetric and
tail-heavy dependence that no correlation matrix can, with one scalar
``theta`` for any dimension.

All three families sample by the Marshall-Olkin (frailty) construction

    U_k = psi(E_k / V),   E_k ~ iid Exp(1),   V ~ F (the LT-inverse law),

which is embarrassingly parallel across samples AND dimensions: one
mixing draw ``V`` per observation, one exponential per coordinate, one
elementwise ``psi`` — no rejection loops over the sample axis, no
sorts, so a copula draw costs about as much as its uniforms.  Per
family (Hofert 2008 gives this catalogue):

* Clayton  psi(t) = (1+t)^(-1/theta),        V ~ Gamma(1/theta),
  lower-tail dependence  lambda_L = 2^(-1/theta),  tau = theta/(theta+2)
* Gumbel   psi(t) = exp(-t^(1/theta)),       V ~ positive stable(1/theta)
  via the Chambers-Mallows-Stuck closed form,
  upper-tail dependence  lambda_U = 2 - 2^(1/theta),  tau = 1 - 1/theta
* Frank    psi(t) = -log1p(-p e^(-t))/theta, V ~ Logarithmic(p) via
  Kemp's LK algorithm (branch-free ``where`` form),  p = 1 - e^(-theta),
  no tail dependence, tau = 1 - 4/theta (1 - D_1(theta)); theta < 0
  (negative dependence, bivariate only) samples by conditional
  inversion instead of the frailty

Every draw is a pure function of the PRNG key, so copula nodes stream
and shard exactly like other distribution nodes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "sample",
    "validate",
    "FAMILIES",
    "ELLIPTICAL_FAMILIES",
    "corr_cholesky",
    "validate_elliptical",
    "elliptical_sample",
    "theta_from_tau",
    "rho_from_tau",
    "empirical_pseudo_observations",
    "empirical_sample",
]

FAMILIES = ("clayton", "gumbel", "frank")


def validate(family, theta, d):
    """Raise ValueError unless (family, theta, d) is a supported combo."""
    if family not in FAMILIES:
        raise ValueError(
            f"Unknown copula family {family!r}; expected one of {FAMILIES}."
        )
    theta = float(theta)
    d = int(d)
    if d < 2:
        raise ValueError(f"A copula needs d >= 2 dimensions, got {d}.")
    if family == "clayton" and not theta > 0:
        raise ValueError(f"Clayton requires theta > 0, got {theta}.")
    if family == "gumbel" and not theta >= 1:
        raise ValueError(f"Gumbel requires theta >= 1, got {theta}.")
    if family == "frank":
        if theta == 0.0:
            raise ValueError(
                "Frank theta=0 is independence; use independent uniforms."
            )
        if theta < 0.0 and d != 2:
            # Negative dependence exists only in the bivariate Frank
            # (the frailty generator must be completely monotone for
            # d >= 3); sampled by conditional inversion.
            raise ValueError(
                f"Frank theta < 0 is bivariate-only (got d={d})."
            )
        if theta < -30.0:
            # The conditional form evaluates e^(-theta u); beyond ~e^30
            # float32 intermediates overflow.
            raise ValueError(
                f"Frank theta must be >= -30 (float32 range), got {theta}."
            )
    return theta, d


def _open_unit(u, dtype):
    from probabilit_tpu.ops.qmc import clamp_open_unit

    # One home for the open-interval clamp policy (CLAUDE.md: always
    # clamp before inverse CDFs); this wrapper only fixes the dtype.
    return clamp_open_unit(jnp.asarray(u, dtype))


def _exp1(key, shape, dtype):
    """iid Exp(1) draws, strictly positive."""
    return -jnp.log(_open_unit(jax.random.uniform(key, shape, dtype=dtype), dtype))


def _positive_stable(key, shape, alpha, dtype):
    """One-sided stable S(alpha) with Laplace transform exp(-s^alpha).

    Chambers-Mallows-Stuck closed form (the Gumbel frailty; degenerate
    at alpha=1, which callers exclude since theta=1 is independence):

        S = (sin(alpha u) / (sin u)^(1/alpha))
            * (sin((1-alpha) u) / w)^((1-alpha)/alpha)

    with u ~ U(0, pi), w ~ Exp(1).
    """
    ku, kw = jax.random.split(key)
    u = _open_unit(jax.random.uniform(ku, shape, dtype=dtype), dtype) * np.pi
    w = _exp1(kw, shape, dtype)
    a = jnp.asarray(alpha, dtype)
    return (jnp.sin(a * u) / jnp.sin(u) ** (1.0 / a)) * (
        jnp.sin((1.0 - a) * u) / w
    ) ** ((1.0 - a) / a)


def _log_series(key, shape, log1mp, dtype):
    """Logarithmic(p) integer draws (as floats >= 1), Kemp's LK algorithm.

    pmf(k) proportional to p^k / k.  Branch-free ``where`` realisation of
    the classic accept branches; exact, no loops.  Parameterised by
    ``log1mp = log(1 - p)`` rather than ``p``: the Frank frailty has
    ``p = 1 - e^(-theta)``, which rounds to exactly 1.0 in float32 for
    theta >= ~16.6 — ``log1p(-p)`` would then be ``-inf`` and every draw
    would silently collapse (measured: Kendall tau 0.38 instead of 0.82
    at theta=20).  The caller knows ``log(1-p) = -theta`` EXACTLY.
    """
    k1, k2 = jax.random.split(key)
    u1 = _open_unit(jax.random.uniform(k1, shape, dtype=dtype), dtype)
    u2 = _open_unit(jax.random.uniform(k2, shape, dtype=dtype), dtype)
    log1mp = jnp.asarray(log1mp, dtype)
    # q = 1 - (1-p)^(u1) = -expm1(u1 * log(1-p)), exact at any theta.
    q = -jnp.expm1(u1 * log1mp)
    # log(q) must come from log1p of the SMALL complement (1-p)^(u1):
    # q itself rounds to 1.0 in f32 once (1-p)^(u1) < 2^-24 (17% of
    # draws at theta=20), and a clamped log(q) floors at -2^-24 —
    # underestimating the heavy-tail V by orders of magnitude (measured:
    # the copula's upper-quantile mass went missing, KS ~0.06).
    comp = jnp.maximum(jnp.exp(u1 * log1mp), jnp.finfo(dtype).tiny)
    log_q = jnp.log1p(-comp)
    heavy = jnp.floor(1.0 + jnp.log(u2) / log_q)
    v = jnp.where(u2 < q * q, heavy, jnp.where(u2 > q, 1.0, 2.0))
    return jnp.maximum(v, 1.0)


def sample(family, key, shape, theta, dtype):
    """(n, d) copula draws: uniform marginals, ``family`` dependence."""
    n, d = shape
    theta, d = validate(family, theta, d)
    kv, ke = jax.random.split(key)
    E = _exp1(ke, (n, d), dtype)
    if family == "clayton":
        # V ~ Gamma(1/theta); psi(t) = (1+t)^(-1/theta) via exp/log1p so
        # theta near 0 (weak dependence) stays accurate.  Half-integer
        # shapes (theta = 2/k) take the exact loop-free chi-square
        # decomposition — jax.random.gamma's rejection while_loop
        # round-trips its carries through device memory on every trip.
        alpha = 1.0 / theta
        if (2.0 * alpha).is_integer() and 1.0 <= 2.0 * alpha <= 128.0:
            from probabilit_tpu.ops.special import chi2_draws

            V = 0.5 * chi2_draws(kv, 2.0 * alpha, n, dtype)[:, None]
        else:
            V = jax.random.gamma(kv, alpha, (n, 1), dtype)
        V = jnp.maximum(V, jnp.finfo(dtype).tiny)
        u = jnp.exp(-jnp.log1p(E / V) / theta)
    elif family == "gumbel":
        if theta == 1.0:
            # Independence: the stable form is degenerate at alpha=1.
            u = jnp.exp(-E)
        else:
            V = _positive_stable(kv, (n, 1), 1.0 / theta, dtype)
            u = jnp.exp(-((E / V) ** (1.0 / theta)))
    elif family == "frank" and theta < 0.0:
        # Bivariate negative dependence: conditional inversion
        # u2 = -(1/theta) log1p( v (1-e^-theta) /
        #                        (v expm1(-theta u1) - e^(-theta u1)) ).
        k1, k2 = jax.random.split(key)
        u1 = _open_unit(jax.random.uniform(k1, (n,), dtype=dtype), dtype)
        v = _open_unit(jax.random.uniform(k2, (n,), dtype=dtype), dtype)
        e1 = jnp.exp(-theta * u1)
        denom = v * jnp.expm1(-theta * u1) - e1
        ratio = v * (-jnp.expm1(-theta)) / denom
        u2 = -jnp.log1p(ratio) / theta
        u = jnp.stack([u1, u2], axis=1)
    else:  # frank, positive dependence (frailty; any dimension)
        p = -np.expm1(-theta)  # 1 - e^(-theta), exact for small theta
        # log(1-p) = -theta exactly; passing p itself would hit the f32
        # p == 1.0 rounding wall at theta >= ~16.6 (see _log_series).
        V = _log_series(kv, (n, 1), -theta, dtype)
        t = E / V
        # psi(t) = -log(1 - p e^(-t)) / theta needs BOTH tails handled:
        # for large theta the frailty V is huge, so typical t ~ 1e-7 and
        # f32 exp(-t) quantizes to ulp steps of 1 (draws collapse onto a
        # visible grid; KS p-value 0 at theta=20 before this split).
        # Small t: 1 - p e^(-t) = -expm1(-t) + e^(-t-theta), each term
        # exact.  Large t: p e^(-t) is small, log1p is exact directly.
        bracket_small = -jnp.expm1(-t) + jnp.exp(-t - theta)
        u = jnp.where(
            t < 0.6931,
            -jnp.log(jnp.maximum(bracket_small, jnp.finfo(dtype).tiny)) / theta,
            -jnp.log1p(-p * jnp.exp(-t)) / theta,
        )
    return _open_unit(u, dtype)


def theta_from_tau(family, tau):
    """Invert Kendall's tau to the family's ``theta`` (host, closed form).

    The standard moment-matching calibration: estimate tau from data
    (e.g. ``scipy.stats.kendalltau``), invert to the copula parameter.

    * Clayton: ``theta = 2 tau / (1 - tau)``
    * Gumbel:  ``theta = 1 / (1 - tau)``
    * Frank:   solves ``tau(theta) = 1 - (4/theta)(1 - D_1(theta))``
      (Debye) by bisection to 1e-10.

    Clayton/Gumbel require ``0 < tau < 1`` (their frailty samplers
    cover positive dependence only); Frank also inverts negative tau
    (bivariate conditional-inversion sampler, ``theta = -theta(|tau|)``
    by the odd symmetry of Frank's tau).

    >>> round(theta_from_tau("clayton", 0.5), 6)
    2.0
    >>> round(theta_from_tau("gumbel", 0.5), 6)
    2.0
    """
    tau = float(tau)
    if family not in FAMILIES:
        raise ValueError(
            f"Unknown copula family {family!r}; expected one of {FAMILIES}."
        )
    if family == "frank" and -1.0 < tau < 0.0:
        # Frank's tau is odd in theta; the bivariate sampler covers
        # theta >= -30 (float32 range), i.e. tau >= ~-0.874.
        theta = -theta_from_tau("frank", -tau)
        if theta < -30.0:
            raise ValueError(
                f"tau={tau} needs Frank theta={theta:.2f}, below the "
                "sampler's float32 floor of -30 (tau >= ~-0.874); no "
                "Frank copula this negative can be sampled here."
            )
        return theta
    if family == "frank" and not -1.0 < tau < 1.0:
        raise ValueError(f"Frank tau must be in (-1, 1), got {tau}.")
    if not 0.0 < tau < 1.0:
        raise ValueError(
            f"tau must be in (0, 1) for the frailty families, got {tau}."
        )
    if family == "clayton":
        return 2.0 * tau / (1.0 - tau)
    if family == "gumbel":
        return 1.0 / (1.0 - tau)
    # Frank: tau(theta) is strictly increasing on theta > 0.
    from scipy.integrate import quad

    def tau_of(theta):
        d1 = quad(lambda t: t / np.expm1(t), 0.0, theta)[0] / theta
        return 1.0 - 4.0 / theta * (1.0 - d1)

    lo, hi = 1e-6, 1.0
    while tau_of(hi) < tau:
        hi *= 2.0
        if hi > 1e6:
            raise ValueError(f"tau={tau} is out of Frank's invertible range.")
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if tau_of(mid) < tau:
            lo = mid
        else:
            hi = mid
        if hi - lo < 1e-10 * max(1.0, hi):
            break
    return 0.5 * (lo + hi)


def rho_from_tau(tau):
    """Elliptical-copula shape from Kendall's tau: ``rho = sin(pi tau / 2)``.

    Holds for EVERY elliptical copula (Gaussian and Student-t alike), so
    it calibrates both ``ImanConover`` targets and ``StudentTCopula``
    shape matrices from rank data.

    >>> round(rho_from_tau(0.5), 6)
    0.707107
    """
    tau = float(tau)
    if not -1.0 < tau < 1.0:
        raise ValueError(f"tau must be in (-1, 1), got {tau}.")
    return float(np.sin(np.pi * tau / 2.0))


ELLIPTICAL_FAMILIES = ("gaussian", "t")


def corr_cholesky(corr, min_d=2):
    """Validated (chol, d) of a correlation matrix (shared helper).

    One home for the unit-diagonal / symmetry / positive-definite checks
    used by the elliptical copulas AND the correlated-GBM path node;
    tests of both assert these exact error strings.
    """
    corr = np.asarray(corr, np.float64)
    if corr.ndim != 2 or corr.shape[0] != corr.shape[1] or corr.shape[0] < min_d:
        raise ValueError(
            f"corr must be square with d >= {min_d}, got {corr.shape}."
        )
    if not np.allclose(np.diag(corr), 1.0):
        raise ValueError("corr must have unit diagonal.")
    if not np.allclose(corr, corr.T):
        raise ValueError("corr must be symmetric.")
    try:
        chol = np.linalg.cholesky(corr)
    except np.linalg.LinAlgError:
        raise ValueError("corr must be positive definite.") from None
    return chol, corr.shape[0]


def validate_elliptical(family, corr, df):
    """(chol, d, df) for an elliptical copula, or raise ValueError."""
    if family not in ELLIPTICAL_FAMILIES:
        raise ValueError(
            f"Unknown elliptical family {family!r}; "
            f"expected one of {ELLIPTICAL_FAMILIES}."
        )
    chol, d = corr_cholesky(corr)
    if family == "t":
        df = float(df)
        if not df > 0:
            raise ValueError(f"t copula needs df > 0, got {df}.")
    elif df is not None:
        raise ValueError("df applies to the t copula only.")
    return chol, d, df


def elliptical_sample(family, key, n, chol, df, dtype):
    """(n, d) elliptical-copula draws: uniform marginals, shape ``chol``.

    Gaussian: ``u = Phi(z)`` with ``z`` the recolored normals; Student-t
    divides by a shared per-observation ``sqrt(chi2(df)/df)`` first and
    maps through the exact t CDF — the same construction as the
    ``StudentTCopula`` correlator, packaged as uniform marginal draws.
    """
    from probabilit_tpu.ops import special as _special

    d = chol.shape[0]
    kz, kw = jax.random.split(key)
    z = jax.random.normal(kz, (n, d), dtype)
    with jax.default_matmul_precision("float32"):
        z = z @ jnp.asarray(chol.T, dtype)
    if family == "gaussian":
        u = _special.ndtr_fast(z)
    else:
        mix = jnp.sqrt(
            _special.chi2_draws(kw, df, n, dtype) / jnp.asarray(df, dtype)
        )
        u = _special.t_cdf(z / mix[:, None], jnp.asarray(df, dtype))
    return _open_unit(u, dtype)


def empirical_pseudo_observations(data):
    """(m, d) pseudo-observations rank(x)/(m+1) of observed rows.

    Average ranks (ties share their midrank), matching the package's
    rank conventions; each column lands strictly inside (0, 1).
    """
    from scipy.stats import rankdata as _rankdata

    data = np.asarray(data, np.float64)
    if data.ndim != 2 or data.shape[1] < 2:
        raise ValueError(
            f"data must be (observations, d >= 2), got {data.shape}."
        )
    if data.shape[0] < 2:
        raise ValueError("Need at least two observations.")
    if not np.isfinite(data).all():
        raise ValueError("data must be finite.")
    m = data.shape[0]
    return _rankdata(data, axis=0) / (m + 1.0)


def empirical_sample(key, n, pseudo, dtype):
    """(n, d) draws with the EMPIRICAL dependence of ``pseudo`` rows.

    Bootstrap of the pseudo-observation rows: dependence is exactly the
    sample's rank structure (the empirical copula), marginals are the
    discrete uniform on {1/(m+1), ..., m/(m+1)} — shape them with
    ``QuantileTransform`` like any other copula node.  One (n,)-indexed
    row gather; fine at any m that fits HBM.
    """
    m = pseudo.shape[0]
    idx = jax.random.randint(key, (n,), 0, m)
    return jnp.asarray(pseudo, dtype)[idx]
