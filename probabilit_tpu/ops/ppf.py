"""Inverse-CDF (ppf) sampling kernels per distribution family.

This module is the device-native replacement for the reference's scipy backend:
``Distribution("name", ...)`` resolves ``getattr(scipy.stats, name).ppf``
(``modeling.py:795-812``).  Here each family is an XLA-traceable function
``kernel(q, *shape_params, loc, scale)`` whose parameter names and order
mirror the scipy.stats conventions, so reference models run unchanged.
Parameters may be traced arrays (composite distributions) — every kernel
broadcasts elementwise and fuses into the surrounding sampling program.

Three tiers:

1. closed-form kernels (uniform, norm, expon, ...),
2. Newton-inversion kernels (beta, gamma, t, ...) on
   ``probabilit_tpu.ops.special``,
3. discrete kernels with a static-parameter fast path (host-precomputed CDF
   table + ``searchsorted``, one gather per sample) and a traced-parameter
   path (vectorised bisection on the analytic CDF),
4. a generic static-parameter continuous tier: host-built monotone-cubic
   (PCHIP) quantile tables in normal-score space, evaluated on-device with
   one gather + cubic Horner (:func:`static_quantile_table`) — every
   remaining scipy.stats continuous family (levy_stable, skewnorm, rice,
   noncentral t/chi2/F, vonmises, ...) samples on-device, shardable and
   streamable, at ~1e-6 scaled accuracy.

Anything else (traced parameters on a no-kernel family) falls back to a
host callback into scipy.stats (:func:`scipy_fallback_ppf`), keeping full
scipy.stats name coverage at reduced speed.  scipy discrete ppf returns ``support_min - 1`` at q=0; we
return the support minimum instead (saner for composite parameters; q=0 has
probability ~2^-24 under float32 uniforms).
"""

from __future__ import annotations

import numbers

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import betainc, gammaincc

from probabilit_tpu import config
from probabilit_tpu.ops import special

__all__ = [
    "register",
    "lookup",
    "call",
    "call_wide",
    "scipy_fallback_ppf",
    "is_multivariate",
]

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def lookup(name):
    return _REGISTRY.get(name)


# Deep-tail kernel variants for DERIVED quantiles.  The hot sampling
# path feeds RNG/QMC uniforms, which cannot fall below the 2^-24 f32
# grid, so its kernels (e.g. ndtri_fast) are allowed to saturate there.
# Quantile nodes computed by the user — importance tilts, survival-space
# windows — are legitimately far smaller; families registered here get a
# variant accurate down to the float's normal range (~1e-37 f32).
_WIDE_REGISTRY = {}


def register_wide(name):
    def deco(fn):
        _WIDE_REGISTRY[name] = fn
        return fn

    return deco


def call_wide(name, q, *args, **kwargs):
    """``call``, preferring a deep-tail-accurate kernel when one exists.

    Families without a wide variant use their standard kernel: correct
    over the RNG-resolvable range, saturating (with the right sign)
    beyond each kernel's documented tail validity.
    """
    kernel = _WIDE_REGISTRY.get(name)
    if kernel is not None:
        return kernel(q, *args, **kwargs)
    return call(name, q, *args, **kwargs)


def call(name, q, *args, **kwargs):
    """Evaluate the ppf kernel for scipy.stats distribution ``name``."""
    kernel = lookup(name)
    if kernel is None:
        # Static-parameter scipy discrete families with a cap-sized
        # reachable support sample on-device from a baked CDF table (no
        # per-call host round trip); traced-parameter, continuous, or
        # huge-support no-kernel families pay the host-callback fallback.
        built = static_cdf_table(name, *args, **kwargs)
        if built is not None:
            table, start = built
            return _table_ppf(q, table, loc=start)
        quantile_table = static_quantile_table(name, *args, **kwargs)
        if quantile_table is not None:
            return _pchip_ppf(q, quantile_table)
        return scipy_fallback_ppf(name, q, *args, **kwargs)
    return kernel(q, *args, **kwargs)


def _f(x):
    """Promote parameters to the configured float dtype."""
    return jnp.asarray(x, config.float_dtype())


def _is_static(*params):
    return all(isinstance(p, (numbers.Number, np.ndarray)) for p in params)


# =====================================================================
# Continuous, closed form
# =====================================================================


@register("uniform")
def uniform(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * _f(q)


@register("norm")
def norm(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.ndtri_fast(_f(q))


# --- Normal-score shortcuts -----------------------------------------
# Families whose ppf is an elementwise function of ndtri(q) admit a
# closed form in a standard-normal score y: ppf(Phi(y)) = g(y).  The
# correlated sampling path (engine/compile.py) produces exactly such
# scores, so evaluating g(y) directly skips the
# Phi/ndtri polynomial roundtrip — ~40 fewer ops per sample AND exact
# where the roundtrip carries up to ~1e-3 absolute error at |y| > 4
# (ndtr's 1.5e-7 CDF error divided by a vanishing pdf).

_SCORE_KERNELS = {}


def score_call(name, y, *args, **kwargs):
    """``ppf(name, ndtr(y))`` in closed form, or None if unsupported."""
    kernel = _SCORE_KERNELS.get(name)
    return None if kernel is None else kernel(y, *args, **kwargs)


def _score_norm(y, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * _f(y)


def _score_lognorm(y, s, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.exp(_f(s) * _f(y))


_SCORE_KERNELS["norm"] = _score_norm
_SCORE_KERNELS["lognorm"] = _score_lognorm


def score_emit(var, y, ctx):
    """Score shortcut for a ``Distribution`` node, or None.

    Resolves Node-valued parameters through ``ctx`` exactly like
    ``Distribution._emit`` before dispatching to the score kernel.
    """
    from probabilit_tpu.models.distributions import Distribution
    from probabilit_tpu.models.graph import Node

    if not isinstance(var, Distribution) or var.distr not in _SCORE_KERNELS:
        return None

    def unpack(a):
        return ctx.value(a) if isinstance(a, Node) else a

    args = tuple(unpack(a) for a in var.args)
    kwargs = {k: unpack(v) for k, v in var.kwargs.items()}
    return score_call(var.distr, y, *args, **kwargs)


@register("expon")
def expon(q, loc=0.0, scale=1.0):
    return _f(loc) - _f(scale) * jnp.log1p(-_f(q))


@register("lognorm")
def lognorm(q, s, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.exp(_f(s) * special.ndtri_fast(_f(q)))


@register_wide("norm")
def norm_wide(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.ndtri_fast_wide(_f(q))


@register_wide("lognorm")
def lognorm_wide(q, s, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.exp(
        _f(s) * special.ndtri_fast_wide(_f(q))
    )


@register("triang")
def triang(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    left = jnp.sqrt(q * c)
    right = 1.0 - jnp.sqrt((1.0 - q) * (1.0 - c))
    x = jnp.where(q <= c, left, right)
    return _f(loc) + _f(scale) * x


@register("truncnorm")
def truncnorm(q, a, b, loc=0.0, scale=1.0):
    a, b, q = _f(a), _f(b), _f(q)
    # Two algebraically-identical formulations; the CDF form loses all
    # resolution for windows in the upper tail (ndtr saturates at 1.0 in
    # float32 beyond ~5 sigma), the survival form for the lower tail.
    # Select per-element by the window midpoint.
    fa, fb = special.ndtr_fast(a), special.ndtr_fast(b)
    x_cdf = special.ndtri_fast_wide(fa + q * (fb - fa))
    sa, sb = special.ndtr_neg_fast(a), special.ndtr_neg_fast(b)
    x_sf = -special.ndtri_fast_wide(sa + q * (sb - sa))
    x = jnp.where(a + b > 0, x_sf, x_cdf)
    x = jnp.clip(x, a, b)  # Rounding must never leave the support.
    return _f(loc) + _f(scale) * x


@register("cauchy")
def cauchy(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.tan(jnp.pi * (_f(q) - 0.5))


@register("laplace")
def laplace(q, loc=0.0, scale=1.0):
    q = _f(q)
    x = jnp.where(q < 0.5, jnp.log(2.0 * q), -jnp.log(2.0 * (1.0 - q)))
    return _f(loc) + _f(scale) * x


@register("logistic")
def logistic(q, loc=0.0, scale=1.0):
    q = _f(q)
    return _f(loc) + _f(scale) * (jnp.log(q) - jnp.log1p(-q))


@register("gumbel_r")
def gumbel_r(q, loc=0.0, scale=1.0):
    return _f(loc) - _f(scale) * jnp.log(-jnp.log(_f(q)))


@register("gumbel_l")
def gumbel_l(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.log(-jnp.log1p(-_f(q)))


@register("rayleigh")
def rayleigh(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.sqrt(-2.0 * jnp.log1p(-_f(q)))


@register("halfnorm")
def halfnorm(q, loc=0.0, scale=1.0):
    # ndtri((1+q)/2) == -ndtri((1-q)/2); the latter keeps precision as
    # q -> 1, where (1+q)/2 rounds to exactly 1.0 in float32.
    q = _f(q)
    return _f(loc) - _f(scale) * special.ndtri_fast_wide(0.5 * (1.0 - q))


@register("pareto")
def pareto(q, b, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.power(1.0 - _f(q), -1.0 / _f(b))


@register("weibull_min")
def weibull_min(q, c, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.power(-jnp.log1p(-_f(q)), 1.0 / _f(c))


@register("weibull_max")
def weibull_max(q, c, loc=0.0, scale=1.0):
    return _f(loc) - _f(scale) * jnp.power(-jnp.log(_f(q)), 1.0 / _f(c))


@register("powerlaw")
def powerlaw(q, a, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.power(_f(q), 1.0 / _f(a))


@register("loguniform")
def loguniform(q, a, b, loc=0.0, scale=1.0):
    a, b = _f(a), _f(b)
    return _f(loc) + _f(scale) * jnp.exp(jnp.log(a) + _f(q) * (jnp.log(b) - jnp.log(a)))


@register("arcsine")
def arcsine(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.square(jnp.sin(0.5 * jnp.pi * _f(q)))


@register("hypsecant")
def hypsecant(q, loc=0.0, scale=1.0):
    # Symmetric evaluation: tan(pi q / 2) loses float32 precision as q -> 1,
    # so reflect the upper half onto the (accurate) small-angle branch.
    q = _f(q)
    tail = jnp.minimum(q, 1.0 - q)
    mag = jnp.log(jnp.tan(0.5 * jnp.pi * tail))
    x = jnp.where(q < 0.5, mag, -mag)
    return _f(loc) + _f(scale) * x


@register("fisk")
def fisk(q, c, loc=0.0, scale=1.0):
    q = _f(q)
    return _f(loc) + _f(scale) * jnp.power(q / (1.0 - q), 1.0 / _f(c))


@register("genpareto")
def genpareto(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    x = jnp.where(
        jnp.abs(c) < 1e-9,
        -jnp.log1p(-q),
        special.expm1_safe(-c * jnp.log1p(-q)) / jnp.where(jnp.abs(c) < 1e-9, 1.0, c),
    )
    return _f(loc) + _f(scale) * x


@register("genextreme")
def genextreme(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    lq = -jnp.log(q)
    x = jnp.where(
        jnp.abs(c) < 1e-9,
        -jnp.log(lq),
        -special.expm1_safe(c * jnp.log(lq)) / jnp.where(jnp.abs(c) < 1e-9, 1.0, c),
    )
    return _f(loc) + _f(scale) * x


@register("semicircular")
def semicircular(q, loc=0.0, scale=1.0):
    # CDF(x) = 1/2 + x sqrt(1-x^2)/pi + arcsin(x)/pi on [-1, 1]; invert by Newton.
    q = _f(q)
    x = 2.0 * q - 1.0  # decent initial guess

    def body(_, x):
        f = 0.5 + (x * jnp.sqrt(1.0 - x * x) + jnp.arcsin(x)) / jnp.pi - q
        pdf = 2.0 * jnp.sqrt(jnp.clip(1.0 - x * x, 1e-12)) / jnp.pi
        return jnp.clip(x - f / pdf, -1.0, 1.0)

    x = jax.lax.fori_loop(0, 16, body, x)
    return _f(loc) + _f(scale) * x


# =====================================================================
# Continuous, Newton inversions of incomplete gamma / beta
# =====================================================================


@register("gamma")
def gamma(q, a, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.gammaincinv(_f(a), _f(q))


@register("erlang")
def erlang(q, a, loc=0.0, scale=1.0):
    return gamma(q, a, loc=loc, scale=scale)


@register("chi2")
def chi2(q, df, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * 2.0 * special.gammaincinv(0.5 * _f(df), _f(q))


@register("chi")
def chi(q, df, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.sqrt(2.0 * special.gammaincinv(0.5 * _f(df), _f(q)))


@register("maxwell")
def maxwell(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.sqrt(2.0 * special.gammaincinv(1.5, _f(q)))


@register("invgamma")
def invgamma(q, a, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) / special.gammaincinv(_f(a), 1.0 - _f(q))


@register("invgauss")
def invgauss(q, mu, loc=0.0, scale=1.0):
    """Inverse Gaussian: Newton on the closed-form (Shuster 1968) CDF.

    F(x; mu) = ndtr((x/mu - 1)/sqrt(x)) + exp(2/mu) ndtr(-(x/mu + 1)/sqrt(x)).
    """
    q, mu = _f(q), _f(mu)

    def cdf(x):
        rx = jax.lax.rsqrt(jnp.clip(x, 1e-30))
        a = (x / mu - 1.0) * rx
        b = -(x / mu + 1.0) * rx
        # exp(2/mu) * ndtr(b) == exp(-a^2/2) * [exp(b^2/2) * ndtr(b)]:
        # 2/mu - b^2/2 = -a^2/2 identically, so evaluating the product
        # through the scaled CDF never overflows — a direct exp(2/mu)
        # needs a clip at exp(80) that garbles quantiles for mu < 0.025
        # (measured: 1.2e-2 rel. error at mu=0.024 vs 4e-4 elsewhere).
        return special.ndtr_fast(a) + jnp.exp(-0.5 * a * a) * special.ndtr_scaled_neg(
            b
        )

    def pdf(x):
        xc = jnp.clip(x, 1e-30)
        return jnp.exp(
            -0.5 * jnp.log(2.0 * jnp.pi * xc**3)
            - jnp.square(xc - mu) / (2.0 * mu * mu * xc)
        )

    # Mode-anchored start; bracket generously around the distribution body.
    x0 = jnp.broadcast_to(mu, jnp.broadcast_shapes(jnp.shape(q), jnp.shape(mu)))
    hi = mu * (1.0 + 50.0 * (1.0 + mu))
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, 1e-12, hi)
    return _f(loc) + _f(scale) * x


@register("wald")
def wald(q, loc=0.0, scale=1.0):
    """Wald = inverse Gaussian with mu = 1 (scipy parametrization)."""
    return invgauss(q, 1.0, loc=loc, scale=scale)


@register("nakagami")
def nakagami(q, nu, loc=0.0, scale=1.0):
    nu = _f(nu)
    return _f(loc) + _f(scale) * jnp.sqrt(special.gammaincinv(nu, _f(q)) / nu)


@register("beta")
def beta(q, a, b, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.betaincinv(_f(a), _f(b), _f(q))


@register("betaprime")
def betaprime(q, a, b, loc=0.0, scale=1.0):
    x = special.betaincinv(_f(a), _f(b), _f(q))
    return _f(loc) + _f(scale) * x / (1.0 - x)


@register("t")
def t(q, df, loc=0.0, scale=1.0):
    q, df = _f(q), _f(df)
    # Two-tailed inversion via the incomplete beta function.
    tail = jnp.minimum(q, 1.0 - q)
    x = special.betaincinv(0.5 * df, 0.5, 2.0 * tail)
    tval = jnp.sqrt(df * (1.0 - x) / jnp.clip(x, 1e-30))
    return _f(loc) + _f(scale) * jnp.where(q < 0.5, -tval, tval)


@register("f")
def f(q, dfn, dfd, loc=0.0, scale=1.0):
    q, dfn, dfd = _f(q), _f(dfn), _f(dfd)
    x = special.betaincinv(0.5 * dfn, 0.5 * dfd, q)
    return _f(loc) + _f(scale) * (dfd * x) / (dfn * (1.0 - x))


# =====================================================================
# Continuous, closed form — wider scipy coverage (round 3)
#
# Each formula inverts the family's scipy.stats CDF analytically (or
# through the native gammaincinv/betaincinv/ndtri kernels); parameter
# names/order mirror scipy so reference models run unchanged, and the
# whole batch is parity-swept against scipy.ppf in
# tests/test_distributions.py.
# =====================================================================


@register("alpha")
def alpha(q, a, loc=0.0, scale=1.0):
    # CDF = ndtr(a - 1/x) / ndtr(a) on x > 0.
    a, q = _f(a), _f(q)
    x = 1.0 / (a - special.ndtri_fast_wide(q * special.ndtr_fast(a)))
    # Upper tail: the denominator cancels to f32 noise as
    # ndtri(q Phi(a)) -> a.  First-order there:
    # a - ndtri(p) ~ D (1 - a D / 2) with D = Phi(a)(1-q)/phi(a), and
    # (1-q) is Sterbenz-exact, so the tail quantile stays
    # relative-accurate (error O(D^2) < 1e-4 at the switch point).
    inv_sqrt2pi = 0.3989422804014327
    phi_a = inv_sqrt2pi * jnp.exp(-0.5 * a * a)
    D = special.ndtr_fast(a) * (1.0 - q) / phi_a
    x_tail = 1.0 / (D * (1.0 - 0.5 * a * D))
    x = jnp.where(q > 1.0 - 1e-3, x_tail, x)
    return _f(loc) + _f(scale) * x


@register("anglit")
def anglit(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * (jnp.arcsin(jnp.sqrt(_f(q))) - 0.25 * jnp.pi)


@register("bradford")
def bradford(q, c, loc=0.0, scale=1.0):
    c = _f(c)
    return _f(loc) + _f(scale) * special.expm1_safe(_f(q) * jnp.log1p(c)) / c


@register("burr")
def burr(q, c, d, loc=0.0, scale=1.0):
    # Burr III: CDF = (1 + x^-c)^-d.
    q, c, d = _f(q), _f(c), _f(d)
    # log1p(q - 1): q - 1 is Sterbenz-exact in f32, so the log keeps
    # relative accuracy as q -> 1 where log(q) collapses to 0.
    x = jnp.power(special.expm1_safe(-jnp.log1p(q - 1.0) / d), -1.0 / c)
    return _f(loc) + _f(scale) * x


@register("burr12")
def burr12(q, c, d, loc=0.0, scale=1.0):
    # Burr XII: SF = (1 + x^c)^-d.
    q, c, d = _f(q), _f(c), _f(d)
    x = jnp.power(special.expm1_safe(-jnp.log1p(-q) / d), 1.0 / c)
    return _f(loc) + _f(scale) * x


@register("dgamma")
def dgamma(q, a, loc=0.0, scale=1.0):
    # Reflected gamma: CDF = gammaincc(a, -x)/2 left of 0,
    # 1/2 + gammainc(a, x)/2 right of 0.
    q, a = _f(q), _f(a)
    eps = 1e-7
    low = -special.gammainccinv(a, jnp.clip(2.0 * q, eps, 1.0))
    high = special.gammaincinv(a, jnp.clip(2.0 * q - 1.0, 0.0, 1.0 - eps))
    return _f(loc) + _f(scale) * jnp.where(q < 0.5, low, high)


@register("dweibull")
def dweibull(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    eps = 1e-12
    mag_low = jnp.power(-jnp.log(jnp.clip(2.0 * q, eps)), 1.0 / c)
    mag_high = jnp.power(-jnp.log(jnp.clip(2.0 * (1.0 - q), eps)), 1.0 / c)
    return _f(loc) + _f(scale) * jnp.where(q < 0.5, -mag_low, mag_high)


@register("exponpow")
def exponpow(q, b, loc=0.0, scale=1.0):
    # CDF = 1 - exp(1 - exp(x^b)).
    x = jnp.power(jnp.log1p(-jnp.log1p(-_f(q))), 1.0 / _f(b))
    return _f(loc) + _f(scale) * x


@register("exponweib")
def exponweib(q, a, c, loc=0.0, scale=1.0):
    # CDF = (1 - exp(-x^c))^a.
    q, a, c = _f(q), _f(a), _f(c)
    # 1 - q^(1/a) evaluated as -expm1(log1p(q-1)/a): exact-difference
    # log plus expm1 keep the upper tail accurate in f32.
    t = -special.expm1_safe(jnp.log1p(q - 1.0) / a)
    x = jnp.power(-jnp.log(t), 1.0 / c)
    return _f(loc) + _f(scale) * x


@register("fatiguelife")
def fatiguelife(q, c, loc=0.0, scale=1.0):
    # Birnbaum-Saunders: x = ((c z + sqrt(c^2 z^2 + 4)) / 2)^2.
    t = _f(c) * special.ndtri_fast(_f(q))
    return _f(loc) + _f(scale) * 0.25 * jnp.square(t + jnp.sqrt(t * t + 4.0))


@register("genhalflogistic")
def genhalflogistic(q, c, loc=0.0, scale=1.0):
    # CDF = (1 - t) / (1 + t) with t = (1 - c x)^(1/c) on [0, 1/c].
    q, c = _f(q), _f(c)
    t = (1.0 - q) / (1.0 + q)
    return _f(loc) + _f(scale) * (1.0 - jnp.power(t, c)) / c


@register("genlogistic")
def genlogistic(q, c, loc=0.0, scale=1.0):
    # CDF = (1 + exp(-x))^-c.
    q = _f(q)
    x = -jnp.log(special.expm1_safe(-jnp.log1p(q - 1.0) / _f(c)))
    return _f(loc) + _f(scale) * x


@register("gengamma")
def gengamma(q, a, c, loc=0.0, scale=1.0):
    q, a, c = _f(q), _f(a), _f(c)
    val = jnp.where(c > 0, special.gammaincinv(a, q), special.gammainccinv(a, q))
    return _f(loc) + _f(scale) * jnp.power(val, 1.0 / c)


@register("gennorm")
def gennorm(q, beta, loc=0.0, scale=1.0):
    q, beta = _f(q), _f(beta)
    mag = jnp.power(
        special.gammaincinv(1.0 / beta, jnp.abs(2.0 * q - 1.0)), 1.0 / beta
    )
    return _f(loc) + _f(scale) * jnp.sign(q - 0.5) * mag


@register("halfgennorm")
def halfgennorm(q, beta, loc=0.0, scale=1.0):
    beta = _f(beta)
    return _f(loc) + _f(scale) * jnp.power(
        special.gammaincinv(1.0 / beta, _f(q)), 1.0 / beta
    )


@register("gibrat")
def gibrat(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.exp(special.ndtri_fast(_f(q)))


@register("gompertz")
def gompertz(q, c, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.log1p(-jnp.log1p(-_f(q)) / _f(c))


@register("halfcauchy")
def halfcauchy(q, loc=0.0, scale=1.0):
    # tan(pi q / 2) loses f32 resolution as q -> 1: route through the
    # cotangent of the complementary angle, exact in the tail.
    q = _f(q)
    return _f(loc) + _f(scale) / jnp.tan(0.5 * jnp.pi * (1.0 - q))


@register("halflogistic")
def halflogistic(q, loc=0.0, scale=1.0):
    q = _f(q)
    return _f(loc) + _f(scale) * (jnp.log1p(q) - jnp.log1p(-q))


@register("invweibull")
def invweibull(q, c, loc=0.0, scale=1.0):
    q = _f(q)
    return _f(loc) + _f(scale) * jnp.power(-jnp.log1p(q - 1.0), -1.0 / _f(c))


@register("johnsonsb")
def johnsonsb(q, a, b, loc=0.0, scale=1.0):
    z = (special.ndtri_fast(_f(q)) - _f(a)) / _f(b)
    return _f(loc) + _f(scale) / (1.0 + jnp.exp(-z))


@register("johnsonsu")
def johnsonsu(q, a, b, loc=0.0, scale=1.0):
    z = (special.ndtri_fast(_f(q)) - _f(a)) / _f(b)
    # sinh via exp (worst case ~1e-3 relative at |z| ~ 1e-4 where |x|
    # itself is ~1e-4 — inside the f32 contract).  Chosen for a kernel
    # compiler without sinh on the earlier accelerator; not re-measured on the H100.
    ez = jnp.exp(z)
    return _f(loc) + _f(scale) * 0.5 * (ez - 1.0 / ez)


@register("kappa3")
def kappa3(q, a, loc=0.0, scale=1.0):
    # CDF = x (a + x^a)^(-1/a)  =>  x = (a q^a / (1 - q^a))^(1/a).
    q, a = _f(q), _f(a)
    z = a * jnp.log1p(q - 1.0)
    # q^a / (1 - q^a) = exp(z) / (-expm1(z)): both factors stay
    # relative-accurate over the whole quantile range.
    ratio = jnp.exp(z) / (-special.expm1_safe(z))
    return _f(loc) + _f(scale) * jnp.power(a * ratio, 1.0 / a)


@register("laplace_asymmetric")
def laplace_asymmetric(q, kappa, loc=0.0, scale=1.0):
    q, kappa = _f(q), _f(kappa)
    k2 = kappa * kappa
    split = k2 / (1.0 + k2)
    low = kappa * jnp.log(jnp.clip(q * (1.0 + k2) / k2, 1e-30))
    high = -jnp.log(jnp.clip((1.0 - q) * (1.0 + k2), 1e-30)) / kappa
    return _f(loc) + _f(scale) * jnp.where(q < split, low, high)


@register("levy")
def levy(q, loc=0.0, scale=1.0):
    z = special.ndtri_fast_wide(0.5 * _f(q))
    return _f(loc) + _f(scale) / (z * z)


@register("levy_l")
def levy_l(q, loc=0.0, scale=1.0):
    z = special.ndtri_fast_wide(0.5 * (1.0 - _f(q)))
    return _f(loc) - _f(scale) / (z * z)


@register("loggamma")
def loggamma(q, c, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * jnp.log(special.gammaincinv(_f(c), _f(q)))


@register("loglaplace")
def loglaplace(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    low = jnp.power(jnp.clip(2.0 * q, 1e-30), 1.0 / c)
    high = jnp.power(jnp.clip(2.0 * (1.0 - q), 1e-30), -1.0 / c)
    return _f(loc) + _f(scale) * jnp.where(q < 0.5, low, high)


@register("lomax")
def lomax(q, c, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.expm1_safe(-jnp.log1p(-_f(q)) / _f(c))


@register("mielke")
def mielke(q, k, s, loc=0.0, scale=1.0):
    # CDF = x^k (1 + x^s)^(-k/s).
    q, k, s = _f(q), _f(k), _f(s)
    z = (s / k) * jnp.log1p(q - 1.0)
    ratio = jnp.exp(z) / (-special.expm1_safe(z))
    return _f(loc) + _f(scale) * jnp.power(ratio, 1.0 / s)


@register("moyal")
def moyal(q, loc=0.0, scale=1.0):
    # CDF = erfc(exp(-x/2) / sqrt(2)):  x = -2 log(-ndtri(q/2)).
    x = -2.0 * jnp.log(-special.ndtri_fast_wide(0.5 * _f(q)))
    return _f(loc) + _f(scale) * x


@register("pearson3")
def pearson3(q, skew, loc=0.0, scale=1.0):
    # Standardized Pearson III == gamma(alpha) / b + zeta with
    # alpha = 4/skew^2, b = skew/2, zeta = -2/skew; the sign of the skew
    # flips the tail the gamma lives in.  skew == 0 is the normal.
    # f32 caveat: |skew| << 1 standardizes a huge-alpha gamma and loses
    # relative precision; the reference (scipy) computes in f64.
    q, skew = _f(q), _f(skew)
    safe = jnp.where(jnp.abs(skew) < 1e-12, 1.0, skew)
    alpha = jnp.clip(4.0 / (safe * safe), max=1e12)
    b = 2.0 / safe
    zeta = -2.0 / safe
    qq = jnp.where(skew < 0, 1.0 - q, q)
    g = special.gammaincinv(alpha, qq)
    x = jnp.where(
        jnp.abs(skew) < 1e-12, special.ndtri_fast(q), g / b + zeta
    )
    return _f(loc) + _f(scale) * x


@register("powerlognorm")
def powerlognorm(q, c, s, loc=0.0, scale=1.0):
    # CDF = 1 - ndtr(-log(x)/s)^c.
    q, c, s = _f(q), _f(c), _f(s)
    x = jnp.exp(-s * _powernorm_score(q, c))
    return _f(loc) + _f(scale) * x


def _powernorm_score(q, c):
    """ndtri(w) for w = (1-q)^(1/c), tail-stable at both ends.

    For q -> 0, w -> 1 and ndtri(w) loses all resolution; there
    1 - w = -expm1(log1p(-q)/c) stays accurate and ndtri(w) = -ndtri(1-w).
    For q -> 1, w -> 0 where the direct wide kernel is accurate.
    """
    w = jnp.power(1.0 - q, 1.0 / c)
    direct = special.ndtri_fast_wide(w)
    one_minus_w = -special.expm1_safe(jnp.log1p(-q) / c)
    reflected = -special.ndtri_fast_wide(jnp.clip(one_minus_w, 2.0**-126))
    return jnp.where(q < 0.5, reflected, direct)


@register("powernorm")
def powernorm(q, c, loc=0.0, scale=1.0):
    # CDF = 1 - ndtr(-x)^c.
    q, c = _f(q), _f(c)
    return _f(loc) - _f(scale) * _powernorm_score(q, c)


@register("rdist")
def rdist(q, c, loc=0.0, scale=1.0):
    c = _f(c)
    return _f(loc) + _f(scale) * (
        2.0 * special.betaincinv(0.5 * c, 0.5 * c, _f(q)) - 1.0
    )


@register("trapezoid")
def trapezoid(q, c, d, loc=0.0, scale=1.0):
    # Rising on [0, c], flat on [c, d], falling on [d, 1];
    # h = 2 / (1 + d - c) is the plateau density.
    q, c, d = _f(q), _f(c), _f(d)
    h = 2.0 / (1.0 + d - c)
    q1 = 0.5 * h * c
    q2 = h * (d - 0.5 * c)
    rise = jnp.sqrt(jnp.clip(2.0 * c * q / h, 0.0))
    flat = q / h + 0.5 * c
    fall = 1.0 - jnp.sqrt(jnp.clip(2.0 * (1.0 - d) * (1.0 - q) / h, 0.0))
    x = jnp.where(q < q1, rise, jnp.where(q < q2, flat, fall))
    return _f(loc) + _f(scale) * x


@register("truncexpon")
def truncexpon(q, b, loc=0.0, scale=1.0):
    x = -jnp.log1p(_f(q) * special.expm1_safe(-_f(b)))
    return _f(loc) + _f(scale) * x


@register("truncpareto")
def truncpareto(q, b, c, loc=0.0, scale=1.0):
    # Pareto(b) truncated to [1, c]: CDF = (1 - x^-b) / (1 - c^-b).
    q, b, c = _f(q), _f(b), _f(c)
    x = jnp.power(1.0 - q * (1.0 - jnp.power(c, -b)), -1.0 / b)
    return _f(loc) + _f(scale) * x


@register("truncweibull_min")
def truncweibull_min(q, c, a, b, loc=0.0, scale=1.0):
    # weibull_min(c) truncated to [a, b], via survival interpolation.
    q, c, a, b = _f(q), _f(c), _f(a), _f(b)
    sa = jnp.exp(-jnp.power(a, c))
    sb = jnp.exp(-jnp.power(b, c))
    x = jnp.power(-jnp.log(sa - q * (sa - sb)), 1.0 / c)
    return _f(loc) + _f(scale) * x


@register("tukeylambda")
def tukeylambda(q, lam, loc=0.0, scale=1.0):
    q, lam = _f(q), _f(lam)
    near0 = jnp.abs(lam) < 1e-7
    safe = jnp.where(near0, 1.0, lam)
    general = (jnp.power(q, safe) - jnp.power(1.0 - q, safe)) / safe
    x = jnp.where(near0, jnp.log(q) - jnp.log1p(-q), general)
    return _f(loc) + _f(scale) * x


@register("wrapcauchy")
def wrapcauchy(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    val = (1.0 - c) / (1.0 + c)
    low = 2.0 * jnp.arctan(val * jnp.tan(jnp.pi * q))
    high = 2.0 * jnp.pi - 2.0 * jnp.arctan(val * jnp.tan(jnp.pi * (1.0 - q)))
    # q == 0.5 exactly: tan(float32(pi/2)) flips sign, both branches
    # land a full period off; the median is pi by symmetry.
    x = jnp.where(q < 0.5, low, jnp.where(q > 0.5, high, jnp.pi))
    return _f(loc) + _f(scale) * x


@register("reciprocal")
def reciprocal(q, a, b, loc=0.0, scale=1.0):
    """scipy alias of ``loguniform``."""
    return loguniform(q, a, b, loc=loc, scale=scale)


@register("skewcauchy")
def skewcauchy(q, a, loc=0.0, scale=1.0):
    # Two Cauchy half-bodies of widths (1 -+ a) glued at 0, where the
    # CDF is F0 = (1 - a)/2.  Each half inverts through a tangent; past
    # the half-body midpoint the complementary-angle cotangent form
    # keeps the tails exact (tan near pi/2 loses all f32 resolution).
    q, a = _f(q), _f(a)
    wl, wu = 1.0 - a, 1.0 + a
    f0 = 0.5 * wl
    up_mid = wu * jnp.tan(jnp.pi * (q - f0) / wu)
    up_tail = wu / jnp.tan(jnp.pi * (1.0 - q) / wu)
    lo_mid = wl * jnp.tan(jnp.pi * (q - f0) / wl)
    lo_tail = -wl / jnp.tan(jnp.pi * q / wl)
    upper = jnp.where(q > f0 + 0.5 * wu * 0.5, up_tail, up_mid)
    lower = jnp.where(q < 0.5 * f0, lo_tail, lo_mid)
    return _f(loc) + _f(scale) * jnp.where(q < f0, lower, upper)


@register("kappa4")
def kappa4(q, h, k, loc=0.0, scale=1.0):
    # CDF = (1 - h (1 - k x)^(1/k))^(1/h); the h=0 / k=0 limits are the
    # expm1 limits of one unified form: with t = (1 - q^h)/h
    # (-> -log q as h -> 0), x = (1 - t^k)/k (-> -log t as k -> 0).
    # scipy switches on EXACT zeros (kappa4_gen._ppf); mirrored here —
    # near-zero nonzero h/k stay accurate through expm1.
    q, h, k = _f(q), _f(h), _f(k)
    logq = jnp.log(q)
    hs = jnp.where(h == 0.0, 1.0, h)
    t = jnp.where(h == 0.0, -logq, -special.expm1_safe(hs * logq) / hs)
    logt = jnp.log(t)
    ks = jnp.where(k == 0.0, 1.0, k)
    x = jnp.where(k == 0.0, -logt, -special.expm1_safe(ks * logt) / ks)
    return _f(loc) + _f(scale) * x


@register("crystalball")
def crystalball(q, beta, m, loc=0.0, scale=1.0):
    """Gaussian core with a power-law left tail grafted at -beta.

    Tail mass C = m exp(-beta^2/2) / (beta (m - 1)), core mass
    D = sqrt(2 pi) ndtr(beta), N = 1/(C + D).  Below q = N C the
    power branch inverts in log space (never overflows); above it the
    Gaussian branch reduces IDENTICALLY to
    x = -ndtri((1 - q) / (N sqrt(2 pi))) — the Phi(-beta) terms cancel,
    so the upper tail stays relative-accurate through the wide kernel.
    """
    q, beta, m = _f(q), _f(beta), _f(m)
    sqrt2pi = jnp.asarray(2.5066282746310002, q.dtype)
    b2h = 0.5 * beta * beta
    C = m / (beta * (m - 1.0)) * jnp.exp(-b2h)
    D = sqrt2pi * special.ndtr_fast(beta)
    logN = -jnp.log(C + D)
    pbeta = jnp.exp(logN) * C
    # Power branch: q = N (m/beta)^m e^{-b2h} (m/beta - beta - x)^{1-m}/(m-1).
    logmb = jnp.log(m / beta)
    L = (jnp.log(q) + jnp.log(m - 1.0) - logN - m * logmb + b2h) / (1.0 - m)
    x_pow = m / beta - beta - jnp.exp(L)
    x_gauss = -special.ndtri_fast_wide(
        jnp.clip((1.0 - q) * (C + D) / sqrt2pi, 2.0**-126, 1.0)
    )
    x = jnp.where(q < pbeta, x_pow, x_gauss)
    return _f(loc) + _f(scale) * x


@register("argus")
def argus(q, chi, loc=0.0, scale=1.0):
    # SF = P(3/2, chi^2 (1-x^2)/2) / P(3/2, chi^2/2) with P the
    # regularized lower incomplete gamma (substitute u = chi^2(1-x^2)/2
    # in the pdf: x sqrt(1-x^2) e^{-u} dx -> sqrt(u) e^{-u} du).
    q, chi = _f(q), _f(chi)
    half_chi2 = 0.5 * chi * chi
    p_chi = special.gammainc_kernel(1.5, half_chi2)
    u = special.gammaincinv(1.5, (1.0 - q) * p_chi)
    x = jnp.sqrt(jnp.clip(1.0 - u / half_chi2, 0.0))
    # x -> 0: u -> chi^2/2 and the difference cancels to f32 noise
    # (50% relative at q=1e-6).  There F(x) = k [y/2 + (a-1/2) y^2/4
    # + (a^2/2 - a/2 - 1/8) y^3/6] in y = x^2 with a = chi^2/2 and
    # k = chi^3 e^{-a} / (sqrt(2 pi) Psi(chi)), Psi(chi) = P(3/2, a)/2;
    # two Newton steps on the cubic invert it to full f32 accuracy.
    sqrt2pi = jnp.asarray(2.5066282746310002, q.dtype)
    a = half_chi2
    k = chi**3 * jnp.exp(-a) / (sqrt2pi * 0.5 * p_chi)
    c2, c3 = 0.25 * (a - 0.5), (0.5 * a * a - 0.5 * a - 0.125) / 6.0
    target = q / k
    y = 2.0 * target
    for _ in range(2):
        g = y * (0.5 + y * (c2 + y * c3))
        gp = 0.5 + y * (2.0 * c2 + y * 3.0 * c3)
        y = jnp.clip(y - (g - target) / gp, 0.0)
    # Valid while the cubic truncation (next term ~ (a y)^4) is below
    # f32 eps relative; switch where the gamma path's cancellation noise
    # (~1e-7 a / x^2 relative) exceeds it.
    use_series = x * x < 0.05 / jnp.maximum(a, 1.0)
    x = jnp.where(use_series, jnp.sqrt(jnp.clip(y, 0.0)), x)
    return _f(loc) + _f(scale) * x


@register("recipinvgauss")
def recipinvgauss(q, mu, loc=0.0, scale=1.0):
    # If X ~ invgauss(mu) then 1/X has exactly the recipinvgauss(mu)
    # density (transform the Shuster form): ppf(q) = 1 / ppf_IG(1 - q),
    # with (1 - q) Sterbenz-exact in f32.
    return _f(loc) + _f(scale) / invgauss(1.0 - _f(q), mu)


# =====================================================================
# Continuous, safeguarded-Newton on a closed-form CDF
# =====================================================================


@register("cosine")
def cosine(q, loc=0.0, scale=1.0):
    # CDF = (pi + x + sin x) / (2 pi) on [-pi, pi].
    q = _f(q)

    def cdf(x):
        return (jnp.pi + x + jnp.sin(x)) / (2.0 * jnp.pi)

    def pdf(x):
        return (1.0 + jnp.cos(x)) / (2.0 * jnp.pi)

    x0 = jnp.pi * (2.0 * q - 1.0)
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, -jnp.pi, jnp.pi)
    return _f(loc) + _f(scale) * x


@register("foldnorm")
def foldnorm(q, c, loc=0.0, scale=1.0):
    # CDF = ndtr(x - c) + ndtr(x + c) - 1 on x >= 0.
    q, c = _f(q), _f(c)

    def cdf(x):
        return special.ndtr_fast(x - c) - special.ndtr_neg_fast(x + c)

    inv_sqrt2pi = 0.3989422804014327

    def pdf(x):
        return inv_sqrt2pi * (
            jnp.exp(-0.5 * jnp.square(x - c)) + jnp.exp(-0.5 * jnp.square(x + c))
        )

    hi = c + 9.0
    x0 = jnp.clip(c + special.ndtri_fast(q) * 0.5, 0.0, hi)
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, 0.0, hi)
    return _f(loc) + _f(scale) * x


@register("foldcauchy")
def foldcauchy(q, c, loc=0.0, scale=1.0):
    # CDF = (arctan(x - c) + arctan(x + c)) / pi on x >= 0.
    q, c = _f(q), _f(c)

    def cdf(x):
        return (jnp.arctan(x - c) + jnp.arctan(x + c)) / jnp.pi

    def pdf(x):
        return (
            1.0 / (1.0 + jnp.square(x - c)) + 1.0 / (1.0 + jnp.square(x + c))
        ) / jnp.pi

    # Heavy upper tail: 1 - F ~ 2/(pi x), so bracket by the tail inverse.
    hi = c + 4.0 / (jnp.pi * jnp.clip(1.0 - q, 1e-12))
    x0 = jnp.clip(2.0 / (jnp.pi * jnp.clip(1.0 - q, 1e-12)), 0.0, hi)
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, 0.0, hi)
    # Deep tail: the f32 CDF resolves ~6e-8, flooring Newton at ~6%
    # relative out there; arctan(u) ~ u - u^3/3 gives the closed form
    # eps = pi(1-q) = 1/(x-c) + 1/(x+c)  =>  x = (1+sqrt(1+(eps c)^2))/eps
    # with (1-q) Sterbenz-exact (series truncation error < 3e-5 past the
    # switch point).
    eps = jnp.pi * (1.0 - q)
    x_tail = (1.0 + jnp.sqrt(1.0 + jnp.square(eps * c))) / eps
    x = jnp.where(q > 0.99, x_tail, x)
    return _f(loc) + _f(scale) * x


@register("exponnorm")
def exponnorm(q, K, loc=0.0, scale=1.0):
    """Exponentially modified normal (EMG).

    CDF = ndtr(x) - exp(1/(2K^2) - x/K) ndtr(x - 1/K); the product is
    evaluated through the scaled normal CDF (the exponents cancel to
    exp(-x^2/2) for x <= 1/K), so small K never overflows — same
    technique as ``invgauss``.
    """
    q, K = _f(q), _f(K)
    kinv = 1.0 / K

    def _term(x):
        y = x - kinv
        scaled = jnp.exp(-0.5 * x * x) * special.ndtr_scaled_neg(
            jnp.minimum(y, 0.0)
        )
        # For y > 0 the exponent 1/(2K^2) - x/K is provably negative.
        direct = jnp.exp(0.5 * kinv * kinv - x * kinv) * special.ndtr_fast(
            jnp.maximum(y, 0.0)
        )
        return jnp.where(y <= 0.0, scaled, direct)

    def cdf(x):
        return special.ndtr_fast(x) - _term(x)

    def pdf(x):
        return kinv * _term(x)

    z = special.ndtri_fast(q)
    # Exponential upper tail: 1 - F ~ exp(1/(2K^2) - x/K).
    hi = 0.5 * kinv - K * jnp.log1p(-q) + 9.0
    lo = z - 1.0
    x0 = jnp.clip(z + K, lo, hi)
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, lo, hi)
    return _f(loc) + _f(scale) * x


@register("genexpon")
def genexpon(q, a, b, c, loc=0.0, scale=1.0):
    # CDF = 1 - exp(E) with E = -(a+b) x + (b/c)(1 - e^{-cx}).  scipy
    # inverts through Lambert W; a safeguarded Newton on the closed
    # form needs no new special function and the bounds
    # -(a+b) x <= E <= -a x + b/c bracket the root exactly.
    q, a, b, c = _f(q), _f(a), _f(b), _f(c)
    nlog1mq = -jnp.log1p(-q)

    def _E(x):
        return -(a + b) * x - (b / c) * special.expm1_safe(-c * x)

    def cdf(x):
        return -special.expm1_safe(_E(x))

    def pdf(x):
        return (a - b * special.expm1_safe(-c * x)) * jnp.exp(_E(x))

    lo = nlog1mq / (a + b)
    hi = (nlog1mq + b / c) / a
    x = special.continuous_ppf_newton(cdf, pdf, q, lo, lo, hi)
    return _f(loc) + _f(scale) * x


@register("kstwobign")
def kstwobign(q, loc=0.0, scale=1.0):
    """Kolmogorov limit distribution of sqrt(n) D_n.

    Body/upper tail: SF = 2 sum_k (-1)^{k-1} e^{-2 k^2 x^2} (5 terms
    resolve below f32 eps for x >= 0.75).  Lower tail: the Jacobi theta
    transform CDF = sqrt(2 pi)/x sum_{j odd} e^{-j^2 pi^2 / (8 x^2)}
    converges just as fast for x < 0.75; both are exact at the switch.
    """
    q = _f(q)
    sqrt2pi = jnp.asarray(2.5066282746310002, q.dtype)

    def _big(x):
        x2 = x * x
        s_cdf = jnp.zeros_like(x)
        s_pdf = jnp.zeros_like(x)
        for k in range(1, 6):
            sign = 1.0 if k % 2 == 1 else -1.0
            e = jnp.exp(-2.0 * k * k * x2)
            s_cdf = s_cdf + sign * e
            s_pdf = s_pdf + sign * (k * k) * e
        return 1.0 - 2.0 * s_cdf, 8.0 * x * s_pdf

    def _small(x):
        xs = jnp.clip(x, 1e-3)
        s_cdf = jnp.zeros_like(x)
        s_pdf = jnp.zeros_like(x)
        for j in (1, 3, 5):
            cj = j * j * jnp.pi * jnp.pi / 8.0
            e = jnp.exp(-cj / (xs * xs))
            s_cdf = s_cdf + e
            s_pdf = s_pdf + e * (2.0 * cj / xs**4 - 1.0 / (xs * xs))
        return sqrt2pi * s_cdf / xs, sqrt2pi * s_pdf

    def cdf(x):
        big_c, _ = _big(x)
        small_c, _ = _small(x)
        return jnp.where(x < 0.75, small_c, big_c)

    def pdf(x):
        _, big_p = _big(x)
        _, small_p = _small(x)
        return jnp.where(x < 0.75, small_p, big_p)

    # One-term SF inverse seeds the body and upper tail exactly.
    x0 = jnp.clip(jnp.sqrt(-0.5 * jnp.log(0.5 * (1.0 - q))), 0.3, 3.8)
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, 0.03, 4.0)
    return _f(loc) + _f(scale) * x


@register("rel_breitwigner")
def rel_breitwigner(q, rho, loc=0.0, scale=1.0):
    # pdf = C / (((x - rho)(x + rho)/rho)^2 + 1) on x >= 0; the CDF is
    # the imaginary part of a complex arctan (partial fractions over
    # the roots x^2 = rho^2 +- i rho).  Newton on that pair.
    q, rho = _f(q), _f(rho)
    inv_r2 = 1.0 / (rho * rho)
    s = jnp.sqrt(1.0 + inv_r2)
    C = jnp.sqrt(2.0 * (1.0 + inv_r2) / (1.0 + s)) * 2.0 / jnp.pi
    cdim = jnp.complex64 if q.dtype == jnp.float32 else jnp.complex128
    w = jnp.sqrt(jnp.asarray(-1.0, cdim) + 1j / rho.astype(cdim))
    root = jnp.sqrt(-rho.astype(cdim) * (rho.astype(cdim) + 1j))
    amp = jnp.sqrt(2.0 / (1.0 + s)) / jnp.pi

    def cdf(x):
        val = 2.0 * amp * jnp.imag(w * jnp.arctan(x.astype(cdim) / root))
        return jnp.clip(val, 0.0, 1.0)

    def pdf(x):
        t = (x - rho) * (x + rho) / rho
        return C / (t * t + 1.0)

    # x^-4 tail: SF ~ C rho^2 / (3 x^3) bounds the upper bracket.
    hi = jnp.power(
        C * rho * rho / (3.0 * jnp.clip(1.0 - q, 1e-12)), 1.0 / 3.0
    ) + 3.0 * (rho + 1.0)
    x0 = jnp.clip(jnp.broadcast_to(rho, jnp.broadcast_shapes(q.shape, rho.shape)), 0.0, hi)
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, 0.0, hi)
    # Upper tail: the f32 CDF saturates (resolution ~1e-7 near 1, 13%
    # quantile error at q = 1-1e-5).  arctan(z) -> pi/2 - arctan(1/z)
    # turns the complement into SF = 2 amp Im(w arctan(root/x)) with no
    # cancellation; Newton in SF space via the same safeguarded helper
    # (cdf := -sf is increasing, target -s, s = 1-q Sterbenz-exact).
    s = 1.0 - q

    def neg_sf(x):
        z = root / jnp.clip(x, 1e-3).astype(cdim)
        return -2.0 * amp * jnp.imag(w * jnp.arctan(z))

    x_tail = special.continuous_ppf_newton(
        neg_sf, pdf, -s, jnp.clip(hi - 3.0 * (rho + 1.0), rho, hi), rho, hi
    )
    x = jnp.where(q > 0.99, x_tail, x)
    return _f(loc) + _f(scale) * x


# =====================================================================
# Discrete distributions
# =====================================================================


def _table_ppf(q, cdf_table, loc=0):
    """Static fast path: searchsorted into a host-precomputed f64 CDF table.

    One gather per sample; the table is baked into the program as a
    constant living in device memory.
    """
    table = jnp.asarray(cdf_table, config.float_dtype())
    k = jnp.searchsorted(table, jnp.asarray(q, config.float_dtype()), side="left")
    k = jnp.minimum(k, table.shape[0] - 1)
    return k.astype(config.float_dtype()) + _f(loc)


def _poisson_cdf_table(mu):
    import scipy.stats as sps

    kmax = int(np.ceil(mu + 12.0 * np.sqrt(mu + 1.0) + 30.0))
    table = sps.poisson.cdf(np.arange(kmax + 1), mu)
    table[-1] = 1.0
    return table


def _binom_cdf_table(n, p):
    import scipy.stats as sps

    table = sps.binom.cdf(np.arange(int(n) + 1), int(n), float(p))
    table[-1] = 1.0
    return table


def _nbinom_cdf_table(n, p):
    import scipy.stats as sps

    mean = n * (1 - p) / p
    var = n * (1 - p) / p**2
    kmax = int(np.ceil(mean + 12 * np.sqrt(var + 1) + 30))
    table = sps.nbinom.cdf(np.arange(kmax + 1), n, p)
    table[-1] = 1.0
    return table


_STATIC_TABLE_BUILDERS = {
    "poisson": lambda mu, loc=0: (_poisson_cdf_table(float(mu)), loc),
    "binom": lambda n, p, loc=0: (_binom_cdf_table(n, p), loc),
    "nbinom": lambda n, p, loc=0: (_nbinom_cdf_table(n, p), loc),
}

# Generic fallback table size: a 4096-entry constant + one searchsorted
# is cheap in XLA; far beyond any realistic hypergeom/zipf/logser support
# reachable by float32 uniforms.
_GENERIC_TABLE_CAP = 4096


def _generic_discrete_table(name, args, kwargs):
    """(f64 CDF table, support start) for no-kernel static discrete families.

    Works for every ``scipy.stats`` discrete distribution WITHOUT a
    registered native kernel, given static scalar parameters: the table
    spans the eps ... 1 - eps quantile range, where eps is one ulp
    below the clamp the engine's uniforms can actually reach (2^-25 in
    float32 mode, 2^-54 in float64 — an f64 run whose tails need more
    than the cap falls back to the exact host callback rather than
    silently truncating).  Unbounded-below supports (skellam, dlaplace)
    start the table at the eps quantile — everything lower is
    unreachable under the clamped uniforms.  Returns None when
    inapplicable (continuous family, a family with its own kernel,
    traced parameters, table too big).
    """
    import scipy.stats as sps

    if lookup(name) is not None:
        # Closed-form/native kernels (bernoulli, geom, randint, ...) must
        # keep their exact emit; the generic table is
        # strictly a fallback for families that would otherwise pay a
        # host callback.
        return None
    dist = getattr(sps, name, None)
    if dist is None or not isinstance(dist, sps.rv_discrete):
        return None
    eps = 2.0**-25 if config.float_dtype() == jnp.float32 else 2.0**-54
    try:
        frozen = dist(*args, **kwargs)
        lo, hi_support = frozen.support()
        if not np.isfinite(lo):
            lo = frozen.ppf(eps)
            if not np.isfinite(lo):
                return None
        hi = frozen.ppf(1.0 - eps)
        if not np.isfinite(hi):
            hi = hi_support
        if not np.isfinite(hi) or hi - lo + 1 > _GENERIC_TABLE_CAP:
            return None
        ks = np.arange(int(lo), int(hi) + 1)
        table = np.asarray(frozen.cdf(ks), np.float64)
        table[-1] = 1.0
        return table, int(lo)
    except (TypeError, ValueError):
        return None


def static_cdf_table(distr, *args, **kwargs):
    """(f64 CDF table, offset) for a static-parameter discrete family, or None.

    The same tables ``_table_ppf`` bakes into the XLA program.  Families
    without a hand-written
    builder fall back to the generic scipy-support scan.  Returns None
    for non-discrete families, non-static (traced/Node) parameters, or
    non-scalar shapes.
    """
    params = list(args) + list(kwargs.values())
    if not _is_static(*params):
        return None
    if any(np.ndim(p) != 0 for p in params) and distr != "poisson_binom":
        # Array params mean a BATCH of distributions (one table each
        # would be wrong) — except poisson_binom, whose success-
        # probability vector parametrizes a single scalar-valued law.
        return None
    builder = _STATIC_TABLE_BUILDERS.get(distr)
    if builder is not None:
        try:
            return builder(*args, **kwargs)
        except TypeError:
            return None
    return _generic_discrete_table(distr, args, kwargs)


@register("poisson")
def poisson(q, mu, loc=0):
    if _is_static(mu) and np.ndim(mu) == 0:
        return _table_ppf(q, _poisson_cdf_table(float(mu)), loc)
    mu = _f(mu)
    q = _f(q)
    # P(X <= k) = Q(k+1, mu), the regularized upper incomplete gamma.
    cdf = lambda k: gammaincc(k + 1.0, mu)
    hi = jnp.ceil(mu + 12.0 * jnp.sqrt(mu + 1.0) + 30.0)
    k = special.discrete_ppf_bisect(cdf, q, hi)
    return jnp.maximum(k, 0.0) + _f(loc)


@register("binom")
def binom(q, n, p, loc=0):
    if _is_static(n, p) and np.ndim(n) == 0 and np.ndim(p) == 0:
        return _table_ppf(q, _binom_cdf_table(n, p), loc)
    n, p, q = _f(n), _f(p), _f(q)
    # P(X <= k) = I_{1-p}(n - k, k + 1) for 0 <= k < n, else 1.
    cdf = lambda k: jnp.where(
        k >= n, 1.0, betainc(jnp.clip(n - k, 1e-9), k + 1.0, 1.0 - p)
    )
    k = special.discrete_ppf_bisect(cdf, q, n)
    return jnp.clip(k, 0.0, n) + _f(loc)


@register("bernoulli")
def bernoulli(q, p, loc=0):
    return (jnp.asarray(q, config.float_dtype()) > (1.0 - _f(p))).astype(
        config.float_dtype()
    ) + _f(loc)


@register("geom")
def geom(q, p, loc=0):
    # Support {1, 2, ...}: smallest k with 1 - (1-p)^k >= q.
    p, q = _f(p), _f(q)
    k = jnp.ceil(jnp.log1p(-q) / jnp.log1p(-p))
    return jnp.maximum(k, 1.0) + _f(loc)


@register("nbinom")
def nbinom(q, n, p, loc=0):
    if _is_static(n, p) and np.ndim(n) == 0 and np.ndim(p) == 0:
        return _table_ppf(q, _nbinom_cdf_table(n, p), loc)
    n, p, q = _f(n), _f(p), _f(q)
    # P(X <= k) = I_p(n, k + 1)
    cdf = lambda k: betainc(n, k + 1.0, p)
    mean = n * (1.0 - p) / p
    var = n * (1.0 - p) / (p * p)
    hi = jnp.ceil(mean + 12.0 * jnp.sqrt(var + 1.0) + 30.0)
    k = special.discrete_ppf_bisect(cdf, q, hi)
    return jnp.maximum(k, 0.0) + _f(loc)


@register("randint")
def randint(q, low, high, loc=0):
    # scipy convention: k = ceil(q*(high-low)) - 1 + low, so exact-integer
    # quantiles (reachable on the float32 2^-24 uniform grid and via QMC
    # lattices) land on the scipy/reference value, not one above it.
    low, high = _f(low), _f(high)
    k = jnp.ceil(_f(q) * (high - low)) - 1.0 + low
    return jnp.clip(k, low, high - 1.0) + _f(loc)


# =====================================================================
# Fallback: host callback into scipy.stats (full name coverage)
# =====================================================================


def is_multivariate(name):
    """True if scipy.stats ``name`` is a multivariate distribution (no ppf)."""
    import scipy.stats as sps

    obj = getattr(sps, name)
    return not hasattr(obj, "ppf")


# =====================================================================
# Generic continuous tier: monotone-cubic quantile tables in z-space
# =====================================================================

# Families with expensive scipy ppfs (numeric integration per point)
# get coarser grids; PCHIP error scales h^4 and is still below those
# ppfs' OWN numeric noise at these counts (measured: levy_stable
# 1.2e-5 scaled error at BOTH 257 and 1025 knots — the floor is
# scipy's inversion, not the interpolation).
_PCHIP_KNOTS = {"levy_stable": 257, "studentized_range": 129}
_PCHIP_KNOTS_DEFAULT = 1025
_PCHIP_CACHE = {}


def _pchip_build(name, args, kwargs):
    """Host-side quantile-table build for a static continuous family.

    Evaluates ``scipy.stats.<name>.ppf`` on a uniform grid in the
    normal-score variable z (q = ndtr(z), z in [-8.3, 8.3] — one ulp
    past the engine's f64 uniform clamp, so every reachable quantile is
    interior), robust-standardizes, compresses tails through asinh, and
    fits a monotone cubic (PCHIP).  The asinh makes heavy-tailed
    quantile curves (levy_stable, landau) polynomially smooth in z, so
    ~1e-8 scaled interpolation error at 1025 knots (measured; see
    tests/test_distributions.py::TestGenericContinuousTable).
    """
    import scipy.special as ssp
    import scipy.stats as sps
    from scipy.interpolate import PchipInterpolator

    dist = getattr(sps, name, None)
    if dist is None or not isinstance(dist, sps.rv_continuous):
        return None
    n_knots = _PCHIP_KNOTS.get(name, _PCHIP_KNOTS_DEFAULT)
    z = np.linspace(-8.3, 8.3, n_knots)
    qs = ssp.ndtr(z)
    try:
        frozen = dist(*args, **kwargs)
        x = np.empty(n_knots, np.float64)
        # Chunked evaluation: some ppfs raise mid-grid at extreme
        # quantiles (norminvgauss overflows k1e in the far tail); only
        # the failing chunk pays a per-point retry.
        step = 64
        with np.errstate(all="ignore"):
            for i in range(0, n_knots, step):
                sl = slice(i, min(i + step, n_knots))
                try:
                    x[sl] = frozen.ppf(qs[sl])
                except Exception:
                    for j in range(sl.start, sl.stop):
                        try:
                            x[j] = frozen.ppf(qs[j])
                        except Exception:
                            x[j] = np.nan
    except (TypeError, ValueError):
        return None
    finite = np.isfinite(x)
    if not finite.any():
        return None
    i0 = int(np.argmax(finite))
    i1 = n_knots - 1 - int(np.argmax(finite[::-1]))
    z, x = z[i0 : i1 + 1], x[i0 : i1 + 1]
    if len(z) < 16 or not np.isfinite(x).all():
        return None
    # Numeric ppfs (levy_stable) carry ~1e-5 inversion noise that can
    # produce locally decreasing values; isotonize rather than bail.
    x = np.maximum.accumulate(x)
    # Robust center/scale at the TRUE quartiles (z = +-0.6745), NOT
    # percentiles of the knot array — the grid is uniform in z, so knot
    # quartiles sit at q ~ 1.7e-5 and blow the scale up by the tail
    # magnitude (heavy-tailed families then lose the body to f32 sinh
    # rounding: measured 1.6e-3 absolute error on landau's body).
    m = float(np.interp(0.0, z, x))
    s = float(np.interp(0.6745, z, x) - np.interp(-0.6745, z, x)) / 1.349
    if not (s > 0.0):
        s = max(float(x[-1] - x[0]) / 8.0, 1e-300)
    y = np.arcsinh((x - m) / s)
    try:
        pchip = PchipInterpolator(z, y)
    except ValueError:
        return None
    # PPoly.c is (4, nseg), highest power first, local in (z - z_k).
    coeffs = np.ascontiguousarray(pchip.c.T, np.float64)
    h = float(z[1] - z[0])
    return coeffs, float(z[0]), h, m, s


def static_quantile_table(name, *args, **kwargs):
    """Cached PCHIP quantile table for a static continuous family, or None.

    The generic no-kernel tier: full ``scipy.stats`` continuous
    coverage on-device (shardable, streamable, jit-fusable) at static
    parameters, replacing the per-call host callback.  Traced
    parameters still fall back to :func:`scipy_fallback_ppf`.
    """
    if lookup(name) is not None:
        return None
    params = list(args) + list(kwargs.values())
    if not _is_static(*params) or any(np.ndim(p) != 0 for p in params):
        return None
    key = (
        name,
        tuple(float(p) for p in args),
        tuple(sorted((k, float(v)) for k, v in kwargs.items())),
    )
    if key not in _PCHIP_CACHE:
        _PCHIP_CACHE[key] = _pchip_build(name, args, kwargs)
    return _PCHIP_CACHE[key]


def _pchip_ppf(q, table):
    """Device evaluation of a host-built PCHIP quantile table.

    z = ndtri(q), one gather of the 4 segment coefficients (the z grid
    is uniform, so the segment index is a floor — no searchsorted),
    cubic Horner, then x = m + s sinh(y) undoes the tail compression.
    """
    coeffs, z0, h, m, s = table
    dt = config.float_dtype()
    c = jnp.asarray(coeffs, dt)
    nseg = c.shape[0]
    z = special.ndtri_fast_wide(jnp.asarray(q, dt))
    z = jnp.clip(z, z0, z0 + h * nseg)
    u = (z - z0) / h
    k = jnp.clip(u.astype(jnp.int32), 0, nseg - 1)
    dz = z - (z0 + k.astype(dt) * h)
    ck = c[k]
    y = ((ck[..., 0] * dz + ck[..., 1]) * dz + ck[..., 2]) * dz + ck[..., 3]
    # sinh via expm1 keeps relative accuracy for |y| << 1 (the body of
    # heavy-tailed families lives there after the asinh compression).
    t = special.expm1_safe(y)
    return m + (0.5 * s) * (t + t / (t + 1.0))


def scipy_fallback_ppf(name, q, *args, **kwargs):
    """Host-callback ppf for scipy.stats distributions without a native kernel.

    Mirrors the reference dispatch (``modeling.py:795-807``).  Traced
    parameters are shipped to host per call; use a registered kernel for
    hot paths.
    """
    import scipy.stats as sps

    getattr(sps, name)  # Raise early (at trace time) on bad names.

    arg_arrays = [a for a in args if isinstance(a, (jax.Array, jnp.ndarray))]
    kw_keys = [k for k, v in kwargs.items() if isinstance(v, (jax.Array, jnp.ndarray))]
    kw_arrays = [kwargs[k] for k in kw_keys]
    static_args = [None if isinstance(a, (jax.Array, jnp.ndarray)) else a for a in args]
    static_kwargs = {k: v for k, v in kwargs.items() if k not in kw_keys}

    out_dtype = config.np_float_dtype()

    def host(q_np, *arrays):
        it = iter(arrays)
        full_args = [next(it) if a is None else a for a in static_args]
        full_kwargs = dict(static_kwargs)
        for k in kw_keys:
            full_kwargs[k] = next(it)
        frozen = getattr(sps, name)(*full_args, **full_kwargs)
        return np.asarray(frozen.ppf(np.asarray(q_np, np.float64)), out_dtype)

    result = jax.ShapeDtypeStruct(jnp.shape(q), out_dtype)
    return jax.pure_callback(host, result, q, *arg_arrays, *kw_arrays)


def scipy_fallback_rvs(name, q, shape, *args, **kwargs):
    """Multivariate fallback: scipy ``.rvs`` seeded from the first quantile.

    Mirrors reference ``modeling.py:808-812`` (seed = int(q[0] * 2**20)).
    ``shape`` is the static output shape (n,) or (n, d).
    """
    import scipy.stats as sps

    out_dtype = config.np_float_dtype()

    def host(q_np):
        seed = int(np.asarray(q_np).ravel()[0] * 2**20)
        frozen = getattr(sps, name)(*args, **kwargs)
        draws = frozen.rvs(size=shape[0], random_state=seed)
        return np.asarray(draws, out_dtype).reshape(shape)

    result = jax.ShapeDtypeStruct(shape, out_dtype)
    return jax.pure_callback(host, result, q)
