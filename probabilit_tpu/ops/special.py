"""Special functions for inverse-CDF sampling kernels.

The reference delegates all of this to scipy.stats' compiled ppf routines
(``modeling.py:805-807``).  Here the inverses are XLA-native so that a
billion-sample ppf evaluation stays on the device: safeguarded Newton iterations
on ``jax.scipy.special.gammainc`` / ``betainc`` with analytically computed
derivatives, fully vectorised and fused into the surrounding program.

All functions broadcast elementwise and operate in the configured float dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import (
    betainc,
    betaln,
    gammainc,
    gammaln,
    ndtr,
    ndtri,
)

__all__ = [
    "ndtr",
    "ndtri",
    "ndtri_fast",
    "ndtri_fast_wide",
    "ndtr_fast",
    "ndtr_neg_fast",
    "erfinv_f32",
    "expm1_safe",
    "t_cdf",
    "chi2_draws",
    "gammaincinv",
    "gammainccinv",
    "betaincinv",
    "discrete_ppf_bisect",
    "continuous_ppf_newton",
]


def erfinv_f32(x):
    """Fast single-precision inverse error function (Giles 2012 scheme).

    Two short polynomial branches in w = -log(1-x^2); ~20 fma + one log +
    one select, no divisions (chosen over the XLA ndtri rational on the
    earlier accelerator; not re-measured on the H100).  Max relative error ~1e-6, well
    inside the framework's float32 sampling accuracy contract.

    The tail branch is fitted up to w ~ 16.6 (|x| up to ~1 - 2^-24, the
    densest float32 value the engine's clamped uniforms can produce);
    beyond that w is clamped, so inputs that round to exactly +/-1
    saturate at ~+/-4 (with the correct sign) instead of evaluating the
    polynomial outside its fit range.  For genuinely tiny tail
    probabilities use :func:`ndtri_fast_wide`.
    """
    x = jnp.asarray(x, jnp.float32)
    w = -jnp.log(jnp.clip((1.0 - x) * (1.0 + x), 1e-37))
    w = jnp.minimum(w, jnp.float32(16.64))
    p1, p2 = _giles_branch_polys(w)
    return jnp.where(w < 5.0, p1, p2) * x


def _giles_branch_polys(w):
    """Giles (2012) erfinv polynomial branches evaluated at ``w``.

    Returns ``(p1, p2)``: the central branch (fit for w < 5) in
    ``w - 2.5`` and the tail branch (fit up to w ~ 16.6, clamped there)
    in ``sqrt(w) - 3``.  One home for the 18 coefficients so
    :func:`erfinv_f32` and :func:`ndtri_fast_wide` can never drift apart
    on a retune.
    """
    wc = w - 2.5
    p1 = jnp.float32(2.81022636e-08)
    p1 = jnp.float32(3.43273939e-07) + p1 * wc
    p1 = jnp.float32(-3.5233877e-06) + p1 * wc
    p1 = jnp.float32(-4.39150654e-06) + p1 * wc
    p1 = jnp.float32(0.00021858087) + p1 * wc
    p1 = jnp.float32(-0.00125372503) + p1 * wc
    p1 = jnp.float32(-0.00417768164) + p1 * wc
    p1 = jnp.float32(0.246640727) + p1 * wc
    p1 = jnp.float32(1.50140941) + p1 * wc

    ws = jnp.sqrt(jnp.minimum(w, jnp.float32(16.64))) - 3.0
    p2 = jnp.float32(-0.000200214257)
    p2 = jnp.float32(0.000100950558) + p2 * ws
    p2 = jnp.float32(0.00134934322) + p2 * ws
    p2 = jnp.float32(-0.00367342844) + p2 * ws
    p2 = jnp.float32(0.00573950773) + p2 * ws
    p2 = jnp.float32(-0.0076224613) + p2 * ws
    p2 = jnp.float32(0.00943887047) + p2 * ws
    p2 = jnp.float32(1.00167406) + p2 * ws
    p2 = jnp.float32(2.83297682) + p2 * ws
    return p1, p2


_SQRT2 = 1.4142135623730951


def ndtri_fast(q):
    """Standard-normal quantile; the HOT sampling path (f32), exact in f64.

    One log + two short polynomials (Giles erfinv branches).  Valid for
    quantiles in [2^-24, 1 - 2^-24] — exactly the open-interval range the
    engine's generators produce (``qmc.clamp_open_unit``); quantiles
    beyond that saturate at ~+/-5.66 sigma with the correct sign (they
    are not resolvable by float32 uniforms anyway).  Use
    :func:`ndtri_fast_wide` when quantiles are *derived* (survival-space
    windows) and can be legitimately tiny.
    """
    q = jnp.asarray(q)
    if q.dtype != jnp.float32:
        return ndtri(q)
    return jnp.float32(_SQRT2) * erfinv_f32(2.0 * q - 1.0)


def ndtri_fast_wide(q):
    """Standard-normal quantile, accurate for q down to 1e-37 (f32).

    Same Giles polynomial branches as :func:`erfinv_f32`, but the working
    variable w = -log((1-x)(1+x)) = -log(4 q (1-q)) is computed DIRECTLY
    from q via log/log1p.  Going through x = 2q-1 (as a plain
    erfinv(2q-1) call would) collapses any q below ~3e-8 onto x = -1 in
    float32; the direct form stays accurate for q down to 1e-38, which
    survival-space formulations (truncnorm windows at 6+ sigma) rely on.
    An extra asymptotic branch covers w beyond the Giles fit (rel err
    <~1e-3).  Exactly-0/1 inputs saturate at ~+/-13, correct sign.
    Costs ~2x :func:`ndtri_fast`; use only off the hot path.
    """
    q = jnp.asarray(q)
    if q.dtype != jnp.float32:
        return ndtri(q)

    tail = jnp.minimum(q, 1.0 - q)
    # 1e-37 is the smallest NORMAL-range clip: float32 subnormals flush to
    # zero under XLA, which would reintroduce -inf/NaN at q exactly 0/1.
    tail_c = jnp.clip(tail, jnp.float32(1e-37))
    log4 = jnp.float32(1.3862944)
    w = -(jnp.log(tail_c) + jnp.log1p(-tail_c) + log4)
    x = 2.0 * q - 1.0
    sign = jnp.where(q >= 0.5, jnp.float32(1.0), jnp.float32(-1.0))
    p1, p2 = _giles_branch_polys(w)

    # Far tail (w beyond the Giles fit): the erfc asymptotic series
    # erfc(y) = exp(-y^2)/(y sqrt(pi)) * (1 - 1/(2y^2) + 3/(4y^4) - ...),
    # solved by fixed-point iteration on
    # y^2 = w + ln2 - ln(y sqrt(pi)) + log1p(-1/(2y^2) + 3/(4y^4)).
    # The series factor matters: dropping it (leading-order only) biases
    # y by ~1/(2y^2) relative — a measured +2.7% tail-probability error
    # at 6 sigma, 16x the estimator noise in importance-sampled
    # rare-event runs.  With two correction terms the residual is
    # O(15/(8y^6)) ~ 3e-4 at y = 4.
    ln2 = jnp.float32(0.6931472)
    ln_sqrt_pi = jnp.float32(0.5723649)
    y = jnp.sqrt(w)
    for _ in range(3):
        inv2 = 1.0 / (2.0 * y * y)
        series = jnp.log1p(-inv2 + 3.0 * inv2 * inv2)
        y = jnp.sqrt(
            jnp.maximum(w + ln2 - ln_sqrt_pi - jnp.log(y) + series, 1.0)
        )

    erfinv = jnp.where(
        w > 16.3, y * sign, jnp.where(w < 5.0, p1 * x, p2 * x)
    )
    return jnp.float32(_SQRT2) * erfinv


def ndtr_fast(x):
    """Standard-normal CDF; polynomial f32 path (A&S 7.1.26 in place of ``erf``).

    Abramowitz & Stegun 7.1.26, restructured so the LOWER tail is the
    directly-computed quantity ``0.5 * poly * exp(-z^2)`` — never
    ``1 - (something near 1)`` — keeping relative (not just absolute)
    accuracy for x << 0, which truncated-normal windows depend on.
    """
    x = jnp.asarray(x)
    if x.dtype != jnp.float32:
        return ndtr(x)
    z = jnp.abs(x) * jnp.float32(1.0 / _SQRT2)
    t = 1.0 / (1.0 + jnp.float32(0.3275911) * z)
    tail = 0.5 * _as_tail_poly(t) * jnp.exp(-z * z)  # ndtr(-|x|), rel-accurate
    return jnp.where(x >= 0, 1.0 - tail, tail)


def _as_tail_poly(t):
    """A&S 7.1.26 erfc polynomial in ``t = 1/(1 + 0.3275911 z)``.

    Shared by :func:`ndtr_fast` (times ``exp(-z^2)``) and
    :func:`ndtr_scaled_neg` (without it).
    """
    return t * (
        jnp.float32(0.254829592)
        + t
        * (
            jnp.float32(-0.284496736)
            + t
            * (
                jnp.float32(1.421413741)
                + t * (jnp.float32(-1.453152027) + t * jnp.float32(1.061405429))
            )
        )
    )


def ndtr_neg_fast(x):
    """Survival function ndtr(-x) = P(Z > x), relative-accurate for x > 0."""
    return ndtr_fast(-jnp.asarray(x))


def ndtr_scaled_neg(x):
    """``exp(x^2/2) * ndtr(x)`` for ``x <= 0`` (scaled normal CDF).

    The A&S 7.1.26 tail is ``0.5 * poly * exp(-x^2/2)``; dropping the
    exponential factor yields the scaled CDF directly, so callers can
    evaluate products like ``exp(c) * ndtr(x)`` as
    ``exp(c - x^2/2) * ndtr_scaled_neg(x)`` and stay finite where the
    two factors individually over/underflow (invgauss' Shuster CDF).
    """
    x = jnp.asarray(x)
    if x.dtype != jnp.float32:
        from jax.scipy.special import log_ndtr

        return jnp.exp(0.5 * x * x + log_ndtr(x))
    z = jnp.abs(x) * jnp.float32(1.0 / _SQRT2)
    t = 1.0 / (1.0 + jnp.float32(0.3275911) * z)
    poly = 0.5 * _as_tail_poly(t)
    # The A&S 7.1.26 polynomial is ABSOLUTE-accurate on erf, so its
    # relative error on the scaled tail grows with |x| (~7% by |x|=20,
    # which shifted exponnorm(K=0.05) quantiles by 4e-3).  Past |x| = 6
    # the Mills-ratio asymptotic series is relative-accurate to ~2e-5.
    x2 = jnp.clip(x * x, 1.0)
    u = 1.0 / x2
    series = 1.0 + u * (-1.0 + u * (3.0 + u * (-15.0 + 105.0 * u)))
    mills = series / (jnp.sqrt(jnp.abs(x2)) * jnp.float32(2.5066282746310002))
    return jnp.where(jnp.abs(x) > 6.0, mills, poly)


def t_cdf(x, df):
    """Student-t CDF via the regularized incomplete beta function.

    ``P(T <= x) = 1 - I_z(df/2, 1/2) / 2`` for ``x >= 0`` with
    ``z = df / (df + x^2)``, mirrored below zero.  The tail is the
    directly computed quantity, so BOTH tails keep relative accuracy —
    the property the t-copula transform needs at extreme scores.
    Exact inverse pair of the ``t`` ppf kernel (ops/ppf.py).
    """
    x = jnp.asarray(x)
    dtype = jnp.result_type(x, jnp.float32)
    x = x.astype(dtype)
    df = jnp.asarray(df, dtype)
    z = df / (df + x * x)
    # float32 uses the in-house Lentz continued fraction: identical
    # accuracy to jax.scipy.betainc at these (a, 1/2) shapes (measured
    # equal to 1e-7) but a fraction of its loop-carry footprint — the
    # t-copula path evaluates this over 1e8-element score rows, where
    # jax.scipy's loop carries ran a 16 GB device out of memory.  float64 keeps
    # jax.scipy's implementation (1e-14 vs the kernel's f32-tuned trips).
    if dtype == jnp.float32:
        # The CF keeps 40 pairs even though it converges by ~12 pairs at
        # b = 1/2 (iteration count does not move the measured accuracy —
        # the lgamma prefactor dominates): a 16-pair body made t_cdf
        # alone faster but the streamed t-copula program slower, because
        # the shorter body flipped XLA into a worse schedule around the
        # per-row lax.map (decided on the earlier accelerator; not re-measured on the H100).
        # Change only with an end-to-end measurement.
        tail = 0.5 * betainc_kernel(0.5 * df, jnp.asarray(0.5, dtype), z)
    else:
        tail = 0.5 * betainc(0.5 * df, jnp.asarray(0.5, dtype), z)
    return jnp.where(x >= 0, 1.0 - tail, tail)


def chi2_draws(key, df, n, dtype):
    """(n,) chi-square(df) draws (t-copula / gamma-frailty mixing).

    Integer df uses the exact loop-free decomposition
    ``chi2(2k + r) = -2 log(U_1 ... U_k) + r Z^2`` — one fused
    elementwise pass over k uniforms (+ one normal when df is odd).
    The alternative, the safeguarded-Newton ``gammaincinv`` ppf, is
    exact for any df but its while_loop round-trips every carry through
    device memory per Newton step (the decomposition was about 80x
    faster at 1e8 draws on the earlier accelerator; not re-measured on the H100).  Fractional df
    keeps the exact ppf route.
    """
    from probabilit_tpu.ops.qmc import clamp_open_unit

    fdf = float(df)
    if fdf.is_integer() and 1.0 <= fdf <= 128.0:
        k, r = divmod(int(fdf), 2)
        ku, kz = jax.random.split(key)
        w = jnp.zeros((n,), dtype)
        if k:
            u = clamp_open_unit(jax.random.uniform(ku, (k, n), dtype=dtype))
            w = -2.0 * jnp.sum(jnp.log(u), axis=0)
        if r:
            z = jax.random.normal(kz, (n,), dtype)
            w = w + z * z
        return jnp.maximum(w, jnp.finfo(dtype).tiny)
    u = clamp_open_unit(jax.random.uniform(key, (n,), dtype=dtype))
    return 2.0 * gammaincinv(jnp.asarray(0.5 * fdf, dtype), u)


def expm1_safe(x):
    """exp(x) - 1, accurate near zero, without the ``expm1`` primitive.

    The float32 path uses a 7-term Taylor branch below |x| < 0.25
    (relative error ~2e-9, below float32 epsilon); it was written for a
    kernel compiler without ``expm1`` and is kept until an H100
    measurement decides between it and ``jnp.expm1``.  float64 uses the
    exact ``jnp.expm1``.
    """
    x = jnp.asarray(x)
    if x.dtype == jnp.float64:
        return jnp.expm1(x)
    small = x * (
        1.0
        + x
        * (
            0.5
            + x
            * (
                1.0 / 6.0
                + x * (1.0 / 24.0 + x * (1.0 / 120.0 + x * (1.0 / 720.0 + x / 5040.0)))
            )
        )
    )
    return jnp.where(jnp.abs(x) < 0.25, small, jnp.exp(x) - 1.0)

_NEWTON_ITERS = 26
_TINY = 1e-30

# ---------------------------------------------------------------------
# Loop-free incomplete functions
#
# Elementwise arithmetic and scalar Python constants only.  Accuracy:
# float32 relative ~1e-6 for shape parameters in (0, ~30] (series/CF
# trip counts sized for that range).  The t CDF and the chi-square
# mixing draws use them; everything else keeps jax.scipy's versions.
# ---------------------------------------------------------------------


def lgamma_kernel(x):
    """Log-gamma for x > 0 via the Lanczos approximation (g=7, n=9).

    Scalar coefficients only.  float32 relative error
    < 1e-6 on (0, 1e4).
    """
    x = jnp.asarray(x)
    # Lanczos coefficients (g=7, 9 terms), classical public values.
    coefs = (
        0.99999999999980993,
        676.5203681218851,
        -1259.1392167224028,
        771.32342877765313,
        -176.61502916214059,
        12.507343278686905,
        -0.13857109526572012,
        9.9843695780195716e-6,
        1.5056327351493116e-7,
    )
    z = x - 1.0
    acc = jnp.full_like(z, coefs[0])
    for i, c in enumerate(coefs[1:], start=1):
        acc = acc + c / (z + i)
    t = z + 7.5
    half_log_two_pi = 0.9189385332046727
    return half_log_two_pi + (z + 0.5) * jnp.log(t) - t + jnp.log(acc)


def _gammainc_series(a, x, log_prefactor, iters=48):
    """P(a,x) by power series (accurate for x < a + 1)."""

    def body(n, carry):
        term, total = carry
        term = term * x / (a + 1.0 + n)
        return term, total + term

    init = jnp.ones_like(x) / a
    term, total = jax.lax.fori_loop(0, iters, body, (init, init))
    return total * jnp.exp(log_prefactor)


def _gammainc_cf(a, x, log_prefactor, iters=48):
    """Q(a,x) by Lentz continued fraction (accurate for x >= a + 1)."""
    tiny = jnp.asarray(1e-30, x.dtype)
    b = x + 1.0 - a
    c = jnp.full_like(x, 1e30)
    d = 1.0 / jnp.where(jnp.abs(b) < tiny, tiny, b)
    h = d

    def body(i, carry):
        c, d, h = carry
        i1 = i + 1.0
        an = -i1 * (i1 - a)
        bb = x + 1.0 - a + 2.0 * i1
        d = bb + an * d
        d = 1.0 / jnp.where(jnp.abs(d) < tiny, tiny, d)
        c = bb + an / c
        c = jnp.where(jnp.abs(c) < tiny, tiny, c)
        h = h * d * c
        return c, d, h

    _, _, h = jax.lax.fori_loop(0, iters, body, (c, d, h))
    return jnp.exp(log_prefactor) * h


def gammainc_kernel(a, x):
    """Regularized lower incomplete gamma P(a, x), elementwise.

    Series for x < a+1, Lentz continued fraction otherwise (both
    branches evaluated, selected elementwise — no data-dependent control
    flow).  Sized for a in (0, ~30].
    """
    dtype = jnp.result_type(a, x, jnp.float32)
    a = jnp.asarray(a, dtype)
    x = jnp.asarray(x, dtype)
    a, x = jnp.broadcast_arrays(a, x)
    x_safe = jnp.maximum(x, _TINY)
    log_pre = a * jnp.log(x_safe) - x_safe - lgamma_kernel(a)
    p_series = _gammainc_series(a, x_safe, log_pre)
    q_cf = _gammainc_cf(a, x_safe, log_pre)
    p = jnp.where(x_safe < a + 1.0, p_series, 1.0 - q_cf)
    p = jnp.where(x <= 0.0, 0.0, p)
    return jnp.clip(p, 0.0, 1.0)


def _betacf(a, b, x, iters=40):
    """Continued fraction for betainc (Lentz, paired even/odd steps).

    Unrolled in Python: a ``fori_loop`` body cannot fuse across
    iterations, so every trip would round-trip its (c, d, h) carries
    through device memory.  Unrolled, XLA emits one elementwise kernel
    that reads x once and writes h once.
    """
    tiny = jnp.asarray(1e-30, x.dtype)
    qab = a + b
    qap = a + 1.0
    qam = a - 1.0
    c = jnp.ones_like(x)
    d = 1.0 - qab * x / qap
    d = 1.0 / jnp.where(jnp.abs(d) < tiny, tiny, d)
    h = d
    for m1 in range(iters):
        m = float(m1 + 1)
        two_m = 2.0 * m
        aa = m * (b - m) * x / ((qam + two_m) * (a + two_m))
        d = 1.0 + aa * d
        d = 1.0 / jnp.where(jnp.abs(d) < tiny, tiny, d)
        c = 1.0 + aa / c
        c = jnp.where(jnp.abs(c) < tiny, tiny, c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + two_m) * (qap + two_m))
        d = 1.0 + aa * d
        d = 1.0 / jnp.where(jnp.abs(d) < tiny, tiny, d)
        c = 1.0 + aa / c
        c = jnp.where(jnp.abs(c) < tiny, tiny, c)
        h = h * d * c
    return h


def betainc_kernel(a, b, x):
    """Regularized incomplete beta I_x(a, b), elementwise.

    Standard symmetry split at x = (a+1)/(a+b+2); both continued
    fractions evaluated and selected elementwise.  Sized for a, b in
    (0, ~30].
    """
    dtype = jnp.result_type(a, b, x, jnp.float32)
    a = jnp.asarray(a, dtype)
    b = jnp.asarray(b, dtype)
    x = jnp.asarray(x, dtype)
    a, b, x = jnp.broadcast_arrays(a, b, x)
    xc = jnp.clip(x, _TINY, 1.0 - 1e-7)
    log_bt = (
        lgamma_kernel(a + b)
        - lgamma_kernel(a)
        - lgamma_kernel(b)
        + a * jnp.log(xc)
        + b * jnp.log1p(-xc)
    )
    bt = jnp.exp(log_bt)
    direct = bt * _betacf(a, b, xc) / a
    flipped = 1.0 - bt * _betacf(b, a, 1.0 - xc) / b
    p = jnp.where(xc < (a + 1.0) / (a + b + 2.0), direct, flipped)
    p = jnp.where(x <= 0.0, 0.0, p)
    p = jnp.where(x >= 1.0, 1.0, p)
    return jnp.clip(p, 0.0, 1.0)


def _wilson_hilferty_gamma_guess(a, p):
    """Initial guess for the inverse regularized lower incomplete gamma.

    Wilson-Hilferty: if X ~ Gamma(a), (X/a)^(1/3) is ~ Normal(1 - 1/(9a),
    1/(9a)).  Good to a few percent for a >~ 0.5; Newton cleans it up.
    """
    s = 1.0 / (9.0 * a)
    z = ndtri(p)
    guess = a * (1.0 - s + z * jnp.sqrt(s)) ** 3
    # Small-a fallback: P(a, x) ~ x^a / Gamma(a+1) for small x.
    small = jnp.exp((jnp.log(jnp.clip(p, _TINY)) + gammaln(a + 1.0)) / a)
    guess = jnp.where((a < 0.5) | (guess <= 0.0), small, guess)
    return jnp.clip(guess, _TINY)


def gammaincinv(a, p):
    """Inverse of the regularized lower incomplete gamma function P(a, x).

    Solves P(a, x) = p for x >= 0 with a safeguarded Newton iteration in
    log-space (guarantees positivity).  Equivalent of
    ``scipy.special.gammaincinv``.
    """
    dtype = jnp.result_type(a, p, jnp.float32)
    a = jnp.asarray(a, dtype)
    p = jnp.asarray(p, dtype)
    a, p = jnp.broadcast_arrays(a, p)

    p_clipped = jnp.clip(p, _TINY, 1.0 - 1e-7 if dtype == jnp.float32 else 1.0 - 1e-15)
    x0 = _wilson_hilferty_gamma_guess(a, p_clipped)
    log_x = jnp.log(x0)

    lgam = gammaln(a)

    # Early-exit Newton: the while_loop stops the WHOLE batch as soon as
    # every lane's log-space step (= relative step) is below tolerance,
    # instead of always paying _NEWTON_ITERS incomplete-gamma
    # evaluations.  The float32 tolerance sits just above the measured
    # step plateau (~1e-5: the f32 noise floor of gammainc - p over the
    # pdf), where iterates are within ~3e-5 relative of the fixed point —
    # an order below the f32 sampling accuracy contract.  Measured trips
    # to exit: 3 (a=30) to 13 (a<=2, clamped-tail quantiles) vs 26 before.
    tol = 3e-5 if dtype == jnp.float32 else 1e-15
    f_tol = 1e-4 if dtype == jnp.float32 else 1e-12

    def cond(carry):
        _, done, i = carry
        return (i < _NEWTON_ITERS) & jnp.any(~done)

    def body(carry):
        log_x, done, i = carry
        x = jnp.exp(log_x)
        f = gammainc(a, x) - p_clipped
        # d/dx P(a,x) = x^(a-1) e^-x / Gamma(a);  d/dlogx = x * that
        log_pdf_logx = a * log_x - x - lgam
        step = f * jnp.exp(-log_pdf_logx)
        step = jnp.clip(step, -2.0, 2.0)  # Safeguard huge steps far from root
        # Freeze lanes whose own step AND residual are below tolerance,
        # and keep looping while ANY lane is unfrozen (or until the trip
        # cap).  Each lane's trip count is then intrinsic to the lane —
        # frozen lanes stop at their own convergence point, never-frozen
        # lanes always get exactly _NEWTON_ITERS — so results are
        # identical across batch compositions (single-shot vs streamed
        # blocks, padded batches).  The residual condition matters: near
        # a pdf singularity a clipped initial guess takes a transiently
        # tiny step while still far from the root (Newton's distance
        # estimate breaks under strong curvature); a move-only freeze
        # would trap it there (measured: 2.5e-4 error, beta(.5,.5)).
        # The mask is ABSORBING (done | converged): without it a
        # frozen lane could oscillate back to life and its value would
        # again depend on when the global loop exits.
        done = done | ((jnp.abs(step) <= tol) & (jnp.abs(f) <= f_tol))
        step = jnp.where(done, jnp.zeros_like(step), step)
        return log_x - step, done, i + 1

    log_x, _, _ = jax.lax.while_loop(
        cond, body, (log_x, jnp.zeros(log_x.shape, bool), jnp.int32(0))
    )
    x = jnp.exp(log_x)

    x = jnp.where(p <= 0.0, 0.0, x)
    x = jnp.where(p >= 1.0, jnp.inf, x)
    return x


def gammainccinv(a, q):
    """Inverse of the regularized upper incomplete gamma function Q(a, x)."""
    return gammaincinv(a, 1.0 - q)


def _beta_guess(a, b, p):
    """Initial guess for betaincinv, Abramowitz & Stegun 26.5.22."""
    y = ndtri(p)
    two = jnp.asarray(2.0, y.dtype)
    la = 1.0 / (2.0 * a - 1.0)
    lb = 1.0 / (2.0 * b - 1.0)
    h = 2.0 / (la + lb)
    w = y * jnp.sqrt(h + (y * y - 3.0) / 6.0) / h - (lb - la) * (
        (y * y - 3.0) / 6.0 + 5.0 / 6.0 - two / (3.0 * h)
    )
    guess = a / (a + b * jnp.exp(2.0 * w))
    # Fallback for small parameters: power-law inversion of the CDF tail.
    t = jnp.exp((jnp.log(jnp.clip(p, _TINY)) + betaln(a, b) + jnp.log(a)) / a)
    guess = jnp.where((a <= 1.0) | (b <= 1.0) | ~jnp.isfinite(guess), t, guess)
    return jnp.clip(guess, 1e-6, 1.0 - 1e-6)


def betaincinv(a, b, p):
    """Inverse of the regularized incomplete beta function I_x(a, b).

    Bisection-safeguarded Newton on ``jax.scipy.special.betainc``.
    Equivalent of ``scipy.special.betaincinv``.
    """
    dtype = jnp.result_type(a, b, p, jnp.float32)
    a = jnp.asarray(a, dtype)
    b = jnp.asarray(b, dtype)
    p = jnp.asarray(p, dtype)
    a, b, p = jnp.broadcast_arrays(a, b, p)

    eps = 1e-7 if dtype == jnp.float32 else 1e-15
    p_c = jnp.clip(p, eps, 1.0 - eps)

    x = _beta_guess(a, b, p_c)
    lo = jnp.zeros_like(x)
    hi = jnp.ones_like(x)
    lbeta = betaln(a, b)

    # Early-exit safeguarded Newton (see gammaincinv): stops when every
    # lane's relative movement drops below tolerance.  Bisection-fallback
    # lanes dominate the exit (~1 bit/trip), so typical trips are 24-30
    # of the 40 cap.
    tol = 3e-5 if dtype == jnp.float32 else 1e-15
    f_tol = 1e-4 if dtype == jnp.float32 else 1e-12

    def cond(carry):
        _, _, _, done, i = carry
        return (i < _NEWTON_ITERS + 14) & jnp.any(~done)

    def body(carry):
        x, lo, hi, done, i = carry
        f = betainc(a, b, x) - p_c
        # Maintain bracket [lo, hi] with f(lo) < 0 < f(hi).
        lo = jnp.where(f < 0.0, x, lo)
        hi = jnp.where(f > 0.0, x, hi)
        log_pdf = (a - 1.0) * jnp.log(x) + (b - 1.0) * jnp.log1p(-x) - lbeta
        newton = x - f * jnp.exp(-log_pdf)
        # Bisect whenever Newton leaves the bracket or is non-finite.
        bad = ~jnp.isfinite(newton) | (newton <= lo) | (newton >= hi)
        x_new = jnp.where(bad, 0.5 * (lo + hi), newton)
        # Per-lane freeze + any-live loop (see gammaincinv): lane trip
        # counts are intrinsic, so results do not depend on batch
        # composition.  The residual condition is required — a guess
        # clipped at 1-1e-6 sits on the endpoint pdf singularity where
        # the first Newton move is transiently ~tol while the root is
        # 2e-4 away (measured, beta(0.5, 0.5) at q~0.99); move-only
        # freezing would trap it there.
        # ABSORBING freeze: a frozen lane's own lo/hi update can flip
        # the bracket test next iteration and bounce it back to life,
        # re-tying its value to the global exit time (observed as
        # streamed-vs-single-shot diffs for beta(0.5, 0.5)).
        rel = jnp.abs(x_new - x) / jnp.maximum(x, _TINY)
        done = done | ((rel <= tol) & (jnp.abs(f) <= f_tol))
        x_new = jnp.where(done, x, x_new)
        return x_new, lo, hi, done, i + 1

    x, _, _, _, _ = jax.lax.while_loop(
        cond, body, (x, lo, hi, jnp.zeros(x.shape, bool), jnp.int32(0))
    )

    x = jnp.where(p <= 0.0, 0.0, x)
    x = jnp.where(p >= 1.0, 1.0, x)
    return x


def continuous_ppf_newton(cdf, pdf, q, x0, lo, hi, iters=40):
    """Generic continuous ppf: solve cdf(x) = q with safeguarded Newton.

    ``cdf``/``pdf`` are elementwise functions; ``x0`` the initial guess and
    [lo, hi] a bracket with cdf(lo) <= q <= cdf(hi).  Newton steps that
    leave the bracket fall back to bisection.  Used by kernels whose CDF
    is closed-form but whose quantile function is not (e.g. invgauss).
    """
    q = jnp.asarray(q)
    x = jnp.clip(jnp.broadcast_to(jnp.asarray(x0, q.dtype), q.shape), lo, hi)
    lo = jnp.broadcast_to(jnp.asarray(lo, q.dtype), q.shape)
    hi = jnp.broadcast_to(jnp.asarray(hi, q.dtype), q.shape)
    best_x = x
    best_f = jnp.full(q.shape, jnp.inf, q.dtype)

    # The iteration returns the best-|f| iterate seen, NOT the final one.
    # XLA may recompute cdf(x) - q per consumer with different fusion/FMA
    # rounding near the root: the bracket comparisons can see exactly 0.0
    # (brackets freeze) while the Newton step sees -3e-9 (x marches one
    # ulp per iteration in a limit cycle), and when the iterate later
    # touches a stale bracket edge it is bisected far from the root
    # (measured: 0.014 absolute error on the cosine ppf's array path,
    # with an optimization_barrier on f NOT preventing the divergence).
    # Every iterate inside the cycle is within ulps of the root, so
    # best-|f| tracking is immune to both the ejection and the freeze.
    def body(_, carry):
        x, lo, hi, best_x, best_f = carry
        f = cdf(x) - q
        af = jnp.abs(f)
        better = af < best_f
        best_x = jnp.where(better, x, best_x)
        best_f = jnp.minimum(af, best_f)
        lo = jnp.where(f < 0.0, x, lo)
        hi = jnp.where(f > 0.0, x, hi)
        newton = x - f / jnp.clip(pdf(x), 1e-30)
        bad = ~jnp.isfinite(newton) | (newton <= lo) | (newton >= hi)
        x = jnp.where(bad, 0.5 * (lo + hi), newton)
        return x, lo, hi, best_x, best_f

    x, _, _, best_x, best_f = jax.lax.fori_loop(
        0, iters, body, (x, lo, hi, best_x, best_f)
    )
    final_f = jnp.abs(cdf(x) - q)
    return jnp.where(final_f < best_f, x, best_x)


def discrete_ppf_bisect(cdf, q, hi, max_iters=40):
    """Generic discrete ppf: smallest integer k in [0, hi] with cdf(k) >= q.

    ``cdf`` maps a float array of ks to CDF values; ``hi`` is a per-element
    upper bound on the support needed.  Runs at most ``max_iters``
    bisection steps (static shapes, fully vectorised), used by
    Poisson/Binomial/... kernels when parameters are traced (composite
    distributions).

    The trip cap is load-bearing, not a formality: above 2^24 the f32
    midpoint ``floor((lo+hi)/2)`` can round back onto ``lo`` while
    ``hi - lo`` is still > 1 (spacing >= 2), so a width-only condition
    would spin the device loop forever.  On a capped exit ``hi`` still
    satisfies ``cdf(hi) >= q`` — correct to one f32 ulp of the support.
    """
    q = jnp.asarray(q)
    lo = jnp.full(q.shape, -1.0, q.dtype)  # invariant: cdf(lo) < q
    hi = jnp.broadcast_to(jnp.asarray(hi, q.dtype), q.shape)

    def cond(carry):
        i, lo, hi = carry
        return (i < max_iters) & jnp.any(hi - lo > 1.0)

    def body(carry):
        i, lo, hi = carry
        mid = jnp.floor((lo + hi) / 2.0)
        go_right = cdf(mid) < q
        lo = jnp.where(go_right, mid, lo)
        hi = jnp.where(go_right, hi, mid)
        return i + 1, lo, hi

    _, lo, hi = jax.lax.while_loop(cond, body, (jnp.int32(0), lo, hi))
    return hi
