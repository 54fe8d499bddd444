"""Pure-jump Lévy path nodes: Variance Gamma and Normal Inverse Gaussian.

Framework extension (the reference models scalar draws only).  Both
families are time-changed Brownian motions — a Brownian motion with
drift evaluated at an independent random clock — and both subordinators
have native inverse-CDF kernels here (``ops/ppf.py``: ``gamma`` via
Newton on the incomplete gamma, ``invgauss`` via Newton on the Shuster
closed-form CDF).  A Lévy process has iid increments whose law is known
in closed form at EVERY time scale, so the grid path is exact by
construction, like the other path families (models/processes.py):

* Variance Gamma (Madan-Carr-Chang 1998):  increment over ``dt`` is
  ``mu dt + theta G + sigma sqrt(G) Z`` with the gamma clock
  ``G ~ Gamma(shape = dt/nu, scale = nu)`` (``E[G] = dt``).
* Normal Inverse Gaussian (Barndorff-Nielsen 1997):  increment is
  ``mu dt + beta I + sqrt(I) Z`` with the inverse-Gaussian clock
  ``I ~ IG(mean = delta dt / g, shape = (delta dt)^2)``,
  ``g = sqrt(alpha^2 - beta^2)`` — mapped onto the scipy
  parametrisation as ``invgauss(mu = 1/(g delta dt), scale =
  (delta dt)^2)``.

Device shape: one ``(n, steps)`` inverse-CDF transform for the clock, one
normal draw, a fused elementwise combine, and a ``cumsum`` — everything
batched, no rejection loops (the classical gamma/IG samplers are
while-loops that XLA cannot fuse across iterations; the inverse-CDF
route is branch-free and QMC-compatible).  Randomness follows the
path-node contract: a column-seeded PRNG key under ``method=None``, a
per-driver quantile slab (clock uniforms first, then the conditional
normals) under QMC/antithetic methods.

>>> vg = VarianceGamma(theta=-0.1, sigma=0.2, nu=0.2, T=1.0, steps=4)
>>> vg.terminal()
PathFunctional(VGPath(mu=0, theta=-0.1, sigma=0.2, nu=0.2, T=1, steps=4), 'terminal')
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from probabilit_tpu.models.processes import PathDistribution

__all__ = ["VarianceGamma", "NormalInverseGaussian", "VGPath", "NIGPath"]


class VGPath(PathDistribution):
    """Variance-Gamma Lévy path — exact iid increments at any ``dt``.

    ``X_t = mu t + theta G_t + sigma W(G_t)`` with a Gamma subordinator
    of unit mean rate and variance rate ``nu``.  Exact moments per unit
    time: mean ``mu + theta``, variance ``sigma^2 + nu theta^2``, excess
    kurtosis ``3 nu (1 + 2 (theta sigma)^2 nu / (sigma^2 + nu
    theta^2)^2) / t`` — the heavy tails and finite-moment structure GBM
    cannot express.  Log-price modeling: ``Exp(x0_log + VGPath(...))``.
    """

    # The gamma clock's LAW depends on nu (shape = dt/nu), so nu has no
    # pathwise derivative; the Brownian layer's parameters do.
    _param_slots = ("mu", "theta", "sigma")

    def __init__(self, mu=0.0, theta=0.0, sigma=0.2, nu=0.2, T=1.0, steps=252):
        sigma, nu = float(sigma), float(nu)
        if not sigma > 0:
            raise ValueError(f"sigma must be positive, got {sigma}.")
        if not nu > 0:
            raise ValueError(f"nu must be positive, got {nu}.")
        self.mu = float(mu)
        self.theta = float(theta)
        self.sigma = sigma
        self.nu = nu
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"VGPath(mu={self.mu:g}, theta={self.theta:g}, "
            f"sigma={self.sigma:g}, nu={self.nu:g}, T={self.T:g}, "
            f"steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "VGPath",
            self.mu,
            self.theta,
            self.sigma,
            self.nu,
            self.T,
            self.steps,
        )

    @property
    def _q_width(self):
        # Two drivers per step: gamma-clock uniform + conditional normal.
        return 2 * self.steps

    def _clock(self, u, dtype):
        """Gamma subordinator increments from uniforms (shape dt/nu)."""
        from probabilit_tpu.ops import ppf as _ppf

        dt = self.T / self.steps
        return self.nu * _ppf.call("gamma", u.astype(dtype), a=dt / self.nu).astype(
            dtype
        )

    def _combine(self, g, z, dtype):
        dt = self.T / self.steps
        return self.mu * dt + self.theta * g + self.sigma * jnp.sqrt(g) * z

    def _increments(self, key, n, dtype):
        from probabilit_tpu.ops.qmc import clamp_open_unit

        ku, kz = jax.random.split(key)
        u = clamp_open_unit(jax.random.uniform(ku, (n, self.steps), dtype=dtype))
        z = jax.random.normal(kz, (n, self.steps), dtype)
        return self._combine(self._clock(u, dtype), z, dtype)

    def _increments_from_slab(self, slab, dtype):
        from probabilit_tpu.ops import special as _special

        # Clock uniforms take the LEADING slab columns: the subordinator
        # carries the tail behavior (most of the variance of path
        # functionals for typical nu), and no Brownian-bridge reorder
        # applies — each increment's clock is its own QMC dimension.
        s = self.steps
        g = self._clock(slab[:, :s], dtype)
        z = _special.ndtri_fast(slab[:, s:].astype(dtype))
        return self._combine(g, z, dtype)

    def _path_from_increments(self, inc):
        return jnp.cumsum(inc, axis=1)


class NIGPath(PathDistribution):
    """Normal-Inverse-Gaussian Lévy path — exact iid increments.

    Barndorff-Nielsen parametrisation ``(alpha, beta, delta, mu)`` with
    ``alpha > |beta|`` (tail heaviness, skew, scale, drift): over any
    horizon ``t`` the increment is exactly ``NIG(alpha, beta, delta t,
    mu t)`` — scipy's ``norminvgauss(a = alpha delta t, b = beta delta
    t, loc = mu t, scale = delta t)``.  Exact per-unit-time moments:
    mean ``mu + delta beta / g``, variance ``delta alpha^2 / g^3`` with
    ``g = sqrt(alpha^2 - beta^2)``; semiheavy tails
    (``~ |x|^{-3/2} e^{-alpha |x| + beta x}``).
    """

    # alpha/beta/delta shape the inverse-Gaussian clock's law; only the
    # deterministic drift has a pathwise derivative.  (beta also enters
    # the conditional mean, but through the clock's law as well.)
    _param_slots = ("mu",)

    def __init__(self, alpha=1.0, beta=0.0, delta=1.0, mu=0.0, T=1.0, steps=252):
        alpha, beta, delta = float(alpha), float(beta), float(delta)
        if not alpha > 0:
            raise ValueError(f"alpha must be positive, got {alpha}.")
        if not abs(beta) < alpha:
            raise ValueError(
                f"NIG needs |beta| < alpha, got beta={beta}, alpha={alpha}."
            )
        if not delta > 0:
            raise ValueError(f"delta must be positive, got {delta}.")
        self.alpha = alpha
        self.beta = beta
        self.delta = delta
        self.mu = float(mu)
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"NIGPath(alpha={self.alpha:g}, beta={self.beta:g}, "
            f"delta={self.delta:g}, mu={self.mu:g}, T={self.T:g}, "
            f"steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "NIGPath",
            self.alpha,
            self.beta,
            self.delta,
            self.mu,
            self.T,
            self.steps,
        )

    @property
    def _q_width(self):
        # Two drivers per step: IG-clock uniform + conditional normal.
        return 2 * self.steps

    def _clock(self, u, dtype):
        """IG subordinator increments from uniforms.

        Target law IG(mean m, shape L) with ``m = delta dt / g``,
        ``L = (delta dt)^2``; scipy's invgauss(mu, scale) has mean
        ``mu * scale`` and shape ``scale``, so ``scale = L``,
        ``mu = m / L = 1 / (g delta dt)``.
        """
        from probabilit_tpu.ops import ppf as _ppf

        dt = self.T / self.steps
        g = math.sqrt(self.alpha**2 - self.beta**2)
        ddt = self.delta * dt
        return _ppf.call(
            "invgauss", u.astype(dtype), mu=1.0 / (g * ddt), scale=ddt * ddt
        ).astype(dtype)

    def _combine(self, clock, z, dtype):
        dt = self.T / self.steps
        return self.mu * dt + self.beta * clock + jnp.sqrt(clock) * z

    def _increments(self, key, n, dtype):
        from probabilit_tpu.ops.qmc import clamp_open_unit

        ku, kz = jax.random.split(key)
        u = clamp_open_unit(jax.random.uniform(ku, (n, self.steps), dtype=dtype))
        z = jax.random.normal(kz, (n, self.steps), dtype)
        return self._combine(self._clock(u, dtype), z, dtype)

    def _increments_from_slab(self, slab, dtype):
        from probabilit_tpu.ops import special as _special

        s = self.steps
        clock = self._clock(slab[:, :s], dtype)
        z = _special.ndtri_fast(slab[:, s:].astype(dtype))
        return self._combine(clock, z, dtype)

    def _path_from_increments(self, inc):
        return jnp.cumsum(inc, axis=1)


def VarianceGamma(mu=0.0, theta=0.0, sigma=0.2, nu=0.2, T=1.0, steps=252):
    """Variance-Gamma Lévy path node; see :class:`VGPath`.

    >>> VarianceGamma(theta=-0.1, sigma=0.2, nu=0.2, steps=4)
    VGPath(mu=0, theta=-0.1, sigma=0.2, nu=0.2, T=1, steps=4)
    """
    return VGPath(mu=mu, theta=theta, sigma=sigma, nu=nu, T=T, steps=steps)


def NormalInverseGaussian(alpha=1.0, beta=0.0, delta=1.0, mu=0.0, T=1.0, steps=252):
    """Normal-Inverse-Gaussian Lévy path node; see :class:`NIGPath`.

    >>> NormalInverseGaussian(alpha=2.0, beta=-0.5, delta=0.8, steps=4)
    NIGPath(alpha=2, beta=-0.5, delta=0.8, mu=0, T=1, steps=4)
    """
    return NIGPath(alpha=alpha, beta=beta, delta=delta, mu=mu, T=T, steps=steps)
