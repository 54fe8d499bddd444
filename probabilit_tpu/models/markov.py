"""Discrete-state Markov chains and regime-switching diffusion paths.

Framework extension (the reference models scalar draws only).  Two
families on the path-node contract (models/processes.py):

* ``MarkovChain`` — a K-state chain on the uniform grid, one
  transition per step from a row-stochastic matrix ``P``; the path
  holds per-step STATE VALUES (``values[k]``, default the state index),
  so functionals compose (``chain.average()`` is occupancy-weighted
  value, ``chain.at(k)`` the state at a date).
* ``RegimeSwitchingGBM`` — a geometric Brownian asset whose drift and
  volatility switch with a hidden chain (the classical Hamilton
  regime-switching model): interval ``k`` uses the parameters of the
  state in force at its left endpoint, so each increment is exactly
  lognormal conditional on the regime path.

Device shape: with K states the chain step is dense linear algebra, not
gather — the carried state is one-hot encoded ``(n, K)`` and the next
state is the inverse-CDF count ``sum_j 1{u > (onehot @ cumP)_j}``: one
``(n, K) @ (K, K)`` matmul plus elementwise compares per step, no
data-dependent indexing (gathers at 1e7+ lanes cost 2-4x a sort on the
earlier accelerator; not re-measured on the H100).  All per-step
uniforms/normals are pre-sampled outside the ``lax.scan`` as usual.  Randomness follows the path-node contract:
column-seeded PRNG key under ``method=None``, per-driver quantile slab
under QMC/antithetic methods (chain uniforms take their dimensions
directly — a discrete recursion has no Brownian-bridge analogue; the
asset normals of ``RegimeSwitchingGBM`` are NOT bridged either, because
their effect on the path is modulated per-interval by the regime).

>>> chain = MarkovChain([[0.9, 0.1], [0.2, 0.8]], x0=0, steps=4)
>>> chain.terminal()
PathFunctional(MarkovChainPath(K=2, x0=0, T=1, steps=4), 'terminal')
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from probabilit_tpu.models.processes import PathDistribution

__all__ = [
    "MarkovChain",
    "RegimeSwitchingGBM",
    "MarkovChainPath",
    "RegimeSwitchingGBMPath",
]


def _validate_transition(transition):
    P = np.asarray(transition, np.float64)
    if P.ndim != 2 or P.shape[0] != P.shape[1]:
        raise ValueError(f"transition must be a square matrix, got {P.shape}.")
    if P.shape[0] < 2:
        raise ValueError("A Markov chain needs at least 2 states.")
    if (P < 0).any():
        raise ValueError("transition probabilities must be non-negative.")
    rows = P.sum(axis=1)
    if not np.allclose(rows, 1.0, atol=1e-9):
        raise ValueError(
            f"transition rows must sum to 1, got row sums {rows}."
        )
    return P


def _chain_scan(u, cum, state0, dtype):
    """(n, steps) uniforms -> (n, steps) state indices (as ``dtype``).

    One-hot carry: ``next = sum_j 1{u > (onehot @ cumP)_j}`` is the
    inverse transform of the current state's transition row, built from
    a matmul and compares — no gather.
    """
    n, steps = u.shape
    K = cum.shape[0]
    cum_t = jnp.asarray(cum, dtype)  # (K, K); row k = cumsum of P[k]
    idx = jnp.arange(K, dtype=dtype)

    def step(onehot, u_k):
        row = onehot @ cum_t  # (n, K) cumulative transition CDF
        nxt = jnp.sum((u_k[:, None] > row).astype(dtype), axis=1)
        nxt = jnp.minimum(nxt, K - 1.0)
        onehot_next = (nxt[:, None] == idx[None, :]).astype(dtype)
        return onehot_next, nxt

    with jax.default_matmul_precision("float32"):
        init = jnp.zeros((n, K), dtype).at[:, state0].set(1.0)
        _, states = jax.lax.scan(step, init, u.T)
    return states.T  # (n, steps), float state indices


class MarkovChainPath(PathDistribution):
    """K-state discrete-time Markov chain on the grid (exact law).

    ``at(k)`` has exactly the law ``e_{x0} P^{k+1}`` over the state
    values; there is no discretisation error (the chain IS the grid
    process).
    """

    _param_slots = ()

    def __init__(self, transition, x0=0, values=None, T=1.0, steps=252):
        P = _validate_transition(transition)
        K = P.shape[0]
        x0 = int(x0)
        if not 0 <= x0 < K:
            raise ValueError(f"x0 must be a state index in [0, {K}), got {x0}.")
        if values is None:
            vals = np.arange(K, dtype=np.float64)
        else:
            vals = np.asarray(values, np.float64)
            if vals.shape != (K,):
                raise ValueError(
                    f"values must have shape ({K},), got {vals.shape}."
                )
        self.transition = P
        self.K = K
        self.x0 = x0
        self.values = vals
        self._cum = np.cumsum(P, axis=1)
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"MarkovChainPath(K={self.K}, x0={self.x0}, T={self.T:g}, "
            f"steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "MarkovChainPath",
            self.transition.tobytes(),
            self.x0,
            self.values.tobytes(),
            self.T,
            self.steps,
        )

    # _q_width: inherited (one uniform per step).

    def _increments(self, key, n, dtype):
        from probabilit_tpu.ops.qmc import clamp_open_unit

        return clamp_open_unit(jax.random.uniform(key, (n, self.steps), dtype))

    def _increments_from_slab(self, slab, dtype):
        return slab.astype(dtype)

    def _path_from_increments(self, u):
        dtype = u.dtype
        states = _chain_scan(u, self._cum, self.x0, dtype)
        if (self.values == np.arange(self.K)).all():
            return states
        # Map indices to values without a gather: states are float
        # indices, values a K-point select chain over host constants.
        out = jnp.full_like(states, self.values[0])
        for k in range(1, self.K):
            out = jnp.where(states == k, jnp.asarray(self.values[k], dtype), out)
        return out


class RegimeSwitchingGBMPath(PathDistribution):
    """GBM with chain-modulated drift/volatility (Hamilton regimes).

    ``dS = mu[s_t] S dt + sigma[s_t] S dW`` with ``s_t`` a K-state
    chain transitioning at grid points; interval ``k`` uses the
    parameters of the state at its LEFT endpoint, so conditional on the
    regime path every increment is exactly lognormal — the only
    approximation versus the continuous-time model is that regimes
    cannot switch mid-interval (refine ``steps`` to taste).
    """

    _param_slots = ()

    def __init__(
        self, s0, mu, sigma, transition, x0_state=0, T=1.0, steps=252
    ):
        P = _validate_transition(transition)
        K = P.shape[0]
        s0 = float(s0)
        if not s0 > 0:
            raise ValueError(f"s0 must be positive, got {s0}.")
        mu = np.asarray(mu, np.float64)
        sigma = np.asarray(sigma, np.float64)
        if mu.shape != (K,) or sigma.shape != (K,):
            raise ValueError(
                f"mu and sigma must each have shape ({K},) matching the "
                f"transition matrix, got {mu.shape} and {sigma.shape}."
            )
        if (sigma <= 0).any():
            raise ValueError("every regime sigma must be positive.")
        x0_state = int(x0_state)
        if not 0 <= x0_state < K:
            raise ValueError(
                f"x0_state must be a state index in [0, {K}), got {x0_state}."
            )
        self.s0 = s0
        self.mu = mu
        self.sigma = sigma
        self.transition = P
        self.K = K
        self.x0_state = x0_state
        self._cum = np.cumsum(P, axis=1)
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"RegimeSwitchingGBMPath(s0={self.s0:g}, K={self.K}, "
            f"x0_state={self.x0_state}, T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "RegimeSwitchingGBMPath",
            self.s0,
            self.mu.tobytes(),
            self.sigma.tobytes(),
            self.transition.tobytes(),
            self.x0_state,
            self.T,
            self.steps,
        )

    @property
    def _q_width(self):
        # Two drivers per step: chain uniform + asset normal.
        return 2 * self.steps

    def _increments(self, key, n, dtype):
        from probabilit_tpu.ops.qmc import clamp_open_unit

        ku, kz = jax.random.split(key)
        u = clamp_open_unit(jax.random.uniform(ku, (n, self.steps), dtype))
        z = jax.random.normal(kz, (n, self.steps), dtype)
        return jnp.stack([u, z], axis=2)

    def _increments_from_slab(self, slab, dtype):
        from probabilit_tpu.ops import special as _special

        s = self.steps
        u = slab[:, :s].astype(dtype)
        z = _special.ndtri_fast(slab[:, s:].astype(dtype))
        return jnp.stack([u, z], axis=2)

    def _path_from_increments(self, inc):
        dtype = inc.dtype
        dt = self.T / self.steps
        u, z = inc[:, :, 0], inc[:, :, 1]
        states = _chain_scan(u, self._cum, self.x0_state, dtype)
        # Interval k uses the state at its LEFT endpoint: x0_state for
        # interval 0, then the post-transition states shifted right.
        prev = jnp.concatenate(
            [
                jnp.full((states.shape[0], 1), float(self.x0_state), dtype),
                states[:, :-1],
            ],
            axis=1,
        )
        mu_k = jnp.full_like(prev, self.mu[0])
        sd_k = jnp.full_like(prev, self.sigma[0])
        for k in range(1, self.K):
            mu_k = jnp.where(prev == k, jnp.asarray(self.mu[k], dtype), mu_k)
            sd_k = jnp.where(prev == k, jnp.asarray(self.sigma[k], dtype), sd_k)
        dlog = (mu_k - 0.5 * sd_k * sd_k) * dt + sd_k * (dt**0.5) * z
        return self.s0 * jnp.exp(jnp.cumsum(dlog, axis=1))


def MarkovChain(transition, x0=0, values=None, T=1.0, steps=252):
    """K-state Markov chain path node; see :class:`MarkovChainPath`.

    >>> MarkovChain([[0.9, 0.1], [0.2, 0.8]], x0=1, steps=8)
    MarkovChainPath(K=2, x0=1, T=1, steps=8)
    """
    return MarkovChainPath(transition, x0=x0, values=values, T=T, steps=steps)


def RegimeSwitchingGBM(
    s0, mu, sigma, transition, x0_state=0, T=1.0, steps=252
):
    """Regime-switching GBM path node; see :class:`RegimeSwitchingGBMPath`.

    >>> RegimeSwitchingGBM(100, [0.08, -0.02], [0.15, 0.4],
    ...                    [[0.95, 0.05], [0.1, 0.9]], steps=8)
    RegimeSwitchingGBMPath(s0=100, K=2, x0_state=0, T=1, steps=8)
    """
    return RegimeSwitchingGBMPath(
        s0, mu, sigma, transition, x0_state=x0_state, T=T, steps=steps
    )
