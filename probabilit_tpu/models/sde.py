"""Generic scalar SDE path node: user drift/diffusion, Euler or Milstein.

Framework extension (the reference models scalar draws only).  The
closed-form path families (models/processes.py, levy.py, stochvol.py)
sample exact grid laws; this node covers everything else: any scalar Ito
diffusion

    dX_t = a(t, X_t) dt + b(t, X_t) dW_t,    X_0 = x0,

with ``a``/``b`` supplied as plain Python callables of ``(t, x)`` traced
into the compiled program.  Two schemes:

* ``"euler"`` — Euler-Maruyama, strong order 0.5 / weak order 1.
* ``"milstein"`` — adds the ``0.5 b b' (dW^2 - dt)`` Ito correction for
  strong order 1.  The state derivative ``b' = db/dx`` is obtained by
  FORWARD-MODE AUTODIFF of the user's diffusion callable (one
  ``jax.jvp`` with a ones tangent per step) — no hand-coded derivative,
  exact to machine precision, and nearly free since it fuses into
  the step's elementwise block.

Device shape: all ``steps`` standard-normal drivers are pre-sampled OUTSIDE
the time recursion as one ``(n, steps)`` matrix (XLA loop iterations
cannot fuse across trips, so nothing expensive may live inside the
loop); the scheme itself is a ``lax.scan`` whose body is a handful of
elementwise ops on the ``(n,)`` carry plus the two user callables.
Randomness follows the path-node contract (models/processes.py): a
column-seeded PRNG key under ``method=None``, a per-step quantile slab
built through the Brownian-bridge matmul (ops/bridge.py) under
QMC/antithetic methods — the bridge is an orthogonal transform of the
iid drivers, so the scheme's law is untouched while QMC dimension 0
controls the terminal point of the driving Brownian path.

Both callables must be ELEMENTWISE in ``x`` (jnp scalar semantics,
broadcast over the sample axis); this is also what makes the
``jvp``-with-ones trick equal the diagonal derivative ``b'``.

>>> sde = SDE(lambda t, x: 1.5 * (0.5 - x), lambda t, x: 0.3, x0=2.0,
...           T=1.0, steps=4)
>>> sde.terminal()
PathFunctional(SDEPath(<lambda>, <lambda>, x0=2, T=1, steps=4, scheme='euler'), 'terminal')
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from probabilit_tpu.models.processes import PathDistribution

__all__ = ["SDE", "SDEPath"]

_SCHEMES = ("euler", "milstein")


class SDEPath(PathDistribution):
    """Scalar Ito diffusion discretised by Euler-Maruyama or Milstein.

    ``drift(t, x)`` and ``diffusion(t, x)`` are traced per step with
    ``t`` the step's LEFT endpoint (a traced scalar) and ``x`` the
    ``(n,)`` state vector; both must be elementwise in ``x``.  Unlike
    the closed-form families the grid law carries discretisation error
    (weak O(dt) / strong O(sqrt(dt)) for Euler, strong O(dt) for
    Milstein) — prefer the exact nodes when one matches the model.
    """

    # Parameters live inside the user's closures, invisible to the
    # attribute-swapping pathwise-Greeks machinery.
    _param_slots = ()

    def __init__(self, drift, diffusion, x0=0.0, T=1.0, steps=252, scheme="euler"):
        if not callable(drift):
            raise TypeError(f"drift must be callable, got {drift!r}.")
        if not callable(diffusion):
            raise TypeError(f"diffusion must be callable, got {diffusion!r}.")
        if scheme not in _SCHEMES:
            raise ValueError(f"scheme must be one of {_SCHEMES}, got {scheme!r}.")
        self.drift = drift
        self.diffusion = diffusion
        self.x0 = float(x0)
        self.scheme = scheme
        super().__init__(steps, T)

    def __repr__(self):
        dname = getattr(self.drift, "__name__", type(self.drift).__name__)
        bname = getattr(self.diffusion, "__name__", type(self.diffusion).__name__)
        return (
            f"SDEPath({dname}, {bname}, x0={self.x0:g}, T={self.T:g}, "
            f"steps={self.steps}, scheme={self.scheme!r})"
        )

    def _static_signature(self):
        # Callables enter by identity, like ScalarFunctionTransform
        # (models/graph.py): two different live functions never collide;
        # the node keeps both alive for its own lifetime.
        return (
            "SDEPath",
            id(self.drift),
            id(self.diffusion),
            self.x0,
            self.T,
            self.steps,
            self.scheme,
        )

    # _q_width: inherited (one Gaussian driver per step).

    def _increments(self, key, n, dtype):
        return jax.random.normal(key, (n, self.steps), dtype)

    def _increments_from_slab(self, slab, dtype):
        return self._bridge_z(slab, dtype)

    def _increments_from_normals(self, z, dtype):
        # The discretisation scales the raw normals itself inside the
        # scheme scan; the MLMC coupling hook is the identity.
        return z

    def _regrid(self, steps):
        return SDEPath(
            self.drift, self.diffusion, x0=self.x0, T=self.T,
            steps=steps, scheme=self.scheme,
        )

    def _eval(self, fn, t, x):
        """User callable -> (n,)-shaped array (constants broadcast)."""
        return jnp.broadcast_to(jnp.asarray(fn(t, x), x.dtype), x.shape)

    def _path_from_increments(self, z):
        dtype = z.dtype
        dt = jnp.asarray(self.T / self.steps, dtype)
        sqdt = jnp.sqrt(dt)
        ts = jnp.arange(self.steps, dtype=dtype) * dt
        milstein = self.scheme == "milstein"

        def step(x, z_t):
            z_k, t = z_t
            a = self._eval(self.drift, t, x)
            if milstein:
                # One forward-mode pass gives b AND b' = db/dx (diagonal
                # because the callable is elementwise).
                b, db = jax.jvp(
                    lambda xx: self._eval(self.diffusion, t, xx),
                    (x,),
                    (jnp.ones_like(x),),
                )
                x1 = (
                    x
                    + a * dt
                    + b * sqdt * z_k
                    + (0.5 * dt) * b * db * (z_k * z_k - 1.0)
                )
            else:
                b = self._eval(self.diffusion, t, x)
                x1 = x + a * dt + b * sqdt * z_k
            return x1, x1

        init = jnp.full((z.shape[0],), self.x0, dtype)
        _, xs = jax.lax.scan(step, init, (z.T, ts))
        return xs.T


def SDE(drift, diffusion, x0=0.0, T=1.0, steps=252, scheme="euler"):
    """Generic scalar SDE path node; see :class:`SDEPath`.

    >>> ou = SDE(lambda t, x: 1.5 * (0.5 - x), lambda t, x: 0.3, x0=2.0,
    ...          steps=8, scheme="milstein")
    >>> ou
    SDEPath(<lambda>, <lambda>, x0=2, T=1, steps=8, scheme='milstein')
    """
    return SDEPath(drift, diffusion, x0=x0, T=T, steps=steps, scheme=scheme)
