"""Brownian-bridge construction for quasi-Monte-Carlo path sampling.

QMC sequences are most accurate in their leading dimensions (Sobol/Halton
discrepancy grows with the dimension index), while a path's statistical
mass concentrates in a few coarse features (terminal level, then
midpoint, then quarter-points, ...).  The Brownian-bridge construction
aligns the two: QMC dimension 0 drives the terminal value, dimension 1
the midpoint conditional on it, and so on coarse-to-fine, which is what
makes RQMC effective on path-dependent payoffs (the effective dimension
of an Asian/barrier payoff drops from ``steps`` to a handful).

The construction is linear, so it is ONE precomputed
``(steps, steps)`` matrix applied as a single matmul:

* ``bridge_matrix(steps)`` — ``B`` with ``W = z @ B.T`` a standard
  Brownian motion on the unit-spaced grid ``t_k = k + 1`` when ``z`` is
  iid standard normal, with ``z[:, 0]`` mapped to the terminal point and
  subsequent columns to midpoints in breadth-first (coarse-to-fine)
  order.
* ``increment_matrix(steps)`` — ``A = diff(B)`` (first row kept), an
  ORTHOGONAL matrix: ``inc = z @ A.T`` are iid standard normals whose
  cumulative sum is ``W``.  Path nodes consume increments, so they apply
  ``A`` directly; orthogonality means the transform is distribution-
  exact (the path law is identical to a plain iid draw — the bridge
  only permutes which QMC dimension controls which feature).

Matrices are built once per ``steps`` on the host in float64 and cached.
No counterpart exists in the reference (its paths do not exist; its QMC
engines feed scalar marginals only, ``modeling.py:479-489``).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["bridge_matrix", "increment_matrix", "normal_increments"]


@functools.lru_cache(maxsize=64)
def _bridge_matrix_np(steps):
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}.")
    # Rows indexed by grid point 0..steps over unit-spaced times t = row
    # index; row 0 is the (deterministic) start W(0) = 0.
    B = np.zeros((steps + 1, steps), dtype=np.float64)
    B[steps, 0] = np.sqrt(float(steps))
    k = 1
    # Breadth-first midpoint refinement: condition each interval's
    # midpoint on its (already constructed) endpoints.  Exact for any
    # steps (power of two or not): every conditional is the Gaussian
    # bridge law  W_m | W_l, W_r ~ N(a W_l + b W_r, (m-l)(r-m)/(r-l)).
    from collections import deque

    queue = deque([(0, steps)])
    while queue:
        lo, hi = queue.popleft()
        if hi - lo < 2:
            continue
        mid = (lo + hi) // 2
        a = (hi - mid) / (hi - lo)
        b = (mid - lo) / (hi - lo)
        s = np.sqrt((mid - lo) * (hi - mid) / (hi - lo))
        B[mid] = a * B[lo] + b * B[hi]
        B[mid, k] = s
        k += 1
        queue.append((lo, mid))
        queue.append((mid, hi))
    assert k == steps
    return B[1:]


def bridge_matrix(steps):
    """``(steps, steps)`` float64 ``B``: ``W = z @ B.T`` is standard BM.

    Grid times are ``1, 2, ..., steps`` (unit step); scale by
    ``sqrt(dt)`` for a ``dt``-spaced grid.  ``z[:, 0]`` controls the
    terminal point, later columns refine coarse-to-fine.

    >>> B = bridge_matrix(4)
    >>> (B @ B.T).round(10)[0]      # cov(W_i, W_j) = min(t_i, t_j)
    array([1., 1., 1., 1.])
    """
    return _bridge_matrix_np(int(steps)).copy()


@functools.lru_cache(maxsize=64)
def _increment_matrix_np(steps):
    B = _bridge_matrix_np(int(steps))
    A = np.diff(B, axis=0, prepend=np.zeros((1, B.shape[1])))
    return A


def increment_matrix(steps):
    """Orthogonal ``(steps, steps)`` float64 ``A``: bridge-ordered z -> iid
    standard-normal increments (``cumsum(z @ A.T, axis=1) = W``).

    >>> A = increment_matrix(8)
    >>> bool(np.abs(A @ A.T - np.eye(8)).max() < 1e-12)
    True
    """
    return _increment_matrix_np(int(steps)).copy()


def normal_increments(u, dtype):
    """Bridge-ordered uniform slab ``(n, steps)`` -> iid N(0, 1) increments.

    ``u[:, 0]`` (the best QMC dimension) controls the terminal point of
    the underlying Brownian path.  The transform is one inverse normal
    CDF plus one ``(n, steps) @ (steps, steps)`` matmul; because the
    increment matrix is orthogonal the output is exactly an iid
    standard-normal matrix in distribution, so PRNG uniforms lose
    nothing either.  Matmul precision is pinned: the GPU's default runs
    f32 matmuls in TF32, which would put ~1e-3 relative error on every
    increment.
    """
    from probabilit_tpu.ops import special as _special

    z = _special.ndtri_fast(u.astype(dtype))
    steps = u.shape[-1]
    if steps == 1:
        return z
    A = jnp.asarray(_increment_matrix_np(steps), dtype)
    with jax.default_matmul_precision("float32"):
        return z @ A.T
