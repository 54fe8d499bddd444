"""Nearest correlation matrix, without CVXPY.

The reference solves a weighted-Frobenius SDP with CVXPY/SCS
(``correlation.py:59-150``, eq. (3) of Qi & Sun's H-weighted NCM paper).
Neither CVXPY nor an external conic solver belongs in a compiled stack;
the matrices involved are K x K for K = number of correlated variables
(small), so we solve the same two problems directly:

* unweighted: Higham's alternating projections with Dykstra correction
  (projection onto {PSD} intersect {unit diagonal}) — converges to the
  exact Frobenius projection;
* elementwise-weighted: ADMM on  min ||H o (X - G)||_F^2  s.t. diag(X)=1,
  X >= eps*I, whose X-update is elementwise closed-form and whose Z-update
  is one eigendecomposition per iteration.

Both run in float64 on host (this is model-build-time work, O(K^3) per
iteration); the *sampling* hot path never touches this code.
"""

from __future__ import annotations

import numpy as np

__all__ = ["nearest_correlation_matrix"]


def _proj_psd(A, floor=0.0):
    """Project a symmetric matrix onto {X : X >= floor * I}."""
    A = (A + A.T) / 2.0
    w, V = np.linalg.eigh(A)
    w = np.maximum(w, floor)
    return (V * w) @ V.T


def _higham(G, eps, max_iter=500, tol=1e-10):
    """Alternating projections with Dykstra correction (unweighted)."""
    n = G.shape[0]
    floor = (eps / n) * 10.0  # Same PD nudge as the reference constraint
    Y = G.copy()
    dS = np.zeros_like(G)
    for _ in range(max_iter):
        R = Y - dS
        X = _proj_psd(R, floor=floor)
        dS = X - R
        Y_new = X.copy()
        np.fill_diagonal(Y_new, 1.0)
        if np.linalg.norm(Y_new - Y, "fro") < tol * max(1.0, np.linalg.norm(Y, "fro")):
            Y = Y_new
            break
        Y = Y_new
    # Guarantee symmetric PD with unit diagonal.
    X = _proj_psd(Y, floor=floor)
    d = np.sqrt(np.clip(np.diag(X), 1e-12, None))
    X = X / np.outer(d, d)
    return (X + X.T) / 2.0


def _admm_weighted(G, H, eps, rho=1.0, max_iter=20000, tol=1e-12):
    """ADMM for the H-weighted problem; exact for the convex program.

    Residual-balancing adaptive rho (Boyd et al. §3.4.1) — needed to reach
    the MATLAB ``nearcorr`` reference values to ~1e-5 when the weight
    matrix contains zeros (free entries converge slowly at fixed rho).
    """
    n = G.shape[0]
    floor = (eps / n) * 10.0
    H2 = 2.0 * H * H
    X = G.copy()
    np.fill_diagonal(X, 1.0)
    Z = _proj_psd(X, floor=floor)
    U = np.zeros_like(G)
    for _ in range(max_iter):
        X = (H2 * G + rho * (Z - U)) / (H2 + rho)
        np.fill_diagonal(X, 1.0)
        Z_new = _proj_psd(X + U, floor=floor)
        r_norm = np.linalg.norm(X - Z_new, "fro")
        s_norm = rho * np.linalg.norm(Z_new - Z, "fro")
        Z = Z_new
        U = U + X - Z
        if r_norm > 10.0 * s_norm:
            rho *= 2.0
            U /= 2.0
        elif s_norm > 10.0 * r_norm:
            rho /= 2.0
            U *= 2.0
        if max(r_norm, s_norm) < tol * max(1.0, np.linalg.norm(Z, "fro")):
            break
    X = _proj_psd(Z, floor=floor)
    d = np.sqrt(np.clip(np.diag(X), 1e-12, None))
    X = X / np.outer(d, d)
    return (X + X.T) / 2.0


def nearest_correlation_matrix(matrix, *, weights=None, eps=1e-6, verbose=False):
    """Return the correlation matrix nearest to ``matrix``.

    Drop-in equivalent of the reference's CVXPY/SCS solve
    (``correlation.py:59-150``): weighted Frobenius projection onto
    {X PSD, diag(X) = 1} with a small PD nudge ``(X - eps*I) >= 0``.

    Parameters mirror the reference: ``weights`` is an elementwise weight
    matrix (H-weighting), ``eps`` the PD nudge / solver tolerance.

    Examples
    --------
    >>> X = np.array([[1, 1, 0],
    ...               [1, 1, 1],
    ...               [0, 1, 1]])
    >>> nearest_correlation_matrix(X).round(4)
    array([[1.    , 0.7607, 0.1573],
           [0.7607, 1.    , 0.7607],
           [0.1573, 0.7607, 1.    ]])
    """
    if not isinstance(matrix, np.ndarray):
        raise TypeError("Input argument `matrix` must be np.ndarray.")
    if not (matrix.ndim == 2 and matrix.shape[0] == matrix.shape[1]):
        raise ValueError("Input argument `matrix` must be square.")

    G = np.asarray(matrix, dtype=np.float64).copy()

    if weights is not None:
        if not isinstance(weights, np.ndarray):
            raise TypeError("Input argument `weights` must be np.ndarray.")
        if not (weights.shape == G.shape):
            raise ValueError("Argument `weights` must have same shape as `matrix`.")
        H = np.asarray(weights, dtype=np.float64)
        X = _admm_weighted(G, H, eps)
    else:
        X = _higham(G, eps)

    # Fail-safe mirroring the reference's recursive eps/10 retry
    # (correlation.py:141-148): re-solve with a smaller nudge if numerics
    # left the result non-PD.
    is_symmetric = np.allclose(X, X.T)
    is_pd = np.linalg.eigvalsh(X).min() > 0
    if not (is_symmetric and is_pd) and (eps > 1e-14):
        if verbose:
            print(f"Recursively calling solver with eps := {eps} / 10")
        return nearest_correlation_matrix(
            G, weights=weights, eps=eps / 10, verbose=verbose
        )

    return X
