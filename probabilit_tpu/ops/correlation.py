"""Correlation induction on sample matrices — XLA-native correlators.

Accelerator-first re-design of the reference correlators (``correlation.py:161-425``):

* ``ImanConover`` — rank-based, marginal-preserving correlation induction
  (Iman & Conover 1982).  The reference pipeline is rankdata -> norm.ppf ->
  Cholesky -> per-column triangular solve -> K Python-loop sorts.  Here the
  whole transform is one traced program of exactly FOUR batched sorts and
  one matmul and nothing else — permutation inversion/application is
  expressed as integer-key variadic sorts because scatter/gather cost
  2-4x a sort at 1e7 elements on the earlier accelerator (not re-measured on the H100;
  see ``_apply_rows`` and ops/sort.py).
* ``Cholesky`` — exact Pearson induction by whiten-then-color; the two
  K x K triangular factors are combined into one (N,K)@(K,K) matmul.
* ``decorrelate`` — whitening helper.

All ``__call__`` paths accept NumPy or JAX arrays and are jit-safe (the
sampling engine splices ``_apply`` directly into its compiled program).
Eager user-facing calls get the reference's full validation.
"""

from __future__ import annotations

import abc

import jax
import jax.numpy as jnp
import numpy as np
from probabilit_tpu.ops.special import ndtri_fast_wide as ndtri

__all__ = [
    "CorrelatorError",
    "Correlator",
    "Cholesky",
    "ImanConover",
    "StudentTCopula",
    "decorrelate",
    "rankdata",
]


class CorrelatorError(Exception):
    pass


def _is_positive_definite(X):
    try:
        np.linalg.cholesky(np.asarray(X))
        return True
    except np.linalg.LinAlgError:
        return False


def _sorted_average_ranks(X_sorted):
    """0-based average-tie ranks for each pre-sorted row of ``(K, N)``.

    Tie runs are resolved with two cumulative scans (no segment ids, no
    scatter): ``first`` propagates each run's start index forward,
    ``last`` propagates its end index backward; the average rank is their
    midpoint.  Cost: two O(KN) scans — negligible next to a sort.
    """
    K, N = X_sorted.shape
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (K, N))
    boundary = X_sorted[:, 1:] != X_sorted[:, :-1]
    edge = jnp.ones((K, 1), dtype=bool)
    starts = jnp.concatenate([edge, boundary], axis=1)
    ends = jnp.concatenate([boundary, edge], axis=1)
    first = jax.lax.cummax(jnp.where(starts, pos, -1), axis=1)
    last = jnp.flip(
        jax.lax.cummin(jnp.flip(jnp.where(ends, pos, N), axis=1), axis=1), axis=1
    )
    # Ranks carry at least f32: rank sums are exact integers up to 2^24,
    # and materializing them in a NARROWER input dtype (f16 data) would
    # round them to the data grid above 2048 rows.  Wider inputs (f64
    # under x64) keep their width so ranks stay exact beyond 2^24 rows.
    rank_dtype = jnp.result_type(X_sorted.dtype, jnp.float32)
    return (first + last).astype(rank_dtype) * 0.5


def rankdata(X, axis=0, method="average"):
    """0-based ranks along ``axis`` (``+ 1`` gives the scipy convention).

    ``method="average"`` assigns tied values the mean of their ordinal
    ranks, matching the reference's scipy ``rankdata`` semantics
    (``correlation.py:394``); ``method="ordinal"`` breaks ties by position.
    Both are expressed as sorts (plus two scans for ties) because
    scatter cost 2-4x a sort at 1e7 elements on the earlier accelerator
    (not re-measured on the H100).
    """
    from probabilit_tpu.ops.sort import (
        apply_inverse_permutation_rows,
        rowsort_with_order,
    )

    if method not in ("average", "ordinal"):
        raise ValueError(f"method must be 'average' or 'ordinal', got {method!r}")
    X = jnp.asarray(X)
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]
        axis = 0
    XT = X.T if axis == 0 else X
    # Ordinal ranks promise position-determined tie order, which only a
    # stable sort provides (XLA's unstable sort may permute equal keys
    # arbitrarily per backend/version); average ranks are tie-order
    # independent and take the 1.5x-cheaper unstable sort.
    X_sorted, order = rowsort_with_order(XT, stable=(method == "ordinal"))
    if method == "ordinal":
        n = XT.shape[1]
        sorted_ranks = jnp.broadcast_to(
            jnp.arange(n, dtype=jnp.int32)[None, :], XT.shape
        )
    else:
        # No f32 cast: tie detection must happen in the input dtype (an
        # f32 cast merges f64 values closer than f32 epsilon into false
        # ties), and f64 inputs get f64 ranks (exact beyond 2^24 rows).
        sorted_ranks = _sorted_average_ranks(X_sorted)
    ranks = apply_inverse_permutation_rows(order, sorted_ranks)
    ranks = ranks.T if axis == 0 else ranks
    return ranks[:, 0] if squeeze else ranks


class Correlator(abc.ABC):
    """Protocol: ``correlator.set_target(C)`` then ``X_corr = correlator(X)``.

    Mirrors reference ``correlation.py:161-202`` including validation
    semantics; ``self.P`` is the lower Cholesky factor of the target.
    """

    def set_target(self, correlation_matrix):
        # Same validation semantics as the reference protocol
        # (correlation.py:162-179): a NumPy target, square, unit diagonal,
        # symmetric, PD — each failure named precisely (including the
        # non-2-D case, which the reference mislabels as "not square").
        C = correlation_matrix
        if not isinstance(C, np.ndarray):
            raise TypeError(
                f"set_target expects a NumPy correlation matrix, got "
                f"{type(C).__name__}."
            )
        if C.ndim != 2:
            raise ValueError(
                f"Target correlation must be a 2-D matrix; got ndim={C.ndim}."
            )
        if C.shape[0] != C.shape[1]:
            raise ValueError(
                f"Target correlation matrix must be square; got shape "
                f"{C.shape}."
            )
        if not np.allclose(np.diag(C), 1.0):
            raise ValueError(
                "Target correlation matrix needs ones on the diagonal."
            )
        if not np.allclose(C.T, C):
            raise ValueError("Target correlation matrix is not symmetric.")
        if not _is_positive_definite(C):
            raise ValueError(
                "Target correlation matrix is not positive definite; "
                "repair it with nearest_correlation_matrix first."
            )

        self.C = C.copy()
        self.P = np.linalg.cholesky(self.C)
        return self

    def _validate_X(self, X, check_rows_cols=True):
        """Check the (observations, variables) sample matrix against the target."""
        if getattr(self, "P", None) is None or getattr(self, "C", None) is None:
            raise CorrelatorError(
                "No target set: call set_target(corr_matrix) before "
                "applying the correlator."
            )
        if not isinstance(X, (np.ndarray, jax.Array)):
            raise TypeError(
                f"X must be a NumPy or JAX array, got {type(X).__name__}."
            )
        if X.ndim != 2:
            raise ValueError(
                f"X must be 2-D with shape (observations, variables); got "
                f"ndim={X.ndim}."
            )

        N, K = X.shape
        if self.P.shape[0] != K:
            raise ValueError(
                f"X has {K} columns but the target correlation is "
                f"{self.P.shape[0]}x{self.P.shape[1]}; they must agree."
            )
        if check_rows_cols and N <= K:
            raise ValueError(
                "Inducing correlations needs more observations than "
                f"variables (rows > columns); X has shape {X.shape}."
            )

        return N, K

    @abc.abstractmethod
    def _apply(self, X):
        """Jit-safe core transform: (N, K) array -> (N, K) array."""

    def _cache_token(self):
        """Hashable identity for compiled-program caches.

        Parameterized correlators (e.g. ``StudentTCopula``) must include
        every value that changes the traced program, else two configs
        would silently share one compiled sampler.
        """
        return type(self).__qualname__

    def __call__(self, X):
        self._validate_X(X)
        return self._apply(jnp.asarray(X))


class Cholesky(Correlator):
    """Exact Pearson correlation by whiten-then-color.

    Preserves each column's mean and standard deviation but NOT the marginal
    shapes (reference ``correlation.py:205-285``).  The whitening factor
    (empirical Cholesky) and coloring factor (target Cholesky) are fused
    into a single K x K matrix so the N-sized work is one matmul.
    """

    def _apply(self, X):
        # The GPU's DEFAULT runs f32 matmuls in TF32 (~1e-3 relative):
        # enough to visibly bias the induced
        # correlation.  Full-f32 passes on these shapes cost well under a
        # millisecond, so pin the whole transform to float32 precision.
        with jax.default_matmul_precision("float32"):
            X = jnp.asarray(X)
            N, K = X.shape
            mean = jnp.mean(X, axis=0)
            std = jnp.std(X, axis=0)
            X_n = (X - mean) / std

            cov = (X_n.T @ X_n) / N
            P_emp = jnp.linalg.cholesky(cov)

            # transform = inv(P_emp).T @ P.T computed by triangular solve
            # on the small K x K system; the big (N,K) matrix sees one
            # matmul.
            target_P = jnp.asarray(self.P, X.dtype)
            transform = jax.scipy.linalg.solve_triangular(
                P_emp.T, target_P.T, lower=False
            )
            return mean + X_n @ (transform * std)


class ImanConover(Correlator):
    """Marginal-preserving rank correlation induction (Iman-Conover 1982).

    Reference: ``correlation.py:288-425``.  Steps (all one traced program):

    1. van der Waerden scores  ndtri(rank / (N+1))  — rank->score scatter
       expressed as an integer-key sort,
    2. decorrelate scores via Cholesky of their empirical correlation,
    3. recolor with the target factor  P  (steps 2+3 fuse into a single
       (N,K) @ (K,K) matmul),
    4. reorder each original column by the rank of its scored column,
       which restores the exact original marginals.

    ``ties="average"`` (default) matches the reference's scipy ``rankdata``
    semantics: tied values share the mean rank of their run, so discrete
    marginals (bernoulli, DiscreteDistribution) score identically to the
    reference.  ``ties="ordinal"`` breaks ties by position — slightly
    cheaper and equivalent for continuous marginals (ties have measure
    zero, modulo the ~N^2/2^33 float32 collision rate).

    Two intentional divergences, both marginal-exact:

    * when two *correlated scores* tie, the reference's
      ``rankdata(...).astype(int)`` (correlation.py:421-422) maps both
      rows to the same original value, duplicating one marginal entry and
      dropping another; the sort-based step 4 here keeps the marginals
      exactly.
    * score columns are standardized before decorrelation/recoloring.
      The reference applies ``inv(L)`` and ``P`` to raw scores
      (correlation.py:411-418); with continuous marginals all score
      columns share the same scale so this cancels, but with ties the
      scales differ and the reference's mixing weights are distorted
      (measured: bernoulli+normal at target 0.6 achieves 0.45 in the
      reference vs 0.59 here).
    """

    def __init__(self, ties="average"):
        if ties not in ("average", "ordinal"):
            raise ValueError(f"ties must be 'average' or 'ordinal', got {ties!r}")
        self.ties = ties

    def _cache_token(self):
        # ties changes the traced program (stable vs unstable sorts,
        # tie-averaged vs positional scores): the two configurations
        # must never share a compiled sampler.
        return (type(self).__qualname__, self.ties)

    def __call__(self, X):
        self._validate_X(X)
        if isinstance(X, np.ndarray):
            # Eager path: reproduce the reference's PD guard on rank data
            # (correlation.py:399-403). The traced path skips it (cannot
            # raise data-dependent errors under jit).
            XT = jnp.asarray(X.T, jnp.float32)
            scores, _, _ = self._scores_rows(*self._sort_rows(XT))
            emp = np.corrcoef(np.asarray(scores), rowvar=True)
            if not _is_positive_definite(np.atleast_2d(emp)):
                msg = "Rank data correlation not positive definite."
                msg += "There are perfect correlations in the ranked data."
                msg += "Supply more data (rows in X) or sample differently."
                raise ValueError(msg)
        return self._apply(jnp.asarray(X))

    # True on the pure Gaussian-copula transform: recolored scores map to
    # uniforms via the normal CDF, so the engine may use closed-form
    # score-linear shortcuts (ppf.score_emit).  Mixed-score subclasses
    # (StudentTCopula) set False and route through _copula_uniforms.
    gaussian_scores = True

    def _mix_scores(self, y, w_key=None):
        """Hook between recoloring and rank placement (identity here).

        Elliptical-copula subclasses scale the recolored Gaussian scores
        by a per-observation mixing variable; the base class IS the
        Gaussian copula, so the scores pass through unchanged.
        """
        return y

    def _copula_uniforms(self, y, w_key=None):
        """(K, N) recolored scores -> correlated uniform quantiles.

        One ``lax.map`` over score rows: the row body (a ~40-term
        unrolled continued fraction for StudentTCopula) is emitted ONCE
        and iterated, not cloned per row — K inlined clones multiplied
        the t-copula program's compile time several-fold, and
        row-at-a-time evaluation also bounds live loop state to one
        row's worth (the all-at-once (K, N) t CDF ran a 16 GB device out
        of memory at K=10, N=1e8).
        """
        y = jnp.asarray(y)
        mix = self._mix_state(y.shape[-1], y.dtype, w_key)
        return jax.lax.map(lambda row: self._copula_uniform_row(row, mix), y)

    def _mix_state(self, n, dtype, w_key=None):
        """Shared per-observation state for row-wise uniform conversion.

        None here (the Gaussian copula needs no mixing); StudentTCopula
        returns its (n,) chi(df)/sqrt(df) scale ONCE so the engine can
        convert score rows one at a time — a (K, n) all-at-once t CDF
        at n=1e8 held K times the continued-fraction loop state and ran
        out of HBM.
        """
        return None

    def _copula_uniform_row(self, y_row, mix):
        """One score row -> correlated uniforms, given ``_mix_state``."""
        from probabilit_tpu.ops import special as _special

        return _special.ndtr_fast(y_row)

    def _apply(self, X):
        """Standard (N, K) layout entry; work happens in ``_apply_rows``."""
        X = jnp.asarray(X)
        return self._apply_rows(X.T).T

    def _sort_rows(self, XT):
        from probabilit_tpu.ops.sort import rowsort_with_order

        # ties="ordinal" assigns distinct scores to tied values by
        # position, which requires a stable sort to be deterministic;
        # the default average mode is tie-order independent.
        return rowsort_with_order(jnp.asarray(XT), stable=(self.ties == "ordinal"))

    def _scores_rows(self, X_sorted, order, chunk_elems=None):
        """(scores, mean, var): van der Waerden scores in original order.

        Scores per sorted position come straight from the (tie-resolved)
        rank — no (N, K) gather; the unsort back to original row order is
        one integer-key variadic sort (see ops/sort.py).
        """
        from probabilit_tpu.ops.sort import (
            _DEFAULT_CHUNK_ELEMS,
            apply_inverse_permutation_rows,
        )

        if chunk_elems is None:
            chunk_elems = _DEFAULT_CHUNK_ELEMS
        K, N = X_sorted.shape
        dtype = X_sorted.dtype
        if self.ties == "average":
            ranks1 = _sorted_average_ranks(X_sorted) + 1.0
            scores_sorted = ndtri(ranks1 / jnp.asarray(N + 1, dtype))
        else:
            s_row = ndtri(jnp.arange(1, N + 1, dtype=dtype) / jnp.asarray(N + 1, dtype))
            scores_sorted = jnp.broadcast_to(s_row[None, :], (K, N))
        scores = apply_inverse_permutation_rows(order, scores_sorted, chunk_elems)
        # Per-row moments from the sorted domain (same multiset per row).
        mean = jnp.mean(scores_sorted, axis=1, keepdims=True)
        var = jnp.mean(jnp.square(scores_sorted - mean), axis=1, keepdims=True)
        return scores, mean, var

    def _apply_rows(self, XT, w_key=None):
        """Iman-Conover on a (K, N) matrix — exactly four sorts, no gathers.

        Scatter/gather over 1e7-element permutations cost 2-4x a sort on
        the earlier accelerator (not re-measured on the H100), so every permutation
        application is expressed as a variadic sort (see ops/sort.py).  Per statistical column:

        1. ``sort(X, iota)``            -> X_sorted, order
        2. ``sort(order, s_sorted)``    -> van der Waerden scores in
           original row order (this IS the rank->score scatter)
        3. one (K,K)@(K,N) matmul recolors the scores (empirical
           decorrelation and target coloring factors pre-combined)
        4. ``sort(corr, iota)`` -> order2; ``sort(order2, X_sorted)``
           places the k-th largest original value at the row of the k-th
           largest correlated score — marginals restored exactly.

        Under an active mesh the statistical columns (rows here) shard
        over the devices: they are independent through all four sorts, so
        N chips divide the dominant cost by N; only the small KxK
        Gram/Cholesky induces collectives.  See ``_apply_rows_sharded``.
        """
        from probabilit_tpu.parallel import mesh as _mesh

        mesh = _mesh.current_mesh()
        if mesh is not None and mesh.size > 1:
            return self._apply_rows_sharded(jnp.asarray(XT), mesh, w_key=w_key)
        return self._transform_rows(jnp.asarray(XT), jnp.asarray(self.P), w_key=w_key)

    def _apply_rows_sharded(self, XT, mesh, w_key=None):
        """Column-sharded transform: pad rows to the mesh size and go.

        Rows are padded with independent hash-based pseudo-uniform rows and
        the target factor extends block-diagonally.  Cholesky factors and
        triangular inverses are order-respecting (row block i of ``L`` and
        ``inv(L)`` depends only on leading blocks), and the padded target
        rows carry zero weight for the real rows, so the first K output
        rows are EXACTLY the unsharded result up to reduction order.
        """
        import numpy as np

        from probabilit_tpu.parallel.mesh import sample_sharding

        K, N = XT.shape
        n_dev = mesh.size
        K_pad = -(-K // n_dev) * n_dev
        if K_pad != K:
            # Deterministic filler rows, independent of the data: iota
            # through a splitmix-style hash (a shortened cousin of
            # ops/hashing.fmix32 — kept verbatim so padded results stay
            # bitwise stable), mapped to (0, 1) then ndtri'd so the
            # padded score Gram stays comfortably PD.
            idx = (
                jnp.arange((K_pad - K) * N, dtype=jnp.uint32).reshape(K_pad - K, N)
                + jnp.uint32(0x9E3779B9)
            )
            h = idx * jnp.uint32(0x85EBCA6B)
            h = (h ^ (h >> jnp.uint32(13))) * jnp.uint32(0xC2B2AE35)
            h = h ^ (h >> jnp.uint32(16))
            filler = (
                (h >> jnp.uint32(8)).astype(XT.dtype) * (2.0**-24) + 2.0**-25
            )
            XT = jnp.concatenate([XT, filler], axis=0)
            P_pad = np.eye(K_pad, dtype=np.asarray(self.P).dtype)
            P_pad[:K, :K] = np.asarray(self.P)
        else:
            P_pad = np.asarray(self.P)

        sharding = sample_sharding(ndim=2, mesh=mesh)
        XT = jax.lax.with_sharding_constraint(XT, sharding)
        # One unchunked call per sort (row slicing would reshard): each
        # device sorts only its own rows.
        out = self._transform_rows(
            XT, jnp.asarray(P_pad), chunk_elems=1 << 62, w_key=w_key
        )
        return out[:K]

    def _transform_rows(self, XT, target_P, chunk_elems=None, w_key=None):
        from probabilit_tpu.ops.sort import (
            _DEFAULT_CHUNK_ELEMS,
            apply_inverse_permutation_rows,
            rowsort_with_order,
        )

        if chunk_elems is None:
            chunk_elems = _DEFAULT_CHUNK_ELEMS

        K, N = XT.shape
        dtype = XT.dtype

        # STEPS 1+2: sorted values + order, then tie-resolved scores.
        X_sorted, order = rowsort_with_order(XT, chunk_elems)
        scores, s_mean, s_var = self._scores_rows(X_sorted, order, chunk_elems)

        # Empirical correlation of the scores from one Gram matrix.
        # float32 matmul precision: the GPU's DEFAULT TF32 would round
        # the f32 score inputs to 10-bit mantissas (~1e-3 corr bias).
        acc_type = jnp.float64 if dtype == jnp.float64 else jnp.float32
        with jax.default_matmul_precision("float32"):
            gram = (
                jax.lax.dot_general(
                    scores,
                    scores,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=acc_type,
                ).astype(dtype)
                / N
            )
            s_std = jnp.sqrt(s_var)
            emp_corr = (gram - s_mean * s_mean.T) / (s_std * s_std.T)
            L = jnp.linalg.cholesky(emp_corr)

            # STEP 3: decorrelate + recolor in one (K,K) @ (K,N) matmul.
            eye = jnp.eye(K, dtype=dtype)
            inv_L = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
            M = jnp.asarray(target_P, dtype) @ inv_L  # corr_T = M @ std scores_T
            correlated = jax.lax.dot_general(
                M,
                (scores - s_mean) / s_std,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=acc_type,
            ).astype(dtype)

        # Elliptical-mixing hook: identity for the Gaussian copula, a
        # per-observation chi(df)/sqrt(df) division for StudentTCopula.
        correlated = self._mix_scores(correlated, w_key)

        # STEP 4: two more sorts place sorted originals at score ranks.
        _, order2 = rowsort_with_order(correlated, chunk_elems)
        return apply_inverse_permutation_rows(order2, X_sorted, chunk_elems)

    def _recolor_scores(self, z):
        """Empirically decorrelate iid normal scores, recolor to target.

        Returns ``y`` of the same (K, N) shape whose rows are standardized
        and whose EMPIRICAL Pearson correlation is exactly ``self.C`` —
        the Iman-Conover score pipeline (empirical decorrelation is the
        1982 paper's variance-reduction step) applied to random normal
        scores instead of van der Waerden rank scores.
        """
        # float32 matmul precision throughout: the GPU's DEFAULT TF32
        # rounds f32 inputs (~1e-3 relative), which measurably biases
        # the empirical-decorrelation factor and therefore the induced
        # correlation.  The f32 passes cost <1 ms even at (16, 1e8).
        with jax.default_matmul_precision("float32"):
            z = jnp.asarray(z)
            K, N = z.shape
            dtype = z.dtype
            acc_type = jnp.float64 if dtype == jnp.float64 else jnp.float32

            mean = jnp.mean(z, axis=1, keepdims=True)
            zc = z - mean
            gram = (
                jax.lax.dot_general(
                    zc,
                    zc,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=acc_type,
                ).astype(dtype)
                / N
            )
            std = jnp.sqrt(jnp.diagonal(gram))
            emp_corr = gram / jnp.outer(std, std)
            L = jnp.linalg.cholesky(emp_corr)
            eye = jnp.eye(K, dtype=dtype)
            inv_L = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
            M = jnp.asarray(self.P, dtype) @ inv_L
            return jax.lax.dot_general(
                M,
                zc / std[:, None],
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=acc_type,
            ).astype(dtype)

    def _apply_generated(self, z, x_sorted):
        """Two-sort Iman-Conover for engine-generated sampling.

        When the engine *generates* the samples (rather than transforming
        user data), the four-sort pipeline collapses: ``x_sorted`` rows are
        produced pre-sorted from uniform order statistics (no sort), and
        ``z`` rows are iid standard-normal scores (the variables' own
        quantile columns through ndtri) taking the role of the van der
        Waerden scores — the original Iman-Conover formulation with random
        normal scores; the decorrelation step removes their empirical
        correlation exactly as with rank-based scores.

        z : (K, N) iid normal scores.
        x_sorted : (K, N) ascending marginal values per variable.
        Returns (K, N) correlated samples with exact marginals.

        NOTE: the production engine no longer routes through this method —
        placing ``x_sorted`` at the ranks of the recolored scores yields
        the SAME rank structure as the direct quantile transform
        ``ppf(ndtr(y))`` (both are monotone in y), so the engine uses the
        sort-free copula form (see ``engine/compile.py``).  Kept for
        direct use on pre-sorted data.
        """
        from probabilit_tpu.ops.sort import (
            apply_inverse_permutation_rows,
            rowsort_with_order,
        )

        z = jnp.asarray(z)
        dtype = z.dtype
        correlated = self._mix_scores(self._recolor_scores(z))

        _, order2 = rowsort_with_order(correlated)
        return apply_inverse_permutation_rows(order2, jnp.asarray(x_sorted, dtype))


class StudentTCopula(ImanConover):
    """Marginal-preserving dependence induction through a Student-t copula.

    A capability beyond the reference: Iman-Conover — like EVERY
    Gaussian-copula method — has zero tail dependence, so joint extremes
    of correlated risks are asymptotically independent no matter the
    correlation (the classic critique of Gaussian dependence in risk
    aggregation).  The t-copula with ``df`` degrees of freedom keeps the
    same elliptical shape matrix but gives symmetric tail dependence
    ``lambda = 2 * t_{df+1}(-sqrt((df+1)(1-rho)/(1+rho)))``, decaying to
    the Gaussian's 0 as ``df -> inf``.

    Pipeline = Iman-Conover's four sorts + one matmul, plus one extra
    elementwise step: the recolored Gaussian scores ``y`` are divided by
    a per-OBSERVATION mixing scale ``sqrt(W/df)``, ``W ~ chi2(df)``
    shared across all K variables (that sharing is what couples the
    tails).  Rank placement then restores the exact original marginals,
    so like Iman-Conover this changes only the dependence structure.

    ``df``    tail-heaviness of the dependence (NOT of the marginals).
    ``seed``  keys the mixing draws when the correlator is applied to a
              plain array (``StudentTCopula(df)(X)``); inside the
              sampling engine the mixing stream derives from the run's
              own randomness instead (``engine/compile.py``).

    The target matrix is the copula's SHAPE matrix.  Kendall's tau
    obeys the same ``tau = (2/pi) * arcsin(rho)`` law as the Gaussian
    copula (true for all elliptical copulas), so rank agreement with
    ``ImanConover`` at equal targets is testable; Pearson correlations
    of transformed marginals drift slightly with small ``df``.

    Memory shape note: a single-shot engine run holds all K correlated
    columns plus the t-CDF conversion live at once, which exhausts a
    16 GB chip near ``n * K ~ 1e9`` (measured: K=10 at n=1e8 does not
    fit).  Big t-copula runs go through the streaming entry points
    (``estimate``/``sample_streaming`` with ``correlator=...``) — any
    size, O(block) memory.
    """

    gaussian_scores = False

    def __init__(self, df=4.0, ties="average", seed=0):
        super().__init__(ties=ties)
        df = float(df)
        if not df > 0.0:
            raise ValueError(f"df must be positive, got {df}.")
        self.df = df
        self.seed = int(seed)

    def _cache_token(self):
        return (type(self).__qualname__, self.df, self.ties, self.seed)

    def _mix_scale(self, n, dtype, w_key=None):
        """(n,) mixing scales sqrt(W/df), W ~ chi2(df) (``chi2_draws``)."""
        from probabilit_tpu.ops.special import chi2_draws

        if w_key is None:
            w_key = jax.random.PRNGKey(self.seed)
        w = chi2_draws(w_key, self.df, n, dtype)
        return jnp.sqrt(w / jnp.asarray(self.df, dtype))

    def _mix_scores(self, y, w_key=None):
        y = jnp.asarray(y)
        return y / self._mix_scale(y.shape[1], y.dtype, w_key)[None, :]

    def _mix_state(self, n, dtype, w_key=None):
        return self._mix_scale(n, dtype, w_key)

    def _copula_uniform_row(self, y_row, mix):
        from probabilit_tpu.ops import special as _special

        t = jnp.asarray(y_row) / mix
        return _special.t_cdf(t, jnp.asarray(self.df, t.dtype))


def decorrelate(X, remove_variance=True):
    """Remove covariance from X, preserving the mean.

    Reference ``correlation.py:706-754``.

    >>> X = np.array([[1. , 1. ],
    ...               [2. , 1.1],
    ...               [2.1, 3. ]])
    >>> np.asarray(np.cov(np.asarray(decorrelate(X)), rowvar=False)).round(6) + 0.0
    array([[1., 0.],
           [0., 1.]])
    """
    if isinstance(X, np.ndarray):
        # Eager host path: honor the input dtype (float64 in, float64
        # out).  The reference works in f64 throughout; going through
        # the default f32 device dtype here would leave ~1e-7 residual
        # correlations that break downstream f64-tolerance checks (e.g.
        # ``np.allclose(corrcoef(decorrelate(X)), eye)``).  K is small;
        # this is setup-time utility work, not the sampling hot path.
        X = np.asarray(X)
        N = X.shape[0]
        mean = X.mean(axis=0)
        Xc = X - mean
        cov = (Xc.T @ Xc) / (N - 1)
        L = np.linalg.cholesky(cov)
        if not remove_variance:
            L = L / np.sqrt(X.var(axis=0))
        Xw = np.linalg.solve(L, Xc.T).T
        return mean + Xw

    X = jnp.asarray(X)
    N = X.shape[0]
    mean = jnp.mean(X, axis=0)
    var = jnp.var(X, axis=0)
    Xc = X - mean
    # Statistics-bearing matmul/cholesky/solve: pin f32 precision or
    # TF32 rounds the inputs (~1e-3 residual correlation after
    # whitening) — same pin as every other correlator path in this file.
    with jax.default_matmul_precision("float32"):
        cov = (Xc.T @ Xc) / (N - 1)

        L = jnp.linalg.cholesky(cov)
        if not remove_variance:
            L = L / jnp.sqrt(var)

        Xw = jax.scipy.linalg.solve_triangular(L, Xc.T, lower=True).T
    return mean + Xw
