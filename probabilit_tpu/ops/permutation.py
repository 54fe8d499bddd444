"""Permutation-based correlation refinement.

Reference: ``correlation.py:428-921``.  Three pieces:

* :class:`CorrelationMatrix` — O(s*n) incremental correlation updates under
  row swaps within one column (host/NumPy: this is the *bookkeeping* API
  used directly by tests and small-sample workflows).
* :class:`SwapIndexGenerator` — streams disjoint index pairs.
* :class:`PermutationCorrelator` — randomized hill-climbing that permutes
  rows within columns until corr(X) approaches a target.  The reference
  runs thousands of tiny Python iterations (``correlation.py:656-701``, a
  listed hot loop); here the entire climb compiles to ONE
  ``lax.while_loop`` program: per step it proposes a masked batch of swaps,
  computes the O(s*K) correlation delta, and accepts/commits functionally.
  No per-iteration Python dispatch, data stays on device.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from probabilit_tpu.ops.correlation import Correlator

__all__ = ["CorrelationMatrix", "SwapIndexGenerator", "PermutationCorrelator"]


def _rankdata_np(X, axis=0):
    """Average-tie ranks (1-based) along an axis, scipy-compatible."""
    import scipy.stats

    return np.apply_along_axis(scipy.stats.rankdata, axis, X)


class CorrelationMatrix:
    """Fast incremental correlation updates when swapping rows in a column.

    Recomputing corr(X) after a swap costs O(m n^2); only row/column ``k``
    of the correlation matrix changes, and of the Pearson numerator
    ``sum x_i y_i`` only the swapped terms change, giving O(s n) per
    proposal (reference ``correlation.py:757-921``).

    Examples
    --------
    >>> rng = np.random.default_rng(42)
    >>> X = rng.normal(size=(9, 4))
    >>> cm = CorrelationMatrix(X)
    >>> new_col = cm.update_column(col=0, i=2, j=3)
    >>> X[2, 0], X[3, 0] = X[3, 0], X[2, 0]
    >>> bool(np.allclose(new_col, np.corrcoef(X, rowvar=False)[:, 0]))
    True
    """

    def __init__(self, X, correlation_type="pearson", check=True):
        valid_corrs = ("pearson", "spearman")
        assert correlation_type in valid_corrs
        assert X.ndim == 2

        self.correlation_type = correlation_type
        self.check = check
        self.X = np.array(X, dtype=float, copy=True)

        if correlation_type == "pearson":
            self.X_ = self.X
        else:  # spearman: Pearson on the column ranks
            self.X_ = _rankdata_np(self.X, axis=0)

        self.m, self.n = self.X_.shape
        centered = self.X_ - np.mean(self.X_, axis=0)
        self.numerator = (centered.T @ centered) / self.m
        self.denominator = np.std(centered, axis=0)
        if np.any(np.isclose(self.denominator, 0)):
            raise ValueError("X has one or several constant columns")
        self.corr_mat = self.numerator / np.outer(self.denominator, self.denominator)

    def __repr__(self):
        return repr(self.corr_mat)

    def __getitem__(self, *args, **kwargs):
        return self.corr_mat.__getitem__(*args, **kwargs)

    def _delta_numerator(self, col, i, j):
        """Change of numerator row ``col`` when swapping rows i <-> j there."""
        if self.check:
            assert isinstance(col, (int, np.integer))
            assert 0 <= col < self.n
            if isinstance(i, (int, np.integer)):
                i = [i]
            if isinstance(j, (int, np.integer)):
                j = [j]
            assert len(i) == len(j)
            if set(np.asarray(i).tolist()).intersection(set(np.asarray(j).tolist())):
                raise ValueError(f"Swaps must be two disjoint sets, got {i} and {j}")

        rows_i = self.X_[i, :]
        rows_j = self.X_[j, :]
        swap_delta = (rows_j[:, col] - rows_i[:, col])[:, None]
        delta = np.sum((rows_i - rows_j) * swap_delta, axis=0)
        delta[col] = 0.0
        return delta

    def delta_column(self, col, i, j):
        """Change of correlation column ``col`` for the proposed swap."""
        delta = self._delta_numerator(col, i, j)
        return delta / (self.m * self.denominator * self.denominator[col])

    def update_column(self, col, i, j):
        """New value of correlation column ``col`` for the proposed swap."""
        return self.corr_mat[:, col] + self.delta_column(col, i, j)

    def commit(self, col, i, j):
        """Apply a proposed swap: update data, numerator and correlations."""
        delta_num = self._delta_numerator(col, i, j)
        delta_col = delta_num / (self.m * self.denominator * self.denominator[col])

        self.corr_mat[:, col] += delta_col
        self.corr_mat[col, :] += delta_col
        # numerator is stored /m (see __init__), so the raw sum-delta is
        # scaled to match.  (The reference adds the raw delta to its
        # /m-normalized numerator — correlation.py:846,873 — leaving that
        # public state wrong by ~m on changed entries; its corr_mat stays
        # right only because delta_column re-divides independently.)
        self.numerator[:, col] += delta_num / self.m
        self.numerator[col, :] += delta_num / self.m

        self.X_[i, col], self.X_[j, col] = self.X_[j, col], self.X_[i, col]
        if self.correlation_type == "spearman":
            self.X[i, col], self.X[j, col] = self.X[j, col], self.X[i, col]
        return self


@dataclasses.dataclass
class SwapIndexGenerator:
    """Streams tuples of disjoint index arrays from a recycled permutation.

    Reference ``correlation.py:428-470``.

    Examples
    --------
    >>> rng = np.random.default_rng(42)
    >>> gen = SwapIndexGenerator(rng=rng, n=9)
    >>> i, j = gen(2)
    >>> len(set(i.tolist()) & set(j.tolist()))
    0
    """

    def __init__(self, rng, n: int):
        assert n >= 2
        self.rng = rng
        self.indices = np.arange(n)
        self.permutation = self.rng.permutation(self.indices)

    def __call__(self, size: int):
        assert size >= 1
        size = min(size, len(self.indices) // 2)
        chosen = self.permutation[: 2 * size]
        self.permutation = self.permutation[2 * size :]
        if len(chosen) < 2 * size:
            self.permutation = self.rng.permutation(self.indices)
            return self.__call__(size=size)
        return chosen[:size], chosen[size:]


class PermutationCorrelator(Correlator):
    """Randomized hill-climbing correlation induction by row permutation.

    Same contract as the reference (``correlation.py:473-703``): cycles
    through columns, proposes batches of row swaps whose size follows a
    closed-form cooling schedule, accepts proposals that reduce the
    weighted error against the target, and stops on tolerance or after
    ``iterations`` cycles.  Supports "pearson" and "spearman" and
    elementwise weights.

    The climb itself runs as one compiled ``lax.while_loop`` with an
    incremental O(s*K) correlation update per step.

    Examples
    --------
    >>> rng = np.random.default_rng(42)
    >>> X = rng.normal(size=(100, 2))
    >>> target = np.array([[1, 0.7], [0.7, 1]])
    >>> pc = PermutationCorrelator(seed=0).set_target(target)
    >>> X_t = np.asarray(pc(X))
    >>> bool(abs(np.corrcoef(X_t, rowvar=False)[0, 1] - 0.7) < 0.1)
    True
    """

    def __init__(
        self,
        *,
        weights=None,
        iterations=1000,
        tol=0.01,
        correlation_type="pearson",
        seed=None,
        verbose=False,
    ):
        # Same ctor contract as the reference correlator, own wording.
        if weights is not None and not np.all(weights > 0):
            raise ValueError(
                "Every entry of weights must be strictly positive."
            )
        if not isinstance(iterations, int) or iterations < 0:
            raise ValueError(
                f"iterations must be an integer >= 0, got {iterations!r}."
            )
        if not isinstance(tol, (int, float)) or tol <= 0:
            raise ValueError(f"tol must be a number > 0, got {tol!r}.")
        if seed is not None and not isinstance(seed, int):
            raise TypeError(f"seed must be None or an int, got {seed!r}.")
        if not isinstance(verbose, bool):
            raise TypeError(f"verbose must be a bool, got {verbose!r}.")

        self.iters = iterations
        self.tol = tol
        self.seed = seed if seed is not None else np.random.SeedSequence().entropy % 2**31
        self.verbose = verbose
        self.correlation_type = correlation_type
        if weights is not None:
            self._init_weights = np.asarray(weights, float)
        else:
            self._init_weights = None

    def set_target(self, correlation_matrix, *, weights=None):
        super().set_target(correlation_matrix)
        if weights is None:
            weights = (
                self._init_weights
                if self._init_weights is not None
                else np.ones_like(self.C)
            )
        self.weights = weights / np.sum(weights)
        self.triu_indices = np.triu_indices(self.C.shape[0], k=1)
        return self

    def _error(self, observed, target):
        """Weighted RMSE over the strict upper triangle."""
        idx = self.triu_indices
        observed = np.asarray(observed)
        target = np.asarray(target)
        weighted = self.weights[idx] * (observed[idx] - target[idx]) ** 2.0
        return float(np.sqrt(np.sum(weighted)))

    @staticmethod
    def subiters(n, i):
        """Cooling schedule: swap batch size at iteration ``i`` of ``n``.

        Closed form of the halving pattern [C, ..., 2, 2, 1, 1, 1, 1] with
        C = log2(n) + 1 (reference ``correlation.py:604-617``).
        """
        C = np.log2(n) + 1
        return int(np.ceil(C ** (1 - (2 * i / n))))

    def __call__(self, X):
        self._validate_X(X, check_rows_cols=False)
        num_obs, num_vars = X.shape
        if not num_vars == self.C.shape[0]:
            raise ValueError(
                "Number of variables in `X` does not match `correlation_matrix`."
            )
        return self._apply(jnp.asarray(X))

    def _apply(self, X):
        X = jnp.asarray(X)
        num_obs, num_vars = X.shape
        # Reference semantics (correlation.py:493-495, 656-668):
        # iterations=0 means "run until tolerance, unbounded".  A traced
        # while_loop supports that directly — the step bound drops out of
        # the loop condition and only the tolerance check remains (like
        # the reference, a target below the reachable error never
        # terminates).  The cooling schedule uses n = 10,000 in that
        # mode, exactly as the reference's subiters call does.
        unbounded = self.iters == 0
        total_iters = self.iters if self.iters else 10_000
        n_sched = self.iters if self.iters else 10_000
        cooling_c = np.log2(n_sched) + 1.0
        # A swap batch can never exceed floor(N/2) disjoint pairs; when
        # the schedule's ceiling crowds the row count, switch to
        # permutation-drawn (exactly disjoint) pairs.
        max_pairs = max(1, min(int(np.ceil(cooling_c)), num_obs // 2))
        small_n = num_obs < 4 * int(np.ceil(cooling_c))

        spearman = self.correlation_type == "spearman"
        if spearman:
            from probabilit_tpu.ops.correlation import rankdata

            Xw = rankdata(X, axis=0).astype(X.dtype) + 1.0
        else:
            Xw = X

        target = jnp.asarray(self.C, X.dtype)
        weights = jnp.asarray(self.weights, X.dtype)
        triu_mask = jnp.triu(jnp.ones((num_vars, num_vars), bool), k=1)

        mean = jnp.mean(Xw, axis=0)
        centered = Xw - mean
        # float32 precision: the GPU's DEFAULT TF32 rounding would bias
        # the correlation estimate the hill-climb optimises against.
        with jax.default_matmul_precision("float32"):
            numerator = (centered.T @ centered) / num_obs
        denominator = jnp.std(Xw, axis=0)
        corr = numerator / jnp.outer(denominator, denominator)

        def full_error(corr):
            w = jnp.where(triu_mask, weights, 0.0)
            return jnp.sqrt(jnp.sum(w * (corr - target) ** 2))

        tol = self.tol
        key0 = jax.random.PRNGKey(int(self.seed))

        # Unbounded mode (iterations=0, reference parity: run until
        # tolerance) dispatches the compiled loop in 10,000-cycle chunks
        # from a host loop — same unbounded semantics, but a target below
        # the reachable error leaves the process interruptible between
        # chunks instead of hung inside one uninterruptible device
        # program.  Bounded mode stays a single dispatch.
        chunk_steps = 10_000 * num_vars

        def cond_bounded(state):
            step, _, _, _, err, _ = state
            return (step < total_iters * num_vars) & (err >= tol)

        # Reference-parity progress lines (correlation.py:662-676): every
        # iters//10 iterations at the top of a cycle (the reference emits
        # none in the unbounded mode — its print condition can never fire
        # there).  jax.debug.print is the only way to print from inside a
        # compiled while_loop.
        print_every = self.iters // 10 if self.iters >= 10 else 0
        verbose_inloop = self.verbose and print_every > 0

        def body(state):
            step, Xw, Xo, corr, err, key = state
            iteration = step // num_vars + 1
            k = step % num_vars

            # Cooling schedule, evaluated with jnp so it stays traced.
            num_swaps = jnp.ceil(
                cooling_c ** (1.0 - 2.0 * iteration.astype(X.dtype) / n_sched)
            ).astype(jnp.int32)

            key, sub = jax.random.split(key)
            in_batch = jnp.arange(max_pairs) < jnp.minimum(num_swaps, max_pairs)
            if small_n:
                # Few rows: draw pairs from a shuffled permutation (the
                # reference's SwapIndexGenerator design) — exactly
                # disjoint by construction.  Rejection sampling below
                # would collide on nearly every draw when
                # 2*max_pairs ~ num_obs (e.g. 5 rows, 11 scheduled
                # swaps) and silently propose NOTHING, so the climb
                # never improved on small inputs.
                perm = jax.random.permutation(sub, num_obs)
                ii, jj = perm[:max_pairs], perm[max_pairs : 2 * max_pairs]
                pair_ok = in_batch
            else:
                # Many rows: cheap independent draws; reject the rare
                # colliding pairs (a full permutation per step would be
                # an O(n log n) sort at every swap batch).
                flat = jax.random.randint(sub, (2 * max_pairs,), 0, num_obs)
                ii, jj = flat[:max_pairs], flat[max_pairs:]
                dup = (flat[:, None] == flat[None, :]) & ~jnp.eye(
                    2 * max_pairs, dtype=bool
                )
                has_dup = jnp.any(dup, axis=1)
                pair_ok = in_batch & ~(has_dup[:max_pairs] | has_dup[max_pairs:])

            rows_i = Xw[ii, :]
            rows_j = Xw[jj, :]
            swap_delta = (rows_j[:, k] - rows_i[:, k])[:, None]
            delta_num = jnp.sum(
                jnp.where(pair_ok[:, None], (rows_i - rows_j) * swap_delta, 0.0),
                axis=0,
            )
            delta_num = delta_num.at[k].set(0.0)
            delta_col = delta_num / (num_obs * denominator * denominator[k])

            old_col = corr[:, k]
            new_col = old_col + delta_col
            w = weights[k, :]
            old_err = jnp.average((target[:, k] - old_col) ** 2, weights=w)
            new_err = jnp.average((target[:, k] - new_col) ** 2, weights=w)
            accept = new_err < old_err

            def commit(args):
                Xw, Xo, corr = args
                corr = corr.at[:, k].add(delta_col)
                corr = corr.at[k, :].add(delta_col)
                vi = Xw[ii, k]
                vj = Xw[jj, k]
                sel_i = jnp.where(pair_ok, vj, vi)
                sel_j = jnp.where(pair_ok, vi, vj)
                Xw = Xw.at[ii, k].set(sel_i).at[jj, k].set(sel_j)
                oi = Xo[ii, k]
                oj = Xo[jj, k]
                Xo = Xo.at[ii, k].set(jnp.where(pair_ok, oj, oi))
                Xo = Xo.at[jj, k].set(jnp.where(pair_ok, oi, oj))
                return Xw, Xo, corr

            # corr evolves by delta_col alone; a numerator carry would be
            # write-only state (delta_num is recomputed from Xw each step).
            Xw, Xo, corr = jax.lax.cond(
                accept, commit, lambda args: args, (Xw, Xo, corr)
            )

            err = jax.lax.cond(
                k == num_vars - 1, lambda c: full_error(c), lambda c: err, corr
            )

            if verbose_inloop:
                jax.lax.cond(
                    (k == 0) & (iteration % print_every == 0),
                    lambda: jax.debug.print(
                        " Iter {i:>6}  Error: {e:.6f} Swaps: {s:>2}",
                        i=iteration,
                        e=err,
                        s=num_swaps,
                    ),
                    lambda: None,
                )
            return (step + 1, Xw, Xo, corr, err, key)

        if self.verbose:
            print(
                "Running permutation correlator for "
                f"{self.iters if self.iters else 'inf'} iterations."
            )
        err0 = full_error(corr)
        state = (jnp.int32(0), Xw, X, corr, err0, key0)
        if unbounded:

            @jax.jit
            def run_chunk(state, limit):
                def cond(s):
                    return (s[0] < limit) & (s[4] >= tol)

                return jax.lax.while_loop(cond, body, state)

            limit = chunk_steps
            while True:
                state = run_chunk(state, jnp.int32(limit))
                # NOT (err >= tol) rather than err < tol: a NaN error
                # (constant or non-finite column makes every correlation
                # NaN) exits the device loop immediately without
                # advancing — mirroring the reference's `while error >=
                # tol` host loop, which also falls through on NaN and
                # returns the data unchanged.  `err < tol` would instead
                # spin ~2^31/chunk no-op dispatches into the safety
                # valve's misleading error.
                err_now = float(state[4])
                if not (err_now >= tol):
                    if np.isnan(err_now):
                        import warnings

                        warnings.warn(
                            "PermutationCorrelator error is NaN (constant "
                            "or non-finite column?); returning the data "
                            "unchanged.",
                            stacklevel=3,
                        )
                    break
                if limit >= 2**31 - chunk_steps:
                    # int32 step-counter safety valve, ~2e5x beyond any
                    # practical run; a clear error beats silent overflow.
                    raise RuntimeError(
                        "PermutationCorrelator(iterations=0) did not reach "
                        f"tol={tol} within 2^31 column steps; the target "
                        "correlation may be unreachable for this data."
                    )
                limit += chunk_steps
        else:
            state = jax.lax.while_loop(cond_bounded, body, state)
        _, Xw_final, Xo_final, corr_final, err_final, _ = state

        if self.verbose:
            print(
                f"Permutation correlator finished: error {float(err_final):.6f} "
                f"after at most "
                f"{'inf' if unbounded else total_iters} iterations."
            )
        return Xo_final if spearman else Xw_final
