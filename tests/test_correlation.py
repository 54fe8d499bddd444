"""Correlation subsystem tests.

Mirrors the reference suites (tests/test_correlation.py,
tests/test_iman_conover.py): NCM vs the MATLAB ``nearcorr`` example and
Cholesky-decomposability sweeps; Iman-Conover invariants (marginal
preservation, error non-increase, identity fixpoint) over many seeds.
"""

import numpy as np
import pytest

from probabilit_tpu.correlation import (
    Cholesky,
    CorrelatorError,
    ImanConover,
    decorrelate,
    nearest_correlation_matrix,
)


@pytest.fixture
def sample_data(rng):
    """Mixed-marginal data and a random PD correlation target."""
    n, k = 200, 4
    X = np.column_stack(
        [
            rng.normal(size=n),
            rng.exponential(size=n),
            rng.uniform(size=n),
            rng.lognormal(size=n),
        ]
    )
    A = rng.normal(size=(k, k))
    C = A @ A.T + np.eye(k) * 0.5
    d = np.sqrt(np.diag(C))
    return X, C / np.outer(d, d)


class TestNearestCorrelationMatrix:
    @pytest.mark.parametrize("variables", range(2, 100, 10))
    def test_result_is_cholesky_decomposable(self, variables):
        rng = np.random.default_rng(variables)
        observations = rng.normal(size=(variables * 2, variables))
        matrix = np.corrcoef(observations, rowvar=False)
        np.linalg.cholesky(matrix)

        # Perturb it so it stops being PSD
        matrix = matrix + rng.normal(size=matrix.shape, scale=0.1)
        matrix = matrix - np.identity(variables) * np.mean(np.diag(matrix))
        with pytest.raises(np.linalg.LinAlgError):
            np.linalg.cholesky(matrix)

        fixed = nearest_correlation_matrix(matrix)
        np.linalg.cholesky(fixed)
        assert np.allclose(np.diag(fixed), 1.0)
        assert np.allclose(fixed, fixed.T)

    def test_matlab_nearcorr_weighted_example(self):
        # Matrices from the MathWorks 'nearcorr' documentation example.
        A = np.array(
            [
                [1.0, 0.0, 0.0, 0.0, -0.936],
                [0.0, 1.0, -0.55, -0.3645, -0.53],
                [0.0, -0.55, 1.0, -0.0351, 0.0875],
                [0.0, -0.3645, -0.0351, 1.0, 0.4557],
                [-0.936, -0.53, 0.0875, 0.4557, 1.0],
            ]
        )
        W = np.array(
            [
                [0.0, 1.0, 0.1, 0.15, 0.25],
                [1.0, 0.0, 0.05, 0.025, 0.15],
                [0.1, 0.05, 0.0, 0.25, 1.0],
                [0.15, 0.025, 0.25, 0.0, 0.25],
                [0.25, 0.15, 1.0, 0.25, 0.0],
            ]
        )
        matlab_Y = np.array(
            [
                [1.0, 0.0014, 0.0287, -0.0222, -0.8777],
                [0.0014, 1.0, -0.498, -0.7268, -0.4567],
                [0.0287, -0.498, 1.0, -0.0358, 0.0878],
                [-0.0222, -0.7268, -0.0358, 1.0, 0.4465],
                [-0.8777, -0.4567, 0.0878, 0.4465, 1.0],
            ]
        )
        Y = nearest_correlation_matrix(A, weights=W)
        assert np.allclose(Y, matlab_Y, atol=1e-4)

    def test_unweighted_higham_example(self):
        # The classic 3x3 example (Higham 2002).
        X = np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]], dtype=float)
        Y = nearest_correlation_matrix(X)
        expected = np.array(
            [
                [1.0, 0.76068985, 0.15729811],
                [0.76068985, 1.0, 0.76068985],
                [0.15729811, 0.76068985, 1.0],
            ]
        )
        assert np.allclose(Y, expected, atol=1e-5)

    def test_already_valid_matrix_unchanged(self):
        C = np.array([[1.0, 0.4], [0.4, 1.0]])
        assert np.allclose(nearest_correlation_matrix(C), C, atol=1e-5)

    def test_type_validation(self):
        with pytest.raises(TypeError):
            nearest_correlation_matrix([[1, 0], [0, 1]])
        with pytest.raises(TypeError):
            nearest_correlation_matrix(np.eye(2), weights=[[1, 1], [1, 1]])


class TestCorrelatorValidation:
    def test_must_set_target_first(self):
        with pytest.raises(CorrelatorError):
            ImanConover()(np.random.rand(10, 2))

    def test_target_validation(self):
        ic = ImanConover()
        with pytest.raises(ValueError, match="diagonal"):
            ic.set_target(np.array([[2.0, 0.0], [0.0, 1.0]]))
        with pytest.raises(ValueError, match="symmetric"):
            ic.set_target(np.array([[1.0, 0.5], [0.2, 1.0]]))
        with pytest.raises(ValueError, match="positive definite"):
            ic.set_target(np.array([[1.0, 1.5], [1.5, 1.0]]))
        with pytest.raises(TypeError):
            ic.set_target([[1, 0], [0, 1]])

    def test_shape_validation(self):
        ic = ImanConover().set_target(np.eye(2))
        with pytest.raises(ValueError, match="rows > columns"):
            ic(np.random.rand(2, 2))
        with pytest.raises(ValueError, match="must agree"):
            ic(np.random.rand(10, 3))


class TestImanConover:
    @pytest.mark.parametrize("seed", range(25))
    def test_marginals_preserved(self, seed):
        rng = np.random.default_rng(seed)
        X = np.column_stack(
            [rng.exponential(size=100), rng.uniform(size=100), rng.normal(size=100)]
        )
        C = np.array([[1, 0.5, 0.2], [0.5, 1, 0.4], [0.2, 0.4, 1]])
        Xt = np.asarray(ImanConover().set_target(C)(X))
        # Each column is a permutation of the original column.
        for k in range(X.shape[1]):
            np.testing.assert_allclose(
                np.sort(Xt[:, k]), np.sort(X[:, k]), rtol=1e-6
            )

    @pytest.mark.parametrize("seed", range(25))
    def test_error_does_not_increase(self, seed):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(150, 4))
        A = rng.normal(size=(4, 4))
        C = A @ A.T + np.eye(4)
        d = np.sqrt(np.diag(C))
        C = C / np.outer(d, d)
        Xt = np.asarray(ImanConover().set_target(C)(X))
        before = np.linalg.norm(np.corrcoef(X, rowvar=False) - C)
        after = np.linalg.norm(np.corrcoef(Xt, rowvar=False) - C)
        assert after <= before + 1e-9

    @pytest.mark.parametrize("seed", range(10))
    def test_identity_target_keeps_data_nearly_decorrelated(self, seed):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(500, 3))
        Xt = np.asarray(ImanConover().set_target(np.eye(3))(X))
        corr = np.corrcoef(Xt, rowvar=False)
        assert np.abs(corr - np.eye(3)).max() < 0.12

    def test_achieves_target_correlation_normal_data(self, rng):
        X = rng.normal(size=(2000, 2))
        C = np.array([[1, 0.7], [0.7, 1]])
        Xt = np.asarray(ImanConover().set_target(C)(X))
        achieved = np.corrcoef(Xt, rowvar=False)[0, 1]
        assert np.isclose(achieved, 0.7, atol=0.03)

    def test_mixed_marginals(self, sample_data):
        X, C = sample_data
        Xt = np.asarray(ImanConover().set_target(C)(X))
        achieved = np.corrcoef(Xt, rowvar=False)
        # Pearson targets degrade on heavy-tailed marginals (rank-space
        # induction; cf. reference docstring correlation.py:353-361).
        assert np.abs(achieved - C).max() < 0.25


class TestCholesky:
    def test_exact_pearson_correlation(self, rng):
        X = rng.normal(size=(100, 2))
        C = np.array([[1, 0.7], [0.7, 1]])
        Xt = np.asarray(Cholesky().set_target(C)(X))
        assert np.isclose(np.corrcoef(Xt, rowvar=False)[0, 1], 0.7, atol=1e-5)

    def test_mean_std_preserved(self, rng):
        X = rng.normal(loc=3.0, scale=2.0, size=(200, 3))
        C = np.array([[1, 0.5, 0.0], [0.5, 1, 0.3], [0.0, 0.3, 1]])
        Xt = np.asarray(Cholesky().set_target(C)(X))
        np.testing.assert_allclose(Xt.mean(axis=0), X.mean(axis=0), rtol=1e-4)
        np.testing.assert_allclose(Xt.std(axis=0), X.std(axis=0), rtol=1e-4)

    def test_does_not_preserve_marginals(self, rng):
        X = rng.uniform(size=(500, 2))
        C = np.array([[1, 0.9], [0.9, 1]])
        Xt = np.asarray(Cholesky().set_target(C)(X))
        # Uniform marginals are destroyed (values leave [0, 1])
        assert (Xt.min() < 0) or (Xt.max() > 1)


class TestDecorrelate:
    @pytest.mark.parametrize("seed", range(10))
    def test_identity_covariance(self, seed):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(100, 3)) @ rng.normal(size=(3, 3))
        Xd = np.asarray(decorrelate(X))
        np.testing.assert_allclose(
            np.cov(Xd, rowvar=False), np.eye(3), atol=1e-3
        )
        np.testing.assert_allclose(Xd.mean(axis=0), X.mean(axis=0), atol=1e-3)

    def test_float64_input_stays_float64(self):
        # Eager numpy input honors the input dtype (reference operates in
        # f64): the residual correlations must sit at f64 machine noise,
        # tight enough for np.allclose's default atol=1e-8 downstream.
        rng = np.random.default_rng(42)
        X = rng.normal(size=(5, 3))
        Xd = decorrelate(X)
        assert isinstance(Xd, np.ndarray) and Xd.dtype == np.float64
        np.testing.assert_allclose(
            np.corrcoef(Xd, rowvar=False), np.eye(3), atol=1e-12
        )

    def test_keep_variance(self, rng):
        X = rng.normal(size=(200, 2)) @ np.array([[1.0, 0.7], [0.0, 0.5]])
        Xd = np.asarray(decorrelate(X, remove_variance=False))
        cov = np.cov(Xd, rowvar=False)
        assert abs(cov[0, 1]) < 1e-4
        np.testing.assert_allclose(
            np.var(Xd, axis=0, ddof=1), np.var(X, axis=0, ddof=0), rtol=0.05
        )


class TestTieHandling:
    """Average-tie ranks: parity with the reference on discrete marginals."""

    def test_rankdata_average_matches_scipy(self, rng):
        import scipy.stats

        from probabilit_tpu.ops.correlation import rankdata

        X = rng.integers(0, 4, size=(60, 3)).astype(float)
        mine = np.asarray(rankdata(X, axis=0)) + 1.0
        ref = np.apply_along_axis(scipy.stats.rankdata, 0, X)
        np.testing.assert_allclose(mine, ref)

    def test_rankdata_f16_input_gets_f32_ranks(self):
        # Ranks must materialize in at least f32: f16 ranks round to the
        # data grid above 2048 rows.
        from probabilit_tpu.ops.correlation import rankdata

        import scipy.stats

        x = (np.arange(5000, dtype=np.float16) % 409).astype(np.float16)
        mine = np.asarray(rankdata(x)) + 1.0
        assert mine.dtype == np.float32
        np.testing.assert_allclose(mine, scipy.stats.rankdata(x.astype(np.float64)))

    def test_rankdata_f64_near_ties_stay_distinct(self):
        # An f32 cast before tie detection would merge f64 values closer
        # than f32 epsilon into false ties; under x64 they must rank
        # distinctly, like scipy.
        import jax

        import scipy.stats

        from probabilit_tpu.ops.correlation import rankdata

        x = np.array([1.0, 1.0 + 1e-12, 1.0 - 1e-12, 2.0], dtype=np.float64)
        old = jax.config.read("jax_enable_x64")
        try:
            jax.config.update("jax_enable_x64", True)
            mine = np.asarray(rankdata(x)) + 1.0
        finally:
            jax.config.update("jax_enable_x64", old)
        np.testing.assert_allclose(mine, scipy.stats.rankdata(x))

    def test_rankdata_ordinal_is_permutation(self, rng):
        from probabilit_tpu.ops.correlation import rankdata

        x = rng.normal(size=50)
        r = np.asarray(rankdata(x, method="ordinal"))
        assert sorted(r.tolist()) == list(range(50))

    def test_rankdata_ordinal_ties_match_scipy(self, rng):
        # Ordinal ranks promise POSITION-determined tie order (scipy
        # semantics), which requires the stable-sort path; an unstable
        # sort may permute equal keys arbitrarily per backend/version.
        import scipy.stats

        from probabilit_tpu.ops.correlation import rankdata

        x = rng.integers(0, 3, size=200).astype(float)  # heavy ties
        mine = np.asarray(rankdata(x, method="ordinal")) + 1
        np.testing.assert_array_equal(
            mine, scipy.stats.rankdata(x, method="ordinal")
        )

    def test_reference_doctest_tie_case(self):
        # The reference's own ImanConover doctest (correlation.py:315-330):
        # a fully tied 6x2 input must transform to this exact matrix.
        C = np.array([[1.0, 0.7], [0.7, 1.0]])
        X = np.array(
            [[0, 0], [0, 0.5], [0, 1], [1, 0], [1, 0.5], [1, 1]], dtype=float
        )
        out = np.asarray(ImanConover().set_target(C)(X))
        expected = np.array(
            [[0, 0], [0, 0], [0, 0.5], [1, 0.5], [1, 1], [1, 1]], dtype=float
        )
        np.testing.assert_allclose(out, expected)

    def test_perfect_rank_correlation_raises(self, rng):
        # Duplicated discrete columns have singular rank correlation; the
        # eager path must raise like the reference (correlation.py:399-403).
        col = rng.integers(0, 2, size=500).astype(float)
        X = np.column_stack([col, col])
        C = np.array([[1.0, 0.5], [0.5, 1.0]])
        with pytest.raises(ValueError, match="positive definite"):
            ImanConover().set_target(C)(X)

    def test_discrete_marginals_hit_target(self, rng):
        # bernoulli + normal: ties dominate one column; average-rank
        # scores + per-column standardization must still induce a rank
        # correlation near the target while preserving marginals exactly.
        X = np.column_stack(
            [rng.integers(0, 2, size=4000).astype(float), rng.normal(size=4000)]
        )
        C = np.array([[1.0, 0.6], [0.6, 1.0]])
        out = np.asarray(ImanConover().set_target(C)(X))
        for k in range(2):
            np.testing.assert_allclose(np.sort(out[:, k]), np.sort(X[:, k]))
        achieved = np.corrcoef(out, rowvar=False)[0, 1]
        assert abs(achieved - 0.6) < 0.1

    def test_ordinal_mode_continuous_equivalent(self, rng):
        X = rng.normal(size=(300, 3))
        C = np.eye(3) * 0.5 + 0.5
        a = np.asarray(ImanConover(ties="average").set_target(C)(X))
        b = np.asarray(ImanConover(ties="ordinal").set_target(C)(X))
        np.testing.assert_allclose(a, b)

    def test_correlated_discrete_nodes_in_graph(self):
        # Graph-level: correlate a bernoulli ISN with a continuous one.
        from probabilit_tpu.modeling import Distribution

        a = Distribution("bernoulli", p=0.5)
        b = Distribution("norm")
        corr = np.array([[1.0, 0.5], [0.5, 1.0]])
        sink = (a + b).correlate(a, b, corr_mat=corr)
        sink.sample(4000, random_state=0)
        sa, sb = np.asarray(a.samples_), np.asarray(b.samples_)
        assert set(np.unique(sa)) <= {0.0, 1.0}
        achieved = np.corrcoef(sa, sb)[0, 1]
        assert abs(achieved - 0.5) < 0.12


class TestStudentTCopula:
    """t-copula dependence induction (framework extension; no reference
    counterpart — Iman-Conover is Gaussian-copula and has zero tail
    dependence)."""

    def _joint_tail(self, a, b, q=0.99):
        ta, tb = np.quantile(a, q), np.quantile(b, q)
        return float(np.mean((a > ta) & (b > tb)) / (1 - q))

    def test_validation(self):
        from probabilit_tpu.correlation import StudentTCopula

        with pytest.raises(ValueError, match="df must be positive"):
            StudentTCopula(df=0.0)
        with pytest.raises(ValueError, match="ties"):
            StudentTCopula(df=2.0, ties="bogus")

    def test_exact_transform_preserves_marginals(self, rng):
        from probabilit_tpu.correlation import StudentTCopula

        X = np.column_stack(
            [rng.normal(size=3000), rng.exponential(size=3000), rng.uniform(size=3000)]
        ).astype(np.float32)
        C = np.array([[1, 0.7, 0.3], [0.7, 1, 0.2], [0.3, 0.2, 1.0]])
        Y = np.asarray(StudentTCopula(df=3.0, seed=1).set_target(C)(X))
        for k in range(3):
            np.testing.assert_array_equal(np.sort(Y[:, k]), np.sort(X[:, k]))

    def test_kendall_tau_matches_elliptical_law(self, rng):
        # tau = (2/pi) arcsin(rho) holds for EVERY elliptical copula, so
        # the t-copula must land on the same tau as the Gaussian target.
        from scipy import stats as sps

        from probabilit_tpu.correlation import StudentTCopula

        X = rng.normal(size=(20000, 2)).astype(np.float32)
        C = np.array([[1, 0.7], [0.7, 1.0]])
        Y = np.asarray(StudentTCopula(df=3.0, seed=2).set_target(C)(X))
        tau = sps.kendalltau(Y[:, 0], Y[:, 1]).statistic
        assert abs(tau - 2 / np.pi * np.arcsin(0.7)) < 0.03

    def test_tail_dependence_beats_gaussian(self, rng):
        # df=2, rho=0.3: t-copula joint 99% exceedance ~0.31 (its tail
        # dependence lambda), Gaussian ~0.06 and decaying to zero.
        from probabilit_tpu.correlation import StudentTCopula

        X = rng.normal(size=(200000, 2)).astype(np.float32)
        C = np.array([[1, 0.3], [0.3, 1.0]])
        Yt = np.asarray(StudentTCopula(df=2.0, seed=1).set_target(C)(X))
        Yg = np.asarray(ImanConover().set_target(C)(X))
        jt = self._joint_tail(Yt[:, 0], Yt[:, 1])
        jg = self._joint_tail(Yg[:, 0], Yg[:, 1])
        assert jt > 3.0 * jg
        assert 0.15 < jt < 0.5

    def test_engine_generated_path(self):
        # correlate() + sample(correlator=StudentTCopula(...)) through the
        # in-program RNG fast path: exact iid marginals, elliptical tau,
        # strong joint tails.
        from scipy import stats as sps

        from probabilit_tpu.correlation import StudentTCopula
        from probabilit_tpu.modeling import Distribution

        a = Distribution("norm")
        b = Distribution("expon")
        C = np.array([[1, 0.6], [0.6, 1.0]])
        model = (a + b).correlate(a, b, corr_mat=C.copy())
        model.sample(200000, random_state=0, correlator=StudentTCopula(df=3))
        sa, sb = np.asarray(a.samples_), np.asarray(b.samples_)
        assert sps.kstest(sa[:5000], "norm").pvalue > 0.01
        assert sps.kstest(sb[:5000], "expon").pvalue > 0.01
        tau = sps.kendalltau(sa[:20000], sb[:20000]).statistic
        assert abs(tau - 2 / np.pi * np.arcsin(0.6)) < 0.03
        model.sample(200000, random_state=0, correlator="imanconover")
        ga, gb = np.asarray(a.samples_), np.asarray(b.samples_)
        assert self._joint_tail(sa, sb) > 1.7 * self._joint_tail(ga, gb)

    def test_engine_quantile_path(self):
        # method="sobol" (no in-program key): the mixing stream derives
        # from the leading quantile bits, reference-rvs style.
        from scipy import stats as sps

        from probabilit_tpu.correlation import StudentTCopula
        from probabilit_tpu.modeling import Distribution

        a = Distribution("norm")
        b = Distribution("uniform")
        C = np.array([[1, 0.5], [0.5, 1.0]])
        model = (a * b).correlate(a, b, corr_mat=C.copy())
        model.sample(65536, random_state=3, method="sobol", correlator=StudentTCopula(df=4))
        sa, sb = np.asarray(a.samples_), np.asarray(b.samples_)
        tau = sps.kendalltau(sa[:20000], sb[:20000]).statistic
        assert abs(tau - 2 / np.pi * np.arcsin(0.5)) < 0.03

    def test_correlator_name_and_cache_tokens(self):
        # "tcopula" resolves; different df instances must not share a
        # compiled program (distinct cache tokens).
        from probabilit_tpu.correlation import StudentTCopula
        from probabilit_tpu.engine import compile as _compile

        assert _compile.resolve_correlator("tcopula") is StudentTCopula
        t3 = StudentTCopula(df=3)._cache_token()
        t5 = StudentTCopula(df=5)._cache_token()
        assert t3 != t5
        assert _compile.correlator_token(StudentTCopula(df=3)) == t3

    def test_seed_controls_exact_path_mixing(self, rng):
        from probabilit_tpu.correlation import StudentTCopula

        X = rng.normal(size=(1000, 2)).astype(np.float32)
        C = np.array([[1, 0.4], [0.4, 1.0]])
        y1 = np.asarray(StudentTCopula(df=3, seed=1).set_target(C)(X))
        y2 = np.asarray(StudentTCopula(df=3, seed=2).set_target(C)(X))
        y1b = np.asarray(StudentTCopula(df=3, seed=1).set_target(C)(X))
        assert np.array_equal(y1, y1b)
        assert not np.array_equal(y1, y2)

    def test_mesh_agrees_with_single_device(self):
        from probabilit_tpu.correlation import StudentTCopula
        from probabilit_tpu.modeling import Distribution
        from probabilit_tpu.parallel import make_mesh, use_mesh

        a = Distribution("norm")
        b = Distribution("norm", loc=2)
        C = np.array([[1, 0.5], [0.5, 1.0]])
        model = (a + b).correlate(a, b, corr_mat=C.copy())
        base = np.asarray(
            model.sample(8192, random_state=0, correlator=StudentTCopula(df=4))
        )
        with use_mesh(make_mesh()):
            sharded = np.asarray(
                model.sample(8192, random_state=0, correlator=StudentTCopula(df=4))
            )
        np.testing.assert_allclose(base, sharded, rtol=1e-3, atol=1e-3)
