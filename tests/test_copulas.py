"""Archimedean copula suite: samplers, graph nodes, QuantileTransform.

Framework extension beyond the reference (whose only dependence tools
are correlation-matrix correlators): validates each family against its
closed-form Kendall tau and tail-dependence coefficients, then the full
compositional workflow (copula -> QuantileTransform -> arithmetic) at
the graph level.
"""

import jax
import numpy as np
import pytest
from scipy import stats

from probabilit_tpu.ops import copulas


class TestCopulaKernels:
    @pytest.mark.parametrize(
        "family,theta,tau_true",
        [
            ("clayton", 2.0, 0.5),
            ("clayton", 0.5, 0.2),
            ("gumbel", 2.0, 0.5),
            ("gumbel", 1.5, 1 - 1 / 1.5),
            ("gumbel", 1.0, 0.0),
        ],
    )
    def test_kendall_tau_closed_forms(self, family, theta, tau_true):
        key = jax.random.PRNGKey(hash((family, theta)) % (2**31))
        U = np.asarray(copulas.sample(family, key, (15000, 2), theta, np.float32))
        tau = stats.kendalltau(U[:, 0], U[:, 1]).statistic
        assert abs(tau - tau_true) < 0.03

    def test_frank_tau_debye(self):
        from scipy.integrate import quad

        theta = 5.0
        d1 = quad(lambda t: t / np.expm1(t), 0, theta)[0] / theta
        tau_true = 1 - 4 / theta * (1 - d1)
        U = np.asarray(
            copulas.sample("frank", jax.random.PRNGKey(3), (15000, 2), theta, np.float32)
        )
        tau = stats.kendalltau(U[:, 0], U[:, 1]).statistic
        assert abs(tau - tau_true) < 0.03

    @pytest.mark.parametrize("family,theta", [("clayton", 2.0), ("gumbel", 2.0), ("frank", 5.0)])
    def test_marginals_uniform(self, family, theta):
        U = np.asarray(
            copulas.sample(family, jax.random.PRNGKey(1), (20000, 3), theta, np.float32)
        )
        assert U.min() > 0.0 and U.max() < 1.0
        for j in range(3):
            assert stats.kstest(U[:8000, j], "uniform").pvalue > 0.005, (family, j)

    def test_clayton_lower_tail_dependence(self):
        # lambda_L = 2^(-1/theta); the upper tail is asymptotically free.
        U = np.asarray(
            copulas.sample("clayton", jax.random.PRNGKey(2), (200000, 2), 2.0, np.float32)
        )
        lo = np.mean((U[:, 0] < 0.01) & (U[:, 1] < 0.01)) / 0.01
        hi = np.mean((U[:, 0] > 0.99) & (U[:, 1] > 0.99)) / 0.01
        assert lo > 3 * hi
        assert abs(lo - 2 ** (-1 / 2.0)) < 0.15

    def test_gumbel_upper_tail_dependence(self):
        # lambda_U = 2 - 2^(1/theta); mirror image of Clayton.
        U = np.asarray(
            copulas.sample("gumbel", jax.random.PRNGKey(2), (200000, 2), 2.0, np.float32)
        )
        lo = np.mean((U[:, 0] < 0.01) & (U[:, 1] < 0.01)) / 0.01
        hi = np.mean((U[:, 0] > 0.99) & (U[:, 1] > 0.99)) / 0.01
        assert hi > 3 * lo
        assert abs(hi - (2 - 2**0.5)) < 0.15

    def test_validation(self):
        with pytest.raises(ValueError, match="Unknown copula family"):
            copulas.validate("gaussian", 1.0, 2)
        with pytest.raises(ValueError, match="d >= 2"):
            copulas.validate("clayton", 1.0, 1)
        with pytest.raises(ValueError, match="theta > 0"):
            copulas.validate("clayton", 0.0, 2)
        with pytest.raises(ValueError, match="theta >= 1"):
            copulas.validate("gumbel", 0.5, 2)
        # frank theta < 0 is now VALID for d=2 (negative dependence);
        # theta=0 and d>2 negatives stay rejected (TestNegativeFrank).
        copulas.validate("frank", -1.0, 2)

    def test_log_series_pmf(self):
        # Kemp LK sampler against the Logarithmic(p) pmf p^k / (-k ln(1-p)).
        p = 0.8
        v = np.asarray(
            copulas._log_series(
                jax.random.PRNGKey(0), (100000,), np.log1p(-p), np.float32
            )
        )
        assert v.min() >= 1.0
        norm = -np.log1p(-p)
        for k in (1, 2, 3, 4):
            expected = p**k / (k * norm)
            observed = np.mean(v == k)
            assert abs(observed - expected) < 0.006, k


class TestCopulaGraph:
    def test_factories_unpack_marginal_nodes(self):
        from probabilit_tpu import ClaytonCopula
        from probabilit_tpu.models.distributions import (
            CopulaDistribution,
            MarginalDistribution,
        )

        u1, u2, u3 = ClaytonCopula(theta=1.0, d=3)
        assert all(isinstance(u, MarginalDistribution) for u in (u1, u2, u3))
        assert isinstance(u1.distr, CopulaDistribution)
        assert u1.distr is u2.distr  # one shared copula parent

    def test_end_to_end_marginals_and_tau(self):
        from probabilit_tpu import ClaytonCopula, QuantileTransform

        u1, u2 = ClaytonCopula(theta=2.0)
        x1 = QuantileTransform(u1, "lognorm", s=0.5)
        x2 = QuantileTransform(u2, "expon", scale=2.0)
        (x1 + x2).sample(60000, random_state=0)
        s1, s2 = np.asarray(x1.samples_), np.asarray(x2.samples_)
        assert stats.kstest(s1[:8000], "lognorm", args=(0.5,)).pvalue > 0.01
        assert stats.kstest(s2[:8000], "expon", args=(0, 2.0)).pvalue > 0.01
        tau = stats.kendalltau(s1[:15000], s2[:15000]).statistic
        # Kendall tau is rank-based: invariant under the monotone
        # QuantileTransform, so the copula's tau = theta/(theta+2) holds.
        assert abs(tau - 0.5) < 0.03

    def test_reproducible_and_copyable(self):
        from probabilit_tpu import GumbelCopula, QuantileTransform

        a, b = GumbelCopula(theta=1.8)
        m = QuantileTransform(a, "norm") + QuantileTransform(b, "norm")
        r1 = np.asarray(m.sample(4096, random_state=7))
        r2 = np.asarray(m.sample(4096, random_state=7))
        np.testing.assert_array_equal(r1, r2)
        r3 = np.asarray(m.copy().sample(4096, random_state=7))
        np.testing.assert_array_equal(r1, r3)

    def test_positive_dependence_raises_sum_variance(self):
        from probabilit_tpu import GumbelCopula, QuantileTransform

        parts = [
            QuantileTransform(u, "norm") for u in GumbelCopula(theta=1.8, d=3)
        ]
        s = np.asarray((parts[0] + parts[1] + parts[2]).sample(30000, random_state=1))
        assert s.var() > 4.0  # independent would be 3.0

    def test_mesh_bitwise_invariance(self):
        from probabilit_tpu import ClaytonCopula, QuantileTransform
        from probabilit_tpu.parallel import make_mesh, use_mesh

        u1, u2 = ClaytonCopula(theta=2.0)
        model = QuantileTransform(u1, "norm") + QuantileTransform(u2, "expon")
        base = np.asarray(model.sample(4096, random_state=3))
        with use_mesh(make_mesh()):
            sharded = np.asarray(model.sample(4096, random_state=3))
        np.testing.assert_array_equal(base, sharded)

    def test_streaming_estimate(self):
        from probabilit_tpu import FrankCopula, QuantileTransform
        from probabilit_tpu.engine import streaming

        u1, u2 = FrankCopula(theta=5.0)
        model = QuantileTransform(u1, "norm") * QuantileTransform(u2, "norm")
        est = streaming.estimate(model, 131072, block_size=16384, random_state=1)
        # E[Z1 Z2] > 0 under positive dependence (0 if independent).
        assert est["mean"] > 0.3


class TestQuantileTransform:
    def test_requires_node(self):
        from probabilit_tpu import QuantileTransform

        with pytest.raises(TypeError, match="graph node"):
            QuantileTransform(0.5, "norm")

    def test_uniform_roundtrip_matches_distribution(self):
        # QuantileTransform(uniform, family) is distributionally the
        # family itself; with the SAME node values it must equal the ppf.
        from probabilit_tpu import Distribution, QuantileTransform

        u = Distribution("uniform")
        x = QuantileTransform(u, "gamma", 2.0, scale=3.0)
        x.sample(4096, random_state=5)
        uu = np.asarray(u.samples_)
        xx = np.asarray(x.samples_)
        ref = stats.gamma.ppf(uu.astype(np.float64), 2.0, scale=3.0)
        np.testing.assert_allclose(xx, ref, rtol=5e-4, atol=5e-6)

    def test_node_parameters(self):
        # Family parameters can be nodes (composite), like Distribution.
        from probabilit_tpu import Distribution, QuantileTransform

        loc = Distribution("norm", loc=10.0, scale=0.001)
        u = Distribution("uniform")
        x = QuantileTransform(u, "norm", loc=loc, scale=1.0)
        s = np.asarray(x.sample(8192, random_state=0))
        assert abs(s.mean() - 10.0) < 0.05

    def test_out_of_unit_values_clamped_at_boundary(self):
        # Values are clamped into the open unit interval; a constant 1.0
        # maps to the largest finite draw rather than +inf.
        from probabilit_tpu import Constant, QuantileTransform

        x = QuantileTransform(Constant(1.0), "norm")
        s = np.asarray(x.sample(8, random_state=0))
        assert np.isfinite(s).all() and (s > 5).all()


class TestReviewRegressions:
    def test_frank_large_theta_not_degenerate(self):
        # theta >= ~16.6 makes p = 1-e^-theta round to exactly 1.0 in
        # float32; the old log1p(-p) seed then collapsed every draw
        # (measured tau 0.38 instead of 0.82).  log(1-p) = -theta is
        # exact at any theta.
        from scipy.integrate import quad

        theta = 20.0
        U = np.asarray(
            copulas.sample("frank", jax.random.PRNGKey(1), (20000, 2), theta, np.float32)
        )
        for j in range(2):
            assert stats.kstest(U[:8000, j], "uniform").pvalue > 0.005
        d1 = quad(lambda t: t / np.expm1(t), 0, theta)[0] / theta
        tau_true = 1 - 4 / theta * (1 - d1)
        tau = stats.kendalltau(U[:15000, 0], U[:15000, 1]).statistic
        assert abs(tau - tau_true) < 0.03

    def test_streamed_blocks_never_collide(self):
        # The reference's floor(q0*2^20) key contract gave only 2^20
        # distinct keys: streamed key-seeded nodes drew bitwise-duplicate
        # blocks at the birthday rate (5 duplicates in 4096 blocks,
        # measured).  The widened two-quantile key must produce all
        # distinct blocks.
        from probabilit_tpu import GeometricBrownianMotion
        from probabilit_tpu.engine import streaming

        g = GeometricBrownianMotion(s0=100, sigma=0.2, steps=4)
        out = streaming.sample_streaming(
            g.terminal(), 262144, block_size=64, random_state=0
        )
        blocks = out.reshape(-1, 64)
        assert len(np.unique(blocks, axis=0)) == blocks.shape[0]

    def test_streamed_method_rejected_for_key_seeded_nodes(self):
        # method= promises bitwise stream equality, which a q-seeded key
        # cannot satisfy (and QMC/antithetic structure never reaches
        # key-based draws) — reject with an actionable error.  Path
        # nodes are NOT rejected any more: they consume per-driver
        # quantile slabs (tests/test_processes.py::TestPathQMC).
        from probabilit_tpu import BrownianMotion, ClaytonCopula
        from probabilit_tpu.engine import streaming

        u1, u2 = ClaytonCopula(theta=2.0)
        with pytest.raises(ValueError, match="column-seeded"):
            streaming.estimate(u1 + u2, 256, block_size=64, method="antithetic")
        mvn = list(
            __import__("probabilit_tpu").MultivariateDistribution(
                "dirichlet", alpha=[1.0, 2.0]
            )
        )
        with pytest.raises(ValueError, match="column-seeded"):
            streaming.estimate(mvn[0], 256, block_size=64, method="sobol")
        # method=None streams stay allowed.
        w = BrownianMotion(steps=4)
        out = streaming.sample_streaming(
            w.terminal(), 256, block_size=64, random_state=0
        )
        assert out.shape == (256,)

    def test_streaming_rejects_vector_sinks(self):
        from probabilit_tpu import BrownianMotion, ClaytonCopula
        from probabilit_tpu.engine import streaming

        w = BrownianMotion(steps=4)
        with pytest.raises(ValueError, match="vector-valued"):
            streaming.estimate(w, 256, block_size=64)
        with pytest.raises(ValueError, match="vector-valued"):
            streaming.sample_streaming(w, 256, block_size=64)
        u1, _ = ClaytonCopula(theta=2.0)
        with pytest.raises(ValueError, match="vector-valued"):
            streaming.estimate_many([u1.distr], 256, block_size=64)

    def test_imanconover_ties_have_distinct_cache_tokens(self):
        from probabilit_tpu.correlation import ImanConover
        from probabilit_tpu.engine import compile as _compile

        avg = _compile.correlator_token(ImanConover(ties="average"))
        ordi = _compile.correlator_token(ImanConover(ties="ordinal"))
        assert avg != ordi


class TestCalibration:
    def test_theta_from_tau_round_trips(self):
        for fam, theta in [("clayton", 2.0), ("gumbel", 2.5), ("frank", 5.0)]:
            U = np.asarray(
                copulas.sample(fam, jax.random.PRNGKey(0), (30000, 2), theta, np.float32)
            )
            tau = stats.kendalltau(U[:20000, 0], U[:20000, 1]).statistic
            est = copulas.theta_from_tau(fam, tau)
            assert abs(est - theta) / theta < 0.08, (fam, est)

    def test_closed_forms_exact(self):
        assert copulas.theta_from_tau("clayton", 0.5) == pytest.approx(2.0)
        assert copulas.theta_from_tau("gumbel", 0.5) == pytest.approx(2.0)
        # Frank at tau=0.4567 -> theta ~ 5 (Debye inversion).
        assert copulas.theta_from_tau("frank", 0.45663) == pytest.approx(5.0, abs=0.01)

    def test_rho_from_tau_elliptical_law(self):
        tau = 2 / np.pi * np.arcsin(0.7)
        assert copulas.rho_from_tau(tau) == pytest.approx(0.7, abs=1e-12)

    def test_validation(self):
        with pytest.raises(ValueError, match="in \\(0, 1\\)"):
            copulas.theta_from_tau("clayton", -0.5)
        with pytest.raises(ValueError, match="Unknown copula family"):
            copulas.theta_from_tau("gauss", 0.5)
        with pytest.raises(ValueError, match="in \\(-1, 1\\)"):
            copulas.rho_from_tau(1.5)


class TestNegativeFrank:
    def test_negative_tau_matches_odd_debye(self):
        from scipy.integrate import quad

        for theta in (-2.0, -20.0):
            U = np.asarray(
                copulas.sample(
                    "frank", jax.random.PRNGKey(2), (30000, 2), theta, np.float32
                )
            )
            for j in range(2):
                assert stats.kstest(U[:8000, j], "uniform").pvalue > 0.005
            t = abs(theta)
            d1 = quad(lambda x: x / np.expm1(x), 0, t)[0] / t
            tau_true = -(1 - 4 / t * (1 - d1))
            tau = stats.kendalltau(U[:15000, 0], U[:15000, 1]).statistic
            assert abs(tau - tau_true) < 0.03, theta

    def test_negative_theta_validation(self):
        with pytest.raises(ValueError, match="bivariate-only"):
            copulas.validate("frank", -2.0, 3)
        with pytest.raises(ValueError, match="independence"):
            copulas.validate("frank", 0.0, 2)
        with pytest.raises(ValueError, match=">= -30"):
            copulas.validate("frank", -100.0, 2)

    def test_negative_tau_inversion(self):
        theta = copulas.theta_from_tau("frank", -0.45663)
        assert theta == pytest.approx(-5.0, abs=0.01)

    def test_graph_level_negative_dependence(self):
        from probabilit_tpu import FrankCopula, QuantileTransform

        u1, u2 = FrankCopula(theta=-5.0)
        m = QuantileTransform(u1, "norm") + QuantileTransform(u2, "norm")
        s = np.asarray(m.sample(20000, random_state=0))
        # Negative dependence shrinks the sum's variance below 2.
        assert s.var() < 1.5


class TestEllipticalCopulas:
    def test_tau_matches_elliptical_law_both_families(self):
        from probabilit_tpu import GaussianCopula, TCopula

        C = [[1, 0.5, 0.2], [0.5, 1, 0.3], [0.2, 0.3, 1]]
        g = GaussianCopula(C)
        t = TCopula(C, df=3)
        (g[0] + g[1] + g[2]).sample(60000, random_state=0)
        (t[0] + t[1] + t[2]).sample(60000, random_state=0)
        expect = 2 / np.pi * np.arcsin(0.5)
        for trio in (g, t):
            tau = stats.kendalltau(
                np.asarray(trio[0].samples_)[:15000],
                np.asarray(trio[1].samples_)[:15000],
            ).statistic
            assert abs(tau - expect) < 0.02
            p = stats.kstest(np.asarray(trio[0].samples_)[:8000], "uniform").pvalue
            assert p > 0.005

    def test_t_tails_dominate_gaussian(self):
        from probabilit_tpu import GaussianCopula, TCopula

        C = [[1, 0.5], [0.5, 1]]
        g1, g2 = GaussianCopula(C)
        t1, t2 = TCopula(C, df=3)
        (g1 + g2).sample(60000, random_state=1)
        (t1 + t2).sample(60000, random_state=1)

        def jt(a, b, q=0.99):
            return np.mean((a > q) & (b > q)) / (1 - q)

        assert jt(
            np.asarray(t1.samples_), np.asarray(t2.samples_)
        ) > 2 * jt(np.asarray(g1.samples_), np.asarray(g2.samples_))

    def test_validation(self):
        from probabilit_tpu import GaussianCopula, TCopula

        with pytest.raises(ValueError, match="unit diagonal"):
            GaussianCopula([[1, 0.5], [0.5, 2.0]])
        with pytest.raises(ValueError, match="positive definite"):
            GaussianCopula([[1, 1.5], [1.5, 1]])
        with pytest.raises(ValueError, match="df > 0"):
            TCopula(np.eye(2), df=0.0)
        from probabilit_tpu.models.distributions import (
            EllipticalCopulaDistribution,
        )

        with pytest.raises(ValueError, match="t copula only"):
            EllipticalCopulaDistribution("gaussian", np.eye(2), df=4.0)

    def test_mesh_bitwise_and_reproducible(self):
        from probabilit_tpu import QuantileTransform, TCopula
        from probabilit_tpu.parallel import make_mesh, use_mesh

        u1, u2 = TCopula([[1, 0.6], [0.6, 1]], df=4)
        m = QuantileTransform(u1, "norm") + QuantileTransform(u2, "expon")
        base = np.asarray(m.sample(4096, random_state=3))
        np.testing.assert_array_equal(np.asarray(m.sample(4096, random_state=3)), base)
        with use_mesh(make_mesh()):
            sharded = np.asarray(m.sample(4096, random_state=3))
        np.testing.assert_array_equal(base, sharded)


class TestEmpiricalCopula:
    def test_rank_dependence_reproduced(self):
        from probabilit_tpu import EmpiricalCopula, QuantileTransform

        rng = np.random.default_rng(0)
        common = rng.exponential(size=2000)
        data = np.column_stack(
            [
                common + rng.normal(size=2000) * 0.4,
                common**1.5 + rng.normal(size=2000) * 0.4,
            ]
        )
        tau_data = stats.kendalltau(data[:, 0], data[:, 1]).statistic
        u1, u2 = EmpiricalCopula(data)
        m = QuantileTransform(u1, "lognorm", s=0.4) + QuantileTransform(u2, "expon")
        m.sample(40000, random_state=1)
        tau_model = stats.kendalltau(
            np.asarray(u1.samples_)[:15000], np.asarray(u2.samples_)[:15000]
        ).statistic
        assert abs(tau_model - tau_data) < 0.03

    def test_reproducible_and_copyable(self):
        from probabilit_tpu import EmpiricalCopula, QuantileTransform

        rng = np.random.default_rng(1)
        u1, u2 = EmpiricalCopula(rng.normal(size=(300, 2)))
        m = QuantileTransform(u1, "norm") + QuantileTransform(u2, "norm")
        r1 = np.asarray(m.sample(2048, random_state=5))
        np.testing.assert_array_equal(np.asarray(m.copy().sample(2048, random_state=5)), r1)

    def test_mesh_bitwise(self):
        from probabilit_tpu import EmpiricalCopula
        from probabilit_tpu.parallel import make_mesh, use_mesh

        rng = np.random.default_rng(2)
        u1, u2 = EmpiricalCopula(rng.normal(size=(200, 2)))
        m = u1 + u2
        base = np.asarray(m.sample(4096, random_state=3))
        with use_mesh(make_mesh()):
            sharded = np.asarray(m.sample(4096, random_state=3))
        np.testing.assert_array_equal(base, sharded)

    def test_validation(self):
        from probabilit_tpu import EmpiricalCopula

        with pytest.raises(ValueError, match="observations, d >= 2"):
            EmpiricalCopula(np.ones((5,)))
        with pytest.raises(ValueError, match="finite"):
            EmpiricalCopula(np.array([[1.0, np.nan], [2.0, 3.0]]))
        with pytest.raises(ValueError, match="two observations"):
            EmpiricalCopula(np.ones((1, 2)))


class TestSecondReviewRegressions:
    def test_negative_tau_beyond_sampler_floor_rejected(self):
        # theta_from_tau must not hand back a parameter the sampler
        # rejects with an unrelated message.
        with pytest.raises(ValueError, match="float32 floor"):
            copulas.theta_from_tau("frank", -0.9)
        with pytest.raises(ValueError, match="in \\(-1, 1\\)"):
            copulas.theta_from_tau("frank", -1.5)

    def test_joint_paths_node_rejected_by_path_functional(self):
        # The joint (n, d, steps) node must not slip through the
        # functional constructor: op='terminal' would silently return
        # the last ASSET's whole path.
        from probabilit_tpu.models.processes import (
            CorrelatedGBMPaths,
            PathFunctional,
        )

        joint = CorrelatedGBMPaths(
            [100, 50], [0, 0], [0.2, 0.3], [[1, 0.5], [0.5, 1]], steps=8
        )
        with pytest.raises(TypeError, match="SCALAR path node"):
            PathFunctional(joint, "terminal")

    def test_shared_corr_validation(self):
        # One helper validates correlation matrices for elliptical
        # copulas AND correlated GBM (identical error strings).
        from probabilit_tpu import CorrelatedGBM, GaussianCopula

        for build in (
            lambda C: GaussianCopula(C),
            lambda C: CorrelatedGBM([100, 50], [0, 0], [0.2, 0.3], C),
        ):
            with pytest.raises(ValueError, match="positive definite"):
                build([[1, 1.5], [1.5, 1]])
