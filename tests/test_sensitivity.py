"""Parameter-sensitivity tests: pathwise gradients vs analytic truth.

``sensitivity()`` differentiates a statistic of the compiled sampling
program w.r.t. distribution parameters (engine/sensitivity.py) — a
capability the scipy-driven reference cannot offer (its per-node ``.ppf``
calls are opaque to autodiff, reference ``modeling.py:805-812``).  Tests
check the estimator against closed-form derivatives, common-random-number
determinism, parameter restoration, validation errors, and the correlated
path.
"""

import numpy as np
import pytest

import probabilit_tpu as pt
from probabilit_tpu.engine.sensitivity import sensitivity


class TestAnalyticGradients:
    def test_affine_of_normal_mean(self):
        # E[5(loc + scale Z) + 1]: d/dloc = 5 exactly (pathwise, any n);
        # d/dscale = 5 E[Z] -> 0 in expectation.
        x = pt.Distribution("norm", loc=2.0, scale=3.0)
        y = 5 * x + 1
        res = sensitivity(y, wrt=x, size=100_000, random_state=0)
        assert res[(x, "loc")] == pytest.approx(5.0, abs=1e-4)
        assert res[(x, "scale")] == pytest.approx(0.0, abs=0.05)
        assert res.value == pytest.approx(11.0, abs=0.1)

    def test_variance_statistic(self):
        # var(scale Z) = scale^2 -> d/dscale = 2 scale.
        x = pt.Distribution("norm", loc=0.0, scale=3.0)
        res = sensitivity(
            x, wrt={x: ["scale"]}, size=200_000, random_state=1, statistic="var"
        )
        assert res[(x, "scale")] == pytest.approx(6.0, rel=0.05)

    def test_exponential_through_transform(self):
        # X ~ Expon(scale=s): E[X^2] = 2 s^2 -> d/ds = 4 s.
        e = pt.Distribution("expon", scale=2.0)
        res = sensitivity(e**2, wrt={e: ["scale"]}, size=400_000, random_state=2)
        assert res[(e, "scale")] == pytest.approx(8.0, rel=0.05)

    def test_positional_parameter_lognorm(self):
        # lognorm(s): E[X] = exp(s^2/2) -> d/ds = s exp(s^2/2).
        s = 0.5
        x = pt.Distribution("lognorm", s)
        res = sensitivity(x, wrt={x: [0]}, size=400_000, random_state=3)
        truth = s * np.exp(s**2 / 2)
        assert res[(x, 0)] == pytest.approx(truth, rel=0.05)

    def test_callable_statistic(self):
        # P05 of norm(loc, scale): quantile is loc + scale z_q -> d/dloc = 1.
        import jax.numpy as jnp

        x = pt.Distribution("norm", loc=1.0, scale=2.0)
        res = sensitivity(
            x,
            wrt={x: ["loc"]},
            size=100_000,
            random_state=4,
            statistic=lambda v: jnp.quantile(v, 0.05),
        )
        assert res[(x, "loc")] == pytest.approx(1.0, abs=0.05)


class TestContracts:
    def test_common_random_numbers_deterministic(self):
        x = pt.Distribution("norm", loc=2.0, scale=3.0)
        r1 = sensitivity(x, wrt=x, size=10_000, random_state=7)
        r2 = sensitivity(x, wrt=x, size=10_000, random_state=7)
        assert r1.value == r2.value
        assert r1.gradients == r2.gradients

    def test_parameters_restored_and_sampling_unchanged(self):
        x = pt.Distribution("norm", loc=2.0, scale=3.0)
        y = x + 1
        before = np.asarray(y.sample(1000, random_state=0))
        sensitivity(y, wrt=x, size=4096, random_state=0)
        assert x.kwargs["loc"] == 2.0 and type(x.kwargs["loc"]) is float
        after = np.asarray(y.sample(1000, random_state=0))
        np.testing.assert_array_equal(before, after)

    def test_node_method(self):
        x = pt.Distribution("norm", loc=2.0, scale=3.0)
        res = (2 * x).sensitivity(wrt=x, size=4096, random_state=0)
        assert res[(x, "loc")] == pytest.approx(2.0, abs=1e-4)

    def test_correlated_graph(self):
        # Linearity through the correlated fast path: d E[a+b]/d loc_b = 1.
        a = pt.Distribution("norm")
        b = pt.Distribution("norm", loc=1.0, scale=2.0)
        s = a + b
        s.correlate(a, b, corr_mat=np.array([[1.0, 0.7], [0.7, 1.0]]))
        res = sensitivity(s, wrt=b, size=50_000, random_state=5)
        assert res[(b, "loc")] == pytest.approx(1.0, abs=1e-3)
        assert np.isfinite(res[(b, "scale")])

    def test_result_repr(self):
        x = pt.Distribution("norm", loc=2.0, scale=3.0)
        res = sensitivity(x, wrt={x: ["loc"]}, size=4096, random_state=0)
        assert "d/d(" in repr(res) and "value=" in repr(res)


class TestStreamedSensitivity:
    """block_size=: exact blockwise gradient accumulation at any size."""

    def test_streamed_matches_analytic_and_estimate_value(self):
        from probabilit_tpu.engine import streaming

        x = pt.Distribution("norm", loc=2.0, scale=3.0)
        y = 5 * x + 1
        res = sensitivity(y, wrt=x, size=2**16, random_state=0,
                          block_size=2**13)
        assert res[(x, "loc")] == pytest.approx(5.0, abs=1e-3)
        assert abs(res[(x, "scale")]) < 0.1
        # Identical draw semantics to estimate(): the
        # streamed VALUE matches exactly (same keys, same Chan merge).
        est = streaming.estimate(
            y, 2**16, block_size=2**13, random_state=0
        )
        assert res.value == pytest.approx(est["mean"], abs=1e-4)

    def test_partial_last_block(self):
        x = pt.Distribution("norm", loc=2.0, scale=3.0)
        y = 5 * x + 1
        res = sensitivity(y, wrt=x, size=2**13 + 137, random_state=1,
                          block_size=2**13)
        assert res[(x, "loc")] == pytest.approx(5.0, abs=1e-3)

    def test_streamed_gbm_greeks(self):
        # E[S_T] = s0 e^{mu T}: delta = e^{mu T}, d/dmu = s0 T e^{mu T},
        # d/dsigma = 0.
        from probabilit_tpu import GeometricBrownianMotion

        gbm = GeometricBrownianMotion(
            s0=100.0, mu=0.05, sigma=0.2, T=1.0, steps=8
        )
        res = sensitivity(
            gbm.terminal(), wrt={gbm: ["s0", "mu", "sigma"]}, size=2**16,
            random_state=0, block_size=2**13,
        )
        assert res[(gbm, "s0")] == pytest.approx(np.exp(0.05), rel=0.01)
        assert res[(gbm, "mu")] == pytest.approx(100 * np.exp(0.05), rel=0.01)
        assert abs(res[(gbm, "sigma")]) < 3.0

    def test_streamed_qmc_bitwise_matches_single_shot(self):
        # Index-addressable sobol blocks concatenate to the single-shot
        # sequence, so the streamed QMC gradient IS the single-shot one.
        x = pt.Distribution("norm", loc=2.0, scale=3.0)
        y = (x - 1.0) ** 2
        ss = sensitivity(y, wrt=x, size=2**13, random_state=3, method="sobol")
        st = sensitivity(y, wrt=x, size=2**13, random_state=3,
                         method="sobol", block_size=2**11)
        assert st.value == pytest.approx(ss.value, abs=1e-4)
        for pair in ss.gradients:
            assert st[pair] == pytest.approx(ss[pair], abs=1e-4)

    def test_replicates_gradient_error_bars(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = pt.models.graph.Exp(x)  # E = e^{1/2}; d/dloc = e^{1/2}
        res = sensitivity(y, wrt={x: ["loc"]}, size=2**16, random_state=2,
                          method="sobol", replicates=4, block_size=2**13)
        want = np.exp(0.5)
        assert res[(x, "loc")] == pytest.approx(want, rel=0.01)
        sem = res.sems[(x, "loc")]
        assert 0.0 <= sem < 0.02
        assert res.value_sem is not None
        assert res[(x, "loc")] == pytest.approx(want, abs=5 * sem + 5e-3)

    def test_size_sweep_reuses_program(self):
        # n_blocks/last_count are traced: a size sweep must not retrace
        # (verified via timing-free identity — the cached callable).
        from probabilit_tpu.engine import sensitivity as S

        x = pt.Distribution("norm", loc=2.0, scale=3.0)
        y = 3 * x
        sensitivity(y, wrt=x, size=2**13, random_state=0, block_size=2**11)
        n_cached = len(S._GRAD_CACHE)
        sensitivity(y, wrt=x, size=2**14, random_state=1, block_size=2**11)
        assert len(S._GRAD_CACHE) == n_cached

    def test_validation(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        # Arbitrary callables need the full sample vector.
        with pytest.raises(ValueError, match="statistic='mean'"):
            sensitivity(x, wrt=x, size=2**12, block_size=2**10,
                        statistic=lambda v: v[0])
        a = pt.Distribution("norm", loc=0.0, scale=1.0)
        b = pt.Distribution("norm", loc=1.0, scale=1.0)
        s = a + b
        s.correlate(a, b, corr_mat=np.array([[1.0, 0.5], [0.5, 1.0]]))
        # Correlated graphs stream through the generated recolor; a
        # correlator WITHOUT score recoloring (Cholesky) cannot.
        with pytest.raises(ValueError, match="not eligible"):
            sensitivity(s, wrt=b, size=2**12, block_size=2**10,
                        correlator="cholesky")
        with pytest.raises(ValueError, match="replicates must be"):
            sensitivity(x, wrt=x, size=2**12, replicates=1)
        with pytest.raises(ValueError, match="divisible"):
            sensitivity(x, wrt=x, size=1001, replicates=4)
        with pytest.raises(ValueError, match="method must be"):
            sensitivity(x, wrt=x, size=2**12, method="fourier")


class TestStreamedVarStdGradients:
    """Streamed variance/std gradients: exact bivariate Chan co-moments."""

    def test_var_matches_analytic(self):
        # var(loc + scale Z) = scale^2: d/dscale = 2 scale, d/dloc = 0.
        x = pt.Distribution("norm", loc=1.0, scale=3.0)
        res = sensitivity(x, wrt=x, size=2**16, random_state=0,
                          statistic="var", block_size=2**13)
        assert res[(x, "scale")] == pytest.approx(6.0, rel=0.02)
        assert abs(res[(x, "loc")]) < 0.05
        assert res.value == pytest.approx(9.0, rel=0.02)

    def test_std_matches_analytic(self):
        # std(loc + scale Z) = scale: d/dscale = 1 (any n, pathwise).
        x = pt.Distribution("norm", loc=-2.0, scale=1.7)
        res = sensitivity(x, wrt={x: ["scale"]}, size=2**15, random_state=1,
                          statistic="std", block_size=2**12)
        assert res[(x, "scale")] == pytest.approx(1.0, rel=0.01)
        assert res.value == pytest.approx(1.7, rel=0.02)

    def test_var_streamed_matches_single_shot_statistically(self):
        # Nonlinear sink: var((X+1)^2) with X ~ N(0, scale). Streamed
        # and single-shot are the same estimator (ddof=1 + exact
        # blockwise cross co-moment), different draws.
        x = pt.Distribution("norm", loc=0.0, scale=2.0)
        y = (x + 1.0) ** 2
        ss = sensitivity(y, wrt={x: ["scale"]}, size=2**16, random_state=1,
                         statistic="var")
        st = sensitivity(y, wrt={x: ["scale"]}, size=2**16, random_state=1,
                         statistic="var", block_size=2**13)
        assert st[(x, "scale")] == pytest.approx(ss[(x, "scale")], rel=0.05)
        assert st.value == pytest.approx(ss.value, rel=0.05)

    def test_var_streamed_qmc_matches_single_shot(self):
        # Sobol blocks concatenate to the single-shot sequence: same
        # points, so estimator agreement is tight (float-order only).
        x = pt.Distribution("norm", loc=0.0, scale=2.0)
        y = (x - 1.0) ** 2
        ss = sensitivity(y, wrt={x: ["scale"]}, size=2**13, random_state=3,
                         statistic="var", method="sobol")
        st = sensitivity(y, wrt={x: ["scale"]}, size=2**13, random_state=3,
                         statistic="var", method="sobol", block_size=2**11)
        assert st[(x, "scale")] == pytest.approx(ss[(x, "scale")], rel=1e-3)
        assert st.value == pytest.approx(ss.value, rel=1e-3)

    def test_partial_last_block_var(self):
        x = pt.Distribution("norm", loc=0.0, scale=3.0)
        res = sensitivity(x, wrt={x: ["scale"]}, size=2**13 + 41,
                          random_state=2, statistic="var", block_size=2**13)
        assert res[(x, "scale")] == pytest.approx(6.0, rel=0.05)


class TestStreamedTailGradients:
    """Two-pass streamed VaR/CVaR gradients (Hong-Liu tail streams)."""

    def test_cvar_gradient_analytic(self):
        # ES_a(loc + scale Z) = loc + scale phi(z_a)/(1-a):
        # d/dloc = 1, d/dscale = phi(z_a)/(1-a) = 2.0627 at a=0.95.
        from scipy import stats as sps

        x = pt.Distribution("norm", loc=1.0, scale=2.0)
        res = sensitivity(x, wrt=x, size=2**17, random_state=0,
                          statistic="cvar0.95", block_size=2**14)
        want_scale = sps.norm.pdf(sps.norm.ppf(0.95)) / 0.05
        assert res[(x, "loc")] == pytest.approx(1.0, abs=0.02)
        assert res[(x, "scale")] == pytest.approx(want_scale, rel=0.03)
        assert res.value == pytest.approx(1.0 + 2.0 * want_scale, rel=0.02)

    def test_pass1_band_quantiles_survive_key_collision(self):
        # "%g"-formatted result keys collide when the band is narrower
        # than the level's 6th significant digit (q0.999999 +/- 5e-7
        # all format to "q0.999999"), which would collapse the
        # conditioning band to a point if pass 2 read the quantiles
        # back through _finalize_estimate's dict.  Pass 2 therefore
        # reads POSITIONALLY from the raw carry; this pins both halves
        # of that contract.
        import jax

        from probabilit_tpu.engine import compile as _compile
        from probabilit_tpu.engine import streaming as streaming

        levels = (0.5000001, 0.5000002, 0.5000003)
        assert len({f"q{lv:g}" for lv in levels}) == 1  # keys DO collide
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        carry = jax.device_get(
            streaming._estimate_carry(
                x, 1 << 15, 1 << 12, jax.random.PRNGKey(0),
                None, levels, _compile.resolve_correlator("imanconover"),
            )
        )
        tails = np.asarray(carry[6], np.float64) / float(carry[0])
        # All three level estimates exist positionally, in level order.
        assert tails.shape == (3,)
        assert tails[0] <= tails[1] <= tails[2]
        assert abs(tails[1]) < 0.05  # the median of N(0,1)
        # The formatted dict keeps only ONE of them — the collision the
        # positional read exists to sidestep.
        stats = streaming._finalize_estimate(carry, 1 << 15, levels)
        assert sum(k.startswith("q0.5") for k in stats) == 1

    def test_quantile_gradient_analytic(self):
        # q_a(loc + scale Z) = loc + scale z_a: d/dloc = 1,
        # d/dscale = z_a = 1.2816 at a=0.9.
        from scipy import stats as sps

        x = pt.Distribution("norm", loc=0.0, scale=2.0)
        res = sensitivity(x, wrt=x, size=2**17, random_state=1,
                          statistic="q0.9", block_size=2**14)
        assert res[(x, "loc")] == pytest.approx(1.0, abs=0.05)
        assert res[(x, "scale")] == pytest.approx(
            sps.norm.ppf(0.9), rel=0.05
        )

    def test_streamed_cvar_matches_single_shot(self):
        # Overlapping-size consistency: streamed two-pass vs single-shot
        # through-the-sort, same estimator target E[g | X >= VaR].
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = pt.models.graph.Exp(x)
        ss = sensitivity(y, wrt={x: ["loc"]}, size=2**15, random_state=2,
                         statistic="cvar0.9")
        st = sensitivity(y, wrt={x: ["loc"]}, size=2**15, random_state=2,
                         statistic="cvar0.9", block_size=2**13)
        assert st[(x, "loc")] == pytest.approx(ss[(x, "loc")], rel=0.05)
        assert st.value == pytest.approx(ss.value, rel=0.02)

    def test_streamed_quantile_matches_single_shot(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = pt.models.graph.Exp(x)
        ss = sensitivity(y, wrt={x: ["loc"]}, size=2**15, random_state=4,
                         statistic="q0.95")
        st = sensitivity(y, wrt={x: ["loc"]}, size=2**15, random_state=4,
                         statistic="q0.95", block_size=2**13)
        assert st[(x, "loc")] == pytest.approx(ss[(x, "loc")], rel=0.05)
        assert st.value == pytest.approx(ss.value, rel=0.02)

    def test_cvar_replicates_error_bars(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        res = sensitivity(x, wrt={x: ["loc"]}, size=2**16, random_state=3,
                          statistic="cvar0.9", block_size=2**13,
                          replicates=4)
        assert res[(x, "loc")] == pytest.approx(1.0, abs=0.05)
        assert res.sems[(x, "loc")] < 0.05


class TestStreamedCorrelatedGradients:
    """Correlated graphs stream gradients via the generated recolor."""

    def test_correlated_scale_gradient_analytic(self):
        # E[(a+b)^2] = 1 + sb^2 + 2 rho sb + loc_b^2 under the Gaussian
        # copula: d/dsb = 2 sb + 2 rho = 5.4 at sb=2, rho=0.7 — the
        # correlation term only appears if the recolored gradient is
        # differentiated THROUGH the recoloring.
        a = pt.Distribution("norm")
        b = pt.Distribution("norm", loc=1.0, scale=2.0)
        s = (a + b) ** 2
        s.correlate(a, b, corr_mat=np.array([[1.0, 0.7], [0.7, 1.0]]))
        res = sensitivity(s, wrt={b: ["scale"]}, size=2**16, random_state=0,
                          block_size=2**13)
        assert res[(b, "scale")] == pytest.approx(5.4, rel=0.05)

    def test_correlated_streamed_matches_single_shot(self):
        a = pt.Distribution("norm")
        b = pt.Distribution("norm", loc=1.0, scale=2.0)
        s = (a + b) ** 2
        s.correlate(a, b, corr_mat=np.array([[1.0, 0.7], [0.7, 1.0]]))
        ss = sensitivity(s, wrt=b, size=2**15, random_state=5)
        st = sensitivity(s, wrt=b, size=2**15, random_state=5,
                         block_size=2**13)
        for pair in ss.gradients:
            assert st[pair] == pytest.approx(ss[pair], rel=0.08, abs=0.08)
        assert st.value == pytest.approx(ss.value, rel=0.02)

    def test_correlated_streamed_var_gradient(self):
        # var(a + b) = 1 + sb^2 + 2 rho sb: d/dsb = 2 sb + 2 rho.
        a = pt.Distribution("norm")
        b = pt.Distribution("norm", loc=0.0, scale=2.0)
        s = a + b
        s.correlate(a, b, corr_mat=np.array([[1.0, 0.7], [0.7, 1.0]]))
        res = sensitivity(s, wrt={b: ["scale"]}, size=2**16, random_state=1,
                          statistic="var", block_size=2**13)
        assert res[(b, "scale")] == pytest.approx(5.4, rel=0.05)


class TestValidation:
    def test_discrete_rejected(self):
        p = pt.Distribution("poisson", 4.0)
        with pytest.raises(ValueError, match="discrete"):
            sensitivity(p, wrt=p, size=4096)

    def test_non_distribution_rejected(self):
        x = pt.Distribution("norm")
        with pytest.raises(TypeError, match="Distribution"):
            sensitivity(x + 1, wrt=x + 1, size=4096)

    def test_non_ancestor_rejected(self):
        x = pt.Distribution("norm")
        other = pt.Distribution("norm", loc=9.0)
        with pytest.raises(ValueError, match="ancestor"):
            sensitivity(x + 1, wrt=other, size=4096)

    def test_unknown_slot_rejected(self):
        x = pt.Distribution("norm", loc=2.0)
        with pytest.raises(ValueError, match="no numeric scalar parameter"):
            sensitivity(x, wrt={x: ["shape"]}, size=4096)

    def test_node_valued_parameter_not_a_slot(self):
        mu = pt.Distribution("norm", loc=5.0)
        x = pt.Distribution("norm", loc=mu, scale=1.0)
        # loc is a Node (part of the graph): only scale is a numeric slot.
        res = sensitivity(x, wrt=x, size=50_000, random_state=6)
        assert set(res.gradients) == {(x, "scale")}
        # ...and the leaf's own loc is reachable by targeting the leaf.
        res2 = sensitivity(x, wrt={mu: ["loc"]}, size=50_000, random_state=6)
        assert res2[(mu, "loc")] == pytest.approx(1.0, abs=1e-4)

    def test_bad_statistic_rejected(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        with pytest.raises(ValueError, match="statistic"):
            sensitivity(x, wrt=x, size=4096, statistic="median")

    def test_host_fallback_family_rejected(self):
        from probabilit_tpu.ops import ppf as _ppf

        # Find a continuous scipy family with no native kernel.
        import scipy.stats as sps

        name = None
        for cand in ("genhyperbolic", "kappa4", "burr12", "mielke"):
            if (
                getattr(sps, cand, None) is not None
                and _ppf.lookup(cand) is None
            ):
                name = cand
                break
        if name is None:
            pytest.skip("every probed family has a native kernel")
        node = pt.Distribution(name, 1.0, 1.0)
        with pytest.raises(ValueError, match="native ppf kernel"):
            sensitivity(node, wrt={node: [0]}, size=4096)


class TestSobolIndices:
    def test_linear_model_variance_shares(self):
        # f = a + b, var(a)=4, var(b)=1: S_a = ST_a = 0.8, S_b = ST_b = 0.2.
        a = pt.Distribution("norm", loc=0.0, scale=2.0)
        b = pt.Distribution("norm", loc=0.0, scale=1.0)
        res = pt.sobol_indices(a + b, size=8192, random_state=0)
        assert res.first_order[a] == pytest.approx(0.8, abs=0.02)
        assert res.total_order[a] == pytest.approx(0.8, abs=0.02)
        assert res.first_order[b] == pytest.approx(0.2, abs=0.02)
        assert res.variance == pytest.approx(5.0, rel=0.05)
        assert res[a] == (res.first_order[a], res.total_order[a])

    def test_ishigami_analytic(self):
        # The canonical GSA benchmark (Ishigami & Homma 1990), a=7, b=0.1:
        # S = [0.3139, 0.4424, 0], ST = [0.5576, 0.4424, 0.2437].
        from probabilit_tpu.models.graph import Sin

        pi = np.pi
        xs = [
            pt.Distribution("uniform", loc=-pi, scale=2 * pi) for _ in range(3)
        ]
        x1, x2, x3 = xs
        f = Sin(x1) + 7 * Sin(x2) ** 2 + 0.1 * x3**4 * Sin(x1)
        res = pt.sobol_indices(f, size=32768, random_state=1)
        truth_S = [0.3139, 0.4424, 0.0]
        truth_T = [0.5576, 0.4424, 0.2437]
        for x, ts, tt in zip(xs, truth_S, truth_T):
            assert res.first_order[x] == pytest.approx(ts, abs=0.01)
            assert res.total_order[x] == pytest.approx(tt, abs=0.01)
        assert res.variance == pytest.approx(13.844, rel=0.02)

    def test_second_order_ishigami(self):
        # The x1-x3 interaction carries ALL of Ishigami's non-additive
        # variance: S_13 = 8 b^2 pi^8 / (225 V) = 0.2437; S_12 = S_23 = 0.
        from probabilit_tpu.models.graph import Sin

        pi = np.pi
        x1, x2, x3 = (
            pt.Distribution("uniform", loc=-pi, scale=2 * pi) for _ in range(3)
        )
        f = Sin(x1) + 7 * Sin(x2) ** 2 + 0.1 * x3**4 * Sin(x1)
        res = pt.sobol_indices(f, size=16384, random_state=0, second_order=True)
        assert res.second_order[(x1, x3)] == pytest.approx(0.2437, abs=0.05)
        assert res.second_order[(x3, x1)] == res.second_order[(x1, x3)]
        assert abs(res.second_order[(x1, x2)]) < 0.05
        assert abs(res.second_order[(x2, x3)]) < 0.05

    def test_second_order_additive_is_zero(self):
        a = pt.Distribution("norm", scale=2.0)
        b = pt.Distribution("norm")
        res = pt.sobol_indices(a + b, size=8192, random_state=1, second_order=True)
        assert abs(res.second_order[(a, b)]) < 0.03

    def test_second_order_default_off_and_validation(self):
        a = pt.Distribution("norm")
        b = pt.Distribution("norm")
        res = pt.sobol_indices(a + b, size=4096, random_state=2)
        assert res.second_order is None
        with pytest.raises(ValueError, match="at least two variables"):
            pt.sobol_indices(a + 0 * b, wrt=[a], size=4096, second_order=True)

    def test_interaction_only_model(self):
        # f = a * b with zero-mean factors: all variance is interaction —
        # first-order ~ 0, totals ~ 1.
        a = pt.Distribution("norm", loc=0.0, scale=1.0)
        b = pt.Distribution("norm", loc=0.0, scale=1.0)
        res = pt.sobol_indices(a * b, size=16384, random_state=2)
        assert res.first_order[a] == pytest.approx(0.0, abs=0.05)
        assert res.total_order[a] == pytest.approx(1.0, abs=0.05)

    def test_prng_method_agrees(self):
        a = pt.Distribution("norm", loc=0.0, scale=2.0)
        b = pt.Distribution("norm", loc=0.0, scale=1.0)
        res = pt.sobol_indices(a + b, size=32768, random_state=3, method=None)
        assert res.first_order[a] == pytest.approx(0.8, abs=0.05)

    def test_subset_and_composite_wrt(self):
        # Composite node: its index measures its own innovation column.
        mu = pt.Distribution("norm", loc=0.0, scale=3.0)
        x = pt.Distribution("norm", loc=mu, scale=1.0)
        res = pt.sobol_indices(x, wrt=[mu, x], size=16384, random_state=4)
        # var = 9 + 1; mu explains 0.9, x's own innovation 0.1.
        assert res.first_order[mu] == pytest.approx(0.9, abs=0.03)
        assert res.first_order[x] == pytest.approx(0.1, abs=0.03)

    def test_node_method_and_determinism(self):
        a = pt.Distribution("norm", loc=0.0, scale=2.0)
        b = pt.Distribution("norm", loc=0.0, scale=1.0)
        r1 = (a + b).sobol_indices(size=4096, random_state=5)
        r2 = (a + b).sobol_indices(size=4096, random_state=5)
        assert r1.first_order == r2.first_order
        assert r1.total_order == r2.total_order

    def test_correlated_model_rejected(self):
        a = pt.Distribution("norm")
        b = pt.Distribution("norm")
        s = (a + b).correlate(a, b, corr_mat=np.array([[1.0, 0.5], [0.5, 1.0]]))
        with pytest.raises(ValueError, match="independent"):
            pt.sobol_indices(s, size=4096)

    def test_non_distribution_wrt_rejected(self):
        a = pt.Distribution("norm")
        with pytest.raises(ValueError, match="distribution node"):
            pt.sobol_indices(a + 1, wrt=[a + 1], size=4096)

    def test_constant_sink_rejected(self):
        a = pt.Distribution("norm")
        with pytest.raises(FloatingPointError, match="constant"):
            pt.sobol_indices(a * 0.0, size=4096, random_state=0)

    def test_duplicate_wrt_rejected(self):
        a = pt.Distribution("norm")
        with pytest.raises(ValueError, match="twice"):
            pt.sobol_indices(a + 1, wrt=[a, a], size=4096)

    def test_repr(self):
        a = pt.Distribution("norm")
        b = pt.Distribution("norm")
        res = pt.sobol_indices(a + b, size=4096, random_state=6)
        assert "S=" in repr(res) and "ST=" in repr(res)

    def test_under_mesh_matches_unsharded(self):
        from probabilit_tpu.parallel import make_mesh, use_mesh

        a = pt.Distribution("norm", loc=0.0, scale=2.0)
        b = pt.Distribution("norm", loc=0.0, scale=1.0)
        base = pt.sobol_indices(a + b, size=8192, random_state=7)
        with use_mesh(make_mesh()):
            sharded = pt.sobol_indices(a + b, size=8192, random_state=7)
        assert sharded.first_order[a] == pytest.approx(
            base.first_order[a], abs=1e-5
        )
        assert sharded.total_order[b] == pytest.approx(
            base.total_order[b], abs=1e-5
        )


class TestQuantileStatistic:
    def test_var_sensitivity_normal(self):
        # q-quantile of loc + scale Z is loc + scale z_q:
        # d/dloc = 1, d/dscale = z_q.
        import scipy.stats

        x = pt.Distribution("norm", loc=10.0, scale=2.0)
        res = sensitivity(
            x, wrt=x, size=200_000, random_state=8, statistic="q0.95"
        )
        z95 = scipy.stats.norm.ppf(0.95)
        assert res[(x, "loc")] == pytest.approx(1.0, abs=0.02)
        assert res[(x, "scale")] == pytest.approx(z95, rel=0.03)
        assert res.value == pytest.approx(10.0 + 2.0 * z95, rel=0.01)

    def test_bad_level_rejected(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        for bad in ("q1.5", "qabc", "q0", "q"):
            with pytest.raises(ValueError, match="statistic"):
                sensitivity(x, wrt=x, size=4096, statistic=bad)


class TestSobolPathNodes:
    """Pick-freeze over path-node slabs (review regression: any path
    node in the graph used to crash _build_sobol_fn, whose matrices
    spanned plan.d instead of plan.d_total)."""

    def test_path_node_as_factor(self):
        import numpy as np

        from probabilit_tpu import Distribution, GeometricBrownianMotion
        from probabilit_tpu.engine.sensitivity import sobol_indices

        g = GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2, steps=8)
        x = Distribution("norm", scale=10.0)
        res = sobol_indices(g.terminal() + x, size=8192, random_state=0)
        # Var(GBM terminal) = s0^2 e^{2 mu T}(e^{sigma^2 T} - 1).
        v_path = np.exp(0.1) * (np.exp(0.04) - 1.0) * 1e4
        want = v_path / (v_path + 100.0)
        assert abs(res.first_order[g] - want) < 0.05
        assert abs(res.first_order[x] - (1.0 - want)) < 0.05
        assert res.total_order[g] == pytest.approx(res.first_order[g], abs=0.06)

    def test_path_node_merely_present(self):
        from probabilit_tpu import Distribution, OrnsteinUhlenbeck
        from probabilit_tpu.engine.sensitivity import sobol_indices

        ou = OrnsteinUhlenbeck(x0=1.0, theta=2.0, mu=1.0, sigma=0.3, steps=4)
        a = Distribution("norm", scale=2.0)
        b = Distribution("norm", scale=1.0)
        res = sobol_indices(
            ou.terminal() * 0.0 + a + b, wrt=[a, b], size=4096, random_state=1
        )
        assert abs(res.first_order[a] - 0.8) < 0.06


class TestSweep:
    """sweep(): batched scenario grids, one vmapped program."""

    def test_linear_model_matches_analytic(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = 2.0 * x + 1.0
        locs = np.linspace(-2.0, 2.0, 9)
        res = pt.sweep(
            y,
            {(x, "loc"): locs},
            size=1 << 14,
            random_state=0,
            statistics=("mean", "std", "q0.95"),
        )
        assert np.abs(res["mean"] - (2 * locs + 1)).max() < 0.05
        # CRN: the ladder inherits the model's exact monotonicity.
        assert np.all(np.diff(res["mean"]) > 0)
        assert np.abs(res["std"] - 2.0).max() < 0.1
        q = 2 * locs + 1 + 2 * 1.6448536
        assert np.abs(res["q0.95"] - q).max() < 0.1
        assert res["sem"].shape == (9,) and np.all(res["sem"] > 0)
        assert res.n == 9 and "mean" in res.keys()

    def test_crn_determinism_and_independent_streams(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = x * x
        vals = np.array([0.5, 0.5])
        crn = pt.sweep(y, {(x, "loc"): vals}, size=4096, random_state=1)
        assert crn["mean"][0] == crn["mean"][1]  # identical scenarios, CRN
        ind = pt.sweep(
            y,
            {(x, "loc"): vals},
            size=4096,
            random_state=1,
            common_random_numbers=False,
        )
        assert ind["mean"][0] != ind["mean"][1]
        assert np.abs(ind["mean"] - 1.25).max() < 0.15  # E[(L+Z)^2]=1.25

    def test_two_slot_grid_and_nested_dict(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = 2.0 * x + 1.0
        ll, ss = np.meshgrid(
            np.array([-1.0, 0.0, 1.0]), np.array([0.5, 1.0, 2.0])
        )
        res = pt.sweep(
            y,
            {x: {"loc": ll.ravel(), "scale": ss.ravel()}},
            size=1 << 14,
            random_state=3,
            statistics=("mean", "std"),
        )
        assert np.abs(res["mean"] - (2 * ll.ravel() + 1)).max() < 0.1
        assert np.abs(res["std"] - 2 * ss.ravel()).max() < 0.15

    def test_qmc_and_path_node_spot_ladder(self):
        gbm = pt.GeometricBrownianMotion(
            s0=100.0, mu=0.05, sigma=0.2, T=1.0, steps=16
        )
        spots = np.linspace(80.0, 120.0, 5)
        res = pt.sweep(
            gbm.terminal(),
            {(gbm, "s0"): spots},
            size=1 << 13,
            random_state=0,
            method="sobol",
        )
        # E[S_T] = s0 e^{mu T} exactly; sobol at 8k is very tight.
        assert np.abs(res["mean"] - spots * np.exp(0.05)).max() < 0.05
        # The slot machinery restored the original parameter.
        assert float(gbm.s0) == 100.0

    def test_correlated_graph(self):
        a = pt.Distribution("norm", loc=0.0, scale=1.0)
        b = pt.Distribution("norm", loc=0.0, scale=1.0)
        s = (a + b).correlate(
            a, b, corr_mat=np.array([[1.0, 0.8], [0.8, 1.0]])
        )
        res = pt.sweep(
            s,
            {(a, "loc"): np.array([0.0, 1.0])},
            size=1 << 15,
            random_state=1,
            statistics=("mean", "var"),
        )
        assert np.abs(res["mean"] - np.array([0.0, 1.0])).max() < 0.05
        assert np.abs(res["var"] - 3.6).max() < 0.1  # 2 + 2*0.8

    def test_validation(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = 2.0 * x
        with pytest.raises(ValueError, match="length"):
            pt.sweep(
                y,
                {
                    (x, "loc"): np.array([0.0, 1.0]),
                    (x, "scale"): np.array([1.0, 2.0, 3.0]),
                },
            )
        with pytest.raises(ValueError, match="no numeric scalar parameter"):
            pt.sweep(y, {(x, "mu"): np.array([0.0])})
        with pytest.raises(ValueError, match="non-empty dict"):
            pt.sweep(y, [])
        a = pt.Distribution("norm", loc=0.0, scale=1.0)
        b = pt.Distribution("norm", loc=0.0, scale=1.0)
        s = (a + b).correlate(
            a, b, corr_mat=np.array([[1.0, 0.5], [0.5, 1.0]])
        )
        # Streamed QMC cannot recolor per block; single-shot QMC can
        # (tested in TestSweepQMCCorrelated).
        with pytest.raises(ValueError, match="correlation-free"):
            pt.sweep(s, {(a, "loc"): np.array([0.0])}, method="sobol",
                     block_size=2**10)
        # Duplicate parameter across the two key forms.
        with pytest.raises(ValueError, match="more than once"):
            pt.sweep(
                y,
                {(x, "loc"): np.array([0.0]), x: {"loc": np.array([1.0])}},
            )
        with pytest.raises(ValueError, match="replicates must be"):
            pt.sweep(y, {(x, "loc"): np.array([0.0])}, replicates=1)
        with pytest.raises(ValueError, match="divisible"):
            pt.sweep(y, {(x, "loc"): np.array([0.0])}, size=1001,
                     replicates=4)
        with pytest.raises(ValueError, match="named"):
            pt.sweep(y, {(x, "loc"): np.array([0.0])}, size=2**12,
                     block_size=2**10, statistics=lambda v: v[0])

    def test_nonfinite_guard(self):
        x = pt.Distribution("norm", loc=10.0, scale=0.1)
        y = pt.models.graph.Log(x)
        with pytest.raises(FloatingPointError, match="Non-finite"):
            pt.sweep(
                y,
                {(x, "loc"): np.array([10.0, -10.0])},
                size=4096,
                random_state=0,
            )

    def test_node_convenience_method(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = 2.0 * x + 1.0
        res = y.sweep({(x, "loc"): np.array([-1.0, 1.0])}, size=4096,
                      random_state=0)
        assert np.abs(res["mean"] - np.array([-1.0, 3.0])).max() < 0.1

    def test_qmc_sem_omitted(self):
        # The iid sem is not a valid QMC error bar: omitted under sobol,
        # kept (conservative) under antithetic, provided by replicates.
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = 2.0 * x
        qmc = pt.sweep(y, {(x, "loc"): np.array([0.0, 1.0])}, size=4096,
                       random_state=0, method="sobol")
        assert "sem" not in qmc.keys()
        anti = pt.sweep(y, {(x, "loc"): np.array([0.0, 1.0])}, size=4096,
                        random_state=0, method="antithetic")
        assert "sem" in anti.keys()


class TestStreamedSweep:
    """block_size=: per-scenario Chan folds, one jitted whole-run program."""

    def test_streamed_matches_analytic(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = 2.0 * x + 1.0
        locs = np.linspace(-2.0, 2.0, 9)
        res = pt.sweep(
            y,
            {(x, "loc"): locs},
            size=1 << 15,
            block_size=1 << 12,
            random_state=0,
            statistics=("mean", "std", "var", "q0.95", "cvar0.95"),
        )
        assert np.abs(res["mean"] - (2 * locs + 1)).max() < 0.05
        assert np.all(np.diff(res["mean"]) > 0)  # CRN ladder monotone
        assert np.abs(res["std"] - 2.0).max() < 0.05
        assert np.abs(res["var"] - 4.0).max() < 0.2
        q = 2 * locs + 1 + 2 * 1.6448536
        assert np.abs(res["q0.95"] - q).max() < 0.1
        es = 2 * locs + 1 + 2 * 2.06271
        assert np.abs(res["cvar0.95"] - es).max() < 0.12
        assert res["sem"].shape == (9,) and np.all(res["sem"] > 0)

    def test_streamed_crn_differences_deterministic(self):
        # Identical scenario values under CRN give IDENTICAL streamed
        # statistics (shared per-block draws), and repeat runs are
        # bitwise-reproducible given the key.
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = x * x
        vals = np.array([0.5, 0.5, 1.5])
        r1 = pt.sweep(y, {(x, "loc"): vals}, size=10_000,
                      block_size=4096, random_state=1)
        r2 = pt.sweep(y, {(x, "loc"): vals}, size=10_000,
                      block_size=4096, random_state=1)
        assert r1["mean"][0] == r1["mean"][1]
        np.testing.assert_array_equal(r1["mean"], r2["mean"])

    def test_streamed_partial_block_and_size_sweep_no_retrace(self):
        from probabilit_tpu.engine import sweep as SW

        x = pt.Distribution("norm", loc=1.0, scale=2.0)
        y = x + 1.0
        res = pt.sweep(y, {(x, "loc"): np.array([0.0, 1.0])},
                       size=4096 + 137, block_size=4096, random_state=0)
        assert np.abs(res["mean"] - np.array([1.0, 2.0])).max() < 0.15
        n_cached = len(SW._SWEEP_CACHE)
        pt.sweep(y, {(x, "loc"): np.array([0.0, 1.0])},
                 size=3 * 4096, block_size=4096, random_state=1)
        assert len(SW._SWEEP_CACHE) == n_cached

    def test_streamed_matches_single_shot_estimator(self):
        # Same statistic targets; different draw partitioning => agree
        # to MC noise.
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = pt.models.graph.Exp(x)
        locs = np.array([0.0, 0.5])
        ss = pt.sweep(y, {(x, "loc"): locs}, size=1 << 15, random_state=2,
                      statistics=("mean", "var"))
        st = pt.sweep(y, {(x, "loc"): locs}, size=1 << 15, random_state=2,
                      statistics=("mean", "var"), block_size=1 << 12)
        assert np.abs(ss["mean"] - st["mean"]).max() < 0.05
        # The lognormal's variance estimator is heavy-tailed (kurtosis
        # ~111 at sigma=1), so independent draws agree only loosely.
        assert np.abs(ss["var"] / st["var"] - 1.0).max() < 0.3

    def test_streamed_correlated_sweep(self):
        # var(a+b) ladder over rho-correlated normals: var = 2 + 2*0.8
        # regardless of loc; streamed per-block recoloring.
        a = pt.Distribution("norm", loc=0.0, scale=1.0)
        b = pt.Distribution("norm", loc=0.0, scale=1.0)
        s = (a + b).correlate(
            a, b, corr_mat=np.array([[1.0, 0.8], [0.8, 1.0]])
        )
        res = pt.sweep(
            s,
            {(a, "loc"): np.array([0.0, 1.0])},
            size=1 << 15,
            block_size=1 << 13,
            random_state=1,
            statistics=("mean", "var"),
        )
        assert np.abs(res["mean"] - np.array([0.0, 1.0])).max() < 0.05
        assert np.abs(res["var"] - 3.6).max() < 0.15

    def test_streamed_non_crn(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = x * x
        vals = np.array([0.5, 0.5])
        res = pt.sweep(y, {(x, "loc"): vals}, size=8192, block_size=4096,
                       random_state=1, common_random_numbers=False)
        assert res["mean"][0] != res["mean"][1]
        assert np.abs(res["mean"] - 1.25).max() < 0.15


class TestSweepReplicates:
    """replicates=: between-replicate sems for every statistic."""

    def test_replicate_sems_cover_truth(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = 2.0 * x + 1.0
        locs = np.array([-1.0, 0.0, 1.0])
        res = pt.sweep(
            y,
            {(x, "loc"): locs},
            size=1 << 14,
            random_state=0,
            replicates=4,
            statistics=("mean", "std"),
        )
        truth = 2 * locs + 1
        assert np.abs(res["mean"] - truth).max() < 0.1
        assert res["mean_sem"].shape == (3,)
        assert np.all(res["mean_sem"] > 0)
        assert np.all(res["std_sem"] > 0)
        np.testing.assert_array_equal(res["sem"], res["mean_sem"])
        # 5-sigma coverage of the analytic truth.
        assert np.all(np.abs(res["mean"] - truth) < 6 * res["mean_sem"] + 1e-3)

    def test_qmc_replicates_valid_error_bar(self):
        # Between-replicate sems are the valid RQMC error estimate and
        # must cover the truth; validated against independent-stream
        # ground truth (20 fresh single-stream runs).
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = pt.models.graph.Exp(x)
        res = pt.sweep(
            y,
            {(x, "loc"): np.array([0.0])},
            size=1 << 14,
            random_state=0,
            method="sobol",
            replicates=8,
        )
        want = np.exp(0.5)
        assert abs(res["mean"][0] - want) < 6 * res["mean_sem"][0] + 1e-4
        # Ground truth spread: independent sobol streams of the same
        # per-replicate size.
        singles = [
            pt.sweep(
                y, {(x, "loc"): np.array([0.0])}, size=1 << 11,
                random_state=100 + i, method="sobol",
            )["mean"][0]
            for i in range(20)
        ]
        truth_sd = np.std(singles, ddof=1)
        est_sd = res["mean_sem"][0] * np.sqrt(8)
        assert 0.3 * truth_sd < est_sd < 3.0 * truth_sd

    def test_streamed_replicates(self):
        x = pt.Distribution("norm", loc=1.0, scale=2.0)
        res = pt.sweep(
            x,
            {(x, "loc"): np.array([1.0, 2.0])},
            size=1 << 14,
            block_size=1 << 12,
            random_state=3,
            replicates=4,
            statistics=("mean", "q0.9"),
        )
        assert np.abs(res["mean"] - np.array([1.0, 2.0])).max() < 0.1
        assert np.all(res["q0.9_sem"] > 0)
        want_q = np.array([1.0, 2.0]) + 2 * 1.2815516
        assert np.all(np.abs(res["q0.9"] - want_q) < 6 * res["q0.9_sem"] + 0.05)


class TestSweepQMCCorrelated:
    """Single-shot QMC + correlated graphs (round-5 demand #5)."""

    def test_sobol_correlated_sweep(self):
        # Same semantics as sample(method="sobol") on a correlated
        # graph: the correlator consumes the sobol quantile matrix.
        a = pt.Distribution("norm", loc=0.0, scale=1.0)
        b = pt.Distribution("norm", loc=0.0, scale=1.0)
        s = (a + b).correlate(
            a, b, corr_mat=np.array([[1.0, 0.8], [0.8, 1.0]])
        )
        res = pt.sweep(
            s,
            {(a, "loc"): np.array([0.0, 1.0])},
            size=1 << 14,
            random_state=0,
            method="sobol",
            statistics=("mean", "var"),
        )
        assert np.abs(res["mean"] - np.array([0.0, 1.0])).max() < 0.05
        assert np.abs(res["var"] - 3.6).max() < 0.15


class TestSequentialSweep:
    """sweep(target_sem=): precision-targeted scenario ladders.

    Rounds of R replicate CRN streams grow until the between-replicate
    sem of every statistic column meets the target; the round size is
    fixed so every round reuses the one compiled program.
    """

    def _grid(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        y = 2.0 * x + 1.0
        return y, {(x, "loc"): np.array([-1.0, 0.0, 1.0])}

    def test_multi_round_convergence_and_accuracy(self):
        y, grid = self._grid()
        # sem ~ 2/sqrt(n_total): one 4096-draw round gives ~0.031, so
        # target 0.01 needs several rounds (~40k draws).
        res = pt.sweep(
            y, grid, size=4096, random_state=0, replicates=4,
            target_sem=0.01,
        )
        assert res.converged is True and res.rounds > 1
        assert res.size == 4096 * res.rounds
        assert np.all(res["sem"] <= 0.01)
        assert np.allclose(res["mean"], [-1.0, 1.0, 3.0], atol=6 * 0.01)

    def test_budget_cap_reports_unconverged(self):
        y, grid = self._grid()
        res = pt.sweep(
            y, grid, size=1024, random_state=1, replicates=4,
            target_sem=1e-6, max_size=4096,
        )
        assert res.converged is False and res.rounds == 4
        assert res.size == 4096

    def test_sem_valid_vs_independent_truth(self):
        y, grid = self._grid()
        res = pt.sweep(
            y, grid, size=2048, random_state=2, replicates=4,
            target_sem=0.02,
        )
        singles = np.stack(
            [
                np.asarray(
                    pt.sweep(
                        y, grid, size=res.size, random_state=100 + i
                    )["mean"]
                )
                for i in range(12)
            ]
        )
        truth_sd = singles.std(axis=0, ddof=1)
        est_sd = np.asarray(res["sem"]) * 2.0  # sem * sqrt(R)
        assert np.all(est_sd < 3.5 * truth_sd)
        assert np.all(est_sd > 0.25 * truth_sd)

    def test_qmc_quantile_sequential(self):
        y, grid = self._grid()
        res = pt.sweep(
            y, grid, size=4096, random_state=1, replicates=4,
            target_sem=0.05, method="sobol",
            statistics=("mean", "q0.9"),
        )
        assert res.converged is True
        want_q = 2.0 * np.array([-1.0, 0.0, 1.0]) + 1.0 + 2.0 * 1.2815516
        assert np.allclose(res["q0.9"], want_q, atol=0.1)
        assert np.all(res["q0.9_sem"] > 0)

    def test_streamed_sequential(self):
        y, grid = self._grid()
        res = pt.sweep(
            y, grid, size=8192, random_state=3, replicates=4,
            target_sem=0.05, block_size=2048,
        )
        assert res.converged is True
        assert np.allclose(res["mean"], [-1.0, 1.0, 3.0], atol=0.3)

    def test_validation(self):
        y, grid = self._grid()
        with pytest.raises(ValueError, match="replicates"):
            pt.sweep(y, grid, size=4096, target_sem=0.01)
        with pytest.raises(ValueError, match="> 0"):
            pt.sweep(
                y, grid, size=4096, replicates=4, target_sem=-1.0
            )
        with pytest.raises(ValueError, match="max_size"):
            pt.sweep(y, grid, size=4096, max_size=1 << 20)
        with pytest.raises(ValueError, match="named"):
            pt.sweep(
                y, grid, size=4096, replicates=4, target_sem=0.01,
                statistics=lambda v: v.max(),
            )
        with pytest.raises(ValueError, match="per-round"):
            pt.sweep(
                y, grid, size=4096, replicates=4, target_sem=0.01,
                max_size=100,
            )


class TestStreamGradCheckpoint:
    """sensitivity(checkpoint=): resumable streamed-gradient folds."""

    def _model(self):
        x = pt.Distribution("norm", loc=2.0, scale=3.0)
        return x, 5 * x + 1

    def _kw(self, path, **extra):
        kw = dict(
            size=20_000, block_size=1_024, random_state=0,
            checkpoint=str(path), checkpoint_every=4_096,
        )
        kw.update(extra)
        return kw

    def test_completed_run_removes_file_and_is_deterministic(self, tmp_path):
        import os

        x, y = self._model()
        p = tmp_path / "g.npz"
        a = sensitivity(y, wrt=x, **self._kw(p))
        assert not os.path.exists(p)
        b = sensitivity(y, wrt=x, **self._kw(p))
        assert a.value == b.value and a.gradients == b.gradients
        assert abs(a[(x, "loc")] - 5.0) < 1e-3
        # Matches the plain streamed fold to float accuracy (segmented
        # float64 host merge vs one device carry).
        plain = sensitivity(
            y, wrt=x, size=20_000, block_size=1_024, random_state=0
        )
        assert abs(a[(x, "loc")] - plain[(x, "loc")]) < 1e-5
        assert abs(a.value - plain.value) < 1e-4 * abs(plain.value)

    def test_killed_run_resumes_bitwise_identically(
        self, tmp_path, monkeypatch
    ):
        from probabilit_tpu.engine import sensitivity as sens_mod

        x, y = self._model()
        p = tmp_path / "g.npz"
        kw = self._kw(p, statistic="var")
        full = sensitivity(y, wrt={x: ["scale"]}, **kw)

        # Die right after the second segment's save: the persisted
        # partial state is exactly what a crash would leave behind.
        real = sens_mod._save_grad_checkpoint
        calls = {"n": 0}

        def dying(*a, **k):
            real(*a, **k)
            calls["n"] += 1
            if calls["n"] >= 2:
                raise RuntimeError("simulated crash")

        monkeypatch.setattr(sens_mod, "_save_grad_checkpoint", dying)
        with pytest.raises(RuntimeError, match="simulated crash"):
            sensitivity(y, wrt={x: ["scale"]}, **kw)
        monkeypatch.setattr(sens_mod, "_save_grad_checkpoint", real)
        assert p.exists()

        resumed = sensitivity(y, wrt={x: ["scale"]}, **kw)
        assert resumed.value == full.value
        assert resumed.gradients == full.gradients

    def test_mismatched_parameters_refused(self, tmp_path, monkeypatch):
        from probabilit_tpu.engine import sensitivity as sens_mod

        x, y = self._model()
        p = tmp_path / "g.npz"
        kw = self._kw(p)
        real = sens_mod._save_grad_checkpoint
        calls = {"n": 0}

        def dying(*a, **k):
            real(*a, **k)
            calls["n"] += 1
            if calls["n"] >= 1:
                raise RuntimeError("boom")

        monkeypatch.setattr(sens_mod, "_save_grad_checkpoint", dying)
        with pytest.raises(RuntimeError, match="boom"):
            sensitivity(y, wrt=x, **kw)
        monkeypatch.setattr(sens_mod, "_save_grad_checkpoint", real)
        assert p.exists()
        # Same graph shape, different CURRENT parameter value: the
        # fingerprint includes theta0, so the resume must refuse.
        old = x.kwargs["loc"]
        x.kwargs["loc"] = 2.5
        try:
            with pytest.raises(ValueError, match="different run"):
                sensitivity(y, wrt=x, **kw)
        finally:
            x.kwargs["loc"] = old

    def test_composition_errors(self, tmp_path):
        x, y = self._model()
        p = str(tmp_path / "g.npz")
        with pytest.raises(ValueError, match="block_size"):
            sensitivity(y, wrt=x, size=1_000, checkpoint=p)
        with pytest.raises(ValueError, match="single-stream"):
            sensitivity(
                y, wrt=x, size=1_000, block_size=256, replicates=2,
                checkpoint=p,
            )
        with pytest.raises(ValueError, match="single-pass"):
            sensitivity(
                y, wrt=x, size=1_000, block_size=256,
                statistic="q0.9", checkpoint=p,
            )
        with pytest.raises(ValueError, match="checkpoint_every"):
            sensitivity(y, wrt=x, size=1_000, checkpoint_every=100)


class TestCVaRStatistic:
    """statistic='cvar<level>' — expected-shortfall values and Greeks."""

    def test_gradients_match_analytic(self):
        # ES_p of loc + scale*Z: d/dloc = 1 exactly; d/dscale =
        # phi(z_p)/(1-p) = 2.0627 at p=0.95 (Hong-Liu pathwise CVaR).
        x = pt.Distribution("norm", loc=2.0, scale=3.0)
        res = sensitivity(
            x, wrt=x, size=1 << 17, random_state=0, statistic="cvar0.95"
        )
        assert res.value == pytest.approx(2.0 + 3.0 * 2.06271, abs=0.08)
        assert res[(x, "loc")] == pytest.approx(1.0, abs=1e-3)
        assert res[(x, "scale")] == pytest.approx(2.06271, abs=0.05)

    def test_sweep_cvar_ladder(self):
        x = pt.Distribution("norm", loc=0.0, scale=3.0)
        locs = np.array([0.0, 1.0, 2.0])
        sw = pt.sweep(
            x,
            {(x, "loc"): locs},
            size=1 << 15,
            random_state=1,
            statistics=("cvar0.95", "q0.95"),
        )
        assert np.abs(sw["cvar0.95"] - (locs + 3 * 2.06271)).max() < 0.1
        # ES dominates VaR at the same level, scenario by scenario.
        assert np.all(sw["cvar0.95"] > sw["q0.95"])

    def test_invalid_levels_rejected(self):
        x = pt.Distribution("norm", loc=0.0, scale=1.0)
        for bad in ("cvar1.5", "cvar0", "cvarx"):
            with pytest.raises(ValueError, match="statistic"):
                sensitivity(x, wrt=x, size=4096, statistic=bad)


class TestStreamedPathNodeTailGreeks:
    """Streamed VaR/CVaR Greeks on path nodes (the bench workload)."""

    def test_gbm_var99_delta_closed_form(self):
        # q_a(S_T) = s0 exp((mu - sigma^2/2) T + sigma sqrt(T) z_a)
        # (terminal of an exact-law GBM is lognormal for any grid), so
        # d q / d s0 = q / s0 — the bench's check, here at test size.
        from probabilit_tpu import GeometricBrownianMotion

        gbm = GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, T=1.0,
                                      steps=8)
        res = sensitivity(
            gbm.terminal(), wrt={gbm: ["s0"]}, size=1 << 17,
            random_state=0, statistic="q0.99", block_size=1 << 14,
        )
        want = float(np.exp(0.03 + 0.2 * 2.3263479))
        assert res[(gbm, "s0")] == pytest.approx(want, rel=0.03)
        assert res.value == pytest.approx(100.0 * want, rel=0.01)

    def test_gbm_cvar_delta_positive_homogeneous(self):
        # S_T is positively homogeneous in s0, so d ES / d s0 = ES / s0
        # exactly — a strong internal-consistency identity.
        from probabilit_tpu import GeometricBrownianMotion

        gbm = GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, T=1.0,
                                      steps=8)
        res = sensitivity(
            gbm.terminal(), wrt={gbm: ["s0"]}, size=1 << 16,
            random_state=1, statistic="cvar0.95", block_size=1 << 13,
        )
        assert res[(gbm, "s0")] == pytest.approx(res.value / 100.0, rel=0.01)
