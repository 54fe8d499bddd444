"""Lévy paths (Variance Gamma, NIG) and square-root diffusions (CIR, Heston).

Framework extensions (the reference models scalar draws only).  Both
module families advertise EXACT grid laws — VG/NIG via closed-form
Lévy increments, CIR via its noncentral-chi-square transition — so the
tests pin terminal distributions against scipy's own families and the
models' analytic moments, plus the path-node plumbing contracts
(QMC slabs, streaming bitwise equality, mesh invariance, validation).
"""

import numpy as np
import pytest
from scipy import stats

from probabilit_tpu import (
    CoxIngersollRoss,
    Heston,
    NormalInverseGaussian,
    VarianceGamma,
)


class TestVarianceGamma:
    def test_terminal_moments_exact(self):
        # X_T = mu T + theta G_T + sigma W(G_T), G_T ~ Gamma(T/nu, nu):
        # mean (mu + theta) T, var (sigma^2 + nu theta^2) T.
        vg = VarianceGamma(mu=0.1, theta=-0.2, sigma=0.3, nu=0.25, T=2.0, steps=16)
        s = np.asarray(vg.terminal().sample(60000, random_state=0))
        assert s.mean() == pytest.approx((0.1 - 0.2) * 2.0, abs=0.01)
        assert s.var() == pytest.approx((0.3**2 + 0.25 * 0.2**2) * 2.0, abs=0.01)
        # theta < 0 skews left (skew sign = sign(theta) for VG).
        assert stats.skew(s) < -0.1

    def test_steps_invariance_of_terminal_law(self):
        # Lévy property: the terminal law must not depend on the grid.
        coarse = VarianceGamma(theta=-0.1, sigma=0.2, nu=0.3, T=1.0, steps=1)
        fine = VarianceGamma(theta=-0.1, sigma=0.2, nu=0.3, T=1.0, steps=64)
        a = np.asarray(coarse.terminal().sample(20000, random_state=1))
        b = np.asarray(fine.terminal().sample(20000, random_state=2))
        assert stats.ks_2samp(a, b).pvalue > 0.01

    def test_sobol_streamed_close_and_moments(self):
        # The gamma clock's shape dt/nu = 0.625 < 1 puts the inverse-CDF
        # Newton on an endpoint pdf singularity where XLA's incomplete
        # gamma (batch-GLOBAL convergence test) drifts ~1 ulp between
        # batch compositions — the documented carve-out
        # (test_streaming_checkpoint.py::test_streamed_singular_beta_close);
        # pinned tight so a real regression still fails.
        from probabilit_tpu.engine import streaming

        vg = VarianceGamma(theta=-0.1, sigma=0.2, nu=0.2, T=1.0, steps=8)
        t = vg.terminal()
        full = np.asarray(t.sample(512, random_state=3, method="sobol"))
        blocks = streaming.sample_streaming(
            t, 512, block_size=128, random_state=3, method="sobol"
        )
        np.testing.assert_allclose(full, np.asarray(blocks), rtol=1e-4, atol=1e-6)
        big = np.asarray(t.sample(8192, random_state=0, method="sobol"))
        assert big.mean() == pytest.approx(-0.1, abs=0.01)

    def test_pathwise_greeks(self):
        # d E[X_T] / d mu = T and / d theta = T (clock mean is T).
        from probabilit_tpu.engine.sensitivity import sensitivity

        vg = VarianceGamma(mu=0.05, theta=-0.1, sigma=0.2, nu=0.2, T=2.0, steps=8)
        res = sensitivity(vg.terminal(), wrt=vg, size=30000, random_state=0)
        assert res[(vg, "mu")] == pytest.approx(2.0, abs=1e-4)
        assert res[(vg, "theta")] == pytest.approx(2.0, abs=0.05)

    def test_validation(self):
        with pytest.raises(ValueError, match="sigma"):
            VarianceGamma(sigma=0.0)
        with pytest.raises(ValueError, match="nu"):
            VarianceGamma(nu=-1.0)


class TestNormalInverseGaussian:
    def test_terminal_matches_scipy_law(self):
        # Increment over T is exactly NIG: scipy norminvgauss with
        # a = alpha delta T, b = beta delta T, loc = mu T, scale = delta T.
        alpha, beta, delta, mu, T = 2.0, -0.5, 0.8, 0.1, 1.5
        nig = NormalInverseGaussian(
            alpha=alpha, beta=beta, delta=delta, mu=mu, T=T, steps=16
        )
        s = np.asarray(nig.terminal().sample(30000, random_state=0))
        p = stats.kstest(
            s[:8000],
            "norminvgauss",
            args=(alpha * delta * T, beta * delta * T, mu * T, delta * T),
        ).pvalue
        assert p > 0.01

    def test_moments(self):
        g = np.sqrt(2.0**2 - 0.5**2)
        nig = NormalInverseGaussian(alpha=2.0, beta=0.5, delta=1.2, mu=0.0, steps=8)
        s = np.asarray(nig.terminal().sample(60000, random_state=1))
        assert s.mean() == pytest.approx(1.2 * 0.5 / g, abs=0.02)
        assert s.var() == pytest.approx(1.2 * 2.0**2 / g**3, abs=0.05)

    def test_steps_invariance_of_terminal_law(self):
        coarse = NormalInverseGaussian(alpha=1.5, beta=0.3, delta=0.7, steps=1)
        fine = NormalInverseGaussian(alpha=1.5, beta=0.3, delta=0.7, steps=32)
        a = np.asarray(coarse.terminal().sample(20000, random_state=4))
        b = np.asarray(fine.terminal().sample(20000, random_state=5))
        assert stats.ks_2samp(a, b).pvalue > 0.01

    def test_validation(self):
        with pytest.raises(ValueError, match="alpha"):
            NormalInverseGaussian(alpha=0.0)
        with pytest.raises(ValueError, match="beta"):
            NormalInverseGaussian(alpha=1.0, beta=1.5)
        with pytest.raises(ValueError, match="delta"):
            NormalInverseGaussian(delta=0.0)


class TestCIR:
    def test_terminal_matches_ncx2_transition(self):
        # Exact transition composed to the horizon: V_T ~ c ncx2(df, v0 e/c).
        v0, kappa, theta, sigma, T = 0.04, 2.0, 0.05, 0.3, 1.0
        v = CoxIngersollRoss(v0=v0, kappa=kappa, theta=theta, sigma=sigma, T=T, steps=32)
        s = np.asarray(v.terminal().sample(30000, random_state=0))
        e = np.exp(-kappa * T)
        c = sigma**2 * (1 - e) / (4 * kappa)
        df = 4 * kappa * theta / sigma**2
        p = stats.kstest(s[:8000] / c, "ncx2", args=(df, v0 * e / c)).pvalue
        assert p > 0.01

    def test_positive_and_mean_reverting(self):
        v = CoxIngersollRoss(v0=0.2, kappa=3.0, theta=0.04, sigma=0.25, T=4.0, steps=64)
        mn = np.asarray(v.minimum().sample(20000, random_state=1))
        assert (mn > 0).all()
        vt = np.asarray(v.terminal().sample(20000, random_state=2))
        # After 12 mean-reversion times the stationary mean is theta.
        assert vt.mean() == pytest.approx(0.04, abs=0.002)

    def test_intermediate_slice_exact(self):
        # at(k) must also follow the composed transition (time (k+1) dt).
        v0, kappa, theta, sigma = 0.06, 1.5, 0.04, 0.2
        v = CoxIngersollRoss(v0=v0, kappa=kappa, theta=theta, sigma=sigma, T=1.0, steps=16)
        s = np.asarray(v.at(7).sample(30000, random_state=3))
        t = 8 / 16
        e = np.exp(-kappa * t)
        c = sigma**2 * (1 - e) / (4 * kappa)
        df = 4 * kappa * theta / sigma**2
        p = stats.kstest(s[:8000] / c, "ncx2", args=(df, v0 * e / c)).pvalue
        assert p > 0.01

    def test_sobol_streamed_bitwise(self):
        from probabilit_tpu.engine import streaming

        v = CoxIngersollRoss(v0=0.04, kappa=2.0, theta=0.04, sigma=0.3, steps=8)
        t = v.terminal()
        full = np.asarray(t.sample(512, random_state=3, method="sobol"))
        blocks = streaming.sample_streaming(
            t, 512, block_size=128, random_state=3, method="sobol"
        )
        np.testing.assert_array_equal(full, np.asarray(blocks))

    def test_validation(self):
        for bad in (
            dict(v0=0.0),
            dict(kappa=-1.0),
            dict(theta=0.0),
            dict(sigma=0.0),
        ):
            with pytest.raises(ValueError):
                CoxIngersollRoss(**bad)
        with pytest.raises(ValueError, match="4\\*kappa\\*theta"):
            CoxIngersollRoss(v0=0.04, kappa=0.5, theta=0.02, sigma=0.5)


class TestHeston:
    def test_martingale_mean(self):
        # E[S_T] = s0 e^{mu T} for the continuous model; the trapezoid
        # integrated-variance approximation is O(dt^2)-weak, so at 64
        # steps the bias is far below the MC standard error.
        h = Heston(
            s0=100, mu=0.04, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3,
            rho=-0.7, T=1.0, steps=64,
        )
        s = np.asarray(h.terminal().sample(60000, random_state=0))
        assert s.mean() == pytest.approx(100 * np.exp(0.04), abs=0.35)

    def test_leverage_skew(self):
        # rho < 0 must add leverage skew BEYOND the rho=0 baseline.
        # (Even at rho=0 log-returns are negatively skewed: with
        # X = -I/2 + sqrt(I) Z the third central moment is
        # -E[(I-EI)^3]/8 - (3/2) Var(I) < 0 from the -I/2 compensator.)
        kw = dict(s0=1.0, mu=0.0, v0=0.04, kappa=2.0, theta=0.04,
                  sigma=0.5, T=1.0, steps=32)
        neg = Heston(rho=-0.8, **kw)
        flat = Heston(rho=0.0, **kw)
        r_neg = stats.skew(np.log(np.asarray(neg.terminal().sample(40000, random_state=1))))
        r_flat = stats.skew(np.log(np.asarray(flat.terminal().sample(40000, random_state=2))))
        assert r_neg < r_flat - 0.3
        assert -0.5 < r_flat < 0.0

    def test_variance_of_log_return_integrates_variance(self):
        # With rho=0 and mu=0, Var[log S_T] ~ E[integral V dt]; at the
        # stationary start v0 = theta that is theta * T.
        h = Heston(s0=1.0, mu=0.0, v0=0.04, kappa=2.0, theta=0.04,
                   sigma=0.3, rho=0.0, T=2.0, steps=64)
        lr = np.log(np.asarray(h.terminal().sample(60000, random_state=3)))
        assert lr.var() == pytest.approx(0.04 * 2.0, rel=0.05)

    def test_sobol_and_mesh_invariance(self):
        from probabilit_tpu.parallel import make_mesh, use_mesh

        h = Heston(s0=100, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3,
                   rho=-0.5, steps=8)
        node = h.terminal()
        base = np.asarray(node.sample(4096, random_state=5, method="sobol"))
        with use_mesh(make_mesh()):
            sharded = np.asarray(node.sample(4096, random_state=5, method="sobol"))
            prng = np.asarray(node.sample(4096, random_state=5))
        # Same Sobol points on every shard, but not always the same bits:
        # the chi-square drivers' Newton inverse (ops/special.gammaincinv)
        # is one fused loop body that XLA compiles per shape, and the
        # CPU backend vectorises and contracts it differently for a
        # 512-row shard than for 4096 rows.  That moves the last bit of a
        # few lanes (measured: 1 of 4096 terminals, 9.2e-8 relative; the
        # same function differs between a 4096-row batch and its last 512
        # rows with no mesh at all).  Hence rtol 1e-6, not bitwise.
        np.testing.assert_allclose(sharded, base, rtol=1e-6)
        assert np.isfinite(prng).all()

    def test_validation(self):
        with pytest.raises(ValueError, match="rho"):
            Heston(rho=1.0)
        with pytest.raises(ValueError, match="s0"):
            Heston(s0=0.0)


class TestQuantilePlumbing:
    def test_q_widths(self):
        from probabilit_tpu.engine import compile as _compile

        # d_total equals the node's total driver count: the scalar
        # column doubles as slab dimension 0.
        vg = VarianceGamma(steps=8)
        assert _compile.get_plan(vg.terminal()).d_total == 16
        nig = NormalInverseGaussian(steps=8)
        assert _compile.get_plan(nig.terminal()).d_total == 16
        cir = CoxIngersollRoss(kappa=2.0, theta=0.04, sigma=0.3, steps=8)
        assert _compile.get_plan(cir.terminal()).d_total == 16
        h = Heston(kappa=2.0, theta=0.04, sigma=0.3, steps=8)
        assert _compile.get_plan(h.terminal()).d_total == 24
