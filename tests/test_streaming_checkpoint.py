"""Streamed sampling, streaming estimates, checkpoint/resume, profiling."""

import numpy as np
import pytest

from probabilit_tpu.engine import checkpoint, streaming
from probabilit_tpu.modeling import Distribution, Exp


class TestStreaming:
    def test_streamed_equals_blocked_total(self):
        model = Distribution("norm", loc=2.0, scale=0.5) * 3
        out = streaming.sample_streaming(model, 10_000, block_size=1024, random_state=0)
        assert out.shape == (10_000,)
        assert np.isclose(out.mean(), 6.0, atol=0.05)
        assert np.isfinite(out).all()

    def test_non_block_multiple_size(self):
        model = Distribution("uniform")
        out = streaming.sample_streaming(model, 1000, block_size=333, random_state=1)
        assert out.shape == (1000,)
        assert out.min() >= 0 and out.max() < 1

    def test_blocks_are_independent(self):
        model = Distribution("norm")
        out = streaming.sample_streaming(model, 2048, block_size=1024, random_state=0)
        # Different blocks must not repeat the same random values.
        assert not np.allclose(out[:1024], out[1024:])

    def test_estimate_matches_analytic(self):
        model = Distribution("norm", loc=5, scale=2)
        stats = streaming.estimate(model, 400_000, block_size=65_536, random_state=0)
        assert stats["n"] == 400_000
        assert np.isclose(stats["mean"], 5.0, atol=0.02)
        assert np.isclose(stats["std"], 2.0, atol=0.02)
        assert stats["min"] < 0 < stats["max"]

    def test_estimate_partial_last_block(self):
        model = Distribution("uniform")
        stats = streaming.estimate(model, 1000, block_size=512, random_state=0)
        assert stats["n"] == 1000
        assert 0.4 < stats["mean"] < 0.6

    def test_correlated_qmc_rejected(self):
        # Streamed QMC promises bitwise equality with single-shot runs,
        # which per-block recoloring cannot satisfy — still an error.
        a, b = Distribution("norm"), Distribution("norm")
        expr = (a + b).correlate(a, b, corr_mat=np.eye(2))
        with pytest.raises(ValueError, match="correlation-free"):
            streaming.sample_streaming(expr, 100, block_size=64, method="sobol")

    def test_correlated_streaming(self):
        # Sort-free per-block recoloring: every streamed block carries
        # EXACTLY the target score correlation, so Var(a+b) = 2 + 2*0.6
        # pools across blocks too.  The reference cannot stream
        # correlated models at any size (IC needs all samples at once).
        a, b = Distribution("norm"), Distribution("norm")
        expr = (a + b).correlate(a, b, corr_mat=np.array([[1, 0.6], [0.6, 1]]))
        out = streaming.sample_streaming(
            expr, 200_000, block_size=32_768, random_state=0
        )
        assert out.shape == (200_000,)
        assert np.isclose(out.var(), 3.2, atol=0.03)
        # Per-block exactness (up to the CDF-roundtrip polynomials).
        assert np.isclose(out[:32_768].var(), 3.2, atol=0.03)

    def test_streamed_quantiles(self):
        import scipy.stats

        model = Distribution("norm", loc=5, scale=2)
        st = streaming.estimate(
            model, 400_000, block_size=65_536, random_state=0,
            quantiles=(0.5, 0.95, 0.99),
        )
        ref = scipy.stats.norm(5, 2)
        for lvl in (0.5, 0.95, 0.99):
            assert np.isclose(st[f"q{lvl:g}"], ref.ppf(lvl), atol=0.03), lvl

    def test_streamed_quantiles_partial_block_and_validation(self):
        model = Distribution("uniform")
        st = streaming.estimate(
            model, 100_001, block_size=32_768, random_state=1, quantiles=(0.25,)
        )
        assert np.isclose(st["q0.25"], 0.25, atol=0.01)
        with pytest.raises(ValueError, match="in \\(0, 1\\)"):
            streaming.estimate(model, 1000, quantiles=(0.0,))

    def test_streamed_cvar_exact_on_single_block(self):
        # One full block: the streamed Rockafellar-Uryasev ES must equal
        # the same identity evaluated on the materialised stream.
        model = Distribution("norm")
        n = 32_768
        st = streaming.estimate(
            model, n, block_size=n, random_state=3,
            cvar=(0.95, 0.99),
        )
        xs = np.sort(
            np.asarray(
                streaming.sample_streaming(
                    model, n, block_size=n, random_state=3
                )
            )
        )
        for q in (0.95, 0.99):
            pos = q * (n - 1)
            lo = int(pos)
            v = xs[lo] + (pos - lo) * (xs[lo + 1] - xs[lo])
            es = v + np.maximum(xs - v, 0.0).sum() / (n * (1 - q))
            assert np.isclose(st[f"cvar{q:g}"], es, rtol=1e-5), q

    def test_streamed_cvar_rows_path_matches_analytic(self):
        import scipy.stats

        # block_size > 2^17 and a multiple of it: the per-row sort path.
        model = Distribution("norm")
        bs = 1 << 18
        st = streaming.estimate(
            model, 2 * bs, block_size=bs, random_state=11,
            quantiles=(0.9,), cvar=(0.95,),
        )
        z = scipy.stats.norm.ppf(0.95)
        exact_es = scipy.stats.norm.pdf(z) / 0.05
        assert np.isclose(st["cvar0.95"], exact_es, atol=0.02)
        assert st["cvar0.95"] > st["q0.9"]

    def test_streamed_histogram_exact_counts(self):
        # Counts (incl. under/overflow and a partial final block) must
        # exactly bucket the materialised stream by the documented
        # half-open convention.
        model = Distribution("norm")
        n, lo, hi, bins = 10_001, -2.0, 2.0, 16
        st = streaming.estimate(
            model, n, block_size=1024, random_state=7,
            histogram=(lo, hi, bins),
        )
        xs = np.asarray(
            streaming.sample_streaming(
                model, n, block_size=1024, random_state=7
            )
        )
        idx = (
            np.clip(np.floor((xs - lo) * bins / (hi - lo)), -1, bins).astype(
                int
            )
            + 1
        )
        exp = np.bincount(idx, minlength=bins + 2)
        h = st["histogram"]
        np.testing.assert_array_equal(h["counts"], exp[1:-1])
        assert h["underflow"] == exp[0] and h["overflow"] == exp[-1]
        np.testing.assert_allclose(h["edges"], np.linspace(lo, hi, bins + 1))
        assert h["counts"].sum() + h["underflow"] + h["overflow"] == n

    def test_streamed_histogram_composes_with_where(self):
        x = Distribution("norm")
        st = streaming.estimate(
            x, 5_000, block_size=1024, random_state=7,
            where=(x > 0), histogram=(-3.0, 3.0, 12),
        )
        h = st["histogram"]
        counted = h["counts"].sum() + h["underflow"] + h["overflow"]
        assert counted == st["n"] < 5_000
        # Nothing below zero may be counted when the condition is x > 0.
        assert h["underflow"] == 0 and h["counts"][:6].sum() == 0

    def test_cvar_histogram_validation(self):
        x = Distribution("norm")
        with pytest.raises(ValueError, match="CVaR levels"):
            streaming.estimate(x, 100, block_size=64, cvar=(1.0,))
        with pytest.raises(ValueError, match="lo < hi"):
            streaming.estimate(x, 100, block_size=64, histogram=(1.0, 0.0, 5))
        with pytest.raises(ValueError, match="bins must be"):
            streaming.estimate(x, 100, block_size=64, histogram=(0, 1, 9999))
        with pytest.raises(ValueError, match="triple"):
            streaming.estimate(x, 100, block_size=64, histogram=(0, 1))
        with pytest.raises(ValueError, match="does not compose"):
            streaming.estimate(
                x, 100, block_size=64, where=(x > 0), cvar=(0.9,)
            )

    def test_cvar_histogram_size_sweep_no_retrace(self):
        x = Distribution("norm") + 1.0
        kw = dict(block_size=512, cvar=(0.9,), histogram=(-3, 5, 6))
        streaming.estimate(x, 3_000, random_state=0, **kw)
        before = streaming._TRACE_COUNT
        st = streaming.estimate(x, 7_777, random_state=1, **kw)
        assert streaming._TRACE_COUNT == before
        assert st["histogram"]["counts"].sum() + st["histogram"][
            "underflow"
        ] + st["histogram"]["overflow"] == 7_777

    def test_cvar_composes_with_replicates(self):
        x = Distribution("norm")
        st = streaming.estimate(
            x, 8_192, block_size=1_024, random_state=2, method="sobol",
            replicates=4, cvar=(0.9,), histogram=(-3, 3, 6),
        )
        # Pooled count-weighted CVaR and summed replicate histograms.
        assert 1.6 < st["cvar0.9"] < 1.9
        h = st["histogram"]
        assert h["counts"].sum() + h["underflow"] + h["overflow"] == 8_192

    def test_correlated_estimate(self):
        a, b = Distribution("norm"), Distribution("norm")
        expr = (a + b).correlate(a, b, corr_mat=np.array([[1, -0.7], [-0.7, 1]]))
        stats = streaming.estimate(expr, 300_000, block_size=65_536, random_state=2)
        assert np.isclose(stats["std"], np.sqrt(0.6), atol=0.01)
        assert np.isclose(stats["mean"], 0.0, atol=0.01)


class TestCheckpoint:
    def test_roundtrip_in_process(self, tmp_path):
        a = Distribution("norm")
        expr = Exp(a) + 1
        expr.sample(100, random_state=0)
        path = checkpoint.save(expr, tmp_path / "state.npz")

        original = np.asarray(expr.samples_)
        expr.sample(100, random_state=1)  # Overwrite with different state
        assert not np.allclose(np.asarray(expr.samples_), original)

        checkpoint.load(expr, path)
        np.testing.assert_allclose(np.asarray(expr.samples_), original)
        assert hasattr(a, "samples_")

    def test_restore_into_fresh_graph(self, tmp_path):
        def build():
            a = Distribution("norm", loc=1, scale=2)
            return Exp(a) * 3

        g1 = build()
        g1.sample(50, random_state=7)
        path = checkpoint.save(g1, tmp_path / "s.npz")

        g2 = build()  # Different _ids, same structure
        checkpoint.load(g2, path)
        np.testing.assert_allclose(
            np.asarray(g2.samples_), np.asarray(g1.samples_)
        )

    def test_gc_state_roundtrip(self, tmp_path):
        a = Distribution("norm")
        expr = a + 1
        expr.sample(10, random_state=0, gc_strategy=[])
        path = checkpoint.save(expr, tmp_path / "gc.npz")
        g2 = (Distribution("norm") + 1)
        checkpoint.load(g2, path)
        assert hasattr(g2, "samples_")
        parents = list(g2.get_parents())
        assert not hasattr(parents[0], "samples_")


class TestProfiling:
    def test_phase_timer(self):
        from probabilit_tpu.utils.profiling import PhaseTimer

        t = PhaseTimer()
        with t.phase("a"):
            pass
        with t.phase("b"):
            pass
        report = t.report()
        assert "a" in report and "b" in report

    def test_compiled_stats(self):
        import jax
        import jax.numpy as jnp

        from probabilit_tpu.utils.profiling import compiled_stats

        f = jax.jit(lambda x: jnp.sum(x * 2.0))
        stats = compiled_stats(f, jnp.ones((128, 128)))
        assert stats["flops"] is None or stats["flops"] > 0


class TestNodeConvenienceMethods:
    def test_node_estimate(self):
        from probabilit_tpu.modeling import Distribution

        stats = Distribution("norm", loc=7).estimate(
            50_000, block_size=8192, random_state=0
        )
        assert np.isclose(stats["mean"], 7.0, atol=0.05)

    def test_node_sample_streaming(self):
        from probabilit_tpu.modeling import Distribution

        out = (Distribution("uniform") * 2).sample_streaming(
            10_000, block_size=4096, random_state=1
        )
        assert out.shape == (10_000,)
        assert 0.95 < out.mean() < 1.05


class TestCheckpointFingerprint:
    def test_mismatched_graph_rejected(self, tmp_path):
        from probabilit_tpu.engine import checkpoint
        from probabilit_tpu.modeling import Distribution

        g1 = Distribution("norm") + Distribution("expon")
        g1.sample(10, random_state=0)
        path = checkpoint.save(g1, tmp_path / "fp.npz")

        different = Distribution("norm") * Distribution("expon")
        with pytest.raises(ValueError, match="fingerprint"):
            checkpoint.load(different, path)

    def test_scalar_transform_static_args_distinguish(self):
        # Static (non-Node) arguments and the Node/static layout are part
        # of the structure: st(x, 2) and st(x, 3) compute different
        # functions and must not share a fingerprint.
        from probabilit_tpu.engine import checkpoint
        from probabilit_tpu.modeling import Distribution, scalar_transform

        @scalar_transform
        def f(a, b):
            return a + b

        x = Distribution("norm")
        fp2 = checkpoint.graph_fingerprint(f(x, 2.0))
        fp3 = checkpoint.graph_fingerprint(f(x, 3.0))
        fp_swapped = checkpoint.graph_fingerprint(f(2.0, x))
        assert fp2 != fp3
        assert fp2 != fp_swapped

    def test_scalar_transform_array_args_sign_by_content(self):
        # numpy reprs truncate past 1000 elements and default object
        # reprs embed memory addresses: array args must sign by bytes,
        # address-bearing reprs by type (stable across processes).
        from probabilit_tpu.engine import checkpoint
        from probabilit_tpu.modeling import Distribution, scalar_transform

        @scalar_transform
        def f(a, table):
            return a

        x = Distribution("norm")
        t1 = np.arange(2000.0)
        t2 = t1.copy()
        t2[1200] = -1.0
        assert checkpoint.graph_fingerprint(f(x, t1)) != checkpoint.graph_fingerprint(
            f(x, t2)
        )
        # Same-typed address-bearing objects fingerprint identically
        # (stability beats distinguishing them).
        o1, o2 = object(), object()
        assert checkpoint.graph_fingerprint(f(x, o1)) == checkpoint.graph_fingerprint(
            f(x, o2)
        )

    def test_fingerprint_stable_across_rebuilds(self):
        from probabilit_tpu.engine import checkpoint
        from probabilit_tpu.modeling import Distribution

        def build():
            return Distribution("norm", loc=2) ** Distribution("uniform")

        assert checkpoint.graph_fingerprint(build()) == checkpoint.graph_fingerprint(
            build()
        )


class TestStreamingFiniteGuard:
    def test_estimate_raises_on_nonfinite(self):
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        # log of a negative-location normal produces NaNs.
        from probabilit_tpu.models.graph import Log

        model = Log(Distribution("norm", loc=-100.0, scale=1.0))
        with pytest.raises(ValueError, match="non-finite"):
            streaming.estimate(model, 10_000, block_size=4096, random_state=0)

    def test_sample_streaming_raises_on_nonfinite(self):
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.models.graph import Log
        from probabilit_tpu.modeling import Distribution

        model = Log(Distribution("norm", loc=-100.0, scale=1.0))
        with pytest.raises(ValueError, match="non-finite"):
            streaming.sample_streaming(model, 10_000, block_size=4096, random_state=0)


class TestProfilingIntegration:
    def test_sample_emits_phase_report(self, capfd, monkeypatch):
        from probabilit_tpu.modeling import Distribution

        monkeypatch.setenv("PROBABILIT_TPU_PROFILE", "1")
        Distribution("norm").sample(64, random_state=0)
        err = capfd.readouterr().err
        assert "[probabilit-tpu profile]" in err
        for phase in ("build+compile", "execute", "host"):
            assert phase in err


class TestStreamedQMC:
    def test_streamed_sobol_equals_single_shot(self):
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        expr = Distribution("lognorm", s=0.4) + Distribution("uniform")
        single = np.asarray(expr.sample(4096, random_state=5, method="sobol"))
        streamed = streaming.sample_streaming(
            expr, 4096, block_size=512, random_state=5, method="sobol"
        )
        np.testing.assert_array_equal(single, streamed)

    def test_streamed_halton_equals_single_shot(self):
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        expr = Distribution("norm", loc=2) * 3
        single = np.asarray(expr.sample(2048, random_state=1, method="halton"))
        streamed = streaming.sample_streaming(
            expr, 2048, block_size=300, random_state=1, method="halton"
        )
        np.testing.assert_array_equal(single, streamed)

    def test_streamed_antithetic_equals_single_shot(self):
        # Pair-index addressability: blocks whose boundaries split an
        # antithetic pair still reproduce the single-shot rows bitwise.
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        expr = Distribution("norm", loc=1.5) * Distribution("uniform")
        single = np.asarray(expr.sample(2048, random_state=9, method="antithetic"))
        streamed = streaming.sample_streaming(
            expr, 2048, block_size=300, random_state=9, method="antithetic"
        )
        np.testing.assert_array_equal(single, streamed)

    def test_streamed_incomplete_families_equal_single_shot(self):
        # Newton-on-incomplete-function ppfs freeze converged lanes
        # per-element (absorbing mask), so trip counts are intrinsic to
        # each lane and streamed blocks reproduce the single-shot values
        # BITWISE.  A batch-global convergence test here would differ by
        # ~1e-6 depending on block composition (regression: round-2 review).
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        cases = [
            ("gamma", dict(a=2.0)),
            ("chi2", dict(df=5.0)),
            ("beta", dict(a=2.5, b=3.5)),
            ("t", dict(df=3.0)),
        ]
        for fam, kw in cases:
            expr = Distribution(fam, **kw)
            single = np.asarray(expr.sample(2048, random_state=0, method="sobol"))
            streamed = streaming.sample_streaming(
                expr, 2048, block_size=512, random_state=0, method="sobol"
            )
            np.testing.assert_array_equal(single, streamed, err_msg=fam)

    def test_streamed_singular_beta_close(self):
        # a or b < 1 puts the clipped guess on the endpoint pdf
        # singularity, where XLA's own incomplete-beta primitive (which
        # iterates with a batch-GLOBAL convergence test) drifts ~2e-6
        # between batch compositions — outside our control; pinned here
        # so a larger drift (a real regression) still fails.
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        expr = Distribution("beta", a=0.5, b=0.5)
        single = np.asarray(expr.sample(2048, random_state=0, method="sobol"))
        streamed = streaming.sample_streaming(
            expr, 2048, block_size=512, random_state=0, method="sobol"
        )
        np.testing.assert_allclose(single, streamed, rtol=1e-4, atol=1e-5)

    def test_streamed_qmc_rejects_past_index_range(self):
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        with pytest.raises(ValueError, match="at most 2\\^32"):
            streaming.sample_streaming(
                Distribution("norm"), 2**32 + 1, method="sobol"
            )
        with pytest.raises(ValueError, match="at most 2\\^31"):
            streaming.estimate(
                Distribution("norm"), 2**31 + 1, method="halton"
            )

    def test_estimate_with_sobol(self):
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        model = Distribution("norm", loc=7.0)
        stats = streaming.estimate(
            model, 200_000, block_size=16384, random_state=0, method="sobol"
        )
        # QMC mean error decays ~1/n: far tighter than the MC tolerance.
        assert abs(stats["mean"] - 7.0) < 1e-3

    def test_streamed_lhs_bitwise_equals_single_shot(self):
        # The keyed-Feistel stratification made LHS index-addressable
        # (VERDICT r2 #8): streamed blocks must reproduce the single-shot
        # global stratification EXACTLY, including a partial last block.
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        expr = Distribution("norm") * 2 + 1
        single = np.asarray(expr.sample(5000, random_state=3, method="lhs"))
        streamed = streaming.sample_streaming(
            expr, 5000, block_size=1024, random_state=3, method="lhs"
        )
        np.testing.assert_array_equal(single, streamed)

    def test_streamed_lhs_large_bitwise(self):
        # The VERDICT r2 "done" criterion: 1e6 points, bitwise equality.
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        expr = Distribution("uniform")
        n = 1_000_000
        single = np.asarray(expr.sample(n, random_state=0, method="lhs"))
        streamed = streaming.sample_streaming(
            expr, n, block_size=1 << 18, random_state=0, method="lhs"
        )
        np.testing.assert_array_equal(single, streamed)

    def test_streamed_lhs_estimate(self):
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        stats = streaming.estimate(
            Distribution("uniform"), 100_000, block_size=16384, random_state=1,
            method="lhs",
        )
        # Stratification: mean error ~1/n, far below the MC tolerance.
        assert abs(stats["mean"] - 0.5) < 1e-4

    def test_lhs_estimate_size_sweep_not_cross_contaminated(self):
        # LHS block programs close over the run's TOTAL size (the global
        # stratification); the estimate cache must NOT reuse a program
        # built for another size (review finding r3): the second call's
        # mean must match the single-shot sample of ITS OWN size to
        # stratification precision, not carry the first call's domain.
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        model = Distribution("uniform")
        streaming.estimate(
            model, 2048, block_size=1024, random_state=7, method="lhs"
        )
        stats = streaming.estimate(
            model, 8192, block_size=1024, random_state=7, method="lhs"
        )
        single = np.asarray(
            model.sample(8192, random_state=7, method="lhs")
        ).mean()
        assert abs(stats["mean"] - single) < 1e-5

    def test_size_zero_rejected(self):
        from probabilit_tpu.engine import streaming
        from probabilit_tpu.modeling import Distribution

        with pytest.raises(ValueError, match="size must be >= 1"):
            streaming.estimate(Distribution("norm"), 0, block_size=256)
        with pytest.raises(ValueError, match="size must be >= 1"):
            streaming.sample_streaming(Distribution("norm"), 0, block_size=256)


class TestStreamingFinalizers:
    def test_streamed_string_categorical_returns_values(self):
        # Same output contract as sample(): actual values, not raw int32
        # indices (reference modeling.py:893-895 returns values from
        # every sampling entry point).
        from probabilit_tpu.modeling import DiscreteDistribution

        d = DiscreteDistribution(["a", "b", "c"], [0.2, 0.3, 0.5])
        single = np.asarray(d.sample(3000, random_state=0))
        streamed = streaming.sample_streaming(
            d, 3000, block_size=1024, random_state=0
        )
        assert streamed.dtype == single.dtype == d.values.dtype
        assert set(np.unique(streamed)) <= {"a", "b", "c"}
        values, counts = np.unique(streamed, return_counts=True)
        freq = dict(zip(values, counts / 3000))
        assert np.isclose(freq["c"], 0.5, atol=0.04)

    def test_estimate_refuses_non_numeric_sink(self):
        from probabilit_tpu.modeling import DiscreteDistribution

        d = DiscreteDistribution(["x", "y"], [0.5, 0.5])
        with pytest.raises(ValueError, match="numeric sink"):
            streaming.estimate(d, 1000, block_size=256)

    def test_numeric_discrete_unaffected(self):
        from probabilit_tpu.modeling import DiscreteDistribution

        d = DiscreteDistribution([1.0, 2.0, 4.0], [0.25, 0.25, 0.5])
        out = streaming.sample_streaming(d, 4000, block_size=1024, random_state=1)
        assert np.isclose(out.mean(), 2.75, atol=0.1)
        stats = streaming.estimate(d, 4000, block_size=1024, random_state=1)
        assert np.isclose(stats["mean"], 2.75, atol=0.1)


class TestEstimateSizeAgnostic:
    def test_size_sweep_no_retrace(self):
        # n_blocks/last_count are traced scalars: sweeping sizes reuses
        # ONE compiled program (VERDICT r2 weak #3: each size used to pay
        # a ~17 s remote recompile).
        model = Distribution("norm", loc=3.0, scale=1.5)
        st0 = streaming.estimate(model, 1000, block_size=512, random_state=0)
        count = streaming._TRACE_COUNT
        st1 = streaming.estimate(model, 3000, block_size=512, random_state=0)
        st2 = streaming.estimate(model, 2048, block_size=512, random_state=0)
        assert streaming._TRACE_COUNT == count
        assert st0["n"] == 1000 and st1["n"] == 3000 and st2["n"] == 2048
        assert np.isclose(st1["mean"], 3.0, atol=0.1)
        assert np.isclose(st2["std"], 1.5, atol=0.1)

    def test_size_sweep_quantiles_no_retrace(self):
        model = Distribution("uniform")
        streaming.estimate(
            model, 1000, block_size=512, random_state=0, quantiles=(0.5, 0.9)
        )
        count = streaming._TRACE_COUNT
        st = streaming.estimate(
            model, 1537, block_size=512, random_state=0, quantiles=(0.5, 0.9)
        )
        assert streaming._TRACE_COUNT == count
        assert np.isclose(st["q0.5"], 0.5, atol=0.05)
        assert np.isclose(st["q0.9"], 0.9, atol=0.05)

    def test_single_partial_block(self):
        model = Distribution("uniform")
        st = streaming.estimate(
            model, 300, block_size=1024, random_state=2, quantiles=(0.25,)
        )
        assert st["n"] == 300
        assert np.isclose(st["mean"], 0.5, atol=0.06)
        assert np.isclose(st["q0.25"], 0.25, atol=0.08)


class TestEstimateErrorBars:
    def test_sem_matches_iid_formula(self):
        model = Distribution("norm", loc=3.0) + Distribution("uniform")
        st = streaming.estimate(model, 8192, block_size=1024, random_state=0)
        assert st["sem"] == pytest.approx(st["std"] / np.sqrt(st["n"]), rel=1e-12)

    def test_replicates_share_one_program(self):
        # All R randomised streams and the pooled result reuse the same
        # compiled block program (it is size- and key-agnostic).
        model = Distribution("norm", loc=1.0)
        streaming.estimate(
            model, 1024, block_size=256, random_state=0, replicates=2
        )
        count = streaming._TRACE_COUNT
        st = streaming.estimate(
            model, 4096, block_size=256, random_state=1, replicates=8
        )
        assert streaming._TRACE_COUNT == count
        assert st["replicates"] == 8 and st["n"] == 4096
        assert np.isclose(st["mean"], 1.0, atol=5 * st["sem"] + 1e-3)

    def test_rqmc_sem_beats_iid_sem(self):
        # Randomised-QMC error estimation: 8 independently scrambled
        # Sobol streams of a smooth model must show an error bar far
        # below the iid formula at the same total size — the whole point
        # of a valid QMC sem (the iid formula ignores QMC convergence).
        model = Distribution("norm", loc=3.0) + Distribution("uniform")
        iid = streaming.estimate(model, 65536, block_size=8192, random_state=0)
        rq = streaming.estimate(
            model,
            65536,
            block_size=8192,
            random_state=0,
            method="sobol",
            replicates=8,
        )
        assert rq["sem"] < 0.2 * iid["sem"]
        # The pooled mean should agree with the truth within its own bar.
        assert abs(rq["mean"] - 3.5) < 6 * rq["sem"] + 1e-4

    def test_antithetic_replicates_collapse_sem(self):
        # Odd-symmetric pipeline: every antithetic pair averages to the
        # true mean, so between-replicate variance is ~0.
        model = Distribution("norm") + Distribution("uniform")
        iid = streaming.estimate(model, 16384, block_size=2048, random_state=3)
        anti = streaming.estimate(
            model,
            16384,
            block_size=2048,
            random_state=3,
            method="antithetic",
            replicates=4,
        )
        assert anti["sem"] < 0.05 * iid["sem"]

    def test_replicate_validation(self):
        model = Distribution("uniform")
        with pytest.raises(ValueError, match="divisible"):
            streaming.estimate(model, 100, block_size=64, replicates=3)
        with pytest.raises(ValueError, match="replicates must be >= 2"):
            streaming.estimate(model, 100, block_size=64, replicates=1)

    def test_replicates_pool_matches_single_stream_scale(self):
        # Pooled var/std across replicates is a consistent estimate of
        # the population variance (not of the sem): compare to a plain
        # single-stream run of the same size.
        model = Distribution("norm", loc=2.0, scale=3.0)
        pooled = streaming.estimate(
            model, 8192, block_size=1024, random_state=5, replicates=4
        )
        single = streaming.estimate(model, 8192, block_size=1024, random_state=5)
        assert np.isclose(pooled["std"], single["std"], rtol=0.1)
        assert np.isclose(pooled["std"], 3.0, rtol=0.1)


class TestStreamedQuantileTails:
    def test_extreme_tail_level_not_row_saturated(self):
        # Levels within 1/2^17 of an endpoint bypass the row-batched
        # estimator (which would saturate at the row max, ~q=0.9999924
        # for uniform rows) in favour of exact full-block sorts
        # (ADVICE r2).  2^21 uniform draws in 2^18-sample blocks: the
        # row path would return ~0.9999924 +- 2e-6; the exact path
        # ~0.9999999.
        model = Distribution("uniform")
        st = streaming.estimate(
            model,
            1 << 21,
            block_size=1 << 18,
            random_state=3,
            quantiles=(1.0 - 1e-7,),
        )
        assert st[f"q{1.0 - 1e-7:g}"] > 0.999995

    def test_row_batched_path_accurate_midrange(self):
        # Blocks wide enough for the 2^17-column row path: midrange
        # levels use it and stay accurate.
        model = Distribution("uniform")
        st = streaming.estimate(
            model,
            1 << 19,
            block_size=1 << 18,
            random_state=4,
            quantiles=(0.5, 0.95),
        )
        assert np.isclose(st["q0.5"], 0.5, atol=0.01)
        assert np.isclose(st["q0.95"], 0.95, atol=0.01)


class TestShardedQMCGeneration:
    def test_sharded_generation_matches_unsharded(self):
        import jax

        from probabilit_tpu.ops import qmc
        from probabilit_tpu.parallel import make_mesh, use_mesh

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        key = jax.random.PRNGKey(3)
        base = np.asarray(qmc.generate("sobol", key, 4096, 5))
        with use_mesh(make_mesh()):
            sharded = qmc.generate_sharded("sobol", key, 4096, 5)
            assert len(sharded.sharding.device_set) == 8
            np.testing.assert_array_equal(base, np.asarray(sharded))

    def test_sample_method_under_mesh(self):
        import jax

        from probabilit_tpu.modeling import Distribution
        from probabilit_tpu.parallel import make_mesh, use_mesh

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        expr = Distribution("gamma", a=3.0) + 1
        base = np.asarray(expr.sample(4096, random_state=2, method="sobol"))
        with use_mesh(make_mesh()):
            sharded = np.asarray(expr.sample(4096, random_state=2, method="sobol"))
        np.testing.assert_array_equal(base, sharded)


class TestStreamingCorrelatorParam:
    """correlator= pass-through on the streaming entry points (extension:
    the reference cannot stream correlated models at all)."""

    def _model(self):
        import numpy as np

        from probabilit_tpu.modeling import Distribution

        a = Distribution("norm")
        b = Distribution("expon")
        C = np.array([[1, 0.6], [0.6, 1.0]])
        return (a + b).correlate(a, b, corr_mat=C.copy())

    def test_tcopula_estimate_fattens_the_sum_tail(self):
        from probabilit_tpu.correlation import StudentTCopula

        model = self._model()
        kw = dict(block_size=32768, random_state=0, quantiles=(0.99,))
        et = streaming.estimate(
            model, 262144, correlator=StudentTCopula(df=3), **kw
        )
        eg = streaming.estimate(model, 262144, **kw)
        # Same marginals, same mean; the t-copula couples the tails so
        # the sum's p99 must exceed the Gaussian copula's.
        assert np.isclose(et["mean"], 1.0, atol=0.02)
        assert np.isclose(eg["mean"], 1.0, atol=0.02)
        assert et["q0.99"] > eg["q0.99"] + 0.05

    def test_tcopula_sample_streaming_runs(self):
        from probabilit_tpu.correlation import StudentTCopula

        model = self._model()
        s = streaming.sample_streaming(
            model,
            20000,
            block_size=8192,
            random_state=0,
            correlator=StudentTCopula(df=4),
        )
        assert s.shape == (20000,) and np.isfinite(s).all()


class TestControlVariates:
    def _model(self):
        from probabilit_tpu.models.graph import Exp

        z = Distribution("norm")
        noise = Distribution("norm", loc=0, scale=2.0)
        return Exp(0.3 * z) + noise, noise, float(np.exp(0.3**2 / 2))

    def test_sem_reduction_and_unbiasedness(self):
        model, noise, true_mean = self._model()
        plain = streaming.estimate(model, 65536, block_size=8192, random_state=0)
        cv = streaming.estimate(
            model, 65536, block_size=8192, random_state=0, control=(noise, 0.0)
        )
        # The noise term dominates the variance (rho ~ 0.99): controlling
        # on it must shrink the error bar several-fold and leave the
        # estimate consistent with the truth at its own scale.
        assert cv["sem"] < 0.3 * plain["sem"]
        assert abs(cv["mean"] - true_mean) < 5 * cv["sem"] + 1e-3
        assert cv["control_beta"] == pytest.approx(1.0, abs=0.05)
        assert abs(cv["control_rho"]) > 0.9
        # var/std/min/max stay distribution properties, not estimator ones.
        assert cv["std"] == pytest.approx(plain["std"], abs=1e-9)
        assert cv["min"] == plain["min"] and cv["max"] == plain["max"]

    def test_composes_with_replicates(self):
        model, noise, true_mean = self._model()
        cvr = streaming.estimate(
            model,
            65536,
            block_size=8192,
            random_state=0,
            control=(noise, 0.0),
            replicates=4,
        )
        assert cvr["replicates"] == 4
        assert abs(cvr["mean"] - true_mean) < 6 * cvr["sem"] + 2e-3
        # The replicate sem prices the ADJUSTED estimator: far below the
        # raw model noise sigma/sqrt(n) ~ 0.0079.
        assert cvr["sem"] < 0.004

    def test_quantiles_unaffected_by_control(self):
        model, noise, _ = self._model()
        q = (0.5, 0.9)
        a = streaming.estimate(
            model, 32768, block_size=8192, random_state=1, quantiles=q
        )
        b = streaming.estimate(
            model,
            32768,
            block_size=8192,
            random_state=1,
            quantiles=q,
            control=(noise, 0.0),
        )
        assert a["q0.5"] == b["q0.5"] and a["q0.9"] == b["q0.9"]

    def test_validation(self):
        model, noise, _ = self._model()
        with pytest.raises(ValueError, match="pair"):
            streaming.estimate(model, 100, block_size=64, control=noise)
        with pytest.raises(ValueError, match="graph node"):
            streaming.estimate(model, 100, block_size=64, control=(3.0, 0.0))

    def test_sibling_control_supported(self):
        # The natural use: control and sink are SIBLINGS sharing a parent
        # (vanilla call controlling an Asian option).  The engine roots
        # them under a cached NoOp so one plan drives both.
        from probabilit_tpu.models.graph import Exp

        z = Distribution("norm")
        sink = Exp(0.2 * z)
        control = 3.0 * z  # sibling, mean 0 known
        cv = streaming.estimate(
            sink, 32768, block_size=8192, random_state=0, control=(control, 0.0)
        )
        plain = streaming.estimate(sink, 32768, block_size=8192, random_state=0)
        assert abs(cv["control_rho"]) > 0.9
        assert cv["sem"] < 0.5 * plain["sem"]
        assert abs(cv["mean"] - np.exp(0.02)) < 5 * cv["sem"] + 1e-3
        # Cached union sink: a second call must not retrace.
        count = streaming._TRACE_COUNT
        streaming.estimate(
            sink, 16384, block_size=8192, random_state=1, control=(control, 0.0)
        )
        assert streaming._TRACE_COUNT == count

    def test_disjoint_control_harmless(self):
        # A control sharing no randomness is statistically useless but
        # must not corrupt the estimate (beta ~ 0).
        model, _, true_mean = self._model()
        cv = streaming.estimate(
            model,
            16384,
            block_size=4096,
            random_state=3,
            control=(Distribution("norm"), 0.0),
        )
        assert abs(cv["control_beta"]) < 0.15
        assert abs(cv["mean"] - true_mean) < 0.05

    def test_uncorrelated_control_is_harmless(self):
        # A control with ~zero correlation must not corrupt the estimate:
        # beta ~ 0 and the mean stays the plain-MC value.
        a = Distribution("norm", loc=5.0)
        b = Distribution("uniform")
        model = a + 0.0 * b
        plain = streaming.estimate(model, 32768, block_size=8192, random_state=2)
        cv = streaming.estimate(
            model, 32768, block_size=8192, random_state=2, control=(b, 0.5)
        )
        assert abs(cv["control_beta"]) < 0.1
        assert cv["mean"] == pytest.approx(plain["mean"], abs=0.01)


class TestEstimateMany:
    def test_joint_consistency_and_moments(self):
        eq = Distribution("lognorm", s=0.25)
        bo = Distribution("norm", loc=1.02, scale=0.05)
        total = 0.6 * eq + 0.4 * bo
        res = streaming.estimate_many(
            [eq, bo, total], 100_000, block_size=16384, random_state=0
        )
        assert np.isclose(res[eq]["mean"], np.exp(0.25**2 / 2), atol=3e-3)
        assert np.isclose(res[bo]["mean"], 1.02, atol=1e-3)
        assert np.isclose(res[bo]["std"], 0.05, atol=2e-3)
        # SAME joint draws: the linear identity holds to float rounding,
        # which per-node estimate() calls cannot achieve (each sink gets
        # its own column layout and randomness).
        lin = 0.6 * res[eq]["mean"] + 0.4 * res[bo]["mean"]
        assert abs(res[total]["mean"] - lin) < 1e-5
        for stats in res.values():
            assert stats["sem"] == pytest.approx(
                stats["std"] / np.sqrt(stats["n"]), rel=1e-9
            )

    def test_program_cached_across_calls_and_sizes(self):
        a = Distribution("norm")
        b = a * 2
        streaming.estimate_many([a, b], 1000, block_size=256, random_state=0)
        count = streaming._TRACE_COUNT
        res = streaming.estimate_many([a, b], 3000, block_size=256, random_state=1)
        assert streaming._TRACE_COUNT == count
        assert res[a]["n"] == 3000

    def test_correlated_model(self):
        a, b = Distribution("norm"), Distribution("norm")
        s = a + b
        s.correlate(a, b, corr_mat=np.array([[1, 0.6], [0.6, 1.0]]))
        res = streaming.estimate_many(
            [a, b, s], 200_000, block_size=32768, random_state=2
        )
        assert np.isclose(res[s]["var"], 3.2, atol=0.05)
        assert np.isclose(res[a]["std"], 1.0, atol=0.02)

    def test_qmc_method(self):
        a = Distribution("uniform")
        b = Distribution("norm", loc=3)
        res = streaming.estimate_many(
            [a, b], 32768, block_size=8192, random_state=0, method="sobol"
        )
        assert np.isclose(res[a]["mean"], 0.5, atol=1e-3)
        assert np.isclose(res[b]["mean"], 3.0, atol=1e-2)

    def test_validation(self):
        a = Distribution("norm")
        with pytest.raises(ValueError, match="at least one"):
            streaming.estimate_many([], 100)
        with pytest.raises(ValueError, match="appears twice"):
            streaming.estimate_many([a, a], 100)
        with pytest.raises(ValueError, match="graph nodes"):
            streaming.estimate_many([3.0], 100)
        from probabilit_tpu.modeling import DiscreteDistribution

        sd = DiscreteDistribution(["a", "b"])
        with pytest.raises(ValueError, match="non-numeric"):
            streaming.estimate_many([sd], 100, block_size=64)

    def test_nonfinite_guard(self):
        from probabilit_tpu.models.graph import Log

        bad = Log(Distribution("norm", loc=-100.0))
        with pytest.raises(ValueError, match="non-finite"):
            streaming.estimate_many([bad], 10_000, block_size=4096, random_state=0)


class TestEstimateManyQuantiles:
    def test_per_node_quantiles_match_analytic(self):
        import scipy.stats as sps

        eq = Distribution("lognorm", s=0.25)
        bo = Distribution("norm", loc=1.02, scale=0.05)
        total = 0.6 * eq + 0.4 * bo
        res = streaming.estimate_many(
            [eq, bo, total],
            200_000,
            block_size=32768,
            random_state=0,
            quantiles=(0.5, 0.95),
        )
        assert res[bo]["q0.5"] == pytest.approx(1.02, abs=2e-3)
        assert res[bo]["q0.95"] == pytest.approx(
            sps.norm.ppf(0.95, 1.02, 0.05), abs=2e-3
        )
        assert res[eq]["q0.95"] == pytest.approx(
            sps.lognorm.ppf(0.95, 0.25), abs=5e-3
        )
        # Monotone combination: the total's p95 sits between components'
        # scaled contributions and above its median.
        assert res[total]["q0.95"] > res[total]["q0.5"]

    def test_no_quantiles_by_default_and_cache_split(self):
        a = Distribution("uniform")
        plain = streaming.estimate_many([a], 4096, block_size=1024, random_state=1)
        assert "q0.5" not in plain[a]
        withq = streaming.estimate_many(
            [a], 4096, block_size=1024, random_state=1, quantiles=(0.25,)
        )
        assert withq[a]["q0.25"] == pytest.approx(0.25, abs=0.02)
        with pytest.raises(ValueError, match="in \\(0, 1\\)"):
            streaming.estimate_many([a], 100, block_size=64, quantiles=(1.5,))


class TestEstimateManyParity:
    """estimate_many carries every single-sink estimate() feature."""

    def test_cvar_rides_quantile_sorts(self):
        import scipy.stats as sps

        x = Distribution("norm", loc=1.0, scale=2.0)
        y = Distribution("expon")
        res = streaming.estimate_many(
            [x, y],
            200_000,
            block_size=32_768,
            random_state=0,
            quantiles=(0.95,),
            cvar=(0.95,),
        )
        # Normal ES_q = loc + scale * phi(z_q) / (1 - q).
        want_x = 1.0 + 2.0 * sps.norm.pdf(sps.norm.ppf(0.95)) / 0.05
        assert res[x]["cvar0.95"] == pytest.approx(want_x, rel=0.01)
        # Exponential ES_q = 1 - log(1 - q) = q_q + 1.
        assert res[y]["cvar0.95"] == pytest.approx(
            1.0 - np.log(0.05), rel=0.01
        )
        for node in (x, y):
            assert res[node]["cvar0.95"] > res[node]["q0.95"]

    def test_per_node_histograms_exact(self):
        x = Distribution("uniform")
        y = x * 2.0
        res = streaming.estimate_many(
            [x, y],
            50_000,
            block_size=8_192,  # partial last block
            random_state=1,
            histogram=(0.0, 2.0, 8),
        )
        for node in (x, y):
            h = res[node]["histogram"]
            assert (
                int(h["counts"].sum()) + h["underflow"] + h["overflow"]
                == 50_000
            )
        # x in [0,1): upper half of the range must be empty.
        assert res[x]["histogram"]["counts"][4:].sum() == 0
        assert res[x]["histogram"]["overflow"] == 0
        # y = 2x spreads over the whole range, ~uniformly.
        ycounts = res[y]["histogram"]["counts"]
        assert ycounts.min() > 0.8 * 50_000 / 8

    def test_where_matches_single_sink(self):
        x = Distribution("norm", loc=1.0, scale=2.0)
        y = x * x
        cond = x > 2.0
        many = streaming.estimate_many(
            [x, y], 100_000, block_size=16_384, random_state=2, where=cond
        )
        one = streaming.estimate(
            x, 100_000, block_size=16_384, random_state=2, where=cond
        )
        assert many[x]["n"] == one["n"]
        assert many[x]["mean"] == pytest.approx(one["mean"], rel=1e-5)
        assert many[x]["acceptance"] == pytest.approx(one["acceptance"])
        assert many[x]["n_total"] == 100_000
        # Conditional consistency across nodes: y = x^2 given x > 2.
        assert many[y]["min"] >= many[x]["min"] ** 2 - 1e-3

    def test_shared_control_adjusts_every_node(self):
        a = Distribution("norm", loc=1.0, scale=1.0)
        b = Distribution("expon")
        tot = a + b
        res = streaming.estimate_many(
            [tot, b],
            65_536,
            block_size=16_384,
            random_state=3,
            control=(a, 1.0),
        )
        # tot co-moves 1:1 with the control; b is independent of it.
        assert res[tot]["control_beta"] == pytest.approx(1.0, abs=0.05)
        assert abs(res[b]["control_beta"]) < 0.05
        assert res[tot]["mean"] == pytest.approx(2.0, abs=0.02)
        # Variance reduction shows in the reported sem.
        plain = streaming.estimate_many(
            [tot], 65_536, block_size=16_384, random_state=3
        )
        assert res[tot]["sem"] < 0.75 * plain[tot]["sem"]

    def test_rqmc_replicates_give_valid_joint_error_bars(self):
        # The VERDICT-4 'done' shape: desk+total VaR/CVaR profile with
        # randomised-QMC error bars, all from one joint program.
        eq = Distribution("lognorm", s=0.25)
        bo = Distribution("norm", loc=1.02, scale=0.05)
        total = 0.6 * eq + 0.4 * bo
        res = streaming.estimate_many(
            [eq, bo, total],
            65_536,
            block_size=8_192,
            random_state=4,
            method="sobol",
            replicates=4,
            quantiles=(0.95,),
            cvar=(0.95,),
        )
        for node in (eq, bo, total):
            assert res[node]["replicates"] == 4
            assert res[node]["cvar0.95"] > res[node]["q0.95"]
        # Joint consistency of the means survives replication.
        lin = 0.6 * res[eq]["mean"] + 0.4 * res[bo]["mean"]
        assert abs(res[total]["mean"] - lin) < 1e-4
        # RQMC sem beats the iid formula for these smooth sinks.
        iid = streaming.estimate_many(
            [total], 65_536, block_size=8_192, random_state=4
        )
        assert res[total]["sem"] < iid[total]["sem"]

    def test_replicates_with_control(self):
        a = Distribution("norm", loc=1.0)
        tot = a + Distribution("expon")
        res = streaming.estimate_many(
            [tot],
            65_536,
            block_size=8_192,
            random_state=5,
            control=(a, 1.0),
            replicates=4,
        )
        assert res[tot]["mean"] == pytest.approx(2.0, abs=0.02)
        assert res[tot]["replicates"] == 4

    def test_composition_rules_match_estimate(self):
        x = Distribution("norm")
        cond = x > 0
        with pytest.raises(ValueError, match="quantiles=/cvar="):
            streaming.estimate_many(
                [x], 1000, block_size=256, where=cond, quantiles=(0.5,)
            )
        with pytest.raises(ValueError, match="quantiles=/cvar="):
            streaming.estimate_many(
                [x], 1000, block_size=256, where=cond, cvar=(0.95,)
            )
        with pytest.raises(ValueError, match="control="):
            streaming.estimate_many(
                [x], 1000, block_size=256, where=cond, control=(x, 0.0)
            )
        with pytest.raises(ValueError, match="histogram must be"):
            streaming.estimate_many([x], 1000, block_size=256, histogram=3)
        with pytest.raises(ValueError, match="replicates must be"):
            streaming.estimate_many([x], 1000, block_size=256, replicates=1)
        with pytest.raises(ValueError, match="divisible"):
            streaming.estimate_many([x], 1001, block_size=256, replicates=4)
        with pytest.raises(ValueError, match="\\(node, known_mean\\)"):
            streaming.estimate_many([x], 1000, block_size=256, control=x)


class TestConditionalEstimate:
    """estimate(..., where=cond): streamed conditional statistics."""

    def test_halfnormal_conditional_mean(self):
        x = Distribution("norm")
        res = streaming.estimate(
            x, 200_000, block_size=32_768, random_state=0, where=(x > 0)
        )
        assert res["mean"] == pytest.approx(np.sqrt(2 / np.pi), abs=0.01)
        assert res["acceptance"] == pytest.approx(0.5, abs=0.01)
        assert res["n"] + 0 == int(res["n"])  # integer accepted count
        assert res["n_total"] == 200_000
        assert res["min"] > 0.0
        # Conditional variance of the half-normal: 1 - 2/pi.
        assert res["var"] == pytest.approx(1 - 2 / np.pi, abs=0.01)

    def test_sink_may_be_nonfinite_off_condition(self):
        # log(x) is NaN for x < 0; masked lanes must never trip the
        # finite guard nor poison the sums.
        x = Distribution("norm")
        from probabilit_tpu.models.graph import Log

        res = streaming.estimate(
            Log(x), 200_000, block_size=32_768, random_state=1, where=(x > 0)
        )
        # E[log|Z|] = -(gamma + log 2)/2 for standard normal.
        want = -(np.euler_gamma + np.log(2)) / 2
        assert res["mean"] == pytest.approx(want, abs=0.02)

    def test_matches_direct_masked_computation(self):
        # Deterministic under sobol: the streamed conditional moments
        # must equal the host-side masked statistics of the same draws.
        x = Distribution("norm", loc=1.0, scale=2.0)
        cond = x > 2.0
        size, bs = 40_000, 8_192  # partial final block (40000 % 8192 != 0)
        res = streaming.estimate(
            x, size, block_size=bs, random_state=3, method="sobol", where=cond
        )
        full = np.asarray(x.sample(size, random_state=3, method="sobol"))
        kept = full[full > 2.0]
        assert res["n"] == kept.size
        assert res["mean"] == pytest.approx(kept.mean(), rel=1e-5)
        assert res["var"] == pytest.approx(kept.var(), rel=1e-4)
        assert res["min"] == pytest.approx(kept.min(), rel=1e-6)
        assert res["max"] == pytest.approx(kept.max(), rel=1e-6)

    def test_rare_condition_and_replicates(self):
        # Rare tail (acceptance ~0.13%): early blocks may hold zero
        # accepted samples; merges must stay NaN-free.  E[Z | Z > 3] =
        # phi(3)/Phi(-3).
        from scipy import stats as sps

        x = Distribution("norm")
        res = streaming.estimate(
            x,
            400_000,
            block_size=16_384,
            random_state=4,
            where=(x > 3),
            replicates=4,
        )
        want = sps.norm.pdf(3) / sps.norm.sf(3)
        assert res["mean"] == pytest.approx(want, abs=0.03)
        assert 0.0005 < res["acceptance"] < 0.0025
        assert np.isfinite(res["sem"])

    def test_validation_and_composition_errors(self):
        x = Distribution("norm")
        with pytest.raises(ValueError, match="graph node"):
            streaming.estimate(x, 1000, where=True)
        with pytest.raises(ValueError, match="quantiles"):
            streaming.estimate(x, 1000, where=(x > 0), quantiles=(0.5,))
        with pytest.raises(ValueError, match="control"):
            streaming.estimate(x, 1000, where=(x > 0), control=(x, 0.0))
        with pytest.raises(ValueError, match="never held"):
            streaming.estimate(
                x, 2_000, block_size=1_024, random_state=5, where=(x > 9)
            )

    def test_zero_accept_replicates_excluded_from_sem(self):
        # Review regression: a replicate whose condition never held used
        # to contribute its never-updated 0.0 init mean to rep_means,
        # fabricating sem.  Zero-accept carries are excluded; if fewer
        # than two replicates accepted anything, the sem is undefined
        # and the call raises.
        from probabilit_tpu.engine.streaming import _merge_carries

        zero = (
            0.0, 0.0, 0.0, np.inf, -np.inf, True, np.zeros(0), 0, 0, 0,
            np.zeros(0), 0.0, 0.0,
        )
        live = (
            100.0, 3.7, 42.0, 1.0, 8.0, True, np.zeros(0), 0, 0, 0,
            np.zeros(0), 0.0, 0.0,
        )
        merged, rep_means = _merge_carries([zero, live, live])
        assert rep_means == [3.7, 3.7]
        assert merged[0] == 200.0 and merged[1] == pytest.approx(3.7)

        # Seed picked so exactly ONE of the four replicate streams
        # accepts samples: a valid mean exists but no spread does.
        x = Distribution("norm")
        with pytest.raises(ValueError, match="replicates accepted"):
            streaming.estimate(
                x, 4_000, block_size=512, random_state=1,
                where=(x > 3.5), replicates=4,
            )

    def test_vector_valued_condition_rejected(self):
        from probabilit_tpu import BrownianMotion

        w = BrownianMotion(steps=4)
        with pytest.raises(ValueError, match="vector-valued"):
            streaming.estimate(w.terminal(), 1000, where=w)


class TestSequentialEstimate:
    """estimate(..., target_sem=) — precision-targeted sequential runs."""

    def test_converges_to_target(self):
        x = Distribution("norm", loc=2.0, scale=3.0)
        st = streaming.estimate(
            x, 2048, block_size=1024, random_state=0, target_sem=0.02
        )
        assert st["converged"] is True
        assert st["sem"] <= 0.02
        assert st["rounds"] > 1 and st["n"] > 2048
        # Two-stage sizing lands near n = 1.2 * (std/target)^2, never
        # wildly past it (the 20% inflation + one resize step).
        assert st["n"] < 4.0 * (3.0 / 0.02) ** 2
        assert abs(st["mean"] - 2.0) < 5 * st["sem"] + 1e-9

    def test_rounds_share_one_program(self):
        x = Distribution("norm", loc=1.0)
        streaming.estimate(x, 512, block_size=256, random_state=0)
        count = streaming._TRACE_COUNT
        st = streaming.estimate(
            x, 512, block_size=256, random_state=1, target_sem=0.05
        )
        assert streaming._TRACE_COUNT == count
        assert st["converged"]

    def test_relative_target(self):
        x = Distribution("norm", loc=10.0, scale=2.0)
        st = streaming.estimate(
            x, 1024, block_size=512, random_state=2, target_rel_sem=0.01
        )
        assert st["converged"] and st["sem"] <= 0.01 * abs(st["mean"])

    def test_max_size_cap(self):
        x = Distribution("norm")
        st = streaming.estimate(
            x,
            1024,
            block_size=1024,
            random_state=1,
            target_sem=1e-7,
            max_size=4096,
        )
        assert st["converged"] is False
        assert st["n"] == 4096 and st["sem"] > 1e-7

    def test_constant_sink_converges_in_one_round(self):
        from probabilit_tpu.modeling import Constant

        node = Constant(4.0) + Distribution("uniform") * 0.0
        st = streaming.estimate(
            node, 512, block_size=256, random_state=0, target_sem=1e-9
        )
        assert st["converged"] and st["rounds"] == 1
        assert st["mean"] == pytest.approx(4.0)

    def test_composes_with_where(self):
        x = Distribution("norm")
        st = streaming.estimate(
            x,
            4096,
            block_size=1024,
            random_state=3,
            where=(x > 0.0),
            target_sem=0.02,
        )
        assert st["converged"] and st["sem"] <= 0.02
        # E[Z | Z > 0] = sqrt(2/pi)
        assert abs(st["mean"] - np.sqrt(2 / np.pi)) < 5 * st["sem"] + 1e-9
        assert 0.3 < st["acceptance"] < 0.7
        assert st["n_total"] >= st["n"]

    def test_control_variate_shrinks_required_n(self):
        # Stopping prices the control-ADJUSTED sem, so a well-correlated
        # control must reach the same target with far fewer draws.
        y = Distribution("norm", loc=0.0, scale=1.0)
        x = y + 0.1 * Distribution("norm", loc=1.0)
        plain = streaming.estimate(
            x, 1024, block_size=512, random_state=4, target_sem=0.01
        )
        ctl = streaming.estimate(
            x,
            1024,
            block_size=512,
            random_state=4,
            target_sem=0.01,
            control=(y, 0.0),
        )
        assert ctl["converged"] and ctl["sem"] <= 0.01
        assert ctl["n"] < 0.25 * plain["n"]

    def test_quantiles_and_histogram_ride_along(self):
        x = Distribution("norm")
        st = streaming.estimate(
            x,
            2048,
            block_size=1024,
            random_state=5,
            target_sem=0.02,
            quantiles=(0.5,),
            histogram=(-4.0, 4.0, 16),
        )
        assert st["converged"]
        assert abs(st["q0.5"]) < 0.1
        h = st["histogram"]
        total = h["counts"].sum() + h["underflow"] + h["overflow"]
        assert int(total) == st["n"]

    def test_error_paths(self):
        x = Distribution("norm")
        # QMC sequential stopping needs replicates (the valid stopping
        # statistic); replicates=1 is never meaningful.
        with pytest.raises(ValueError, match="QMC error bar"):
            streaming.estimate(
                x, 1024, target_sem=0.1, method="sobol", random_state=0
            )
        with pytest.raises(ValueError, match="replicates must be"):
            streaming.estimate(
                x, 1024, target_sem=0.1, replicates=1, random_state=0
            )
        with pytest.raises(ValueError, match="must be > 0"):
            streaming.estimate(x, 1024, target_sem=0.0, random_state=0)
        with pytest.raises(ValueError, match="max_size"):
            streaming.estimate(
                x, 1024, target_sem=0.1, max_size=512, random_state=0
            )

    def test_antithetic_allowed_and_converges(self):
        x = Distribution("norm", loc=5.0)
        st = streaming.estimate(
            x,
            1024,
            block_size=512,
            random_state=6,
            method="antithetic",
            target_sem=0.05,
        )
        assert st["converged"] and st["sem"] <= 0.05
        assert abs(st["mean"] - 5.0) < 5 * st["sem"] + 1e-9


class TestSequentialEstimateMany:
    """estimate_many(..., target_sem=) — joint sequential stopping."""

    def test_all_nodes_converge_worst_binds(self):
        a = Distribution("norm", loc=1.0, scale=1.0)
        b = Distribution("norm", loc=0.0, scale=5.0)
        total = a + b
        out = streaming.estimate_many(
            [a, b, total],
            2048,
            block_size=1024,
            random_state=0,
            target_sem=0.05,
        )
        assert all(v["converged"] and v["sem"] <= 0.05 for v in out.values())
        # One shared stream: every node reports the same n and rounds.
        assert len({v["n"] for v in out.values()}) == 1
        assert len({v["rounds"] for v in out.values()}) == 1
        # The sizing is driven by the WORST node (total, var ~26):
        # n ~ 1.2 * 26 / 0.05^2 ~ 12.5k, far beyond what `a` alone needs.
        n = next(iter(out.values()))["n"]
        assert 26 / 0.05**2 < n < 4.0 * 26 / 0.05**2
        assert abs(out[total]["mean"] - 1.0) < 5 * out[total]["sem"]

    def test_consistent_with_single_sink_rules(self):
        a = Distribution("norm")
        # target_sem + replicates is SUPPORTED for estimate_many (the
        # replicated Chow-Robbins path) — only a degenerate replicate
        # count is rejected, same as estimate().
        with pytest.raises(ValueError, match=">= 2"):
            streaming.estimate_many(
                [a], 1024, target_sem=0.1, replicates=1, random_state=0
            )
        out = streaming.estimate_many(
            [a], 1024, block_size=512, target_sem=0.1, replicates=2,
            random_state=0,
        )
        assert out[a]["converged"] is True and out[a]["replicates"] == 2
        with pytest.raises(ValueError, match="QMC error bar"):
            streaming.estimate_many(
                [a], 1024, target_sem=0.1, method="lhs", random_state=0
            )
        with pytest.raises(ValueError, match="max_size"):
            streaming.estimate_many(
                [a], 1024, target_sem=0.1, max_size=4, random_state=0
            )

    def test_cap_reports_unconverged(self):
        a = Distribution("norm")
        out = streaming.estimate_many(
            [a, a + 1.0],
            512,
            block_size=512,
            random_state=1,
            target_sem=1e-7,
            max_size=1024,
        )
        assert all(v["converged"] is False for v in out.values())
        assert all(v["n"] == 1024 for v in out.values())

    def test_composes_with_where_and_quantiles(self):
        x = Distribution("norm")
        y = x * 2.0
        out = streaming.estimate_many(
            [x, y],
            4096,
            block_size=1024,
            random_state=2,
            where=(x > 0.0),
            target_sem=0.03,
        )
        assert all(v["converged"] for v in out.values())
        assert abs(out[x]["mean"] - np.sqrt(2 / np.pi)) < 5 * out[x]["sem"]
        assert abs(out[y]["mean"] - 2 * out[x]["mean"]) < 1e-6
        outq = streaming.estimate_many(
            [x, y],
            2048,
            block_size=1024,
            random_state=3,
            target_sem=0.05,
            quantiles=(0.5,),
        )
        assert all("q0.5" in v and v["converged"] for v in outq.values())


class TestStreamedMoments:
    """estimate(..., moments=True) — streamed skewness / excess kurtosis."""

    def test_matches_scipy_on_materialized_draws(self):
        import scipy.stats

        x = Distribution("lognorm", s=0.5)
        st = streaming.estimate(
            x, 1 << 15, block_size=1 << 12, random_state=0, moments=True
        )
        # Exactness of the fold: sample_streaming yields the SAME draws
        # estimate folds (per-sample scalars), so scipy on the
        # materialized stream must agree to f32 merge noise.
        draws = np.fromiter(
            streaming.sample_streaming(
                x, 1 << 15, block_size=1 << 12, random_state=0
            ),
            np.float32,
            count=1 << 15,
        )
        g1 = scipy.stats.skew(draws)
        g2 = scipy.stats.kurtosis(draws)
        assert st["skew"] == pytest.approx(g1, rel=2e-4)
        assert st["kurt"] == pytest.approx(g2, rel=2e-3, abs=2e-3)

    def test_host_merge_exactness_via_replicates(self):
        # The replicates path pools per-replicate carries through the
        # HOST Pebay merge; materializing each replicate's stream (same
        # folded keys) and running scipy on the concatenation must agree
        # to f32 noise — exactness of _merge_carries' M3/M4.
        import scipy.stats

        from probabilit_tpu.engine.sampler import resolve_key

        x = Distribution("expon")
        n, reps = 1 << 13, 4
        st = streaming.estimate(
            x,
            n,
            block_size=1 << 10,
            random_state=1,
            replicates=reps,
            moments=True,
        )
        import jax

        key = resolve_key(1)
        draws = np.concatenate(
            [
                np.fromiter(
                    streaming.sample_streaming(
                        x,
                        n // reps,
                        block_size=1 << 10,
                        random_state=jax.random.fold_in(key, r),
                    ),
                    np.float32,
                    count=n // reps,
                )
                for r in range(reps)
            ]
        )
        assert st["skew"] == pytest.approx(
            float(scipy.stats.skew(draws)), rel=2e-4
        )
        assert st["kurt"] == pytest.approx(
            float(scipy.stats.kurtosis(draws)), rel=2e-3, abs=2e-3
        )

    def test_normal_truth_and_default_off(self):
        x = Distribution("norm", loc=3.0)
        st = streaming.estimate(
            x, 1 << 15, block_size=1 << 12, random_state=2, moments=True
        )
        assert abs(st["skew"]) < 0.05 and abs(st["kurt"]) < 0.1
        st0 = streaming.estimate(x, 4096, block_size=1024, random_state=2)
        assert "skew" not in st0 and "kurt" not in st0

    def test_composes_with_where_replicates_sequential(self):
        x = Distribution("norm")
        # Conditional shape: Z | Z > 0 is the half-normal,
        # skew = sqrt(2)(4 - pi)/(pi - 2)^1.5 ~ 0.9953.
        stw = streaming.estimate(
            x,
            1 << 16,
            block_size=1 << 13,
            random_state=3,
            where=(x > 0.0),
            moments=True,
        )
        assert stw["skew"] == pytest.approx(0.9953, abs=0.06)
        str_ = streaming.estimate(
            x,
            1 << 14,
            block_size=1 << 12,
            random_state=4,
            replicates=4,
            moments=True,
        )
        assert abs(str_["skew"]) < 0.1
        sts = streaming.estimate(
            x,
            2048,
            block_size=1024,
            random_state=5,
            target_sem=0.02,
            moments=True,
        )
        assert sts["converged"] and np.isfinite(sts["kurt"])

    def test_estimate_many_parity(self):
        import scipy.stats

        a = Distribution("lognorm", s=0.5)
        b = Distribution("norm")
        out = streaming.estimate_many(
            [a, b], 1 << 15, block_size=1 << 12, random_state=6, moments=True
        )
        g1 = float(scipy.stats.lognorm.stats(0.5, moments="s"))
        assert out[a]["skew"] == pytest.approx(g1, abs=0.3)
        assert abs(out[b]["skew"]) < 0.06 and abs(out[b]["kurt"]) < 0.15
        out0 = streaming.estimate_many(
            [a, b], 4096, block_size=1024, random_state=6
        )
        assert "skew" not in out0[a]


class TestStreamedCovariance:
    """estimate_many(..., covariance=True) — joint M x M cov/corr."""

    def test_matches_analytic_linear_model(self):
        x = Distribution("norm")
        y = 2.0 * x + Distribution("norm")
        z = -1.0 * x + Distribution("norm", scale=0.5)
        out = streaming.estimate_many(
            [x, y, z],
            1 << 16,
            block_size=1 << 13,
            random_state=0,
            covariance=True,
        )
        corr = np.stack([out[n]["corr"] for n in (x, y, z)])
        cov = np.stack([out[n]["cov"] for n in (x, y, z)])
        # Symmetric, unit diagonal, and cov diagonal == streamed var.
        assert np.allclose(corr, corr.T, atol=1e-6)
        assert np.allclose(np.diag(corr), 1.0)
        for i, n in enumerate((x, y, z)):
            assert cov[i, i] == pytest.approx(out[n]["var"], rel=1e-4)
        # corr(x,y) = 2/sqrt(5); corr(x,z) = -1/sqrt(1.25);
        # corr(y,z) = -2/sqrt(5 * 1.25).
        assert corr[0, 1] == pytest.approx(2 / np.sqrt(5.0), abs=0.01)
        assert corr[0, 2] == pytest.approx(-1 / np.sqrt(1.25), abs=0.01)
        assert corr[1, 2] == pytest.approx(-2 / np.sqrt(6.25), abs=0.01)

    def test_default_off(self):
        x = Distribution("norm")
        out = streaming.estimate_many(
            [x, x + 1.0], 4096, block_size=1024, random_state=1
        )
        assert "cov" not in out[x] and "corr" not in out[x]

    def test_composes_with_where(self):
        # X | X > 0 against Y = 2X + E: Var(X | X>0) = 1 - 2/pi, so
        # corr = 2v / sqrt(v (4v + 1)).
        x = Distribution("norm")
        y = 2.0 * x + Distribution("norm")
        out = streaming.estimate_many(
            [x, y],
            1 << 16,
            block_size=1 << 13,
            random_state=2,
            covariance=True,
            where=x > 0,
        )
        v = 1.0 - 2.0 / np.pi
        expected = 2 * v / np.sqrt(v * (4 * v + 1))
        assert float(out[x]["corr"][1]) == pytest.approx(expected, abs=0.02)
        assert out[x]["acceptance"] == pytest.approx(0.5, abs=0.02)

    def test_composes_with_replicates_and_sequential(self):
        x = Distribution("norm")
        y = 2.0 * x + Distribution("norm")
        rep = streaming.estimate_many(
            [x, y],
            1 << 14,
            block_size=1 << 12,
            random_state=3,
            covariance=True,
            replicates=4,
        )
        assert float(rep[x]["corr"][1]) == pytest.approx(
            2 / np.sqrt(5.0), abs=0.03
        )
        seq = streaming.estimate_many(
            [x, y],
            1 << 12,
            block_size=1 << 12,
            random_state=4,
            covariance=True,
            moments=True,
            target_sem=0.05,
        )
        assert seq[x]["converged"]
        assert float(seq[x]["corr"][1]) == pytest.approx(
            2 / np.sqrt(5.0), abs=0.05
        )

    def test_matrix_reassembly_order(self):
        # Row i of every node's "cov" is its row of the joint matrix in
        # nodes order: stacking rebuilds a PSD matrix.
        a = Distribution("norm")
        b = Distribution("expon")
        c = a * b
        nodes = [a, b, c]
        out = streaming.estimate_many(
            nodes, 1 << 14, block_size=1 << 12, random_state=5,
            covariance=True,
        )
        cov = np.stack([out[n]["cov"] for n in nodes])
        eig = np.linalg.eigvalsh((cov + cov.T) / 2)
        assert eig.min() > -1e-6 * max(eig.max(), 1.0)


class TestSequentialReplicated:
    """target_sem + replicates: QMC-valid sequential stopping."""

    def test_sobol_sequential_converges(self):
        x = Distribution("norm", loc=2.0, scale=3.0)
        st = streaming.estimate(
            x, 4096, block_size=1024, random_state=0, method="sobol",
            target_sem=0.01, replicates=4,
        )
        assert st["converged"] is True
        assert st["sem"] <= 0.01
        assert st["replicates"] == 4 and st["rounds"] >= 1
        assert abs(st["mean"] - 2.0) < 6 * st["sem"] + 1e-6

    def test_stopping_sem_valid_vs_independent_truth(self):
        # The reported between-replicate sem must match the spread of
        # genuinely independent replicated runs of the same recipe
        # (ground truth): within a factor ~3 at these sizes.
        x = Distribution("norm", loc=0.0, scale=1.0)
        y = Exp(x)
        st = streaming.estimate(
            y, 8192, block_size=2048, random_state=1, method="sobol",
            target_sem=5e-4, replicates=4, max_size=1 << 17,
        )
        singles = [
            streaming.estimate(
                y, st["n"] // 4, block_size=2048, random_state=100 + i,
                method="sobol",
            )["mean"]
            for i in range(16)
        ]
        truth_sd = float(np.std(singles, ddof=1))
        est_sd = st["sem"] * 2.0  # sem * sqrt(R)
        assert 0.3 * truth_sd < est_sd < 3.0 * truth_sd
        assert abs(st["mean"] - np.exp(0.5)) < 6 * st["sem"] + 1e-5

    def test_prng_sequential_replicated_also_works(self):
        x = Distribution("norm", loc=5.0, scale=2.0)
        st = streaming.estimate(
            x, 2048, block_size=1024, random_state=2, target_sem=0.02,
            replicates=2,
        )
        assert st["converged"] and st["sem"] <= 0.02
        assert st["replicates"] == 2

    def test_lhs_sequential_replicated(self):
        x = Distribution("uniform", 0.0, 1.0)
        st = streaming.estimate(
            x, 2048, block_size=1024, random_state=3, method="lhs",
            target_sem=0.005, replicates=4, max_size=1 << 16,
        )
        assert st["sem"] <= 0.005 or st["converged"] is False
        assert abs(st["mean"] - 0.5) < 0.01


class TestStreamCheckpoint:
    """estimate(checkpoint=...): resumable mid-stream folds."""

    def _run(self, x, path, **kw):
        return streaming.estimate(
            x, 10_000, block_size=1024, random_state=0,
            checkpoint=str(path), checkpoint_every=2048, **kw
        )

    def test_completed_run_removes_file_and_matches_plain_segments(self, tmp_path):
        import os

        x = Distribution("norm", loc=1.0, scale=2.0)
        p = tmp_path / "run.ckpt.npz"
        st = self._run(x, p)
        assert not os.path.exists(p)
        assert abs(st["mean"] - 1.0) < 0.1
        # Deterministic: a second identical run reproduces bitwise.
        st2 = self._run(x, p)
        assert st["mean"] == st2["mean"] and st["var"] == st2["var"]

    def test_killed_run_resumes_bitwise_identically(self, tmp_path, monkeypatch):
        x = Distribution("norm", loc=1.0, scale=2.0)
        y = Exp(x)
        p = tmp_path / "run.ckpt.npz"
        full = self._run(y, p, quantiles=(0.9,), moments=True)

        # Simulate a crash after 2 segments: the real _estimate_carry
        # runs for segments 0-1, then the process "dies".
        real = streaming._estimate_carry
        calls = {"n": 0}

        def dying(*a, **k):
            if calls["n"] >= 2:
                raise RuntimeError("simulated crash")
            calls["n"] += 1
            return real(*a, **k)

        monkeypatch.setattr(streaming, "_estimate_carry", dying)
        with pytest.raises(RuntimeError, match="simulated crash"):
            self._run(y, p, quantiles=(0.9,), moments=True)
        monkeypatch.setattr(streaming, "_estimate_carry", real)
        assert p.exists()  # partial state survived the crash

        resumed = self._run(y, p, quantiles=(0.9,), moments=True)
        # Bitwise: identical segment carries, identical float64 merge.
        for k in ("mean", "var", "std", "sem", "min", "max", "q0.9",
                  "skew", "kurt"):
            assert resumed[k] == full[k], k

    def test_mismatched_run_refused(self, tmp_path):
        x = Distribution("norm", loc=1.0, scale=2.0)
        p = tmp_path / "run.ckpt.npz"
        # Leave partial state behind via a simulated crash.
        real = streaming._estimate_carry
        calls = {"n": 0}

        def dying(*a, **k):
            if calls["n"] >= 1:
                raise RuntimeError("boom")
            calls["n"] += 1
            return real(*a, **k)

        streaming._estimate_carry = dying
        try:
            with pytest.raises(RuntimeError):
                self._run(x, p)
        finally:
            streaming._estimate_carry = real
        assert p.exists()
        # Different key => different run => refused.
        with pytest.raises(ValueError, match="different run"):
            streaming.estimate(
                x, 10_000, block_size=1024, random_state=1,
                checkpoint=str(p), checkpoint_every=2048,
            )
        # Different size likewise.
        with pytest.raises(ValueError, match="different run"):
            streaming.estimate(
                x, 20_000, block_size=1024, random_state=0,
                checkpoint=str(p), checkpoint_every=2048,
            )

    def test_checkpoint_composition_errors(self, tmp_path):
        x = Distribution("norm")
        with pytest.raises(ValueError, match="checkpoint"):
            streaming.estimate(
                x, 1024, checkpoint=str(tmp_path / "c.npz"), replicates=2
            )
        with pytest.raises(ValueError, match="checkpoint"):
            streaming.estimate(
                x, 1024, checkpoint=str(tmp_path / "c.npz"), target_sem=0.1
            )

    def test_qmc_checkpointed_equals_uncheckpointed_stream(self, tmp_path):
        # Absolute sobol offsets: the checkpointed fold consumes exactly
        # the single-shot sequence, so the mean matches the plain
        # streamed estimate to f32 merge-order noise.
        x = Distribution("norm", loc=0.0, scale=1.0)
        p = tmp_path / "q.ckpt.npz"
        ck = streaming.estimate(
            x, 8192, block_size=1024, random_state=0, method="sobol",
            checkpoint=str(p), checkpoint_every=4096,
        )
        plain = streaming.estimate(
            x, 8192, block_size=1024, random_state=0, method="sobol"
        )
        assert abs(ck["mean"] - plain["mean"]) < 1e-5
        assert abs(ck["var"] - plain["var"]) < 1e-4


class TestSequentialReplicatedMany:
    """estimate_many(target_sem=, replicates=): joint QMC-valid stopping."""

    def test_sobol_sequential_many_converges(self):
        a = Distribution("norm", loc=2.0, scale=3.0)
        b = a + Distribution("norm", loc=0.0, scale=1.0)
        out = streaming.estimate_many(
            [a, b], 4096, block_size=1024, random_state=0, method="sobol",
            target_sem=0.01, replicates=4,
        )
        for node in (a, b):
            assert out[node]["converged"] is True
            assert out[node]["sem"] <= 0.01
            assert out[node]["replicates"] == 4
        assert abs(out[a]["mean"] - 2.0) < 6 * out[a]["sem"] + 1e-6
        assert abs(out[b]["mean"] - 2.0) < 6 * out[b]["sem"] + 1e-6

    def test_qmc_without_replicates_still_rejected(self):
        a = Distribution("norm")
        with pytest.raises(ValueError, match="QMC error bar"):
            streaming.estimate_many(
                [a], 1024, target_sem=0.1, method="sobol", random_state=0
            )


class TestStreamCheckpointMany:
    """estimate_many(checkpoint=...): resumable multi-node folds."""

    def _run(self, nodes, path, **kw):
        return streaming.estimate_many(
            nodes, 10_000, block_size=1024, random_state=0,
            checkpoint=str(path), checkpoint_every=2048, **kw
        )

    def test_killed_run_resumes_bitwise_identically(self, tmp_path, monkeypatch):
        import os

        a = Distribution("norm", loc=1.0, scale=2.0)
        b = a * a
        p = tmp_path / "many.ckpt.npz"
        full = self._run([a, b], p, covariance=True, moments=True)
        assert not os.path.exists(p)

        real = streaming._many_carry
        calls = {"n": 0}

        def dying(*args, **kw):
            if calls["n"] >= 2:
                raise RuntimeError("simulated crash")
            calls["n"] += 1
            return real(*args, **kw)

        monkeypatch.setattr(streaming, "_many_carry", dying)
        with pytest.raises(RuntimeError, match="simulated crash"):
            self._run([a, b], p, covariance=True, moments=True)
        monkeypatch.setattr(streaming, "_many_carry", real)
        assert p.exists()
        resumed = self._run([a, b], p, covariance=True, moments=True)
        for node in (a, b):
            for k in ("mean", "var", "sem", "min", "max", "skew", "kurt"):
                assert resumed[node][k] == full[node][k], k
            np.testing.assert_array_equal(
                resumed[node]["cov"], full[node]["cov"]
            )

    def test_mismatched_node_order_refused(self, tmp_path):
        a = Distribution("norm", loc=1.0, scale=2.0)
        b = Distribution("expon", scale=1.0)
        p = tmp_path / "many.ckpt.npz"
        real = streaming._many_carry
        calls = {"n": 0}

        def dying(*args, **kw):
            if calls["n"] >= 1:
                raise RuntimeError("boom")
            calls["n"] += 1
            return real(*args, **kw)

        streaming._many_carry = dying
        try:
            with pytest.raises(RuntimeError):
                self._run([a, b], p)
        finally:
            streaming._many_carry = real
        assert p.exists()
        with pytest.raises(ValueError, match="different run"):
            self._run([b, a], p)

    def test_composition_errors(self, tmp_path):
        a = Distribution("norm")
        with pytest.raises(ValueError, match="checkpoint"):
            streaming.estimate_many(
                [a], 1024, checkpoint=str(tmp_path / "c.npz"), replicates=2
            )
        with pytest.raises(ValueError, match="checkpoint_every"):
            streaming.estimate_many([a], 1024, checkpoint_every=512)
        with pytest.raises(ValueError, match="checkpoint_every"):
            streaming.estimate(a, 1024, checkpoint_every=512)


class TestLHSSequentialCompileReuse:
    """LHS sequential rounds must not compile one program per round.

    The LHS block program bakes the round's total size into its cache
    key (the Feistel stratification domain), so Chow-Robbins round
    sizing would otherwise pay a fresh XLA compile every round;
    ``_round_chunk`` quantises LHS chunks to
    powers of two so distinct programs stay logarithmic in max_size.
    """

    def test_round_chunk_quantizes_lhs_only(self):
        rc = streaming._round_chunk
        assert rc(1000, "lhs", 10**9) == 1024
        assert rc(1024, "lhs", 10**9) == 1024
        assert rc(1025, "lhs", 10**9) == 2048
        assert rc(1, "lhs", 10**9) == 1
        assert rc(0, "lhs", 10**9) == 1
        # The final round clamps to the remaining budget even if that
        # breaks the power of two — overshooting max_size is worse.
        assert rc(1000, "lhs", 600) == 600
        # Size-agnostic methods pass through untouched.
        assert rc(1000, "sobol", 10**9) == 1000
        assert rc(1000, "halton", 10**9) == 1000
        assert rc(1000, "antithetic", 10**9) == 1000
        assert rc(1000, None, 10**9) == 1000

    def test_lhs_sequential_compiles_pow2_programs_only(self):
        x = Distribution("norm", loc=2.0, scale=3.0)
        before = set(streaming._ESTIMATE_CACHE)
        st = streaming.estimate(
            x, 4096, block_size=1024, random_state=0, method="lhs",
            target_sem=0.02, replicates=4,
        )
        assert st["converged"] is True
        assert abs(st["mean"] - 2.0) < 6 * st["sem"] + 1e-6
        # Every NEW cached program for this run has a power-of-two LHS
        # total (cache-key slot 6 = lhs_total, see _estimate_carry).
        new_totals = [
            k[6]
            for k in set(streaming._ESTIMATE_CACHE) - before
            if k[6] is not None
        ]
        assert new_totals, "the LHS run should have cached LHS programs"
        for t in new_totals:
            assert t & (t - 1) == 0, f"non-power-of-two LHS total {t}"
