"""The XLA sampling path at CPU sizes: statistics, tables and the surface.

``sample()``'s only path draws counter-based uniforms inside one jitted
program and pushes them through every node's inverse CDF.  These tests
cover what that path serves: statistics and determinism per seed,
correlated marginals, odd sizes, table and discrete families, kept
intermediates, seed independence, incomplete-function families against
SciPy, the table lookups at their largest sizes, the compile-cache helper
and the mesh-equality rule.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats

from probabilit_tpu import config
from probabilit_tpu.engine import streaming
from probabilit_tpu.modeling import (
    CumulativeDistribution,
    DiscreteDistribution,
    Distribution,
    EmpiricalDistribution,
)
from probabilit_tpu.ops import ppf as ppf_mod


class TestSampleStatistics:
    def test_statistics_and_determinism(self):
        sink = Distribution("norm", loc=3, scale=2) * Distribution("uniform") + 1
        s1 = np.asarray(sink.sample(200_000, random_state=7, gc_strategy=[]))
        assert np.isfinite(s1).all()
        assert np.isclose(s1.mean(), 2.5, atol=0.05)  # E[N(3,2)*U(0,1)] + 1
        s2 = np.asarray(sink.sample(200_000, random_state=7, gc_strategy=[]))
        np.testing.assert_array_equal(s1, s2)
        s3 = np.asarray(sink.sample(200_000, random_state=8, gc_strategy=[]))
        assert not np.array_equal(s1, s3)

    def test_correlated_statistics(self):
        # Two unit normals at corr 0.6: normal marginals make the score
        # correlation the Pearson correlation, and the empirical
        # decorrelation pins it to the target, so Var(a+b) = 3.2.
        a, b = Distribution("norm"), Distribution("norm")
        sink = (a + b).correlate(a, b, corr_mat=np.array([[1, 0.6], [0.6, 1]]))
        s = np.asarray(sink.sample(200_000, random_state=3, gc_strategy=[]))
        assert np.isclose(s.std(), np.sqrt(3.2), atol=1e-3)
        assert np.isclose(s.mean(), 0.0, atol=1e-3)
        s2 = np.asarray(sink.sample(200_000, random_state=3, gc_strategy=[]))
        np.testing.assert_array_equal(s, s2)

    def test_correlated_marginal_preserved(self):
        e = Distribution("expon", scale=2.0)
        x = Distribution("norm")
        sink = e + x * 0.0
        sink.correlate(e, x, corr_mat=np.array([[1, 0.5], [0.5, 1]]))
        s = np.asarray(sink.sample(100_000, random_state=11, gc_strategy=[]))
        ks = scipy.stats.kstest(s, scipy.stats.expon(scale=2.0).cdf)
        assert ks.pvalue > 0.001

    def test_correlated_odd_size(self):
        # A size that is no power of two and no multiple of any block: the
        # empirical score moments must cover exactly n samples.
        a, b = Distribution("norm"), Distribution("norm")
        sink = (a + b).correlate(a, b, corr_mat=np.array([[1, -0.7], [-0.7, 1]]))
        n = 200_001
        s = np.asarray(sink.sample(n, random_state=5, gc_strategy=[]))
        assert s.shape == (n,)
        assert np.isclose(s.std(), np.sqrt(0.6), atol=1e-3)

    def test_discrete_table_families(self):
        d = Distribution("poisson", mu=3)
        s = np.asarray((d + 0.0).sample(200_000, random_state=6, gc_strategy=[]))
        ref = scipy.stats.poisson(3)
        for k in range(8):
            assert abs(np.mean(s == k) - ref.pmf(k)) < 0.005, k
        b = Distribution("binom", n=10, p=0.3)
        sb = np.asarray((b + 0.0).sample(200_000, random_state=8, gc_strategy=[]))
        assert abs(sb.mean() - 3.0) < 0.02
        assert abs(sb.var() - 2.1) < 0.03

    def test_table_families(self):
        d = DiscreteDistribution([1.0, 2.0, 5.0], [0.2, 0.5, 0.3])
        s = np.asarray((d + 0.0).sample(200_000, random_state=2, gc_strategy=[]))
        for v, p in ((1.0, 0.2), (2.0, 0.5), (5.0, 0.3)):
            assert abs(np.mean(s == v) - p) < 0.01, v
        data = np.random.default_rng(5).normal(loc=3.0, size=60)
        se = np.asarray(
            (EmpiricalDistribution(data) + 0.0).sample(
                100_000, random_state=4, gc_strategy=[]
            )
        )
        # Linear-interp empirical sampling stays within the data range and
        # reproduces its median.
        assert se.min() >= data.min() and se.max() <= data.max()
        assert abs(np.median(se) - np.median(data)) < 0.05

    def test_multi_output_keep_list(self):
        # Kept intermediates come from the same draws as the sink, so the
        # algebra holds exactly.
        a = Distribution("norm", loc=2.0)
        b = Distribution("uniform")
        sink = a * b + 1
        out = np.asarray(sink.sample(200_000, random_state=5, gc_strategy=[a, b]))
        sa, sb = np.asarray(a.samples_), np.asarray(b.samples_)
        np.testing.assert_allclose(out, sa * sb + 1, rtol=1e-6, atol=1e-6)
        assert np.isclose(sa.mean(), 2.0, atol=0.02)
        assert np.isclose(sb.mean(), 0.5, atol=0.01)
        out2 = np.asarray(sink.sample(200_000, random_state=5, gc_strategy=[a, b]))
        np.testing.assert_array_equal(out, out2)

    def test_large_table_family(self):
        # poisson(mu=400): a ~600-entry CDF table through searchsorted.
        d = Distribution("poisson", mu=400) + 0.0
        s = np.asarray(d.sample(200_000, random_state=6, gc_strategy=[]))
        ref = scipy.stats.poisson(400)
        assert abs(s.mean() - 400.0) < 0.3
        assert abs(s.var() - 400.0) / 400.0 < 0.02
        for q in (0.05, 0.5, 0.95):
            assert abs(np.quantile(s, q) - ref.ppf(q)) <= 1.0, q

    def test_correlated_50_generated_matches_quantile_path(self):
        # The generated sort-free Iman-Conover (method=None) and the
        # four-sort transform on a quantile matrix (method="sobol") are
        # two algorithms for one distribution: compare moments.
        from probabilit_tpu.models import benchmarks

        n = 1 << 17
        sink = benchmarks.mixed_correlated_50()
        gen = np.asarray(sink.sample(n, random_state=3, gc_strategy=[]))
        qmc = np.asarray(sink.sample(n, random_state=3, method="sobol", gc_strategy=[]))
        assert np.isclose(gen.mean(), qmc.mean(), rtol=0.01)
        assert np.isclose(gen.std(), qmc.std(), rtol=0.02)
        for q in (0.05, 0.5, 0.95):
            assert np.isclose(
                np.quantile(gen, q), np.quantile(qmc, q), rtol=0.02, atol=0.05
            ), q

    def test_adjacent_seeds_give_different_block_streams(self):
        # Streamed blocks are keyed by fold_in(key, block): adjacent seeds
        # must not emit the same multiset of blocks in another order.
        sink = Distribution("norm")
        a, b = (
            np.sort(
                streaming.sample_streaming(
                    sink, 4 * 4096, block_size=4096, random_state=seed
                )
            )
            for seed in (0, 1)
        )
        assert not np.array_equal(a, b)

    def test_nonfinite_raises(self):
        from probabilit_tpu.modeling import Log

        sink = Log(Distribution("norm", loc=0, scale=1))
        with pytest.raises(ValueError, match="non-finite"):
            sink.sample(4096, random_state=0, gc_strategy=[])

    def test_failed_call_clears_stale_samples(self, monkeypatch):
        # A previous run's samples_ must not survive a failed call: the
        # clearing loop runs before the program is built.
        from probabilit_tpu.engine import compile as _compile

        sink = Distribution("norm") + 1
        sink.sample(64, random_state=0)
        assert hasattr(sink, "samples_")

        def boom(*args, **kwargs):
            raise RuntimeError("compile failed")

        monkeypatch.setattr(_compile, "get_program", boom)
        with pytest.raises(RuntimeError, match="compile failed"):
            sink.sample(64, random_state=0, gc_strategy=[])
        assert not hasattr(sink, "samples_")


@pytest.mark.parametrize(
    "name,kw",
    [
        ("gamma", dict(a=2.5)),
        ("beta", dict(a=2.0, b=5.0)),
        ("t", dict(df=7)),
        ("f", dict(dfn=5, dfd=9)),
        ("chi2", dict(df=4)),
        ("invgamma", dict(a=3.0)),
        ("nakagami", dict(nu=1.5)),
        ("maxwell", dict()),
    ],
)
def test_incomplete_function_family_ks(name, kw):
    node = Distribution(name, **kw)
    s = np.asarray(node.sample(100_000, random_state=3, gc_strategy=[]))
    ref = getattr(scipy.stats, name)(**kw)
    assert scipy.stats.kstest(s, ref.cdf).pvalue > 0.001


def _from_quantiles(node, q):
    return np.asarray((node + 0.0).sample_from_quantiles(q[:, None], gc_strategy=[]))


class TestTableLookups:
    """Table lookups of the XLA path against NumPy at their largest sizes."""

    @pytest.mark.parametrize("mu", [3, 400, 2000])
    def test_cdf_table_matches_searchsorted_left(self, mu):
        table, loc = ppf_mod.static_cdf_table("poisson", mu)
        rng = np.random.default_rng(9)
        q = rng.uniform(2.0**-24, 1 - 2.0**-24, size=8192).astype(np.float32)
        t32 = table.astype(np.float32)
        # Exact boundary hits (strict-side check) at every entry the
        # engine's clamped uniforms can reach; below 2^-24 the table
        # holds float32 subnormals, which the device flushes to zero.
        hits = t32[(t32 >= 2.0**-24) & (t32 <= 1 - 2.0**-24)]
        q[: hits.size] = hits
        got = np.asarray(ppf_mod._table_ppf(jnp.asarray(q), table, loc))
        k = np.minimum(np.searchsorted(t32, q, side="left"), len(table) - 1)
        np.testing.assert_array_equal(got, k.astype(np.float32) + loc)

    @pytest.mark.parametrize("size", [1, 9, 512])
    def test_discrete_matches_searchsorted_right(self, size):
        rng = np.random.default_rng(size)
        p = rng.dirichlet(np.ones(size))
        values = rng.normal(size=size) * 50
        node = DiscreteDistribution(values, p)
        cumulative = np.cumsum(p).astype(np.float32)
        q = rng.uniform(2.0**-24, 1 - 2.0**-24, size=8192).astype(np.float32)
        q[: size - 1] = cumulative[: size - 1]  # exact threshold hits
        got = _from_quantiles(node, q)
        idx = np.minimum(np.searchsorted(cumulative, q, side="right"), size - 1)
        np.testing.assert_array_equal(got, values[idx].astype(np.float32))

    @pytest.mark.parametrize("knots", [17, 512])
    def test_cumulative_interp_matches_numpy(self, knots):
        rng = np.random.default_rng(knots)
        xp = np.concatenate([[0.0], np.sort(rng.uniform(0, 1, knots - 2)), [1.0]])
        fp = np.cumsum(rng.uniform(0.1, 1.0, knots))
        node = CumulativeDistribution(xp, fp)
        q = rng.uniform(2.0**-24, 1 - 2.0**-24, size=8192).astype(np.float32)
        got = _from_quantiles(node, q)
        want = np.interp(q, xp.astype(np.float32), fp.astype(np.float32))
        # Dense random knots: on-device f32 slopes and NumPy's round
        # differently; agreement is to ~slope * ulp(q).
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)

    def test_empirical_with_duplicate_values(self):
        # Tied data make flat stretches in the interpolation table; the
        # lookup must match np.quantile's linear method through them.
        data = np.array([1.0, 2.0, 2.0, 2.0, 5.0, 5.0, 9.0])
        q = np.linspace(2.0**-24, 1 - 2.0**-24, 1001).astype(np.float32)
        got = _from_quantiles(EmpiricalDistribution(data), q)
        want = np.quantile(data, q.astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_single_entry_tables(self):
        q = np.array([0.2, 0.8], np.float32)
        got = _from_quantiles(DiscreteDistribution([7.0]), q)
        np.testing.assert_array_equal(got, [7.0, 7.0])
        got = np.asarray(ppf_mod._table_ppf(jnp.asarray(q), np.array([1.0]), 3.0))
        np.testing.assert_array_equal(got, [3.0, 3.0])


class TestNoExecutorOption:
    """The sampling path is one; no entry point takes ``executor=``."""

    @pytest.mark.parametrize(
        "call",
        [
            lambda x: x.sample(64, random_state=0, executor="xla"),
            lambda x: streaming.sample_streaming(x, 64, block_size=32, executor="xla"),
            lambda x: streaming.estimate(x, 64, block_size=32, executor="xla"),
        ],
        ids=["sample", "sample_streaming", "estimate"],
    )
    def test_executor_keyword_rejected(self, call):
        with pytest.raises(TypeError, match="executor"):
            call(Distribution("norm") + 1)


class TestCompileCache:
    @pytest.fixture
    def saved_jax_config(self):
        names = (
            "jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
        )
        old = {name: getattr(jax.config, name) for name in names}
        yield
        for name, value in old.items():
            jax.config.update(name, value)

    def test_env_var_is_left_to_jax(self, monkeypatch, saved_jax_config, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        assert config.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0

    def test_fixed_checkout_path_otherwise(self, monkeypatch, saved_jax_config):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = config.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert config.enable_compile_cache() == path  # never moves
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


class TestMeshEquality:
    def test_bitwise_and_last_bit_rule(self):
        from __graft_entry__ import assert_mesh_equal

        a = np.linspace(1.0, 2.0, 64, dtype=np.float32)
        assert assert_mesh_equal(a.copy(), a, "same") == 0
        b = a.copy()
        b[3] = np.nextafter(b[3], np.float32(3.0))
        assert assert_mesh_equal(b, a, "one ulp") == 1
        b[5] *= 1.001
        with pytest.raises(AssertionError):
            assert_mesh_equal(b, a, "too far")

    def test_mesh_checks_on_four_devices(self):
        from __graft_entry__ import mesh_checks

        devices = jax.devices()[:4]
        assert len(devices) == 4
        messages = []
        mesh_checks(
            devices, n=512, ic_shape=(512, 6), stream_n=512, stream_block=256,
            log=messages.append,
        )
        assert any("mesh checks OK on 4 devices" in m for m in messages)
