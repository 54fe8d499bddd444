"""Distributional parity against the reference implementation.

Loads the reference library (``/root/reference/src``, cvxpy stubbed since
its NCM solver is not exercised here) and compares sample distributions of
identical models: two-sample Kolmogorov-Smirnov tests between our engine's
output and the reference's, plus summary-statistic agreement.  This is the
"RNG bridge" contract of SURVEY §7: statistical equivalence, not bitwise.
"""

import sys
import types

import numpy as np
import pytest
import scipy.stats

sys.modules.setdefault("cvxpy", types.ModuleType("cvxpy"))
sys.path.insert(0, "/root/reference/src")

try:
    import probabilit.modeling as ref_modeling

    HAVE_REFERENCE = True
except Exception:  # pragma: no cover
    HAVE_REFERENCE = False

import probabilit_tpu.modeling as ours_modeling

pytestmark = pytest.mark.skipif(not HAVE_REFERENCE, reason="reference unavailable")

N = 200_000
KS_PVALUE_MIN = 1e-3


def _build_and_sample(modeling, builder, n=N, seed=0):
    sink = builder(modeling)
    return np.asarray(sink.sample(n, random_state=seed), dtype=np.float64)


MODELS = [
    (
        "height_diff",
        lambda m: m.Distribution("norm", loc=176, scale=7.1)
        - m.Distribution("norm", loc=162.5, scale=7.1),
    ),
    (
        "box_volume",
        lambda m: m.Distribution("norm", loc=0.5, scale=0.01)
        * m.Distribution("norm", loc=1, scale=0.01)
        * m.Distribution("norm", loc=0.8, scale=0.01)
        * 50,
    ),
    (
        "composite_poisson_binom",
        lambda m: m.Distribution("binom", n=m.Distribution("poisson", mu=3), p=0.4),
    ),
    (
        "lognorm_exponent",
        lambda m: m.Exp(m.Distribution("norm", loc=0, scale=0.5))
        + m.Distribution("expon", scale=2),
    ),
    (
        "beta_gamma_mix",
        lambda m: m.Distribution("beta", a=2, b=5)
        * m.Distribution("gamma", a=3, scale=0.5),
    ),
    (
        "triangular_sum",
        lambda m: m.Distribution("triang", c=0.3, loc=1, scale=4)
        + m.Distribution("uniform", loc=-1, scale=2),
    ),
    (
        "truncnorm",
        lambda m: m.Distribution("truncnorm", -1.0, 2.0, loc=1, scale=2),
    ),
]


class TestDistributionalParity:
    @pytest.mark.parametrize("name,builder", MODELS, ids=[m[0] for m in MODELS])
    def test_two_sample_ks(self, name, builder):
        ours = _build_and_sample(ours_modeling, builder, seed=0)
        theirs = _build_and_sample(ref_modeling, builder, seed=1)
        # Discrete models need a continuity correction-free comparison:
        # compare category frequencies instead of KS.
        if name == "composite_poisson_binom":
            values = np.arange(0, 12)
            f_ours = np.array([(ours == v).mean() for v in values])
            f_theirs = np.array([(theirs == v).mean() for v in values])
            np.testing.assert_allclose(f_ours, f_theirs, atol=5e-3)
            return
        stat = scipy.stats.ks_2samp(ours, theirs)
        assert stat.pvalue > KS_PVALUE_MIN, (
            f"{name}: KS={stat.statistic:.5f} p={stat.pvalue:.2e}"
        )

    @pytest.mark.parametrize("name,builder", MODELS, ids=[m[0] for m in MODELS])
    def test_summary_statistics(self, name, builder):
        ours = _build_and_sample(ours_modeling, builder, seed=0)
        theirs = _build_and_sample(ref_modeling, builder, seed=1)
        scale = max(abs(theirs.mean()), theirs.std(), 1e-12)
        assert abs(ours.mean() - theirs.mean()) / scale < 0.02
        assert abs(ours.std() - theirs.std()) / max(theirs.std(), 1e-12) < 0.03


class TestCorrelationParity:
    def test_induced_correlation_matches_reference(self):
        def build(m):
            a = m.Distribution("uniform")
            b = m.Distribution("expon")
            sink = (a + b).correlate(a, b, corr_mat=np.array([[1, 0.5], [0.5, 1]]))
            return sink, a, b

        ours_sink, oa, ob = build(ours_modeling)
        ours_sink.sample(50_000, random_state=0)
        ours_corr = np.corrcoef(
            np.asarray(oa.samples_, np.float64), np.asarray(ob.samples_, np.float64)
        )[0, 1]

        # The reference's NCM needs CVXPY (absent here); its input is
        # already a valid correlation matrix, so substitute our solver.
        from probabilit_tpu.ops.ncm import nearest_correlation_matrix

        ref_modeling.nearest_correlation_matrix = nearest_correlation_matrix
        ref_sink, ra, rb = build(ref_modeling)
        ref_sink.sample(50_000, random_state=1)
        ref_corr = np.corrcoef(ra.samples_, rb.samples_)[0, 1]

        assert abs(ours_corr - ref_corr) < 0.02
