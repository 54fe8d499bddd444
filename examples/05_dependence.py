"""Dependence modeling beyond correlation matrices: t and Archimedean
copulas, and why tail dependence changes risk numbers.

The classic failure of Gaussian dependence (Iman-Conover included): at
any correlation short of 1, joint extremes decouple — the probability
that two risks blow up TOGETHER goes to zero at extreme levels.  Real
portfolios crash together.  Two remedies, both compiled here:

1. ``StudentTCopula(df)`` — drop-in correlator: same marginals, same
   Kendall rank agreement, but coupled tails.
2. Archimedean copulas (``ClaytonCopula``/``GumbelCopula``/
   ``FrankCopula``) + ``QuantileTransform`` — build the joint law
   bottom-up when dependence is asymmetric (e.g. losses cluster only in
   the DOWN direction).

Run: python examples/05_dependence.py
"""

import numpy as np

from probabilit_tpu import ClaytonCopula, Distribution, QuantileTransform
from probabilit_tpu.correlation import StudentTCopula
from probabilit_tpu.engine import streaming

N = 400_000
LEVEL = 0.999


def var_of(model, **kw):
    est = streaming.estimate(
        model, N, block_size=65_536, random_state=0, quantiles=(LEVEL,), **kw
    )
    return est[f"q{LEVEL:g}"], est["mean"]


def main():
    # --- 1. Same correlated portfolio, three dependence assumptions ----
    equities = Distribution("lognorm", s=0.25)
    credit = Distribution("expon", scale=0.5)
    corr = np.array([[1.0, 0.6], [0.6, 1.0]])
    loss = (equities + credit).correlate(equities, credit, corr_mat=corr)

    var_gauss, mean_g = var_of(loss)
    var_t4, _ = var_of(loss, correlator=StudentTCopula(df=4))
    var_t2, _ = var_of(loss, correlator=StudentTCopula(df=2.5))

    print(f"portfolio mean               : {mean_g:8.4f} (identical marginals)")
    print(f"VaR {LEVEL:.1%}  Gaussian copula   : {var_gauss:8.4f}")
    print(f"VaR {LEVEL:.1%}  t-copula df=4     : {var_t4:8.4f}")
    print(f"VaR {LEVEL:.1%}  t-copula df=2.5   : {var_t2:8.4f}")
    print("  -> same means, same correlations; the tail assumption alone")
    print("     moves extreme-loss capital.\n")

    # --- 2. Asymmetric dependence: crashes cluster, booms don't --------
    # Clayton couples the LOWER tail of the uniforms; routing u -> 1-u
    # through the loss quantile puts the clustering in the loss's upper
    # tail without touching either marginal.
    u1, u2 = ClaytonCopula(theta=2.0)  # Kendall tau = 0.5
    big_l1 = QuantileTransform(1 - u1, "lognorm", s=0.25)
    big_l2 = QuantileTransform(1 - u2, "expon", scale=0.5)
    clayton_loss = big_l1 + big_l2

    var_c, mean_c = var_of(clayton_loss)
    print(f"Clayton-coupled loss  mean   : {mean_c:8.4f}")
    print(f"VaR {LEVEL:.1%}  Clayton (crash-coupled): {var_c:8.4f}")

    # Joint-exceedance check: how often are BOTH components extreme?
    clayton_loss.sample(N // 4, random_state=1)
    a = np.asarray(big_l1.samples_)
    b = np.asarray(big_l2.samples_)
    q = 0.99
    joint = np.mean((a > np.quantile(a, q)) & (b > np.quantile(b, q))) / (1 - q)
    print(f"P(both in top 1% | one is)   : {joint:8.3f}  (independent: 0.010)")

    # --- 3. Calibrate the copula parameter FROM data ------------------
    # Standard workflow: estimate Kendall's tau on observed pairs,
    # invert to theta (closed form), then model with the fitted copula.
    from scipy import stats as sps

    from probabilit_tpu.ops.copulas import theta_from_tau

    tau_hat = sps.kendalltau(a[:20000], b[:20000]).statistic
    theta_hat = theta_from_tau("clayton", tau_hat)
    print(f"calibration: tau_hat={tau_hat:.3f} -> theta_hat={theta_hat:.3f} "
          f"(true 2.0)")


if __name__ == "__main__":
    main()
