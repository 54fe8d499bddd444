"""Canonical benchmark model graphs (bench.py and chip_smoke.py configs).

These mirror the reference's README/tests models and the driver-defined
benchmark configurations:

1. README height model (README.md:19-27)
2. Bird survival composite Poisson->Binomial DAG (README.md:55-62)
3. Mutual fund 20-year recursion (README.md:68-78)
4. 10-dim QMC portfolio with Iman-Conover target correlation
5. The headline 20-node mixed DAG
"""

from __future__ import annotations

import numpy as np

from probabilit_tpu.models.distributions import Distribution
from probabilit_tpu.models.graph import Exp, Max, Sqrt

__all__ = [
    "height_model",
    "bird_survival",
    "mutual_fund",
    "portfolio_model",
    "mixed_dag_20",
    "mixed_correlated_50",
]


def height_model():
    """P(male taller than female): two normals and a comparison."""
    male = Distribution("norm", loc=176, scale=7.1)
    female = Distribution("norm", loc=162.5, scale=7.1)
    return male > female


def bird_survival():
    """Composite Poisson -> Binomial chain."""
    eggs_per_nest = Distribution("poisson", mu=3)
    return Distribution("binom", n=eggs_per_nest, p=0.4)


def mutual_fund(years=20, saved_per_year=1200):
    """Yearly savings compounded by normally-distributed interest."""
    returns = 0
    for _ in range(years):
        interest = Distribution("norm", loc=1.11, scale=0.15)
        returns = returns * interest + saved_per_year
    return returns


def portfolio_model(d=10, target_corr=0.3):
    """d correlated lognormal assets, equal-weight portfolio value.

    Iman-Conover induces a uniform ``target_corr`` across all assets.
    """
    assets = [Distribution("lognorm", s=0.2, scale=100.0) for _ in range(d)]
    total = assets[0]
    for a in assets[1:]:
        total = total + a
    corr = np.full((d, d), target_corr)
    np.fill_diagonal(corr, 1.0)
    total = total.correlate(*assets, corr_mat=corr)
    return total


def mixed_dag_20():
    """The headline 20-node mixed DAG (8 distributions + 12 transforms).

    Mixes the main native kernel families (norm, uniform, expon, lognorm,
    triang) with arithmetic/transcendental transforms, shaped like a small
    risk model: price x volume with costs, floors and a tax-like nonlinearity.
    """
    price = Distribution("lognorm", s=0.25, scale=50.0)  # 1
    volume = Distribution("triang", c=0.4, loc=800, scale=600)  # 2
    fx = Distribution("norm", loc=1.0, scale=0.05)  # 3
    unit_cost = Distribution("uniform", loc=20, scale=15)  # 4
    fixed_cost = Distribution("norm", loc=5000, scale=400)  # 5
    delay = Distribution("expon", scale=0.1)  # 6
    demand_shock = Distribution("norm", loc=0.0, scale=1.0)  # 7
    tax_rate = Distribution("uniform", loc=0.2, scale=0.1)  # 8

    eff_volume = volume * Exp(demand_shock * 0.1)  # 9, 10, 11
    revenue = price * eff_volume * fx  # 12, 13
    cost = unit_cost * eff_volume + fixed_cost  # 14, 15
    gross = revenue - cost  # 16
    penalty = delay * revenue  # 17
    pre_tax = gross - penalty  # 18
    taxed = pre_tax * (1 - tax_rate)  # 19 (Subtract), 20 (Multiply)
    profit = Max(taxed, pre_tax * 0.05) + Sqrt(fx * fx)  # a few extra nodes
    return profit


def mixed_correlated_50():
    """~50-node mixed DAG, nearest-corr repair + IC.

    Ten correlated drivers with a deliberately *invalid* target correlation
    matrix (inconsistent pairwise specs) so the engine's NCM repair runs,
    feeding a transform lattice of ~40 more nodes.
    """
    drivers = [
        Distribution("norm", loc=0.0, scale=1.0),
        Distribution("lognorm", s=0.3, scale=10.0),
        Distribution("uniform", loc=-1, scale=2),
        Distribution("expon", scale=0.5),
        Distribution("triang", c=0.5, loc=0, scale=2),
        Distribution("norm", loc=5.0, scale=2.0),
        Distribution("uniform", loc=0, scale=1),
        Distribution("lognorm", s=0.5, scale=1.0),
        Distribution("norm", loc=-2.0, scale=0.5),
        Distribution("expon", scale=2.0),
    ]
    # Inconsistent spec: strong a-b and b-c correlation with strong negative
    # a-c is not PSD -> forces nearest_correlation_matrix repair.
    corr = np.eye(10)
    corr[0, 1] = corr[1, 0] = 0.9
    corr[1, 2] = corr[2, 1] = 0.9
    corr[0, 2] = corr[2, 0] = -0.9
    for i in range(3, 10):
        corr[0, i] = corr[i, 0] = 0.3

    layer = []
    for i in range(0, 10, 2):
        layer.append(drivers[i] * drivers[i + 1] + i)  # 3 nodes per pair
    total = layer[0]
    for term in layer[1:]:
        total = Max(total, term) + Sqrt(Exp(term * 0.01))
    total = total.correlate(*drivers, corr_mat=corr)
    return total
