"""Beyond closed forms: generic SDEs, multilevel MC, American exercise.

Three capabilities stacked on the path-node machinery:

* the generic ``SDE`` node — any scalar Ito diffusion from two Python
  callables (here a CEV model, which has no exact-law node), Milstein
  scheme with its derivative from forward-mode autodiff,
* ``mlmc_estimate`` — Giles' multilevel Monte Carlo, putting almost all
  samples on coarse grids via coupled corrections (cost reported
  against plain MC at the same accuracy),
* ``american_price`` — Longstaff-Schwartz optimal stopping on any path
  node, the whole backward induction one ``lax.scan`` of matmul
  regressions, two-pass for a foresight-free lower bound.

Run: python examples/07_sde_mlmc_american.py
"""

import numpy as np
from scipy import stats

import jax.numpy as jnp

from probabilit_tpu import (
    SDE,
    GeometricBrownianMotion,
    Heston,
    american_price,
    mlmc_estimate,
)

S0, K, R, SIGMA, T = 100.0, 100.0, 0.05, 0.2, 1.0


def bs_call():
    d1 = (np.log(S0 / K) + (R + SIGMA**2 / 2) * T) / (SIGMA * np.sqrt(T))
    d2 = d1 - SIGMA * np.sqrt(T)
    return float(
        S0 * stats.norm.cdf(d1) - K * np.exp(-R * T) * stats.norm.cdf(d2)
    )


def cev_model():
    # Constant-elasticity-of-variance: sigma * x^0.8 diffusion — no
    # closed-form path law, so the generic SDE node earns its keep.
    print("CEV model (Milstein, autodiff b'):")
    cev = SDE(
        lambda t, x: R * x,
        lambda t, x: 0.6 * x**0.8,
        x0=S0,
        T=T,
        steps=252,
        scheme="milstein",
    )
    # Path functionals compose like any node; price a call under sobol.
    call = (cev.terminal() > K) * (cev.terminal() - K)
    s = np.asarray(call.sample(2**16, random_state=0, method="sobol"))
    print(f"  CEV call (undiscounted): {s.mean():.4f}")


def mlmc_demo():
    print("Multilevel MC (GBM call, exact answer e^rT * BS):")
    res = mlmc_estimate(
        lambda t, x: R * x,
        lambda t, x: SIGMA * x,
        lambda paths: jnp.maximum(paths[:, -1] - K, 0.0),
        x0=S0,
        eps=0.02,
        scheme="milstein",
        random_state=0,
    )
    want = np.exp(R * T) * bs_call()
    print(f"  estimate {res['mean']:.4f} (true {want:.4f}), eps={res['eps']}")
    print(
        f"  levels={res['levels']} steps={res['steps']} "
        f"n={res['n_per_level']}"
    )
    print(
        f"  cost {res['cost']:.3g} step-evals vs plain-MC {res['cost_mc']:.3g}"
        f"  ({res['cost_mc'] / res['cost']:.1f}x saved)"
    )


def american_demo():
    print("American put (Longstaff-Schwartz 2001, table 1):")
    for s0, fd in [(36.0, 4.478), (40.0, 2.314), (44.0, 1.110)]:
        gbm = GeometricBrownianMotion(s0=s0, mu=0.06, sigma=0.2, T=1.0, steps=50)
        res = american_price(
            gbm, lambda s: jnp.maximum(40.0 - s, 0.0), rate=0.06,
            size=2**17, random_state=0,
        )
        print(
            f"  S0={s0:g}: {res['price']:.3f} +/- {res['se']:.3f} "
            f"(FD {fd}), exercised early on {res['exercise_fraction']:.0%}"
        )
    h = Heston(
        s0=36.0, mu=0.06, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3,
        rho=-0.7, T=1.0, steps=50,
    )
    res = american_price(
        h, lambda s: jnp.maximum(40.0 - s, 0.0), rate=0.06,
        size=2**17, random_state=0,
    )
    print(f"  Heston S0=36: {res['price']:.3f} +/- {res['se']:.3f}")


def main():
    cev_model()
    mlmc_demo()
    american_demo()


if __name__ == "__main__":
    main()
