"""Rare-event estimation with quantile-space importance sampling.

Estimating P(event) ~ 1e-9 by plain Monte Carlo needs ~1e9 draws per
observed HIT — a hundred billion draws for a 1% error bar.  The
`tilted()` helper makes the event routine instead: it draws the
quantile of a chosen driver from a polynomial proposal concentrated in
the tail and returns the unbiased likelihood-ratio weight, all as
ordinary graph nodes.  No pdfs, no per-family math, and every engine
feature (streaming, QMC, replicates, meshes) composes unchanged.

The scipy-driven reference has no variance-reduction machinery; at
these probabilities it simply cannot produce an answer.

Run: python examples/08_rare_events.py   (seconds on CPU or GPU)
"""

import numpy as np
import scipy.stats

from probabilit_tpu import suggest_tilt, tilted
from probabilit_tpu.engine import streaming


def main():
    # ------------------------------------------------------------------
    # 1. A deep normal tail with a known answer: P(Z < -6) = 9.866e-10.
    # ------------------------------------------------------------------
    p_target = 1e-9  # rough guess of the rarity (sets efficiency only)
    k = suggest_tilt(p_target)
    z, w = tilted("norm", k=k, tail="lower")
    est = streaming.estimate(
        (z < -6.0) * w, 10**6, block_size=2**17, random_state=0
    )
    exact = scipy.stats.norm.cdf(-6.0)
    print(f"tilt exponent k* = {k:.3e}")
    print(
        f"P(Z < -6): estimate {est['mean']:.4e} +/- {est['sem']:.1e}"
        f"   exact {exact:.4e}   rel err "
        f"{est['mean'] / exact - 1.0:+.3%}"
    )

    # ------------------------------------------------------------------
    # 2. A structural-failure model: capacity vs load with a safety
    #    margin chosen so failure is a ~1e-7 event.  The load is the
    #    dominant driver, so IT gets the tilt; capacity stays as-is.
    #
    #    The failure event sits in the load's UPPER tail — but at 1e-7
    #    rarity an upper tilt would quantise on the float32 uniform grid
    #    near u = 1 (~2^-24) and bias the estimate (tilted() warns).
    #    Reformulate in the LOWER tail instead, where float32 resolves
    #    to ~1e-38: lognorm(s) is exp(s * Z), and -Z ~ Z, so driving the
    #    load with the NEGATED lower-tilted normal puts the proposal
    #    mass exactly where the failures are with no deep u-near-1
    #    quantiles anywhere.
    # ------------------------------------------------------------------
    from probabilit_tpu import Distribution
    from probabilit_tpu.models.graph import Exp

    # Rarity guess: ~1e-6 (the true answer is 2.5e-6).  Guess toward
    # the COMMON side when unsure — overshooting k by much more than
    # ~20x saturates float32 depth resolution and biases low (see
    # suggest_tilt's docstring); undershooting only costs variance.
    z2, w2 = tilted("norm", k=suggest_tilt(1e-6), tail="lower")
    load = Exp(0.25 * -z2)  # lognorm(s=0.25) with an upper-tail proposal
    capacity = Distribution("norm", loc=3.2, scale=0.15)
    failure = (load > capacity) * w2
    est2 = streaming.estimate(
        failure, 10**6, block_size=2**17, random_state=1,
        replicates=4, method="sobol",
    )
    # Exact by 1-d integration: P = E_C[P(Z > log(C)/s)] over capacity.
    cs = np.linspace(3.2 - 8 * 0.15, 3.2 + 8 * 0.15, 20001)
    exact2 = np.trapezoid(
        scipy.stats.norm.pdf(cs, 3.2, 0.15)
        * scipy.stats.norm.sf(np.log(np.maximum(cs, 1e-300)) / 0.25),
        cs,
    )
    print(
        f"P(load > capacity): {est2['mean']:.3e} "
        f"+/- {est2['sem']:.1e}  (randomised-QMC error bar, 4 replicates)"
        f"   exact {exact2:.3e}   rel err {est2['mean'] / exact2 - 1.0:+.2%}"
    )

    # Weight diagnostics: E[w] = 1 and the effective sample size.  Use a
    # GENTLE tilt here: without the event indicator, E[w^2] under the
    # proposal is 1/(k(2-k)) — INFINITE for k >= 2 — so the bare-weight
    # diagnostic is only readable at small k; at the production k above,
    # Monte Carlo cannot resolve E[w] at all.
    wd, w_diag = tilted("norm", k=1.5, tail="lower")
    wsq = w_diag * w_diag
    diag = streaming.estimate_many(
        [w_diag, wsq], 10**6, block_size=2**17, random_state=2
    )
    ew, ew2 = diag[w_diag]["mean"], diag[wsq]["mean"]
    print(
        f"E[w] = {ew:.4f} (should be ~1, k=1.5 diagnostic tilt);  "
        f"effective sample size = {ew * ew / ew2:.2%} of draws"
    )


if __name__ == "__main__":
    main()
