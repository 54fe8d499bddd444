"""A correlated portfolio risk model end-to-end: QMC, correlation
induction, a streamed VaR profile at 1e9 draws, and checkpoint/resume.

Run: python examples/03_portfolio_var.py          (reduced sizes, any backend)
     python examples/03_portfolio_var.py --full   (1e9 draws; wants a GPU)
"""

import argparse
import os
import tempfile
import time

import numpy as np

from probabilit_tpu import Distribution, estimate_many
from probabilit_tpu.engine import checkpoint
from probabilit_tpu.ops.ncm import nearest_correlation_matrix
from probabilit_tpu.utils.helpers import build_corrmat


def build_portfolio():
    """Three asset classes with a (repaired) target rank correlation."""
    equities = Distribution("lognorm", s=0.25, scale=1.0)
    bonds = Distribution("norm", loc=1.02, scale=0.05)
    commodities = Distribution("t", df=4, loc=1.0, scale=0.15)

    # An analyst's pairwise guesses rarely form a valid correlation
    # matrix; assemble the blocks, then repair to the nearest one
    # (Higham projection, on device).
    guess = build_corrmat(
        [
            ((0, 1), np.array([[1.0, 0.4], [0.4, 1.0]])),
            ((0, 2), np.array([[1.0, 0.6], [0.6, 1.0]])),
            ((1, 2), np.array([[1.0, -0.3], [-0.3, 1.0]])),
        ]
    )
    target = nearest_correlation_matrix(guess)

    portfolio = 0.5 * equities + 0.3 * bonds + 0.2 * commodities
    portfolio.correlate(equities, bonds, commodities, corr_mat=target)
    return portfolio, {
        "equities": equities, "bonds": bonds, "commodities": commodities,
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--full", action="store_true", help="deployment sizes (1e9 draws)"
    )
    full = parser.parse_args().full
    tail_draws = 10**9 if full else 10**6
    portfolio, assets = build_portfolio()

    # 1. Quasi-Monte Carlo for the smooth-statistic phase: Sobol points
    #    cut the estimator variance well below iid sampling.
    returns = np.asarray(portfolio.sample(1 << 16, random_state=0, method="sobol"))
    print(f"sobol 65k draws: mean={returns.mean():.4f} std={returns.std():.4f}")

    # 2. The full tail profile at 1e9 draws, one device dispatch: the
    #    sort-free recoloring keeps the target correlation per block, and
    #    the streamed order statistics never materialise 4 GB of samples.
    t0 = time.perf_counter()
    stats = portfolio.estimate(
        tail_draws,
        block_size=1 << 26 if full else 1 << 18,
        random_state=0,
        quantiles=(0.01, 0.05, 0.5),
    )
    var99 = stats["q0.01"]  # keys are f"q{level:g}"
    print(
        f"{tail_draws:.0e} correlated draws in {time.perf_counter() - t0:.1f}s: "
        f"mean={stats['mean']:.4f}  VaR95={stats['q0.05']:.4f}  "
        f"VaR99={var99:.4f}"
    )

    # 3. Precision-targeted estimation: let the error bar choose the
    #    sample count.  The pilot size grows in variance-sized rounds
    #    until sem <= target; moments=True adds streamed skewness and
    #    excess kurtosis through the same fold (tail asymmetry is the
    #    whole reason VaR99 != 2.33 sigma here).
    seq = portfolio.estimate(
        1 << 16,
        block_size=1 << 22 if full else 1 << 18,
        random_state=1,
        target_rel_sem=0.005,
        moments=True,
    )
    print(
        f"sequential: {seq['n']:.2e} draws in {seq['rounds']} rounds "
        f"(converged={seq['converged']})  mean={seq['mean']:.4f} "
        f"+/- {seq['sem']:.5f}  skew={seq['skew']:.3f} "
        f"kurt={seq['kurt']:.3f}"
    )

    # 4. The realised desk correlation matrix, jointly consistent: every
    #    asset AND the portfolio measured on the SAME streamed draws
    #    (separate per-node runs could never produce a coherent matrix).
    nodes = [*assets.values(), portfolio]
    joint = estimate_many(
        nodes,
        1 << 24 if full else 1 << 18,
        block_size=1 << 22 if full else 1 << 16,
        random_state=2,
        covariance=True,
    )
    corr = np.stack([joint[n]["corr"] for n in nodes])
    labels = [*assets, "portfolio"]
    print("realised correlations (induced vs declared):")
    for i, row in enumerate(corr):
        cells = "  ".join(f"{v:+.3f}" for v in row)
        print(f"  {labels[i]:<12} {cells}")

    # 5. Checkpoint the sampled state and restore it into a rebuilt graph
    #    (the structural fingerprint refuses a mismatched model).
    portfolio.sample(1 << 14, random_state=3)
    path = checkpoint.save(
        portfolio, os.path.join(tempfile.gettempdir(), "portfolio_state.npz")
    )
    rebuilt, _ = build_portfolio()
    checkpoint.load(rebuilt, path)
    print(
        "resumed samples match:",
        bool(
            np.array_equal(
                np.asarray(portfolio.samples_), np.asarray(rebuilt.samples_)
            )
        ),
    )

    # 6. Mid-stream checkpointing (round 5): a long estimate() fold cut
    #    at fixed block boundaries persists each segment's carry, so a
    #    killed 1e10-draw run resumes at the first unfinished segment —
    #    bitwise-identical to the uninterrupted run.  (Small sizes here;
    #    the mechanics are size-independent.)
    from probabilit_tpu import estimate

    ck = estimate(
        portfolio,
        1 << 24 if full else 1 << 18,
        block_size=1 << 22 if full else 1 << 15,
        random_state=4,
        checkpoint=os.path.join(tempfile.gettempdir(), "portfolio_stream.ckpt.npz"),
        checkpoint_every=1 << 23 if full else 1 << 17,
    )
    print(
        f"checkpointed streamed mean {ck['mean']:,.0f} "
        "(file removed on completion)"
    )


if __name__ == "__main__":
    main()
