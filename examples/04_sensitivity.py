"""Sensitivity analysis of a Monte Carlo model, three complementary ways.

Both run through the SAME compiled sampling program `sample()` uses —
capabilities the scipy-driven reference cannot offer (its per-node
`.ppf` calls are opaque to autodiff, and a pick-freeze sweep at scipy
throughput is prohibitive):

1. `sensitivity()` — LOCAL, derivative-based: exact pathwise
   d statistic / d parameter via `jax.grad` through the program.
   "If the price volatility were 1% higher, how would the P95 move?"
2. `sobol_indices()` — GLOBAL, variance-based: which variables' overall
   randomness drives the output variance, interactions included.
   "Which inputs are worth refining at all?"
3. `sweep()` — NONLOCAL, scenario-based: a whole parameter ladder in one
   vmapped program under common random numbers.
   "What does the P95 curve actually look like across rate scenarios?"

Run: python examples/04_sensitivity.py   (seconds on CPU or GPU)
"""

import numpy as np

from probabilit_tpu import Distribution, sensitivity, sobol_indices, sweep


def build_project_cost():
    """A project-cost model: labour, materials, delay risk."""
    labour_hours = Distribution("triang", c=0.3, loc=800, scale=600)
    hourly_rate = Distribution("norm", loc=95.0, scale=8.0)
    materials = Distribution("lognorm", s=0.35, scale=40_000.0)
    delay_months = Distribution("expon", scale=1.5)
    overhead_rate = Distribution("uniform", loc=0.10, scale=0.08)

    base = labour_hours * hourly_rate + materials
    delay_penalty = delay_months * 12_000.0
    total = (base + delay_penalty) * (1.0 + overhead_rate)
    variables = {
        "labour_hours": labour_hours,
        "hourly_rate": hourly_rate,
        "materials": materials,
        "delay_months": delay_months,
        "overhead_rate": overhead_rate,
    }
    return total, variables


def main():
    total, variables = build_project_cost()

    # ------------------------------------------------------------------
    # Global: where does the output variance come from?
    # ------------------------------------------------------------------
    res = sobol_indices(total, size=1 << 15, random_state=0)
    print("Sobol' indices (first-order S, total ST):")
    for name, node in variables.items():
        s, st = res[node]
        bar = "#" * int(round(40 * max(s, 0.0)))
        print(f"  {name:<14} S={s:6.3f}  ST={st:6.3f}  {bar}")
    print(f"  output mean {res.mean:,.0f}, std {np.sqrt(res.variance):,.0f}")
    interactions = 1.0 - sum(res.first_order.values())
    print(f"  variance in interactions: {interactions:.1%}\n")

    # ------------------------------------------------------------------
    # Local: exact derivatives of the P95 (budget-at-risk) w.r.t. the
    # parameters we could actually change.  Pathwise gradients under
    # common random numbers — no finite differences, no noise floor.
    # ------------------------------------------------------------------
    grad = sensitivity(
        total,
        wrt={
            variables["hourly_rate"]: ["loc", "scale"],
            variables["delay_months"]: ["scale"],
            variables["materials"]: ["s"],
        },
        size=1 << 18,
        random_state=0,
        statistic="q0.95",
    )
    print(f"P95 cost: {grad.value:,.0f}")
    print("d P95 / d parameter:")
    for (node, slot), g in grad.gradients.items():
        name = next(k for k, v in variables.items() if v is node)
        print(f"  {name}.{slot:<6} {g:12,.1f}")

    # A sanity check the derivative is actionable: bump the hourly-rate
    # mean by +1 and compare the predicted vs re-simulated P95 shift.
    bump = 1.0
    predicted = grad[(variables["hourly_rate"], "loc")] * bump
    variables["hourly_rate"].kwargs["loc"] += bump
    shifted = sensitivity(
        total,
        wrt={variables["hourly_rate"]: ["loc"]},
        size=1 << 18,
        random_state=0,
        statistic="q0.95",
    ).value
    variables["hourly_rate"].kwargs["loc"] -= bump
    print(
        f"\n+{bump} on hourly rate mean: predicted P95 shift {predicted:,.1f}, "
        f"re-simulated {shifted - grad.value:,.1f}"
    )

    # 3. Scenario sweep — the NONLOCAL picture the derivative linearises:
    #    a whole rate ladder in ONE vmapped program, common random
    #    numbers, so the P95 curve is smooth and its slope at the base
    #    rate should match the pathwise derivative above.
    rates = np.linspace(85.0, 105.0, 9)
    curve = sweep(
        total,
        {(variables["hourly_rate"], "loc"): rates},
        size=1 << 16,
        random_state=0,
        statistics=("mean", "q0.95"),
    )
    print("\nHourly-rate ladder (one compiled program, CRN):")
    for r, m, q in zip(rates, curve["mean"], curve["q0.95"]):
        print(f"  rate {r:6.1f}  mean {m:12,.0f}  P95 {q:12,.0f}")
    slope = np.gradient(curve["q0.95"], rates)[4]
    print(
        f"ladder slope at the base rate {slope:,.1f} vs pathwise "
        f"derivative {grad[(variables['hourly_rate'], 'loc')]:,.1f}"
    )

    # 4. Risk-manager Greeks at scale (round 5): tail statistics stream
    #    too — d VaR / d parameter and d CVaR / d parameter fold in
    #    blocks (two-pass Hong-Liu), so the size below could as well be
    #    1e9+; and the ladder itself streams with valid replicate error
    #    bars on every statistic.
    var_grad = sensitivity(
        total,
        wrt={variables["hourly_rate"]: ["loc"]},
        size=1 << 18,
        block_size=1 << 15,
        random_state=0,
        statistic="q0.95",
    )
    print(
        f"\nstreamed d P95 / d rate = "
        f"{var_grad[(variables['hourly_rate'], 'loc')]:,.1f} "
        f"(P95 = {var_grad.value:,.0f})"
    )
    curve_s = sweep(
        total,
        {(variables["hourly_rate"], "loc"): rates},
        size=1 << 17,
        block_size=1 << 15,
        random_state=0,
        replicates=4,
        statistics=("mean", "q0.95"),
    )
    print(
        "streamed ladder with replicate error bars: P95 at base rate "
        f"{curve_s['q0.95'][4]:,.0f} +/- {curve_s['q0.95_sem'][4]:,.0f}"
    )

    # 5. Precision-targeted ladders: instead of guessing a size, let
    #    every ladder point run until its error bar is tight enough.
    #    Rounds of replicated CRN streams grow Chow-Robbins-style; all
    #    rounds reuse the one compiled program.
    curve_t = sweep(
        total,
        {(variables["hourly_rate"], "loc"): rates},
        size=1 << 14,
        random_state=0,
        replicates=4,
        target_sem=200.0,
    )
    print(
        f"sequential ladder: converged={curve_t.converged} after "
        f"{curve_t.rounds} round(s), {curve_t.size:,} draws/scenario; "
        f"worst sem {max(curve_t['sem']):,.0f}"
    )

    # 6. Long gradient runs survive crashes: the streamed fold persists
    #    per-segment co-moment carries, and an identical re-run resumes
    #    at the first unfinished segment (bitwise-identical result).
    #    The fingerprint pins the CURRENT parameter values, so resuming
    #    an edited model is refused rather than silently spliced.
    g_ck = sensitivity(
        total,
        wrt={variables["hourly_rate"]: ["loc"]},
        size=1 << 18,
        block_size=1 << 15,
        random_state=0,
        checkpoint="/tmp/sens_grad.ckpt.npz",
        checkpoint_every=1 << 16,
    )
    print(
        "checkpointed streamed gradient d mean / d rate = "
        f"{g_ck[(variables['hourly_rate'], 'loc')]:,.1f}"
    )


if __name__ == "__main__":
    main()
