"""Benchmark harness: one process on the accelerator.

Headline metric: samples/sec on the 20-node mixed DAG at 1e8 draws,
through ``sample()``'s compiled XLA program.  Also measures Iman-Conover
at 1e7x50, the streamed estimators, gradients, paths and the other
shipped hot paths.  Refuses to run without a GPU.

Prints exactly ONE JSON line to stdout, naming the device it ran on;
diagnostics go to stderr.  Run: ``python bench.py``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def bench_flagship(n=100_000_000, repeats=5):
    """Samples/sec on the 20-node DAG through the compiled sampling program.

    The program ``sample()`` runs (uniforms generated in-program, fused
    finite flag), timed to ``block_until_ready``.  Reports the MEDIAN of
    ``repeats`` runs; returns (samples_per_sec_median, spread_dict).
    """
    import jax

    from probabilit_tpu.engine import compile as _compile
    from probabilit_tpu.models import benchmarks

    sink = benchmarks.mixed_dag_20()
    plan = _compile.Plan(sink)
    program = _compile.get_program(
        plan, "imanconover", keep_ids=frozenset({sink._id}), rng_inline_n=n
    )

    def run(seed):
        return jax.block_until_ready(program(jax.random.PRNGKey(seed)))

    t0 = time.perf_counter()
    run(0)
    log(f"flagship compile+first run: {time.perf_counter() - t0:.2f}s")

    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        run(i + 1)
        dt = time.perf_counter() - t0
        times.append(dt)
        log(f"flagship run {i}: {dt * 1e3:.1f} ms -> {n / dt / 1e9:.3f} Gsamples/s")
    med = float(np.median(times))
    spread = {
        "flagship_ms_median": med * 1e3,
        "flagship_ms_min": min(times) * 1e3,
        "flagship_ms_max": max(times) * 1e3,
        "flagship_repeats": repeats,
    }
    log(
        f"flagship median {med * 1e3:.1f} ms (min {min(times) * 1e3:.1f} / "
        f"max {max(times) * 1e3:.1f})"
    )
    return n / med, spread


def bench_imanconover(n=10_000_000, k=50, repeats=3):
    """Iman-Conover wall time (ms) on an (n, k) matrix."""
    import jax
    import jax.numpy as jnp

    from probabilit_tpu.ops.correlation import ImanConover

    corr = np.full((k, k), 0.3)
    np.fill_diagonal(corr, 1.0)
    transform = ImanConover().set_target(corr)
    apply_fn = jax.jit(transform._apply_rows)  # (K, N) lane-aligned layout

    def run(X):
        return jax.block_until_ready(apply_fn(X))

    X = jax.random.normal(jax.random.PRNGKey(0), (k, n), dtype=jnp.float32)
    jax.block_until_ready(X)
    t0 = time.perf_counter()
    run(X)
    log(f"imanconover compile+first: {time.perf_counter() - t0:.2f}s")

    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        run(X)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        log(f"imanconover run {i}: {dt * 1e3:.1f} ms")
    return best * 1e3


def bench_qmc_portfolio(n=1_000_000, repeats=2):
    """10-dim QMC portfolio with Iman-Conover, 1e6 draws."""
    import jax.numpy as jnp

    from probabilit_tpu.models import benchmarks

    sink = benchmarks.portfolio_model(d=10, target_corr=0.3)

    def run(seed):
        s = sink.sample(n, random_state=seed, method="sobol", gc_strategy=[])
        return float(jnp.mean(s))

    t0 = time.perf_counter()
    run(0)
    log(f"qmc portfolio compile+first: {time.perf_counter() - t0:.2f}s")
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        run(i + 1)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        log(f"qmc portfolio run {i}: {dt * 1e3:.0f} ms")
    return best * 1e3


def bench_correlated_50(n=100_000_000, repeats=2):
    """~50-node DAG, NCM repair + Iman-Conover, 1e8 draws.

    Exercises the engine's sort-free generated Iman-Conover (Gaussian-copula
    score recoloring): correlation induction adds no sorts to the program.
    """
    import jax

    from probabilit_tpu.models import benchmarks

    sink = benchmarks.mixed_correlated_50()

    def run(seed):
        return jax.block_until_ready(
            sink.sample(n, random_state=seed, gc_strategy=[])
        )

    t0 = time.perf_counter()
    run(0)
    log(f"correlated-50 compile+first: {time.perf_counter() - t0:.2f}s")
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        run(i + 1)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        log(f"correlated-50 run {i}: {dt * 1e3:.0f} ms -> {n / dt / 1e9:.3f} G/s")
    return best * 1e3


def bench_dependence(n=100_000_000):
    """Round-3 dependence extensions at 1e8 draws (XLA path).

    (1) the 50-node correlated DAG with the StudentTCopula correlator:
    the Gaussian recoloring plus one chi2 ppf (safeguarded-Newton
    gammaincinv) and a t CDF over the correlated rows; (2) a
    Clayton-copula loss pair via frailty sampling + QuantileTransform.
    """
    import jax.numpy as jnp

    from probabilit_tpu import ClaytonCopula, QuantileTransform
    from probabilit_tpu.correlation import StudentTCopula
    from probabilit_tpu.models import benchmarks

    out = {}

    from probabilit_tpu.engine import streaming

    sink = benchmarks.mixed_correlated_50()

    # Streamed: the block stream is the supported shape for big t-copula
    # runs — any size, O(block) memory.
    def run_t(seed):
        return streaming.estimate(
            sink,
            n,
            block_size=1 << 24,
            random_state=seed,
            correlator=StudentTCopula(df=4),
        )["mean"]

    t0 = time.perf_counter()
    run_t(0)
    log(f"tcopula-50 [streamed] compile+first: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    run_t(1)
    dt = time.perf_counter() - t0
    log(f"tcopula-50 [streamed] run: {dt * 1e3:.0f} ms -> {n / dt / 1e9:.3f} G/s")
    out["tcopula_50node_1e8_streamed_ms"] = dt * 1e3

    u1, u2 = ClaytonCopula(theta=2.0)
    loss = QuantileTransform(u1, "lognorm", s=0.25) + QuantileTransform(
        u2, "expon", scale=0.5
    )

    def run_c(seed):
        s = loss.sample(n, random_state=seed, gc_strategy=[])
        return float(jnp.mean(s))

    t0 = time.perf_counter()
    run_c(0)
    log(f"clayton-pair compile+first: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    run_c(1)
    dt = time.perf_counter() - t0
    log(f"clayton-pair run: {dt * 1e3:.0f} ms -> {n / dt / 1e9:.3f} G/s")
    out["clayton_pair_1e8_ms"] = dt * 1e3
    return out


def bench_paths(n_paths=1 << 21, steps=252):
    """Path-dependent workload: barrier payoff on exact-law GBM paths.

    2^21 paths x 252 steps ~ 5.3e8 normal draws + one cumsum scan + a
    running max, streamed in 2^16-path blocks (66 MB of path matrix per
    block) through estimate().
    """
    import numpy as np

    from probabilit_tpu import GeometricBrownianMotion
    from probabilit_tpu.engine import streaming

    gbm = GeometricBrownianMotion(s0=100, mu=0.03, sigma=0.2, T=1.0, steps=steps)
    payoff = (
        (gbm.maximum() < 130)
        * ((gbm.terminal() - 100) > 0)
        * (gbm.terminal() - 100)
        * float(np.exp(-0.03))
    )

    def run(seed):
        return streaming.estimate(
            payoff, n_paths, block_size=1 << 16, random_state=seed
        )["mean"]

    t0 = time.perf_counter()
    run(0)
    log(f"gbm-barrier compile+first: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    price = run(1)
    dt = time.perf_counter() - t0
    log(
        f"gbm-barrier run: {dt * 1e3:.0f} ms -> "
        f"{n_paths * steps / dt / 1e9:.2f} G path-elements/s "
        f"(price {price:.4f})"
    )
    return dt * 1e3


def bench_american(n_paths=1 << 18, steps=50):
    """Optimal stopping: Longstaff-Schwartz American put, two-pass.

    2^18 paths x 50 exercise dates, each date an ITM-weighted cubic
    regression (Gram matmuls + 4x4 solve) inside one lax.scan, run
    twice (fit + independent policy evaluation).
    """
    import jax.numpy as jnp

    from probabilit_tpu import GeometricBrownianMotion
    from probabilit_tpu.engine.american import american_price

    gbm = GeometricBrownianMotion(s0=36.0, mu=0.06, sigma=0.2, T=1.0, steps=steps)

    def payoff(s):
        # One function object across calls: the compiled-program cache
        # keys the payoff by identity.
        return jnp.maximum(40.0 - s, 0.0)

    def run(seed):
        return american_price(
            gbm, payoff, rate=0.06, size=n_paths, random_state=seed
        )

    t0 = time.perf_counter()
    run(0)
    log(f"american compile+first: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    res = run(1)
    dt = time.perf_counter() - t0
    log(
        f"american-lsmc run: {dt * 1e3:.0f} ms -> price {res['price']:.4f} "
        f"+/- {res['se']:.4f} (FD benchmark 4.478)"
    )
    return dt * 1e3


def bench_streaming_1e9():
    """Full 1e9-draw estimation with a streamed p95 (single dispatch).

    The whole-run program is cached by (graph, quantiles, block, ...) and
    size-agnostic since round 3 (n_blocks/last_count are traced scalars)
    — warm once, then time 1e9 AND a different size on the SAME program.
    """
    from probabilit_tpu.engine import streaming
    from probabilit_tpu.models import benchmarks

    sink = benchmarks.mixed_dag_20()
    q = (0.5, 0.95, 0.99)
    streaming.estimate(sink, 10**9, block_size=1 << 26, random_state=0, quantiles=q)
    t0 = time.perf_counter()
    stats = streaming.estimate(
        sink, 10**9, block_size=1 << 26, random_state=0, quantiles=q
    )
    dt = time.perf_counter() - t0
    log(
        f"streaming 1e9 (+p50/p95/p99): {dt:.2f}s "
        f"(mean={stats['mean']:.1f} p95={stats['q0.95']:.0f})"
    )
    # Size sweep on the cached program: a different size must NOT pay a
    # recompile.
    trace_count = streaming._TRACE_COUNT
    t0 = time.perf_counter()
    streaming.estimate(
        sink, 3 * 10**8 + 12345, block_size=1 << 26, random_state=0, quantiles=q
    )
    dt_sweep = time.perf_counter() - t0
    assert streaming._TRACE_COUNT == trace_count, "size sweep retraced!"
    log(f"streaming size-sweep 3e8 (cached program, no retrace): {dt_sweep:.2f}s")
    return 10**9 / dt, dt_sweep


def bench_large_table(n=100_000_000, repeats=3):
    """A 471-knot CDF-table family (poisson, mu=2000) at 1e8 draws: ns/sample."""
    import jax

    from probabilit_tpu.modeling import Distribution

    sink = Distribution("poisson", mu=2000) + 0.0

    def run(seed):
        return jax.block_until_ready(
            sink.sample(n, random_state=seed, gc_strategy=[])
        )

    t0 = time.perf_counter()
    run(0)
    log(f"large-table compile+first: {time.perf_counter() - t0:.2f}s")
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        run(i + 1)
        times.append(time.perf_counter() - t0)
    ns = float(np.median(times)) / n * 1e9
    log(f"large-table: {ns:.3f} ns/sample (median of {repeats})")
    return ns


def bench_sobol_indices(size=1 << 20, repeats=2):
    """Global sensitivity on the 20-node DAG (round-3 capability).

    First-order + total Sobol' indices over the DAG's 8 variables:
    (2 + 8) * 2^20 ~ 10.5M model evaluations batched into ONE compiled
    pick-freeze program.  The scipy reference has no GSA capability; at
    its measured DAG throughput the same evaluation sweep alone would
    take ~1 minute per analysis.
    """
    from probabilit_tpu import sobol_indices
    from probabilit_tpu.models import benchmarks

    sink = benchmarks.mixed_dag_20()
    t0 = time.perf_counter()
    res = sobol_indices(sink, size=size, random_state=0)
    log(f"sobol-indices compile+first: {time.perf_counter() - t0:.2f}s")
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        res = sobol_indices(sink, size=size, random_state=i + 1)
        best = min(best, time.perf_counter() - t0)
    top = max(res.first_order.values())
    log(
        f"sobol-indices (10 matrices x {size:.0f} rows): {best * 1e3:.0f} ms, "
        f"top S={top:.3f}"
    )
    return best * 1e3


def bench_sensitivity_stream(size=1_000_000_000):
    """Streamed pathwise gradients at 1e9 draws (round-4 capability).

    Two workloads, both ONE jitted fold with per-block VJP cotangents
    (engine/sensitivity.py:_build_stream_grad_fn):

    - the 20-node DAG's parameter gradients (d mean / d loc & scale of
      its normal FX leaf and the lognormal price leaf) at 1e9 draws;
    - GBM terminal delta/vega/d-mu at 2^30 paths x 8 steps (the
      gradients have closed forms: delta = e^{mu T}, d/dmu = s0 T e^{mu
      T}, d/dsigma = 0 — printed for the log as a correctness check).

    The reference has no autodiff at all; finite differences at this
    scale would cost 2P re-simulations per parameter set.
    """
    from probabilit_tpu import GeometricBrownianMotion, sensitivity
    from probabilit_tpu.engine import compile as _compile
    from probabilit_tpu.models import benchmarks

    sink = benchmarks.mixed_dag_20()
    plan = _compile.get_plan(sink)
    targets = [
        node
        for node in plan.isns
        if getattr(node, "distr", None) in ("norm", "lognorm")
    ][:2]
    t0 = time.perf_counter()
    res = sensitivity(
        sink, wrt=targets, size=size, random_state=0, block_size=1 << 24
    )
    dag_s = time.perf_counter() - t0
    log(
        f"streamed DAG gradients (1e9 draws, {len(res.gradients)} params): "
        f"{dag_s:.2f}s incl. compile, value={res.value:.4g}"
    )
    t0 = time.perf_counter()
    res = sensitivity(
        sink, wrt=targets, size=size, random_state=1, block_size=1 << 24
    )
    dag_s = time.perf_counter() - t0
    log(f"streamed DAG gradients steady-state: {dag_s:.2f}s")

    gbm = GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, T=1.0, steps=8)
    t0 = time.perf_counter()
    g = sensitivity(
        gbm.terminal(),
        wrt={gbm: ["s0", "mu", "sigma"]},
        size=1 << 30,
        random_state=0,
        block_size=1 << 21,
    )
    gbm_s = time.perf_counter() - t0
    want = float(np.exp(0.05))
    log(
        f"streamed GBM greeks (2^30 paths x 8 steps): {gbm_s:.2f}s incl. "
        f"compile; delta={g[(gbm, 's0')]:.5f} (exact {want:.5f}), "
        f"dmu={g[(gbm, 'mu')]:.3f} (exact {100 * want:.3f}), "
        f"dsigma={g[(gbm, 'sigma')]:.3f} (exact 0)"
    )
    return {
        "grad_stream_dag_1e9_s": dag_s,
        "grad_stream_gbm_2p30x8_s": gbm_s,
        "grad_stream_gbm_delta_relerr": abs(g[(gbm, "s0")] / want - 1.0),
    }


def bench_round5_risk(
    ladder_scen=32, ladder_size=100_000_000, var_size=1_000_000_000
):
    """Round-5 risk workloads: streamed VaR Greeks + streamed spot ladder.

    - d VaR_99 / d s0 of the GBM terminal at 1e9 draws: the two-pass
      Hong-Liu stream (pass 1: streamed quantile fold; pass 2: streamed
      band-conditional gradient mean).  Closed form for the check:
      q = s0 exp((mu - sigma^2/2) T + sigma sqrt(T) z_q), so
      dq/ds0 = q/s0 = 1.6409 at (mu, sigma, T, q) = (.05, .2, 1, .99).
    - a 32-point spot ladder at 1e8 draws/scenario as ONE streamed
      program (mean + q0.99 + cvar0.99 per scenario): per-scenario Chan
      folds with batched per-block row sorts.  The reference evaluates
      scenarios one scipy re-run at a time and cannot reach this size
      at all.
    """
    from probabilit_tpu import GeometricBrownianMotion, sensitivity, sweep

    gbm = GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, T=1.0, steps=8)
    want = float(np.exp(0.03 + 0.2 * 2.3263479))

    def var_grad(seed):
        t0 = time.perf_counter()
        g = sensitivity(
            gbm.terminal(),
            wrt={gbm: ["s0"]},
            size=var_size,
            random_state=seed,
            statistic="q0.99",
            block_size=1 << 22,
        )
        return time.perf_counter() - t0, g

    var_s, g = var_grad(0)
    log(
        f"streamed VaR99 gradient (1e9 draws): {var_s:.2f}s incl. "
        f"compile; dq/ds0={g[(gbm, 's0')]:.4f} (exact {want:.4f}), "
        f"q99={g.value:.3f}"
    )
    var_s, g = var_grad(1)
    log(f"streamed VaR99 gradient steady-state: {var_s:.2f}s")

    spots = np.linspace(80.0, 120.0, ladder_scen)

    def ladder(seed):
        t0 = time.perf_counter()
        res = sweep(
            gbm.terminal(),
            {(gbm, "s0"): spots},
            size=ladder_size,
            block_size=1 << 18,
            random_state=seed,
            statistics=("mean", "q0.99", "cvar0.99"),
        )
        return time.perf_counter() - t0, res

    ladder_s, res = ladder(0)
    mean_err = np.abs(res["mean"] / (spots * np.exp(0.05)) - 1.0).max()
    log(
        f"streamed 32-scenario spot ladder (1e8 draws/scenario, mean + "
        f"q99 + cvar99): {ladder_s:.2f}s incl. compile; max mean relerr "
        f"{mean_err:.2e}; monotone={bool(np.all(np.diff(res['mean']) > 0))}"
    )
    ladder_s, res = ladder(1)
    log(f"streamed spot ladder steady-state: {ladder_s:.2f}s")
    return {
        "var99_grad_stream_1e9_s": var_s,
        "var99_grad_relerr": abs(g[(gbm, "s0")] / want - 1.0),
        "ladder_32x1e8_stream_s": ladder_s,
    }


def _release_device_memory():
    """Drop dead device buffers between benchmarks.

    The Iman-Conover transform peaks at several GB of sort workspace on a
    (50, 1e7) matrix; buffers retained from earlier benches (samples_
    arrays) can exhaust device memory when it runs late.  Collecting here
    frees every graph-held array before the next bench allocates.
    """
    import gc

    gc.collect()


def main():
    import jax

    from probabilit_tpu import config

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {devices}")
    log(f"compile cache: {config.enable_compile_cache()}")

    flagship_sps, spread = bench_flagship()
    _release_device_memory()
    # Largest transient allocation first, before benches that retain
    # compiled programs and sample buffers.
    ic_ms = bench_imanconover()
    _release_device_memory()
    streaming_sps, sweep_s = bench_streaming_1e9()
    qmc_ms = bench_qmc_portfolio()
    _release_device_memory()
    corr50_ms = bench_correlated_50()
    _release_device_memory()
    dependence = bench_dependence()
    _release_device_memory()
    paths_ms = bench_paths()
    _release_device_memory()
    american_ms = bench_american()
    _release_device_memory()
    table_ns = bench_large_table()
    _release_device_memory()
    sobol_ms = bench_sobol_indices()
    _release_device_memory()
    grad_stream = bench_sensitivity_stream()
    _release_device_memory()
    risk5 = bench_round5_risk()

    print(
        json.dumps(
            {
                "metric": "samples_per_sec_per_chip_20node_1e8",
                "value": flagship_sps,
                "unit": "samples/s",
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
                "extras": {
                    "streaming_1e9_samples_per_sec": streaming_sps,
                    "qmc_portfolio_1e6x10_ic_ms": qmc_ms,
                    "correlated_50node_1e8_ms": corr50_ms,
                    "imanconover_1e7x50_ms": ic_ms,
                    "streaming_size_sweep_3e8_s": sweep_s,
                    "large_table_471knot_ns_per_sample": table_ns,
                    "sobol_indices_20node_10x1m_ms": sobol_ms,
                    **grad_stream,
                    **risk5,
                    **dependence,
                    "gbm_barrier_2p21x252_ms": paths_ms,
                    "american_lsmc_2p18x50_ms": american_ms,
                    **spread,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
