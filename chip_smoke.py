"""Smoke test of the sampling engine on one NVIDIA GPU.

Drives the public entry points at the sizes the README advertises and
compares every phase with a plain float64 NumPy/SciPy reference written
independently of the engine.  One process, one card:

    python chip_smoke.py               # every phase on one card
    python chip_smoke.py --four-cards  # only the sample mesh on four cards

Earlier lines report the card, the devices, the compile-cache directory
and, per phase, compile seconds, the median steady seconds over at least
three runs, ``peak_bytes_in_use`` and each check's deviation beside its
tolerance.  The last line is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
printed only when every phase passed.  Without a GPU the script exits
non-zero before any phase runs.

Each phase is a module-level function that takes its sizes, so the CPU
tests run the same code at tiny sizes (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import scipy.special as sps
import scipy.stats as st

import jax
import jax.numpy as jnp

# The flagship DAG's eight leaves in the engine's column order (ISNs by
# creation), as (scipy family, parameters) -- the reference evaluates the
# same formula independently of the engine's node classes.
FLAGSHIP_LEAVES = (
    ("lognorm", dict(s=0.25, scale=50.0)),
    ("triang", dict(c=0.4, loc=800, scale=600)),
    ("norm", dict(loc=1.0, scale=0.05)),
    ("uniform", dict(loc=20, scale=15)),
    ("norm", dict(loc=5000, scale=400)),
    ("expon", dict(scale=0.1)),
    ("norm", dict(loc=0.0, scale=1.0)),
    ("uniform", dict(loc=0.2, scale=0.1)),
)

# mixed_correlated_50's ten correlated drivers, in plan.corr_vars order.
CORRELATED_DRIVERS = (
    ("norm", dict(loc=0.0, scale=1.0)),
    ("lognorm", dict(s=0.3, scale=10.0)),
    ("uniform", dict(loc=-1, scale=2)),
    ("expon", dict(scale=0.5)),
    ("triang", dict(c=0.5, loc=0, scale=2)),
    ("norm", dict(loc=5.0, scale=2.0)),
    ("uniform", dict(loc=0, scale=1)),
    ("lognorm", dict(s=0.5, scale=1.0)),
    ("norm", dict(loc=-2.0, scale=0.5)),
    ("expon", dict(scale=2.0)),
)

# Elementwise flagship check: |engine - float64| over the size of the
# largest term of the formula (revenue + cost), which the cancellations
# in gross/pre_tax would otherwise turn into an unbounded relative error.
# The float32 program deviates by 2.2e-7 on the CPU backend (2^20 rows).
FLAGSHIP_ELEMENTWISE_RTOL = 1e-6
# Longstaff-Schwartz (2001) table 1 (S0=36, sigma=0.2, T=1, K=40,
# r=0.06, 50 dates): 4.472, itself a simulation with SE 0.010.  The
# tolerance is a 0.003 margin for LSMC's regression bias plus three of
# our standard errors: 0.020 at 2^18 paths (SE 0.0057), where four seeds
# on the CPU backend deviated by 0.0002 to 0.0124.
AMERICAN_REFERENCE = 4.472
AMERICAN_BIAS_MARGIN = 0.003
N_SIGMA = 5.0


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations.

    A persistent-cache hit still records a (short) backend event, so a
    warm cache shows up as fewer compile seconds.
    """

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


class Phase:
    """One phase's record: timings, memory and checks."""

    def __init__(self, name, clock=None):
        self.name = name
        self.clock = clock
        self.compile_s = None
        self.steady_s = None
        self.runs = 0
        self.checks = []

    def time(self, fn, runs=3):
        """First call (compiles), then ``runs`` steady calls; returns the first."""
        before = self.clock.seconds if self.clock else None
        out = jax.block_until_ready(fn(0))
        if self.clock:
            self.compile_s = self.clock.seconds - before
        times = []
        for i in range(runs):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(i + 1))
            times.append(time.perf_counter() - t0)
        self.steady_s = float(np.median(times))
        self.runs = runs
        return out

    def check(self, what, deviation, tolerance):
        self.checks.append(
            dict(check=what, deviation=float(deviation), tolerance=float(tolerance),
                 ok=bool(deviation <= tolerance))
        )

    @property
    def ok(self):
        return all(c["ok"] for c in self.checks)

    def record(self):
        stats = jax.devices()[0].memory_stats() or {}
        return dict(
            phase=self.name, compile_s=self.compile_s, steady_s=self.steady_s,
            runs=self.runs, peak_bytes_in_use=stats.get("peak_bytes_in_use"),
            checks=self.checks,
        )


# ----------------------------------------------------------------------
# Plain float64 references
# ----------------------------------------------------------------------


def flagship_formula(q):
    """float64 NumPy/SciPy evaluation of mixed_dag_20 on quantiles ``q``."""
    x = [
        getattr(st, name)(**kw).ppf(q[:, i])
        for i, (name, kw) in enumerate(FLAGSHIP_LEAVES)
    ]
    price, volume, fx, unit_cost, fixed_cost, delay, shock, tax = x
    eff_volume = volume * np.exp(shock * 0.1)
    revenue = price * eff_volume * fx
    cost = unit_cost * eff_volume + fixed_cost
    pre_tax = revenue - cost - delay * revenue
    taxed = pre_tax * (1 - tax)
    return np.maximum(taxed, pre_tax * 0.05) + np.sqrt(fx * fx), revenue + cost


def flagship_reference(n, seed=12345, chunk=1 << 22):
    """``n`` float64 draws of the flagship output from NumPy's generator."""
    rng = np.random.default_rng(seed)
    parts = []
    for lo in range(0, n, chunk):
        parts.append(flagship_formula(rng.random((min(chunk, n - lo), 8)))[0])
    return np.concatenate(parts)


def _mean_z(x_mean, x_var, n, ref):
    """|mean - ref mean| in combined standard errors."""
    se = np.sqrt(x_var / n + ref.var() / ref.size)
    return abs(x_mean - ref.mean()) / se


def _std_z(x_std, n, ref):
    m2 = ref.var()
    m4 = np.mean((ref - ref.mean()) ** 4)
    se_var = np.sqrt((m4 - m2 * m2) * (1.0 / ref.size + 1.0 / n))
    return abs(x_std - np.sqrt(m2)) / (se_var / (2.0 * np.sqrt(m2)))


def _quantile_z(value, p, n, ref_sorted):
    """Binomial band: F_ref(value) against p, in standard errors."""
    f = np.searchsorted(ref_sorted, value, side="right") / ref_sorted.size
    se = np.sqrt(p * (1 - p) * (1.0 / ref_sorted.size + 1.0 / n))
    return abs(f - p) / se


def _host_moments(x):
    x = np.asarray(x)
    return float(np.mean(x, dtype=np.float64)), float(np.var(x, dtype=np.float64))


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------


def phase_flagship(n, elementwise_rows, ref, clock=None):
    """``mixed_dag_20().sample(n)``: elementwise and statistical checks."""
    from __graft_entry__ import entry
    from probabilit_tpu.engine import compile as _compile
    from probabilit_tpu.models import benchmarks

    ph = Phase("flagship", clock)
    sink = benchmarks.mixed_dag_20()
    plan = _compile.get_plan(sink)
    leaves = [(node.distr, node.kwargs) for node in plan.dist_nodes]
    if leaves != [(name, kw) for name, kw in FLAGSHIP_LEAVES]:
        raise AssertionError(f"flagship leaves changed: {leaves}")

    # Elementwise: the compiled program on NumPy-drawn quantile rows.
    fn, _ = entry()
    rng = np.random.default_rng(7)
    q32 = rng.uniform(2.0**-20, 1.0 - 2.0**-20, (elementwise_rows, 8))
    q32 = q32.astype(np.float32)
    got = np.asarray(jax.jit(fn)(jnp.asarray(q32)), np.float64)
    want, scale = flagship_formula(q32.astype(np.float64))
    ph.check(
        "elementwise |engine-f64|/(revenue+cost)",
        np.max(np.abs(got - want) / np.abs(scale)),
        FLAGSHIP_ELEMENTWISE_RTOL,
    )

    # The program sample() runs holds no host callback.
    program = _compile.get_program(
        plan, "imanconover", frozenset({sink._id}), rng_inline_n=n
    )
    hlo = program.lower(jax.random.PRNGKey(0)).as_text().lower()
    ph.check("host callbacks in program", hlo.count("callback"), 0)

    x = ph.time(lambda i: sink.sample(n, random_state=i, gc_strategy=[]))
    x = np.asarray(x)
    ph.check("non-finite samples", np.count_nonzero(~np.isfinite(x)), 0)
    mean, var = _host_moments(x)
    ph.check("mean (SE)", _mean_z(mean, var, n, ref), N_SIGMA)
    ph.check("std (SE)", _std_z(np.sqrt(var), n, ref), N_SIGMA)
    ref_sorted = np.sort(ref)
    for p, v in zip((0.01, 0.5, 0.99), np.quantile(x, (0.01, 0.5, 0.99))):
        z = _quantile_z(v, p, n, ref_sorted)
        ph.check(f"q{p:g} binomial band (SE)", z, N_SIGMA)
    return ph


def _scores(name, kw, x):
    """float64 normal scores Phi^-1(F(x)) of one driver's samples."""
    x = np.asarray(x, np.float64)
    if name == "norm":
        return (x - kw["loc"]) / kw["scale"]
    if name == "lognorm":
        return np.log(x / kw["scale"]) / kw["s"]
    return sps.ndtri(getattr(st, name)(**kw).cdf(x))


def phase_correlated(n, clock=None, chunk=1 << 23):
    """``mixed_correlated_50().sample(n)``: score correlation and marginals."""
    from probabilit_tpu.engine import compile as _compile
    from probabilit_tpu.models import benchmarks

    ph = Phase("correlated", clock)
    sink = benchmarks.mixed_correlated_50()
    plan = _compile.get_plan(sink)
    drivers = list(plan.corr_vars)
    found = [(d.distr, d.kwargs) for d in drivers]
    if found != [(name, kw) for name, kw in CORRELATED_DRIVERS]:
        raise AssertionError(f"correlated drivers changed: {found}")
    target = np.asarray(plan.corr_matrix, np.float64)

    ph.time(lambda i: sink.sample(n, random_state=i, gc_strategy=[]))
    sink.sample(n, random_state=0, gc_strategy=drivers)
    k = len(drivers)
    s1, s2 = np.zeros(k), np.zeros(k)  # driver value sums
    y1, yy = np.zeros(k), np.zeros((k, k))  # score sums
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        xs = [np.asarray(d.samples_[lo:hi], np.float64) for d in drivers]
        ys = np.stack(
            [_scores(name, kw, x) for (name, kw), x in zip(CORRELATED_DRIVERS, xs)]
        )
        for i, x in enumerate(xs):
            s1[i] += x.sum()
            s2[i] += np.dot(x, x)
        y1 += ys.sum(axis=1)
        yy += ys @ ys.T
    ym = y1 / n
    cov = yy / n - np.outer(ym, ym)
    sd = np.sqrt(np.diag(cov))
    corr = cov / np.outer(sd, sd)
    ph.check("score corr vs NCM target (max abs)", np.max(np.abs(corr - target)), 1e-4)
    worst_mean = worst_std = 0.0
    for i, (name, kw) in enumerate(CORRELATED_DRIVERS):
        dist = getattr(st, name)(**kw)
        mean = s1[i] / n
        std = np.sqrt(max(s2[i] / n - mean * mean, 0.0))
        mu, sigma = dist.mean(), dist.std()
        kurt = float(dist.stats(moments="k")) + 3.0
        worst_mean = max(worst_mean, abs(mean - mu) / (sigma / np.sqrt(n)))
        se_std = sigma * np.sqrt((kurt - 1) / (4 * n))
        worst_std = max(worst_std, abs(std - sigma) / se_std)
    ph.check("marginal means (worst SE)", worst_mean, N_SIGMA)
    ph.check("marginal stds (worst SE)", worst_std, N_SIGMA)
    for d in drivers:
        del d.samples_
    return ph


def _gram_f64(a, chunk=1 << 21):
    """a.T @ a summed in float64 over float32 row chunks on the device."""
    gram = jax.jit(lambda b: jnp.dot(b.T, b, precision=jax.lax.Precision.HIGHEST))
    out = np.zeros((a.shape[1], a.shape[1]))
    for lo in range(0, a.shape[0], chunk):
        out += np.asarray(gram(a[lo : lo + chunk]), np.float64)
    return out


def phase_exact_ic(n, k, clock=None):
    """``ImanConover().set_target(C)(X)`` on an (n, k) float32 matrix."""
    from probabilit_tpu.ops.correlation import ImanConover

    ph = Phase("exact_ic", clock)
    C = np.full((k, k), 0.3)
    np.fill_diagonal(C, 1.0)
    X = jax.random.normal(jax.random.PRNGKey(3), (n, k), jnp.float32)
    ic = ImanConover().set_target(C)
    out = ph.time(lambda i: ic(X))
    same = jnp.all(jnp.sort(out, axis=0) == jnp.sort(X, axis=0))
    ph.check("columns not a permutation of the input", 0 if bool(same) else 1, 0)
    # Spearman = Pearson of the ranks.  Iman-Conover sets the van der
    # Waerden scores' Pearson correlation to C; for Gaussian scores the
    # rank correlation is then (6/pi) asin(C/2) (0.2871 at C = 0.3).
    ranks = jnp.argsort(jnp.argsort(out, axis=0), axis=0).astype(jnp.float32)
    ranks = ranks - jnp.float32((n - 1) / 2.0)
    del out
    gram = _gram_f64(ranks)
    sd = np.sqrt(np.diag(gram))
    spearman = gram / np.outer(sd, sd)
    # A rank correlation's sampling SE is about 1/sqrt(n): 2e-3 holds at
    # n = 1e7; small test sizes get N_SIGMA of it.
    expected = 6.0 / np.pi * np.arcsin(C / 2.0)
    ph.check(
        "Spearman vs (6/pi)asin(C/2) (max abs)",
        np.max(np.abs(spearman - expected)),
        max(2e-3, N_SIGMA / np.sqrt(n)),
    )
    return ph


def phase_streamed(n, ref, clock=None, block_size=None):
    """``streaming.estimate(flagship, n, quantiles, cvar)`` against ``ref``."""
    from probabilit_tpu.engine import streaming
    from probabilit_tpu.models import benchmarks

    ph = Phase("streamed", clock)
    sink = benchmarks.mixed_dag_20()
    levels = (0.5, 0.95, 0.99)
    kw = {} if block_size is None else dict(block_size=block_size)
    stats = ph.time(
        lambda i: streaming.estimate(
            sink, n, random_state=i, quantiles=levels, cvar=(0.99,), **kw
        )
    )
    ph.check("n", abs(stats["n"] - n), 0)
    ph.check("mean (SE)", _mean_z(stats["mean"], stats["var"], n, ref), N_SIGMA)
    ref_sorted = np.sort(ref)
    for p in levels:
        z = _quantile_z(stats[f"q{p:g}"], p, n, ref_sorted)
        ph.check(f"q{p:g} binomial band (SE)", z, N_SIGMA)
    v = np.quantile(ref, 0.99)
    excess = np.maximum(ref - v, 0.0)
    es_ref = v + excess.mean() / 0.01
    se = np.sqrt(excess.var() / ref.size) / 0.01
    ph.check("cvar0.99 (SE)", abs(stats["cvar0.99"] - es_ref) / se, N_SIGMA)
    return ph


def phase_gradient(n, clock=None, block_size=1 << 22):
    """Streamed VaR99 gradient d q0.99 / d s0 of a GBM terminal."""
    from probabilit_tpu import GeometricBrownianMotion, sensitivity

    ph = Phase("gradient", clock)
    mu, sigma, p, band = 0.05, 0.2, 0.99, 0.005
    gbm = GeometricBrownianMotion(s0=100.0, mu=mu, sigma=sigma, T=1.0, steps=8)
    z = st.norm.ppf(p)
    m = mu - 0.5 * sigma**2
    want = np.exp(m + sigma * z)  # dq/ds0 = q / s0, exactly
    # The estimator is the Hong-Liu conditional mean of dX/ds0 = X/s0
    # over the +/-0.005 probability band around the level
    # (engine/sensitivity.py), whose exact value for a lognormal X is:
    band_mean = np.exp(m + 0.5 * sigma**2) * (
        st.norm.cdf(st.norm.ppf(p + band) - sigma)
        - st.norm.cdf(st.norm.ppf(p - band) - sigma)
    ) / (2 * band)
    g = ph.time(
        lambda i: sensitivity(
            gbm.terminal(), wrt={gbm: ["s0"]}, size=n, random_state=i,
            statistic="q0.99", block_size=block_size,
        )
    )
    # dq/ds0 = q/s0 pathwise, so the error is that of the streamed q0.99:
    # relative SE sigma sqrt(p(1-p)/n) / phi(z).
    rel_se = sigma * np.sqrt(p * (1 - p) / n) / st.norm.pdf(z)
    tol = max(1e-3, N_SIGMA * rel_se)
    got = g[(gbm, "s0")]
    err = abs(got / band_mean - 1.0)
    ph.check("relative error vs band-conditional closed form", err, tol)
    # Against q/s0 itself the band's O(band) smoothing bias (3.2e-3) adds.
    bias = abs(band_mean / want - 1.0)
    ph.check("relative error vs q/s0", abs(got / want - 1.0), bias + tol)
    return ph


def barrier_reference(n_paths, steps, seed=99, chunk=1 << 15):
    """float64 NumPy MC of the discretely monitored up-and-out call."""
    rng = np.random.default_rng(seed)
    s0, mu, sigma, dt = 100.0, 0.03, 0.2, 1.0 / steps
    pay = []
    for lo in range(0, n_paths, chunk):
        z = rng.standard_normal((min(chunk, n_paths - lo), steps))
        log_steps = (mu - 0.5 * sigma**2) * dt + sigma * np.sqrt(dt) * z
        s = s0 * np.exp(np.cumsum(log_steps, axis=1))
        s_t = s[:, -1]
        pay.append((s.max(axis=1) < 130) * np.maximum(s_t - 100, 0.0) * np.exp(-0.03))
    pay = np.concatenate(pay)
    return pay.mean(), pay.std() / np.sqrt(n_paths)


def phase_barrier(barrier_paths, ref_paths, steps=252, clock=None):
    """Streamed up-and-out call on exact-law GBM paths."""
    from probabilit_tpu import GeometricBrownianMotion
    from probabilit_tpu.engine import streaming

    ph = Phase("barrier", clock)
    gbm = GeometricBrownianMotion(s0=100, mu=0.03, sigma=0.2, T=1.0, steps=steps)
    payoff = (
        (gbm.maximum() < 130)
        * ((gbm.terminal() - 100) > 0)
        * (gbm.terminal() - 100)
        * float(np.exp(-0.03))
    )
    est = ph.time(
        lambda i: streaming.estimate(
            payoff, barrier_paths, block_size=min(1 << 16, barrier_paths),
            random_state=i,
        )
    )
    ref_mean, ref_se = barrier_reference(ref_paths, steps)
    z = abs(est["mean"] - ref_mean) / np.hypot(est["sem"], ref_se)
    ph.check("barrier price (SE)", z, N_SIGMA)
    return ph


def _put40(s):
    # One function object across calls: compiled programs key the payoff
    # by identity.
    return jnp.maximum(40.0 - s, 0.0)


def phase_american(n_paths, clock=None):
    """Two-pass Longstaff-Schwartz American put, 50 exercise dates."""
    from probabilit_tpu import GeometricBrownianMotion, american_price

    ph = Phase("american", clock)
    am = GeometricBrownianMotion(s0=36.0, mu=0.06, sigma=0.2, T=1.0, steps=50)
    res = ph.time(
        lambda i: american_price(am, _put40, rate=0.06, size=n_paths, random_state=i)
    )
    ph.check(
        "put price vs LS 4.472",
        abs(res["price"] - AMERICAN_REFERENCE),
        AMERICAN_BIAS_MARGIN + 3 * res["se"],
    )
    return ph


# ----------------------------------------------------------------------
# Entry point
# ----------------------------------------------------------------------


def _card():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip()


def _report(ph, failed):
    print(json.dumps(ph.record()), flush=True)
    if not ph.ok:
        failed.append(ph.name)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the sample-mesh checks on four cards",
    )
    args = parser.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {devices}")
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        raise SystemExit(f"need {want} GPUs, JAX found {len(devices)}")

    from probabilit_tpu import config

    cache = config.enable_compile_cache()
    print(f"card: {_card()}", flush=True)
    print(f"devices: {devices}", flush=True)
    print(f"compile cache: {cache}", flush=True)
    clock = CompileClock()

    if args.four_cards:
        from __graft_entry__ import mesh_checks

        t0 = time.perf_counter()
        mesh_checks(
            devices[:4], n=10**8, ic_shape=(10**7, 50), stream_n=10**8,
            stream_block=1 << 24, log=lambda msg: print(msg, flush=True),
        )
        print(json.dumps(dict(
            phase="four_cards", seconds=time.perf_counter() - t0,
            compile_s=clock.seconds,
        )), flush=True)
    else:
        t0 = time.perf_counter()
        ref = flagship_reference(10**7)
        t_ref = time.perf_counter() - t0
        print(f"float64 reference: {ref.size} draws in {t_ref:.1f}s", flush=True)
        failed = []
        _report(phase_flagship(10**8, 1 << 20, ref, clock), failed)
        _report(phase_correlated(10**8, clock), failed)
        _report(phase_exact_ic(10**7, 50, clock), failed)
        _report(phase_streamed(10**9, ref, clock), failed)
        _report(phase_gradient(10**9, clock), failed)
        _report(phase_barrier(1 << 21, 1 << 18, clock=clock), failed)
        _report(phase_american(1 << 18, clock), failed)
        if failed:
            raise SystemExit(f"failed phases: {failed}")

    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }}), flush=True)


if __name__ == "__main__":
    main()
