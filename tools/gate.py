"""Mechanical green-suite gate: run before EVERY snapshot commit.

Round-4's verdict demanded this become mechanical after two consecutive
rounds shipped an end-of-round snapshot with ``estimate()`` raising
``TypeError`` on every call (42b9466, and round 3's equivalent): dozens
of tests would have caught it, but no gate forced them to run.

Two modes:

* default (smoke): a <3-minute curated slice driving every flagship
  entry point — ``sample``, ``estimate``, ``estimate_many``,
  ``sample_streaming``, ``sensitivity``, ``sweep``, ``sobol_indices``,
  ``american_price``/``american_greeks``, ``mlmc`` — against analytic
  values on the simulated 8-device CPU mesh.  This is the minimum bar
  for ANY commit touching the engine: it proves the public surface is
  callable and sane, not that every edge case passes.
* ``--full``: the full pytest suite in two halves (the smoke slice is
  NOT a substitute for this before an end-of-round snapshot).

Exit status 0 = green, 1 = any failure.  Usage:

    python tools/gate.py            # smoke slice (~2-3 min)
    python tools/gate.py --full     # full suite (~70 CPU-minutes)
"""

import os
import sys
import time
import traceback

# Must run before any jax backend initialisation: the platform is forced
# through jax.config so it holds even if jax was imported earlier (see
# tests/conftest.py).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

_CHECKS = []


def check(name):
    def wrap(fn):
        _CHECKS.append((name, fn))
        return fn

    return wrap


@check("sample: README height model, mean/std vs analytic")
def _sample():
    import probabilit_tpu as pt

    h = pt.Distribution("norm", loc=170.0, scale=8.0)
    s = h.sample(20_000, random_state=0)
    assert abs(float(np.mean(s)) - 170.0) < 0.3, np.mean(s)
    assert abs(float(np.std(s)) - 8.0) < 0.3, np.std(s)


@check("estimate: streamed moments + quantile + cvar vs analytic normal")
def _estimate():
    import probabilit_tpu as pt

    x = pt.Distribution("norm", loc=1.0, scale=2.0)
    st = pt.estimate(
        x, size=300_000, block_size=65_536, random_state=0,
        quantiles=(0.95,), cvar=(0.95,),
    )
    assert abs(st["mean"] - 1.0) < 0.05, st["mean"]
    assert abs(st["std"] - 2.0) < 0.05, st["std"]
    assert abs(st["q0.95"] - (1.0 + 2.0 * 1.6449)) < 0.08, st["q0.95"]
    # ES_0.95 of N(1,2) = 1 + 2*phi(z)/(1-q)
    es = 1.0 + 2.0 * np.exp(-1.6449**2 / 2) / np.sqrt(2 * np.pi) / 0.05
    assert abs(st["cvar0.95"] - es) < 0.15, (st["cvar0.95"], es)


@check("estimate_many: joint covariance corr vs analytic 0.8944")
def _estimate_many():
    import probabilit_tpu as pt

    a = pt.Distribution("norm", loc=0.0, scale=1.0)
    b = a + pt.Distribution("norm", loc=0.0, scale=0.5)
    out = pt.estimate_many(
        [a, b], size=200_000, block_size=65_536, random_state=0,
        covariance=True,
    )
    rho = out[a]["corr"][1]
    assert abs(rho - 0.8944) < 0.01, rho


@check("sample_streaming: blocked stream matches analytic uniform mean")
def _streaming():
    import probabilit_tpu as pt
    from probabilit_tpu.engine.streaming import sample_streaming

    u = pt.Distribution("uniform", 2.0, 4.0)  # loc=2, scale=4 -> [2, 6]
    s = sample_streaming(u, size=100_000, block_size=32_768, random_state=1)
    assert s.shape == (100_000,)
    assert abs(float(s.mean()) - 4.0) < 0.03, s.mean()


@check("sensitivity: d/dloc of 5x+1 = 5 exactly (pathwise)")
def _sensitivity():
    import probabilit_tpu as pt
    from probabilit_tpu.engine.sensitivity import sensitivity

    x = pt.Distribution("norm", loc=2.0, scale=3.0)
    y = 5 * x + 1
    res = sensitivity(y, wrt=x, size=20_000, random_state=0)
    assert abs(res[(x, "loc")] - 5.0) < 1e-3, res
    # Streamed path must agree.
    res_s = sensitivity(
        y, wrt=x, size=60_000, block_size=16_384, random_state=0
    )
    assert abs(res_s[(x, "loc")] - 5.0) < 1e-3, res_s


@check("sweep: 3-point loc ladder is monotone and exact under CRN")
def _sweep():
    import probabilit_tpu as pt

    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    y = 2.0 * x + 1.0
    res = pt.sweep(
        y, {(x, "loc"): np.array([-1.0, 0.0, 1.0])}, size=8_192,
        random_state=0,
    )
    m = res["mean"]
    assert np.all(np.diff(m) > 0), m
    # CRN: scenario differences are exact (2.0 * dloc), not just close.
    assert np.allclose(np.diff(m), 2.0, atol=1e-4), np.diff(m)


@check("sobol_indices: additive normals split variance 0.8/0.2")
def _sobol():
    import probabilit_tpu as pt
    from probabilit_tpu.engine.sensitivity import sobol_indices

    a = pt.Distribution("norm", loc=0.0, scale=2.0)
    b = pt.Distribution("norm", loc=0.0, scale=1.0)
    res = sobol_indices(a + b, size=4_096, random_state=0)
    assert abs(res.first_order[a] - 0.8) < 0.05, res.first_order


@check("correlate: induced Iman-Conover correlation hits target 0.7")
def _correlate():
    import probabilit_tpu as pt

    # Normal marginals: the induced Pearson correlation matches the
    # score-rank target directly (non-normal marginals shrink it).
    a = pt.Distribution("norm", loc=0.0, scale=1.0)
    b = pt.Distribution("norm", loc=1.0, scale=2.0)
    sink = (a + b).correlate(a, b, corr_mat=np.array([[1.0, 0.7], [0.7, 1.0]]))
    sink.sample(20_000, random_state=0)
    rho = np.corrcoef(np.asarray(a.samples_), np.asarray(b.samples_))[0, 1]
    assert abs(rho - 0.7) < 0.05, rho


@check("american_price: LS-2001 put 36/40 within 0.1 (small n)")
def _american():
    import jax.numpy as jnp

    from probabilit_tpu import GeometricBrownianMotion
    from probabilit_tpu.engine.american import american_price

    gbm = GeometricBrownianMotion(s0=36.0, mu=0.06, sigma=0.2, T=1.0, steps=50)
    res = american_price(
        gbm, lambda s: jnp.maximum(40.0 - s, 0.0), rate=0.06, size=2**14,
        random_state=0,
    )
    assert abs(res["price"] - 4.478) < 0.12, res["price"]


@check("mlmc: GBM European call via node API within 3 sem")
def _mlmc():
    import jax.numpy as jnp

    from probabilit_tpu import GeometricBrownianMotion
    from probabilit_tpu.engine.mlmc import mlmc_estimate

    gbm = GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, T=1.0, steps=64)
    res = mlmc_estimate(
        gbm,
        lambda s: jnp.exp(-0.05) * jnp.maximum(s[:, -1] - 100.0, 0.0),
        eps=0.1,
        random_state=0,
    )
    # Black-Scholes: 10.4506
    assert abs(res["mean"] - 10.4506) < 0.35, res["mean"]


@check("american_greeks: frozen-policy put delta in (-1, 0), rho < 0")
def _american_greeks():
    import jax.numpy as jnp

    from probabilit_tpu import GeometricBrownianMotion
    from probabilit_tpu.engine.american import american_greeks

    gbm = GeometricBrownianMotion(s0=40.0, mu=0.06, sigma=0.2, T=1.0, steps=8)
    g = american_greeks(
        gbm, lambda s: jnp.maximum(40.0 - s, 0.0), rate=0.06, size=2**13,
        random_state=0,
    )
    assert -1.0 < g["s0"] < 0.0, g
    assert g["rate"] < 0.0, g
    assert g["se"] > 0.0 and np.isfinite(g["se"]), g


@check("estimate(target_sem=): sequential stopping meets the bar")
def _sequential():
    import probabilit_tpu as pt

    x = pt.Distribution("norm", loc=2.0, scale=3.0)
    st = pt.estimate(
        x, 4_096, block_size=2_048, random_state=0, target_sem=0.02,
    )
    assert st["converged"] is True and st["sem"] <= 0.02, st
    assert abs(st["mean"] - 2.0) < 6 * st["sem"] + 1e-6, st


@check("estimate(checkpoint=): segmented run deterministic, file cleaned")
def _checkpoint_resume():
    import tempfile

    import probabilit_tpu as pt

    x = pt.Distribution("norm", loc=1.0, scale=2.0)
    kw = dict(size=40_000, block_size=4_096, random_state=5,
              checkpoint_every=16_384)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "carry.npz")
        a = pt.estimate(x, checkpoint=path, **kw)
        # A completed run removes its carry file; an identical rerun
        # reproduces the segment folds bitwise.
        assert not os.path.exists(path), "completed run left its carry"
        b = pt.estimate(x, checkpoint=path, **kw)
    assert a["mean"] == b["mean"] and a["std"] == b["std"], (a, b)
    assert abs(a["mean"] - 1.0) < 0.05, a["mean"]


def run_smoke():
    failures = 0
    for name, fn in _CHECKS:
        t0 = time.time()
        try:
            fn()
        except Exception:
            failures += 1
            print(f"FAIL  {name}  ({time.time() - t0:.1f}s)")
            traceback.print_exc()
        else:
            print(f"ok    {name}  ({time.time() - t0:.1f}s)")
    print(
        f"gate: {len(_CHECKS) - failures}/{len(_CHECKS)} smoke checks green"
    )
    return failures == 0


def run_full():
    """Full pytest suite in two halves (bounded memory, clear tails)."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    tests = sorted(
        f
        for f in os.listdir(os.path.join(repo, "tests"))
        if f.startswith("test_") and f.endswith(".py")
    )
    halves = [tests[: len(tests) // 2], tests[len(tests) // 2 :]]
    ok = True
    for i, half in enumerate(halves):
        print(f"=== full-suite half {i + 1}/2: {len(half)} files ===")
        cmd = [sys.executable, "-m", "pytest", "-q", *(
            os.path.join("tests", f) for f in half
        )]
        r = subprocess.run(cmd, cwd=repo)
        ok = ok and r.returncode == 0
    return ok


if __name__ == "__main__":
    full = "--full" in sys.argv[1:]
    good = run_full() if full else run_smoke()
    sys.exit(0 if good else 1)
