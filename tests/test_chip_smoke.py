"""chip_smoke.py's phases at tiny sizes on the CPU backend.

The script itself refuses to run without a GPU; these tests run each
phase's code path and float64 reference here, so a wrong reference or a
broken entry point shows up before a chip run.
"""

import numpy as np
import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def flagship_ref():
    return cs.flagship_reference(1 << 16)


PHASES = {
    "flagship": lambda ref: cs.phase_flagship(1 << 14, 1 << 12, ref),
    "correlated": lambda ref: cs.phase_correlated(1 << 14, chunk=1 << 12),
    "exact_ic": lambda ref: cs.phase_exact_ic(4096, 6),
    "streamed": lambda ref: cs.phase_streamed(1 << 16, ref, block_size=1 << 13),
    "gradient": lambda ref: cs.phase_gradient(1 << 16, block_size=1 << 13),
    "barrier": lambda ref: cs.phase_barrier(1 << 12, 1 << 12, steps=64),
    "american": lambda ref: cs.phase_american(1 << 13),
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_agrees_with_its_reference(name, flagship_ref):
    ph = PHASES[name](flagship_ref)
    assert ph.checks, "a phase must check something"
    assert ph.ok, ph.checks
    assert ph.runs >= 3 and ph.steady_s > 0.0
    rec = ph.record()
    assert rec["phase"] == name


def test_flagship_reference_is_the_engine_formula(flagship_ref):
    # The float64 formula on the engine's own (float32) quantiles matches
    # the engine's evaluation elementwise; the reference draws have the
    # DAG's positive mean and spread.
    assert flagship_ref.shape == (1 << 16,)
    assert 1e4 < flagship_ref.mean() < 1.5e4
    assert np.isfinite(flagship_ref).all()


def test_main_refuses_a_cpu_backend(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code != 0
    assert "GPU" in str(exc.value.code)
    # No phase ran and no result line was printed.
    assert '"ok"' not in capsys.readouterr().out


def test_main_refuses_four_cards_without_gpus():
    with pytest.raises(SystemExit, match="GPU"):
        cs.main(["--four-cards"])
