"""Test configuration.

The tests run on the CPU backend with 8 virtual devices, so that:
* the suite is hermetic and needs no accelerator,
* multi-device sharding paths are exercised exactly as
  ``__graft_entry__.dryrun_multichip`` does, per SURVEY §4's
  same-program-different-mesh testing strategy.

The platform is forced through ``jax.config`` (and the device count
through ``XLA_FLAGS``) before any backend is initialised, so the settings
hold even when JAX was imported before this file ran.  The accelerator
path is checked by ``python chip_smoke.py`` on the card, not by pytest.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
