"""Sample-axis sharding over a device mesh.

The reference is single-process NumPy (SURVEY §2.3).  The natural scale
axis for Monte Carlo is the *sample* dimension: every node's sample vector
is sharded over the mesh's ``samples`` axis, transforms are embarrassingly
parallel, and only correlator statistics/sorts induce collectives (inserted
automatically by XLA from the sharding annotations).

Because quantile generation is counter-based (threefry / index-addressable
QMC), results are independent of the mesh shape: the same seed produces the
same samples on 1 chip or N chips.

Usage::

    mesh = make_mesh()                  # all local devices, axis "samples"
    with use_mesh(mesh):
        node.sample(1_000_000, random_state=0)
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = [
    "make_mesh",
    "use_mesh",
    "set_mesh",
    "current_mesh",
    "sample_sharding",
    "shard_samples",
]

SAMPLE_AXIS = "samples"

_ACTIVE_MESH = None


def make_mesh(devices=None, axis_name=SAMPLE_AXIS):
    """1-D mesh over ``devices`` (default: all) with a sample axis."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def set_mesh(mesh):
    """Set (or clear, with None) the process-wide sampling mesh."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    return mesh


def current_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """Context manager scoping the sampling mesh."""
    previous = current_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(previous)


def sample_sharding(ndim=2, mesh=None):
    """NamedSharding partitioning axis 0 (samples) over the mesh."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or ndim < 1:
        # 0-d values have no sample axis to partition; None means "leave
        # placement alone", the correct no-op for scalars.
        return None
    axis = mesh.axis_names[0]
    spec = PartitionSpec(axis, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def shard_samples(array, mesh=None):
    """Place ``array`` with its leading (sample) axis sharded over the mesh."""
    sharding = sample_sharding(np.ndim(array), mesh)
    if sharding is None:
        return array
    return jax.device_put(array, sharding)
