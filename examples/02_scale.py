"""Scaling up: billions of draws, streaming, correlated models, meshes.

Run: python examples/02_scale.py          (the 1e9-draw steps want a GPU)
"""

import time

import numpy as np

from probabilit_tpu.engine import streaming
from probabilit_tpu.models import benchmarks
from probabilit_tpu.parallel import make_mesh, use_mesh


def main():
    model = benchmarks.mixed_dag_20()  # 20-node risk model

    # 1. Streaming estimation: 1e9 draws, O(block) device memory, one
    #    on-device reduction.
    t0 = time.perf_counter()
    stats = streaming.estimate(model, 10**9, block_size=1 << 26, random_state=0)
    print(
        f"1e9 draws in {time.perf_counter() - t0:.1f}s: "
        f"mean={stats['mean']:.1f} std={stats['std']:.1f} "
        f"p-range=[{stats['min']:.0f}, {stats['max']:.0f}]"
    )

    # 2. Materialised mega-runs stream block-wise to host.
    out = streaming.sample_streaming(model, 10**8, block_size=1 << 24, random_state=0)
    print(f"materialised 1e8 samples on host: {out.nbytes / 1e9:.1f} GB")

    # 3. Correlated models at scale: the sort-free Gaussian-copula
    #    Iman-Conover runs inside the one compiled program and streams to
    #    any size — the NumPy/SciPy approach needs every sample in memory
    #    for its rank transform.
    corr_model = benchmarks.mixed_correlated_50()
    t0 = time.perf_counter()
    s = corr_model.sample(10**8, random_state=1, gc_strategy=[])
    print(
        f"{np.asarray(s).shape[0]:,} draws of a 10-variable correlated model "
        f"in {time.perf_counter() - t0:.2f}s"
    )
    stats = streaming.estimate(corr_model, 10**9, block_size=1 << 26, random_state=2)
    print(f"1e9 correlated draws estimated: mean={stats['mean']:.1f}")

    # 4. Multiple devices: shard the sample axis over every available
    #    device.  Counter-based RNG gives every shard the same draws it
    #    would get on one device.
    with use_mesh(make_mesh()):
        sharded = np.asarray(model.sample(1 << 20, random_state=0, gc_strategy=[]))
    single = np.asarray(model.sample(1 << 20, random_state=0, gc_strategy=[]))
    print("max relative mesh difference:", float(np.max(np.abs(sharded / single - 1))))


if __name__ == "__main__":
    main()
