"""Sampling engine: graph analysis, compilation, orchestration.

Submodules: ``compile`` (graph -> XLA program), ``sampler`` (public
sample() orchestration), ``streaming`` (mega-batch blocks + O(1)-memory
estimation), ``checkpoint`` (sampled-state save/load).
"""

from probabilit_tpu.engine import checkpoint, streaming  # noqa: F401
from probabilit_tpu.engine.streaming import estimate, sample_streaming  # noqa: F401
