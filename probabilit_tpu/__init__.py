"""probabilit-tpu: an accelerator-native Monte Carlo modeling framework.

A ground-up JAX/XLA re-design with the capabilities of the reference
``probabilit`` library (graph-based Monte Carlo modeling): lazy
computational graphs of distributions, constants and transforms; inverse-CDF
sampling kernels per distribution family; quasi-Monte Carlo sequences;
rank-based correlation induction; all compiled into single XLA programs
with the sample axis shardable over a device mesh.

Public API mirrors the reference ``probabilit/__init__.py``.
"""

from probabilit_tpu.models.graph import Constant, Equal, scalar_transform
from probabilit_tpu.models.distributions import (
    CumulativeDistribution,
    DiscreteDistribution,
    Distribution,
    EmpiricalDistribution,
    MultivariateDistribution,
    QuantileTransform,
)
from probabilit_tpu.models.factories import (
    PERT,
    ClaytonCopula,
    EmpiricalCopula,
    FrankCopula,
    GaussianCopula,
    GumbelCopula,
    TCopula,
)
from probabilit_tpu.inspection import plot
from probabilit_tpu.engine.sensitivity import sensitivity, sobol_indices
from probabilit_tpu.engine.sweep import sweep
from probabilit_tpu.engine.american import american_greeks, american_price
from probabilit_tpu.engine.mlmc import mlmc_estimate
from probabilit_tpu.engine.streaming import estimate, estimate_many, sample_streaming
from probabilit_tpu.engine.importance import suggest_tilt, tilted
from probabilit_tpu.models.processes import (
    BrownianMotion,
    CorrelatedGBM,
    CorrelatedMerton,
    GeometricBrownianMotion,
    MertonJumpDiffusion,
    OrnsteinUhlenbeck,
    PoissonProcess,
)
from probabilit_tpu.models.levy import NormalInverseGaussian, VarianceGamma
from probabilit_tpu.models.markov import MarkovChain, RegimeSwitchingGBM
from probabilit_tpu.models.sde import SDE
from probabilit_tpu.models.stochvol import CorrelatedHeston, CoxIngersollRoss, Heston

__version__ = "0.1.0"

__all__ = [
    "Distribution",
    "Constant",
    "EmpiricalDistribution",
    "CumulativeDistribution",
    "DiscreteDistribution",
    "Equal",
    "scalar_transform",
    "MultivariateDistribution",
    "PERT",
    "plot",
    "sensitivity",
    "sobol_indices",
    "sweep",
    "estimate",
    "estimate_many",
    "sample_streaming",
    "mlmc_estimate",
    "american_greeks",
    "american_price",
    "tilted",
    "suggest_tilt",
    "QuantileTransform",
    "ClaytonCopula",
    "GumbelCopula",
    "FrankCopula",
    "GaussianCopula",
    "TCopula",
    "EmpiricalCopula",
    "BrownianMotion",
    "GeometricBrownianMotion",
    "OrnsteinUhlenbeck",
    "PoissonProcess",
    "MertonJumpDiffusion",
    "CorrelatedGBM",
    "CorrelatedMerton",
    "VarianceGamma",
    "NormalInverseGaussian",
    "CoxIngersollRoss",
    "Heston",
    "CorrelatedHeston",
    "SDE",
    "MarkovChain",
    "RegimeSwitchingGBM",
]
