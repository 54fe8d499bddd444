"""Reference-parity module: ``probabilit_tpu.modeling``.

Users of the reference import everything from ``probabilit.modeling``
(nodes, transforms, distributions — ``modeling.py:1-1264``); this module
re-exports the same surface from the compiled implementation so models
port with an import rename only.
"""

from probabilit_tpu.models.graph import *  # noqa: F401,F403
from probabilit_tpu.models.graph import __all__ as _graph_all
from probabilit_tpu.models.distributions import (  # noqa: F401
    AbstractDistribution,
    CopulaDistribution,
    EllipticalCopulaDistribution,
    EmpiricalCopulaDistribution,
    CumulativeDistribution,
    Distribution,
    DiscreteDistribution,
    EmpiricalDistribution,
    MarginalDistribution,
    MultivariateDistribution,
    QuantileTransform,
)

# The reference's modeling.py imports these into its own namespace
# (modeling.py:261-263), so user code legitimately does
# ``from probabilit.modeling import ImanConover`` etc.; mirror that.
from probabilit_tpu.garbage_collector import GarbageCollector  # noqa: F401
from probabilit_tpu.models.processes import (  # noqa: F401
    BrownianMotion,
    CorrelatedGBM,
    GeometricBrownianMotion,
    MertonJumpDiffusion,
    OrnsteinUhlenbeck,
    PathDistribution,
    PathFunctional,
    PoissonProcess,
)
from probabilit_tpu.ops.correlation import Cholesky, ImanConover  # noqa: F401
from probabilit_tpu.ops.ncm import nearest_correlation_matrix  # noqa: F401
from probabilit_tpu.utils.helpers import build_corrmat, zip_args  # noqa: F401

__all__ = list(_graph_all) + [
    "AbstractDistribution",
    "Distribution",
    "EmpiricalDistribution",
    "CumulativeDistribution",
    "DiscreteDistribution",
    "MarginalDistribution",
    "MultivariateDistribution",
    "CopulaDistribution",
    "EllipticalCopulaDistribution",
    "EmpiricalCopulaDistribution",
    "QuantileTransform",
    "BrownianMotion",
    "GeometricBrownianMotion",
    "OrnsteinUhlenbeck",
    "PoissonProcess",
    "MertonJumpDiffusion",
    "CorrelatedGBM",
    "PathDistribution",
    "PathFunctional",
    "GarbageCollector",
    "Cholesky",
    "ImanConover",
    "nearest_correlation_matrix",
    "build_corrmat",
    "zip_args",
]
