"""Tools around the solvers (port of the JAX package's ``utils``): run
configuration, the ``isolve`` command line, profiling, checkpoints,
reports, bulk runs, scaling harnesses, calibration, multi-process launch.
"""

from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.config import (  # noqa: F401
    RunConfig,
    default_config,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import (  # noqa: F401
    PhaseTimer,
)
