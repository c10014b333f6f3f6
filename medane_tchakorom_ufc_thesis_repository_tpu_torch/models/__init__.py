"""Algorithm drivers (port of the JAX package's ``models``): the stacked
block operators and the two-stage multisplitting solvers."""

from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.blockops import (  # noqa: F401
    BlockOperator,
    StackedBSROperator,
    StackedDIAOperator,
    StackedELLOperator,
    StackedStencil2D,
    StackedStencil3D,
    as_stacked_routed_operator,
    block_poisson2d,
    block_poisson2d_ell,
    block_poisson3d,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (  # noqa: F401
    MultisplitResult,
    am,
    amam,
    multisplit_solve,
    sm,
    smsm,
)
