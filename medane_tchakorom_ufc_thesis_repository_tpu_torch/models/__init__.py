"""Algorithm drivers (port of the JAX package's ``models``): the stacked
block operators, the two-stage multisplitting solvers, their host-stepped
twin with stage timers, and the genuinely asynchronous execution (one
thread per block, or one process per block over TCP)."""

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
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.host_async import (  # noqa: F401
    host_async_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.net_async import (  # noqa: F401
    launch_net_async,
    net_async_block_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.staged import (  # noqa: F401
    staged_multisplit_solve,
)
