"""PyTorch and CUDA port of the JAX package
``medane_tchakorom_ufc_thesis_repository_tpu``, for NVIDIA Hopper.

Slice 1, the 3D Poisson north-star: the matrix-free 7-point operator
(``core.operators.Stencil3D``) is solved to ``||b - Ax|| <= rtol ||b||`` by
``solvers.refine.df_northstar_fused``: W-cycle-preconditioned CG
(``solvers.krylov.cg``, ``solvers.multigrid.mg_preconditioner``) inside
double-float refinement (``solvers.df64``).

Slice 2, the thesis's two-stage multisplitting
(``models.multisplitting``: ``sm``, ``am``, ``smsm``, ``amam`` and the
driver ``multisplit_solve``) on the stacked 2D and 3D Poisson strips
(``models.blockops``), with batched GMRES (``solvers.krylov.gmres``) or
Chebyshev inner solves and tall-skinny least-squares minimization.

On the card every stencil apply and GMRES's Gram-Schmidt pair run
hand-written CUDA kernels (``csrc/``, ``ops/``); on the CPU the kernels'
plain PyTorch versions run.  The JAX package stays the reference.
"""

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    Stencil2D,
    Stencil3D,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.poisson import (
    poisson2d,
    poisson3d,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.blockops import (
    StackedStencil2D,
    StackedStencil3D,
    block_poisson2d,
    block_poisson3d,
    final_residual_norm,
    rhs_ones,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
    InnerConfig,
    MultisplitResult,
    OuterConfig,
    am,
    amam,
    multisplit_solve,
    sm,
    smsm,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
    chebyshev,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import cg, gmres
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.multigrid import (
    mg_preconditioner,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.refine import (
    df_northstar_fused,
)

__all__ = ["poisson2d", "poisson3d", "Stencil2D", "Stencil3D", "cg", "gmres",
           "chebyshev", "mg_preconditioner", "df_northstar_fused",
           "StackedStencil2D", "StackedStencil3D", "block_poisson2d",
           "block_poisson3d", "rhs_ones", "final_residual_norm",
           "InnerConfig", "OuterConfig", "MultisplitResult",
           "multisplit_solve", "sm", "am", "smsm", "amam"]
