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

Slice 3, the one-call API over general sparse matrices (``api``:
``solve``, ``prepare``/``PreparedSolver``, ``lstsq``): a ``scipy.sparse``
matrix is routed to ``DIA``, ``BSR``, ``DenseOp`` or ``AIJ``
(``core.operators``, constants from ``core.calibration``) and solved by
``cg``, ``minres``, ``bicgstab``, ``gmres`` or ``ca_gmres`` with a
Jacobi, block-Jacobi (``solvers.bjacobi``) or smoothed-aggregation
(``solvers.amg``) preconditioner.

On the card every stencil apply, GMRES's Gram-Schmidt pair, and the CSR
and block-ELL sparse products run hand-written CUDA kernels (``csrc/``,
``ops/``); on the CPU the kernels' plain PyTorch versions run.  Entry
points that take a ``device`` build on the current CUDA device when it
is None and raise without one; ``device="cpu"`` asks for the host.  The
JAX package stays the reference.
"""

from medane_tchakorom_ufc_thesis_repository_tpu_torch.api import (
    PreparedSolver,
    lstsq,
    prepare,
    solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import (
    default_device,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    AIJ,
    BSR,
    DIA,
    ELL,
    DenseOp,
    Stencil2D,
    Stencil3D,
    as_routed_operator,
    from_scipy,
    operator_from_coo,
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
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import (
    bicgstab,
    cg,
    gmres,
    minres,
)
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
           "multisplit_solve", "sm", "am", "smsm", "amam",
           "solve", "prepare", "lstsq", "PreparedSolver", "DenseOp", "ELL",
           "DIA", "BSR", "AIJ", "operator_from_coo", "from_scipy",
           "as_routed_operator", "minres", "bicgstab", "default_device"]
