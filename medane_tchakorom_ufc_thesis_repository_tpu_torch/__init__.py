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

Slice 4, the stencil family's remaining paths: ``cg``'s
``matvec_axpy_dot`` hook behind ``Stencil3D.axpy_mv_dot`` (PCG's direction
update fused into the matvec), ``residual_norm_sq`` (``ops.fused``: the
apply with a fused residual norm, 2D and 3D), multigrid and the
north-star on a ``Stencil2D`` and with ``transfers='linear'``, the
refinement loops ``iterative_refinement`` / ``device_iterative_refinement``
/ ``df_iterative_refinement``, and the multisplitting inner methods
``cg``, ``bicgstab``, ``ca_gmres`` and ``pc='mg'``.

Slice 8, general sparse matrices in the multisplitting drivers: an
assembled matrix is block-split (``core.poisson.block_split_ell``) into a
``StackedELLOperator`` and routed by ``as_stacked_routed_operator`` to
``StackedDIAOperator`` (banded), ``StackedBSROperator`` (blockable, kernel
I) or left on the stacked ELL (kernel H on its CSR); the inner solves take
``pc='bjacobi'`` and each block's own Jacobi diagonal.  The strip
operators ``StencilStrip2D``/``StencilStrip3D`` (``strip2d``/``strip3d``)
come with it.

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
    StencilStrip2D,
    StencilStrip3D,
    as_routed_operator,
    from_scipy,
    operator_from_coo,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.poisson import (
    block_split_ell,
    poisson2d,
    poisson3d,
    strip2d,
    strip3d,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.blockops import (
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
    final_residual_norm,
    from_stacked_ell,
    rhs_ones,
    stacked_bsr_from_ell,
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
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.fused import (
    residual_norm_sq,
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
    device_iterative_refinement,
    df_iterative_refinement,
    df_northstar_fused,
    iterative_refinement,
)

__all__ = ["poisson2d", "poisson3d", "Stencil2D", "Stencil3D", "cg", "gmres",
           "chebyshev", "mg_preconditioner", "df_northstar_fused",
           "StackedStencil2D", "StackedStencil3D", "block_poisson2d",
           "block_poisson3d", "rhs_ones", "final_residual_norm",
           "InnerConfig", "OuterConfig", "MultisplitResult",
           "multisplit_solve", "sm", "am", "smsm", "amam",
           "solve", "prepare", "lstsq", "PreparedSolver", "DenseOp", "ELL",
           "DIA", "BSR", "AIJ", "operator_from_coo", "from_scipy",
           "as_routed_operator", "minres", "bicgstab", "default_device",
           "residual_norm_sq", "iterative_refinement",
           "device_iterative_refinement", "df_iterative_refinement",
           "BlockOperator", "StackedELLOperator", "StackedDIAOperator",
           "StackedBSROperator", "as_stacked_routed_operator",
           "from_stacked_ell", "stacked_bsr_from_ell", "block_poisson2d_ell",
           "block_split_ell", "StencilStrip2D", "StencilStrip3D", "strip2d",
           "strip3d"]
