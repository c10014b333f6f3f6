"""PyTorch and CUDA port of the JAX package
``medane_tchakorom_ufc_thesis_repository_tpu``, for NVIDIA Hopper.

First slice: the 3D Poisson north-star.  The matrix-free 7-point operator
(``core.operators.Stencil3D``) is solved to ``||b - Ax|| <= rtol ||b||`` by
``solvers.refine.df_northstar_fused``: W-cycle-preconditioned CG
(``solvers.krylov.cg``, ``solvers.multigrid.mg_preconditioner``) inside
double-float refinement (``solvers.df64``).  On the card every stencil
pass is a hand-written CUDA kernel (``csrc/``, ``ops/stencil3d.py``); on
the CPU the kernels' plain PyTorch versions run.  The JAX package stays
the reference.
"""

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import Stencil3D
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.poisson import poisson3d
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import cg
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.multigrid import (
    mg_preconditioner,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.refine import (
    df_northstar_fused,
)

__all__ = ["poisson3d", "Stencil3D", "cg", "mg_preconditioner",
           "df_northstar_fused"]
