"""Distribution layer: meshes, halo exchange, sharded solvers (port of the
JAX package's ``parallel``).

The replacement for the reference's MPI stack: the communicator topology
becomes a ``Mesh`` with axes ``('block', 'intra')`` (or ``('block', 'ir',
'ic')``), the ``MPI_Sendrecv`` halos ``Mesh.ppermute``, the norm
reductions ``Mesh.psum`` over mesh axes, and the two-level communicator
hierarchy reductions over ``'intra'`` versus ``('block', 'intra')``.  A
mesh runs all its shards in one process (``'local'``) or across
``torch.distributed`` processes (``'dist'``).
"""

from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_multihost,
    make_mesh,
    make_multihost_mesh,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedPoisson2D,
    ShardedPoisson3D,
    sharded_ca_gmres_solve,
    sharded_gmres_solve,
    sharded_multisplit_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.mgpcg import (  # noqa: F401
    sharded_df_northstar,
    sharded_df_northstar_fused,
    sharded_df_refine,
    sharded_mgpcg_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.tiled import (  # noqa: F401
    make_tiled_mesh,
    tiled_gmres_solve,
    tiled_gmres_solve_3d,
    tiled_multisplit_solve,
    tiled_multisplit_solve_3d,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.general import (  # noqa: F401
    ShardedAIJ,
    ShardedBlockJacobi,
    ShardedGeneralBSR,
    shard_aij_from_coo,
    shard_aij_from_scipy,
    shard_bjacobi_from_coo,
    shard_general_from_coo,
    sharded_aij_solve,
    sharded_general_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.probe import (  # noqa: F401
    measure_collective_latency,
    measure_dispatch_latency,
)
