#!/usr/bin/env python3
"""Drive the PyTorch port's slices on one NVIDIA GPU: the 3D Poisson
north-star (as one program of CUDA graphs), the thesis's two-stage
multisplitting solvers, the one-call solve API over general sparse
matrices, and the stencil family's fused PCG direction, fused residual
norms, coarse solve in one launch, 2D multigrid north-star and
multigrid-preconditioned inner solves, and the thesis's genuinely
asynchronous execution (one thread, or one process over TCP, a block).

Run from the root of a checkout:

    python3 chip_smoke.py

(With phase names as arguments, of ``PHASES`` below, only those phases
run, for work on one of them; such a run prints no result lines.
``python3 chip_smoke.py kernels`` alone builds every kernel and holds
kernels A-D, among them the warp walks of B and of A's ``jacobi_dot``
and A's ``mv_dot`` on the stack walk, against their plain versions.)

It imports the port (``medane_tchakorom_ufc_thesis_repository_tpu_torch``)
from this checkout and nothing of JAX, and:

1. finds a CUDA device, or exits non-zero;
2. prints the card's name and power limit (``nvidia-smi``);
3. builds the CUDA kernels from ``csrc/`` (one ``nvcc`` per source, all
   started together) and prints the build time;
4. kernel phase: holds every kernel and kind against its plain PyTorch
   version on the card, for every dtype combination of the paths:
   kernels A-D at 512^3, at an odd shape and at 4^3, kernel C also at
   2^3, 8^3 (the cycle's last prolongation), 514x258x130 (every dim 2 past
   a multiple of its tile) and on grids at an odd offset (its scalar
   path), kernel B at the same shapes and at the W-cycle's 256^3, 64^3
   and 16^3, bit for bit; A's ``jacobi_dot`` also at 256^3, its y bit
   for bit the kind ``jacobi``'s and two launches bit-equal; A's
   ``mv_dot`` also at 256^3 and on a 9x10x64 grid one value past 16
   bytes, in every dtype pair and f64, its y bit for bit the kind
   ``mv``'s, its dot bit for bit kernel J's with beta 0 and p 0 (x and y
   of one type) or the same x's into x's own type (the pairs that mix),
   two launches bit-equal, and its device time at 512^3 and 256^3 beside
   ``mv``'s and that of ``mv`` + an f32 ``torch.dot``; kernel E
   (the 2D apply) at 8192^2, the two 2048x4096 strips of 4096^2, an s=4 panel
   of 4096^2, 3x37x130 and 4x4 in f32 and f64; kernels F and G (VecMDot
   and VecMAXPY) on the GMRES(20) basis of 4096^2 strips, (2, 21, 2^23),
   with a f32, bf16 and f64 basis at several live-row counts, and at an
   odd length; kernel N (the minimization's one-pass TSQR least squares)
   on nearly collinear panels, the SMSM cell's (2^24 x 4) and ragged and
   wide ones, in f32 and f64, against the float64 least-squares residual
   and its plain version, two launches bit-equal, timed beside the library
   composition it replaces (``torch.linalg.qr`` + Q^T t +
   ``solve_triangular``); kernel H (the CSR product) on a structureless square
   pattern, n = 2^22 with 10 draws a row, and on a rectangular
   200,003 x 150,001 pattern with empty rows and one row of 50,000
   entries, forward and transpose, and on one row of 20,000 entries
   among 100,000 empty ones, a 2-row matrix whose rows span chunks and
   64 rows of exactly one chunk; kernel I (the block-ELL product) at
   (nb 256, bs 128, width 8), (nb 4096, bs 64, width 8), bs 8 and 16, and
   a shape not divisible by bs; H and I in f32 and f64, for 1 and 4
   vectors (H also 5), two launches giving equal bits.  Times kernel, plain and,
   where one PyTorch call computes the same function, that call, at the
   paths' shapes (CUDA events, median of 20), beside the least time the
   card could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s).
   Kernel A also in f64 at the small shapes, kernel E also in bf16.
   Kernel A's kinds without a dot (mv, residual, jacobi, mv_cast) also on
   a stack of three 37x24x130 grids, on a stack of three 9x10x64 grids
   one value past 16 bytes and on the sharded paths' stacks of 8 tiles of
   64^3 and 256^3, in every dtype pair and f64: one launch against the
   plain version and bit for bit against a launch a grid; at 512^3
   each timed kind is also replayed in a CUDA graph, its device time beside
   its bound.
   Kernel J (PCG's fused direction update) at 512^3, the odd shape and
   4^3 in f32, bf16 and f64, with beta 0, negative, and read from a
   device tensor: p' must have the bits of ``z + beta * p``, and in f32
   the whole triple the bits of that axpy followed by kernel A's
   ``mv_dot``.  Kernels K and L (the applies with a fused residual norm)
   at 512^3 and 8192^2 and the odd shapes in f32 and f64: y must have the
   bits of the operator's ``mv``, the norm agree to 1e-5, and two
   launches give equal bits.  No one PyTorch call computes B, A's
   ``mv_dot`` or ``jacobi_dot``, J, K or L; beside each the composition
   the port would run without it is timed;
4a. coarse phase: kernel M (the multigrid cycle's coarse Chebyshev solve
   in one launch) against its plain version and against the loop it
   replaces (``chebyshev(A.mv, b, maxiter=40).x``, kernel A or E as the
   matvec), bit for bit, two launches bit-equal, at 4^3, 4x4, 4x8x8, a
   stack of 2 x 4x8, the cap of 4096 points (16^3, 64x64) and odd grids,
   in f32, bf16 and f64; timed at 4^3 bf16 and 4x4 f32 one launch at a
   time and in a CUDA graph, beside the loop with its norms;
5. north-star phase: ``df_northstar_fused(op, b_df, rtol=1e-8,
   inner_rtol=1e-4)`` at 256^3 and 512^3 with b = A·1, through the
   cached program and its two CUDA graphs.  The first run at each size is
   counted (it captures the graphs; the capture time is printed apart):
   kernels A-D and M must have been launched, M once a coarse visit and
   kernel A ``mv`` only at the cycle's first sweeps (no coarse loop), and
   three warm runs must count three times as many launches, graph replays
   included.  It must converge in at most 3 passes with PCG 5 and 6
   iterations (as every earlier run), 17 host syncs at 512^3, to a
   relative residual <= 1e-8 recomputed in f64 on the card, with
   max|x - 1| <= 1e-6.  The solve time is the median of 3 more runs; the
   device-busy share comes from the profiler and from the graphs'
   replays timed alone; the same solve through ``df_iterative_refinement``
   around ``cg`` (no graph) runs in turns with the graphed one, with equal
   PCG counts and x equal to the bit; a digest of x's bytes (sha256)
   is printed, to compare two trees' solutions.  At 512^3 one more eager run,
   neither counted nor timed, records the launches of kernels A-D and M
   by grid, each grid's launch then timed alone in a CUDA graph;
5a. fused-direction phase, 512^3: ``df_iterative_refinement`` around
   ``cg(..., precond_dot=W-cycle, matvec_dot=op.mv_dot,
   matvec_axpy_dot=op.axpy_mv_dot)`` and the same without the hook.
   Both must meet the north-star's bounds with PCG iteration counts 5
   and 6; the hooked run must launch kernel J once per PCG iteration
   and ``mv_dot`` never.  Then ``residual_norm_sq`` (kernel K) on the
   solution moved off by noise, against the f64 residual.  Solve times
   are medians of 3;
5b. 2D north-star phase: ``df_northstar_fused(poisson2d(n, n))`` with its
   defaults (W-cycle) through the graphed program at 2048^2 (PCG 4 and 5,
   beside the eager solve, x equal to the bit) and 8192^2 (12 levels,
   1024 coarse visits a cycle), kernel M (2D) once a coarse visit; at
   8192^2 also the same refinement through ``df_iterative_refinement``
   around PCG with one f32 V-cycle; each to the north-star's bounds,
   counted once and timed 3 times; ``residual_norm_sq`` (kernel L)
   beside the f64 residual; ``device_iterative_refinement`` (f64
   residual on the card) around the same PCG; the 2D double-float
   residual on the card against the same function on the CPU, bit for
   bit;
5c. cycle-precision phase: one multigrid cycle in f32 and in bf16 at
   128^3, 256^3, 2048^2 and 8192^2, the reading behind
   ``multigrid._BF16_CYCLE_BYTES``, and the 2D PCG iteration counts by
   cycle type and cycle precision;
6. golden phase: SM, AM (staleness 2), SMSM_LOCAL, SMSM_SEMI_LOCAL and
   SMSM_GLOBAL on the 2D 32^2 strips in f64, through the kernels: the
   sweep counts must be exactly 42, 88, 36, 12 and 12;
7. thesis phase, in f32: SMSM_GLOBAL 2D 4096^2 (2 blocks, s=4, rtol
   1e-3), AM 1024^2 (staleness 2, rtol 1e-3) and SMSM_GLOBAL 3D 64^3
   with Chebyshev(20) inner solves (rtol 1e-5), b = A·1.  The first run
   of each is counted: every kernel of its path must have been launched.
   Each must converge (AM certified), to ||b - A x|| / ||r0|| under its
   rtol recomputed in f64 on the card.  Prints sweeps, cycles, inner
   iterations, host syncs, launches, the solve time (median of 3 more
   runs, one for AM) and peak memory;
7a. inner-solve phase, in f32, each run once and counted: SM on the 3D
   64^3 strips with GMRES inner solves left-preconditioned by a W-cycle
   (``InnerConfig(pc='mg')``), beside the unpreconditioned SM, and
   SMSM_GLOBAL 2D 1024^2 with inner ``cg`` + ``pc='mg'``, both running
   kernel M at the strips' coarsest grids; all must converge to their
   rtol recomputed in f64, SM with ``pc='mg'`` in 51 sweeps;
8. calibration phase, through ``utils/calibrate.measure_calibration``:
   the per-stored-value times of kernel I by block size, of kernel H and
   of ``ELL.mv`` relative to ``DIA.mv``, and the largest n at which
   ``DenseOp.mv`` is no slower than kernel H: the constants of
   ``core/calibration.py``, each the median of 3 medians with their
   spread, printed as one JSON line beside the shipped table and saved
   under ``build/`` (the solves that follow route by the shipped table);
9. API phase, in f32, on scipy matrices made from a seed: GMRES with
   Jacobi on a structureless symmetric diagonally dominant matrix of
   n = 2^22 (AIJ; one right-hand side, then a panel of 4), GMRES with
   block-Jacobi on a block-sparse SPD matrix of 4096 blocks of 64 (BSR),
   CG with Jacobi on the 1024^2 2D Poisson matrix (DIA), and LSQR on the
   rectangular pattern (AIJ, forward and transpose).  The block-sparse
   matrix is packed once by ``native.bsr_pack`` (which ``prepare`` packs
   with) and once by the plain ``_bsr_pack_plain``, each timed: the two
   must agree in every bit.  The first solve of
   each is counted: every kernel on its route must have been launched,
   it must converge on the stated operator, in the iterations every
   earlier run took (AIJ 7, and 7 each with 4 right-hand sides; LSQR 8),
   and the residual measured on the host in f64 against the input matrix
   must lie under the bound.  Prints iterations, launches, set-up and
   solve times (one more solve, timed), peak memory, the device-busy
   share of one AIJ solve, and beside kernel H on the solve's matrix the
   time of its gathers alone (``torch.index_select``);
10. stacked phase, in f32: general sparse matrices in the multisplitting
   drivers, block-split into 2 (``block_split_ell``) and routed by
   ``as_stacked_routed_operator``.  The 2D Poisson matrix of 1024^2 must
   route to ``StackedDIAOperator`` and SMSM_GLOBAL (s=4, inner GMRES(30),
   rtol 1e-3) runs on it beside the stencil strips, then with inner
   ``pc='bjacobi'`` (blocks of 64); in f64 the two routes' sweeps must lie
   within 2 of each other.  The API phase's block-sparse matrix (4096
   blocks of 64) must route to ``StackedBSROperator`` (kernel I on the
   block-diagonal pack and on the coupling, held against its plain version
   and timed beside the torch sparse BSR product) and SM with inner
   GMRES + ``pc='bjacobi'`` runs on it.  A structureless symmetric matrix
   of n = 2^20 must stay on ``StackedELLOperator`` with a warning (kernel H
   on its two CSRs, held and timed the same way) and SM with inner GMRES +
   ``pc='jacobi'`` (each block's own diagonal) runs on it.  Each solve is
   counted once (kernels H, I, F, G as its route needs), must converge to
   its rtol recomputed in f64 on the host against the matrix, and is timed
   once more (the f32 DIA cell and its stencil twin: median of 3).  Then
   ``StencilStrip2D(2048, 4096).mv_full`` against the strip rows of the
   4096^2 stack's ``full_mv``, and
   ``StencilStrip3D(256, 512, 512).mv`` against kernel A's plain version;
11. async phase, in f32 on 2D 1024^2 in 2 blocks at rtol 1e-3 with the
   default inner GMRES(30), maxiter 20: ``host_async_solve`` AM and
   AMAM_GLOBAL (s=4), one thread and one CUDA stream a block, each
   converged and certified with the f64 residual under 1e-3, run and
   timed once, that run counted (kernels E [mv], F, G and, for
   AMAM_GLOBAL, E [spmm] must launch from the block threads),
   with the busy share of a 10-sweep window under the profiler;
   ``staged_multisplit_solve`` SMSM_GLOBAL bit-equal to ``smsm`` with its
   four stage shares; and ``launch_net_async`` with 2 processes on the
   card (AM under Alg-5.15 on the native and the Python router, then the
   sync schedule), every rank certified and the merged residual under
   1e-3.

12. sharded phase (``sharded_phase``): the distribution layer on a
   ``(2, 4)`` ``'local'`` mesh on the card: every kernel of the sharded
   paths (E [mv]/[spmm], A mv/jacobi, B, C, M, F, G, H, I) held against
   its plain version at the shard-stack shapes and timed (kernel A on the
   stacks of 8 tiles of 64^3 and 256^3 in one launch, bit for bit the
   loop of a launch a tile, and timed in turns beside that loop,
   ``conv3d`` over the stack and the bound, with events and as device
   time in a CUDA graph); SMSM_GLOBAL 2D
   4096^2 f32 and 1024^2 f64 (sweeps equal to the stacked solve's) beside
   the stacked ``smsm``, AM 1024^2, sharded GMRES (f32) and CA-GMRES
   (s=16, f64) on 3D 64^3, the sharded north-star at 256^3 beside the single-device one (f64
   rel <= 1e-8 in <= 3 passes), the tiled 4096^2 on ``(2, 2, 2)``, the
   row-sharded AIJ (kernel H) and block-ELL (kernel I) solves, the
   collective latency, 2 ``'dist'`` gloo ranks on the card (SM 1024^2 f64,
   sweeps equal to the local mesh's) and ``dryrun_multichip(8)``.  Each run
   counted once: the kernels its path needs must launch.  The shard-stack
   kernels are timed beside one PyTorch call each where there is one
   (``conv2d``/``conv3d``, ``bmm``, ``baddbmm``, the sparse CSR and BSR
   products).

13. cli phase (``cli_phase``): the port's command line
   (``utils/cli.main(argv + ["--json"])``) on the card at the widths the
   reference and the JAX CLI document: AM 1024^2 (staleness 2, the
   reference's default experiment), SMSM_GLOBAL 4096^2, MGPCG 3D 256^3 to
   1e-8 in f32 (double-float refinement), SM 3D 64^3 to 1e-5, GMRES with
   ``--pc-type jacobi`` on a structureless n = 2^20 ``--matrix`` (the
   stacked ELL route, kernel H) and the same on ``--backend sharded``
   (kernel I), SM sharded on ``(2, 4)`` 1024^2 in f64 and SMSM_GLOBAL
   1024^2 with ``--flame``.  Each run is counted once (its kernels must
   launch), its counts must equal the same configuration called directly
   (for AM, the thesis phase's run of it where that phase ran), its
   ``rel_rnorm`` and the direct call's f64 residual must lie under the
   rtol; then one ``bulk.run_one`` subprocess on ``cuda:0``.

Any failure raises.  The line before the last is a JSON object of the
kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "medane_tchakorom_ufc_thesis_repository_tpu_torch"
REF = "medane_tchakorom_ufc_thesis_repository_tpu/ops/stencil_pallas.py"
FUSED = "medane_tchakorom_ufc_thesis_repository_tpu/ops/fused_pallas.py"
AIJ_REF = "medane_tchakorom_ufc_thesis_repository_tpu/ops/aij_pallas.py"
BSR_REF = "medane_tchakorom_ufc_thesis_repository_tpu/ops/bsr_pallas.py"
# kernel M replaces no Pallas kernel: the coarse loop XLA compiles inside
# _df_fused_program, chebyshev's lax.fori_loop
CHEB_REF = "medane_tchakorom_ufc_thesis_repository_tpu/solvers/chebyshev.py:81"
# nor does kernel N: the JAX lstsq_qr leaves the QR to XLA
LSTSQ_REF = "medane_tchakorom_ufc_thesis_repository_tpu/solvers/lstsq.py:46"

# kernel entries: (name, source, replaced TPU kernel, dtypes timed, the
# path whose counted runs give its launches)
ENTRIES = [
    ("stencil3d_apply[mv]", "stencil3d.cu", f"{REF}:441", ("f32", "f32"),
     "northstar"),
    ("stencil3d_apply[mv_dot]", "stencil3d.cu", f"{REF}:441", ("f32", "f32"),
     "northstar"),
    ("stencil3d_apply[residual]", "stencil3d.cu", f"{REF}:441",
     ("bf16", "bf16"), "northstar"),
    ("stencil3d_apply[jacobi]", "stencil3d.cu", f"{REF}:441", ("bf16", "bf16"),
     "northstar"),
    ("stencil3d_apply[jacobi_dot]", "stencil3d.cu", f"{REF}:441",
     ("bf16", "f32"), "northstar"),
    ("stencil3d_mv_cast", "stencil3d.cu", f"{REF}:607", ("f32", "bf16"),
     "northstar"),
    ("stencil3d_residual_restrict", "stencil3d.cu", f"{REF}:1140",
     ("bf16", "bf16"), "northstar"),
    ("stencil3d_prolong_jacobi", "stencil3d.cu", f"{REF}:1094",
     ("bf16", "bf16"), "northstar"),
    ("stencil3d_df_residual", "df_residual.cu", f"{REF}:867", ("f32", "f32"),
     "northstar"),
    ("stencil2d_apply[mv]", "stencil2d.cu", f"{REF}:269", ("f32", "f32"),
     "thesis"),
    ("stencil2d_apply[spmm]", "stencil2d.cu", f"{FUSED}:156", ("f32", "f32"),
     "thesis"),
    ("mdot", "mdot.cu", f"{FUSED}:408", ("f32", "f32"), "thesis"),
    ("maxpy", "mdot.cu", f"{FUSED}:439", ("f32", "f32"), "thesis"),
    ("tsqr", "tsqr.cu", LSTSQ_REF, ("f32", "f32"), "thesis"),
    ("csr_mv", "csr_mv.cu", f"{AIJ_REF}:307", ("f32", "f32"), "api"),
    ("bsr_mv", "bsr_mv.cu", f"{BSR_REF}:51", ("f32", "f32"), "api"),
    ("stencil3d_axpy_mv_dot", "stencil3d.cu", f"{REF}:721", ("f32", "f32"),
     "fused"),
    ("stencil3d_mv_norm", "stencil3d.cu", f"{FUSED}:355", ("f32", "f32"),
     "fused"),
    ("stencil2d_mv_norm", "stencil2d.cu", f"{FUSED}:255", ("f32", "f32"),
     "fused"),
    ("stencil3d_chebyshev", "stencil3d.cu", CHEB_REF, ("bf16", "bf16"),
     "northstar"),
    ("stencil2d_chebyshev", "stencil2d.cu", CHEB_REF, ("f32", "f32"),
     "northstar2d"),
]
# the phases, in the order they run
PHASES = ("kernels", "kernels2d", "fusedkernels", "coarse", "sparse",
          "northstar",
          "fused", "northstar2d", "cycle", "golden", "thesis", "inner",
          "calibration", "api", "stacked", "async", "sharded", "cli")
# the card's published peaks: memory rate, and f32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12
FULL = (512, 512, 512)
ODD = (37, 24, 130)
# kernel A's stacks of grids: of odd grids, and of grids whose nz is a
# multiple of every type's vector, for a stack one value past 16 bytes
ODD_STACK = (3, 37, 24, 130)
OFFSET_STACK = (3, 9, 10, 64)
# kernel A's dot walk on one grid one value past 16 bytes (its scalar path
# where nz is a multiple of every type's vector)
OFFSET_GRID = OFFSET_STACK[1:]
ODD_EVEN = (38, 24, 130)   # kernels B and C need even dims
TINY = (4, 4, 4)
# kernel C's further shapes: 2^3, the cycle's last prolongation (8^3 from
# 4^3), and every dim 2 past a multiple of its tile (16 y, 64 z, a slab of
# 16 x planes at this size)
C_SHAPES = ((2, 2, 2), (8, 8, 8), (514, 258, 130))
# kernel B's further shapes: C's, and the levels the 512^3 W-cycle passes
# it (512^3 and 8^3 are among the others)
B_SHAPES = C_SHAPES + ((256, 256, 256), (64, 64, 64), (16, 16, 16))
LEVEL0 = (256, 256, 256)    # the 256^3 north-star's finest grid
SLICE = (256, 512)          # north-star grid sizes
DIAG, OFF = 6.0, -1.0
# kernel E: (batch, m, n) shapes; the timed ones: the strips of 4096^2
# for [mv], the s=4 panel for [spmm]
E_SHAPES = [(1, 8192, 8192), (2, 2048, 4096), (4, 4096, 4096), (3, 37, 130),
            (1, 4, 4)]
E_TIMED = {"stencil2d_apply[mv]": (2, 2048, 4096),
           "stencil2d_apply[spmm]": (4, 4096, 4096)}
# kernel E's further shapes, held bit for bit and timed where the path
# runs them: the sharded stack of 4096^2 (8 shards of 512 rows), a last
# slab one row short of the walk's 32, 64 rows and one either side, n % 4
# of 1, 2 and 3, grids of one row on the 16-byte path, and stacks whose
# base lies one value past 16 bytes (a view at offset 1: odd n, and n a
# multiple of every type's vector)
E_MORE = [(8, 512, 4096), (2, 2047, 4096), (1, 65, 129), (1, 63, 130),
          (3, 37, 131), (3, 1, 128)]
E_OFFSET = [(3, 37, 130), (3, 9, 64)]
E_DEVICE = {(2, 2048, 4096), (8, 512, 4096), (4, 4096, 4096),
            (1, 8192, 8192)}
# the 2D W-cycle's levels: single grids 4^2 .. 8192^2, timed in f32
E_LEVELS = tuple(1 << k for k in range(2, 14))
# kernels F, G: the GMRES(20) basis of the 4096^2 strips, and an odd length
FG_SHAPES = [(2, 21, 8_388_608), (3, 7, 1_000_003)]
# kernel N: (batch, rows, s) panels; the first is the SMSM cell's
# minimization (2 strips of 2048 x 4096, s = 4), timed
N_SHAPES = [(1, 16_777_216, 4), (2, 1_000_003, 8), (1, 100_003, 30),
            (2, 65_537, 12), (1, 257, 30)]
GOLDEN = (("SM", 42), ("AM", 88), ("SMSM_LOCAL", 36),
          ("SMSM_SEMI_LOCAL", 12), ("SMSM_GLOBAL", 12))
OMEGA = (6.0 / 7.0) / DIAG
# kernel M: (batch, grid) of the coarsest grids of the paths (the 3D and
# 2D north-stars, the SM 3D 64^3 strips and the 2D strips under
# pc='mg'), a grid at the cap of 4096 points in 3D and 2D, and odd grids;
# the timed ones are the 512^3 and 2048^2 cycles'
COARSE_ITERS = 40
COARSE_SHAPES = [((), (4, 4, 4)), ((), (4, 4)), ((), (4, 8, 8)), ((2,), (4, 8)),
                 ((), (16, 16, 16)), ((), (64, 64)), ((), (3, 4, 5)),
                 ((3,), (5, 7))]
COARSE_TIMED = {((), (4, 4, 4), "bf16"), ((), (4, 4), "f32")}
# the grids of COARSE_SHAPES that kernel M's launcher puts on its warp
# path (at most 64 points, fewer than 32 a row or plane); the others take
# the block path
COARSE_WARP = {(4, 4, 4), (4, 4), (4, 8), (3, 4, 5), (5, 7)}


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import medane_tchakorom_ufc_thesis_repository_tpu_torch as port

    if Path(port.__file__).resolve().parent != ROOT / PKG:
        raise RuntimeError(f"{PKG} was imported from {port.__file__}, "
                           f"not from this checkout")
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    import logging
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout)
    t0 = time.perf_counter()
    build.load_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    only = sys.argv[1:]
    unknown = [p for p in only if p not in PHASES]
    if unknown:
        sys.exit(f"chip_smoke: unknown phases {unknown}; known: {PHASES}")
    if "api" in only:
        only.append("sparse")      # it takes its matrices
    todo = [p for p in PHASES if not only or p in only]

    t_all = time.perf_counter()
    report, launches, cases = {}, {}, {}
    for phase in todo:
        t0 = time.perf_counter()
        if phase == "kernels":
            report.update(kernel_phase(torch, k, dev))
        elif phase == "kernels2d":
            report.update(kernel_phase_2d(torch, dev))
        elif phase == "fusedkernels":
            report.update(kernel_phase_fused(torch, k, dev))
        elif phase == "coarse":
            report.update(kernel_phase_coarse(torch, dev))
        elif phase == "sparse":
            sparse_report, cases = kernel_phase_sparse(torch, dev)
            report.update(sparse_report)
        elif phase == "northstar":
            launches.update(slice_phase(torch, port, k, dev))
        elif phase == "fused":
            launches.update(fused_direction_phase(torch, port, k, dev))
        elif phase == "northstar2d":
            launches.update(northstar2d_phase(torch, port, dev))
        elif phase == "cycle":
            cycle_precision_phase(torch, port, dev, card)
        elif phase == "golden":
            golden_phase(torch, port, dev)
        elif phase == "thesis":
            launches.update(thesis_phase(torch, port, dev))
        elif phase == "inner":
            inner_phase(torch, port, dev)
        elif phase == "calibration":
            calibration_phase(torch, dev, card)
        elif phase == "api":
            launches.update(api_phase(torch, port, dev, cases, report))
        elif phase == "stacked":
            stacked_phase(torch, port, dev, card)
        elif phase == "async":
            async_phase(torch, port, dev, card)
        elif phase == "sharded":
            sharded_phase(torch, port, dev, card)
        elif phase == "cli":
            cli_phase(torch, port, dev, card)
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    if only:
        log(f"partial run of {todo}: no result lines")
        return
    kernels = []
    for name, src, replaces, _, _ in ENTRIES:
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if not launches[name] > 0 or None in (r["ms"], r["plain_ms"],
                                              r["bound_ms"]):
            raise AssertionError(f"kernel entry incomplete: {kernels[-1]}")
    log(f"whole run: {time.perf_counter() - t_all:.1f} s after the build")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def check(torch, what: str, out, ref, tol: str, dot_floor: float = 0.0) -> float:
    """Raise unless the kernel's ``out`` agrees with the plain ``ref``;
    return the largest absolute difference.

    f32: rtol 1e-6, with an absolute floor of 1e-6 * max|ref| because the
    tap order and FMA contraction differ and a residual can cancel to
    near zero.  f64: the same at 1e-12.  bf16: 1 bf16 ulp of ref plus the
    f32 floor.  dot: rtol 1e-5 (dot64: 1e-12), with an absolute floor
    ``dot_floor`` (1e-6, or 1e-12 in f64, times |a| |b| of the dot's
    operands: the two sum in different orders and a small dot can
    cancel).  bits: equal bit patterns."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{what}: got {out.dtype}{tuple(out.shape)}, "
                             f"expected {ref.dtype}{tuple(ref.shape)}")
    if tol == "bits":
        as_int = {2: torch.int16, 4: torch.int32,
                  8: torch.int64}[out.element_size()]
        diff = out.view(as_int) != ref.view(as_int)
        if diff.any():
            raise AssertionError(f"{what}: {int(diff.sum())} values differ in "
                                 f"their bits")
    o, r = out.double(), ref.double()
    if not torch.isfinite(o).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (o - r).abs()
    floor = 1e-6 * float(r.abs().max())
    if tol == "f32":
        bound = 1e-6 * r.abs() + floor
    elif tol == "f64":
        bound = 1e-12 * r.abs() + 1e-12 * float(r.abs().max())
    elif tol == "bf16":
        ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
        bound = torch.where(r == 0, 0.0, ulp) + floor
    elif tol == "dot":
        bound = 1e-5 * r.abs() + dot_floor
    elif tol == "dot64":
        bound = 1e-12 * r.abs() + dot_floor
    elif tol == "bits":
        bound = torch.zeros_like(r)
    else:
        raise ValueError(tol)
    bad = err > bound
    if bad.any():
        i = int(torch.argmax((err - bound).reshape(-1)))
        raise AssertionError(
            f"{what}: {int(bad.sum())} values out of tolerance ({tol}); worst "
            f"kernel {o.reshape(-1)[i].item()!r} plain {r.reshape(-1)[i].item()!r}")
    return float(err.max())


def median_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def repeat_ms(torch, fn, rounds: int = 3):
    """The median of ``rounds`` medians of 20, and their spread
    ((largest - smallest) / median)."""
    ms = [median_ms(torch, fn) for _ in range(rounds)]
    mid = statistics.median(ms)
    return mid, (max(ms) - min(ms)) / mid


def new_report_entry(name: str) -> dict:
    return {name: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                   "bound_ms": None, "bound_by": None, "library_ms": None}}


def new_report(path: str) -> dict:
    out = {}
    for name, _, _, _, p in ENTRIES:
        if p == path:
            out.update(new_report_entry(name))
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the f32
    peak, whichever is longer."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def library_ms(torch, fn, what: str):
    """The time of one PyTorch call computing the same function, or None
    when the installed PyTorch refuses it (said in the log)."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"{what}: no library call ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:120]})")
        return None
    return median_ms(torch, fn)


def stencil_conv(torch, x, diag: float, off: float):
    """``x -> A x`` for a batch ``(B, *grid)`` of 2D or 3D grids as one
    convolution with the 5- or 7-point kernel and zero padding, in full
    f32: the one-call counterpart of the stencil applies."""
    import torch.nn.functional as F

    nd = x.dim() - 1
    w = torch.zeros((3,) * nd, dtype=x.dtype, device=x.device)
    mid = (1,) * nd
    w[mid] = diag
    for d in range(nd):
        for o in (0, 2):
            i = list(mid)
            i[d] = o
            w[tuple(i)] = off
    conv = F.conv2d if nd == 2 else F.conv3d
    w = w[None, None]

    def call():
        return conv(x[:, None], w, padding=1)[:, 0]

    return call


def jacobi_dot_composition(torch, k, x, b, odt):
    """What the port would run without the kind jacobi_dot: kind jacobi,
    then an f32 ``torch.dot`` of b and y."""
    def call():
        y = k.stencil3d_apply(x, b, kind="jacobi", diag=DIAG, off=OFF,
                              omega=OMEGA, out_dtype=odt)
        return y, torch.dot(b.reshape(-1).float(), y.reshape(-1).float())
    return call


def mv_dot_composition(torch, k, x, odt):
    """What the port would run without the kind mv_dot: kind mv, then an
    f32 ``torch.dot`` of x and y."""
    def call():
        y = k.stencil3d_apply(x, kind="mv", diag=DIAG, off=OFF, out_dtype=odt)
        return y, torch.dot(x.reshape(-1).float(), y.reshape(-1).float())
    return call


def hold_mv_dot(torch, k, x, odt, what: str) -> None:
    """The kind mv_dot (kernel A's dot walk): y has the bits of the kind mv
    on the same x; the dot has the bits of kernel J's with beta = 0 and p
    = 0 (then p' = x, and J's A p' the bits of y) where x and y share a
    type, and of the same x's mv_dot into x's own type where they do not
    (the dot is taken before the cast); two launches give equal bits, y
    and dot."""
    def call(out):
        return k.stencil3d_apply(x, kind="mv_dot", diag=DIAG, off=OFF,
                                 out_dtype=out)
    y1, d1 = call(odt)
    y2, d2 = call(odt)
    ym = k.stencil3d_apply(x, kind="mv", diag=DIAG, off=OFF, out_dtype=odt)
    ap = None
    if odt == x.dtype:
        _, ap, dj = k.stencil3d_axpy_mv_dot(x, torch.zeros_like(x), 0.0,
                                            diag=DIAG, off=OFF)
        ref, ref_what = dj.to(torch.float32), "kernel J's (beta 0, p 0)"
    else:
        ref, ref_what = call(x.dtype)[1], f"mv_dot's into {x.dtype}"
    torch.cuda.synchronize()
    check(torch, f"mv_dot y against mv {what}", y1, ym, "bits")
    check(torch, f"mv_dot y, two launches {what}", y2, y1, "bits")
    check(torch, f"mv_dot dot, two launches {what}", d2, d1, "bits")
    check(torch, f"mv_dot dot against {ref_what} {what}", d1, ref, "bits")
    if ap is not None:
        check(torch, f"mv_dot y against kernel J's A p' {what}", ap, y1,
              "bits")


def hold_jacobi_dot(torch, k, x, b, odt, what: str) -> None:
    """The kind jacobi_dot on f32/bf16 storage (its own warp walk): y has
    the bits of the kind jacobi on the same inputs, and two launches give
    equal bits, y and dot."""
    def call():
        return k.stencil3d_apply(x, b, kind="jacobi_dot", diag=DIAG, off=OFF,
                                 omega=OMEGA, out_dtype=odt)
    y1, d1 = call()
    y2, d2 = call()
    yj = k.stencil3d_apply(x, b, kind="jacobi", diag=DIAG, off=OFF,
                           omega=OMEGA, out_dtype=odt)
    torch.cuda.synchronize()
    check(torch, f"jacobi_dot y against jacobi {what}", y1, yj, "bits")
    check(torch, f"jacobi_dot y, two launches {what}", y2, y1, "bits")
    check(torch, f"jacobi_dot dot, two launches {what}", d2, d1, "bits")


def mv_dot_device(torch, k, x, shape) -> None:
    """Device ms (``graph_ms``) of the kind mv_dot on the f32 grid x,
    beside the kind mv and the composition mv + f32 ``torch.dot``, and
    the share of mv_dot's bound (x read once, y written once)."""
    least = bound(2 * nbytes(x), 15 * x.numel())["bound_ms"]
    dot = graph_ms(torch, lambda: k.stencil3d_apply(
        x, kind="mv_dot", diag=DIAG, off=OFF))
    mv = graph_ms(torch, lambda: k.stencil3d_apply(x, kind="mv", diag=DIAG,
                                                   off=OFF))
    comp = graph_ms(torch, mv_dot_composition(torch, k, x, x.dtype))
    log(f"stencil3d_apply[mv_dot] f32 {shape} device: mv_dot {dot:.4f} ms "
        f"({least / dot:.0%} of its bound {least:.4f} ms), mv {mv:.4f} ms, "
        f"mv + torch.dot {comp:.4f} ms")


STACK_KINDS = ("mv", "residual", "jacobi", "mv_cast")


def stack_apply(k, kind, x, b, odt):
    """Kernel A's kind ``kind`` (one without a dot) on ``x``, a grid or a
    stack of grids: ``y``, or ``(y, cast x)`` for ``mv_cast``."""
    if kind == "mv_cast":
        return k.stencil3d_mv_cast(x, diag=DIAG, off=OFF, out_dtype=odt)
    extras = (b,) if kind in ("residual", "jacobi") else ()
    return k.stencil3d_apply(x, *extras, kind=kind, diag=DIAG, off=OFF,
                             omega=OMEGA if kind == "jacobi" else None,
                             out_dtype=odt)


def stack_loop(torch, k, kind, x, b, odt):
    """The same, a launch a grid of the stack, stacked after: what the
    stacked 3D paths ran before kernel A took a stack."""
    outs = [stack_apply(k, kind, x[g], b[g], odt) for g in range(x.shape[0])]
    if kind == "mv_cast":
        return tuple(torch.stack([o[i] for o in outs]) for i in range(2))
    return torch.stack(outs)


def hold_stack(torch, k, kind, x, b, odt, tol, what) -> float:
    """Kernel A's kind on the ``(T, nx, ny, nz)`` stack ``x`` in one
    launch: against its plain version (``tol``) and, bit for bit, against
    the loop of one-grid launches.  Returns the largest difference from
    the plain version."""
    out = stack_apply(k, kind, x, b, odt)
    loop = stack_loop(torch, k, kind, x, b, odt)
    if kind == "mv_cast":
        ref = k.stencil3d_mv_cast_plain(x, diag=DIAG, off=OFF, out_dtype=odt)
    else:
        extras = (b,) if kind in ("residual", "jacobi") else ()
        ref = k.stencil3d_apply_plain(
            x, *extras, kind=kind, diag=DIAG, off=OFF,
            omega=OMEGA if kind == "jacobi" else None, out_dtype=odt)
    torch.cuda.synchronize()
    out, loop, ref = (o if isinstance(o, tuple) else (o,)
                      for o in (out, loop, ref))
    err = 0.0
    for o, l, r in zip(out, loop, ref):
        err = max(err, check(torch, f"{what} stack", o, r, tol))
        check(torch, f"{what} stack against a launch a grid", o, l, "bits")
    return err


def kernel_phase(torch, k, dev) -> dict:
    torch.backends.cudnn.allow_tf32 = False     # the yardsticks in full f32
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float64).to(dt[dtype])

    report = new_report("northstar")
    timed = {name: dts for name, _, _, dts, _ in ENTRIES}
    combos = [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32"),
              ("f32", "bf16")]

    def run(name, shape, dts, kernel, plain, tols, dot_operand=None,
            path=True, inputs=(), flops_per_point=13, library=None):
        """Compare; ``max_abs_err`` takes the array outputs, not the dots.
        Time at 512^3 in the path's dtypes (and coefficients: ``path``);
        the bound counts ``inputs`` and the outputs once each."""
        outs = kernel()
        refs = plain()
        torch.cuda.synchronize()
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = refs if isinstance(refs, tuple) else (refs,)
        what = f"{name} {dts} {shape}"
        for o, r, tol in zip(outs, refs, tols):
            if tol == "dot":
                norm = torch.linalg.vector_norm
                floor = 1e-6 * float(norm(dot_operand.double())
                                     * norm(refs[0].double()))
                check(torch, what, o, r, tol, floor)
                continue
            e = check(torch, what, o, r, tol)
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
        if shape == FULL and dts == timed[name] and path:
            r = report[name]
            r["ms"] = median_ms(torch, kernel)
            r["plain_ms"] = median_ms(torch, plain)
            r.update(bound(nbytes(*inputs, *outs),
                           flops_per_point * inputs[0].numel()))
            if library is not None:
                r["library_ms"] = library_ms(torch, library, name)
            device = graph_ms(torch, kernel)
            log(f"{name} {dts} 512^3: kernel {r['ms']:.3f} ms (device "
                f"{device:.4f} ms, {r['bound_ms'] / device:.0%} of its bound),"
                f" plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")

    for shape in (FULL, LEVEL0, ODD, TINY):
        # f64 (kernel A alone computes in it) at the small shapes
        f64 = [("f64", "f64")] if shape in (ODD, TINY) else []
        for xd, od in combos + f64:
            x = rand(shape, xd)
            b = rand(shape, xd)
            odt = dt[od]
            for kind in (k.KINDS if shape != LEVEL0 else
                         ("mv_dot", "jacobi_dot")):
                ex = (b,) if kind in ("residual", "jacobi", "jacobi_dot") else ()
                om = OMEGA if kind.startswith("jacobi") else None
                tols = ((od, "dot") if kind.endswith("_dot") else (od,))
                operand = b if kind == "jacobi_dot" else x
                run(f"stencil3d_apply[{kind}]", shape, (xd, od),
                    lambda: k.stencil3d_apply(x, *ex, kind=kind, diag=DIAG,
                                              off=OFF, omega=om,
                                              out_dtype=odt),
                    lambda: k.stencil3d_apply_plain(x, *ex, kind=kind,
                                                    diag=DIAG, off=OFF,
                                                    omega=om, out_dtype=odt),
                    tols, operand, inputs=(x, *ex),
                    flops_per_point=13 + 2 * len(ex) + 2 * kind.endswith("dot"),
                    library=(stencil_conv(torch, x[None], DIAG, OFF)
                             if kind == "mv" and xd == od == "f32" else
                             mv_dot_composition(torch, k, x, odt)
                             if kind == "mv_dot" else
                             jacobi_dot_composition(torch, k, x, b, odt)
                             if kind == "jacobi_dot" else None))
                if kind == "jacobi_dot" and xd != "f64":
                    hold_jacobi_dot(torch, k, x, b, odt, f"{shape} {xd}->{od}")
                if kind == "mv_dot":
                    hold_mv_dot(torch, k, x, odt, f"{shape} {xd}->{od}")
            if shape in (FULL, LEVEL0) and xd == od == "f32":
                mv_dot_device(torch, k, x, shape)
            if shape == LEVEL0:
                del x, b
                continue
            # the cycle's first sweep: the modified coefficients of A2
            d2, o2 = 2 * OMEGA - OMEGA * OMEGA * DIAG, -OMEGA * OMEGA * OFF
            run("stencil3d_mv_cast", shape, (xd, od),
                lambda: k.stencil3d_mv_cast(x, diag=d2, off=o2, out_dtype=odt),
                lambda: k.stencil3d_mv_cast_plain(x, diag=d2, off=o2,
                                                  out_dtype=odt),
                (od, od), inputs=(x,))
            del x, b
        log(f"kernel A: {shape} ok")
    for xd, od in combos + [("f64", "f64")]:
        n = math.prod(OFFSET_GRID)
        x = rand((n + 1,), xd)[1:].view(OFFSET_GRID)
        run("stencil3d_apply[mv_dot]", OFFSET_GRID, (xd, od),
            lambda: k.stencil3d_apply(x, kind="mv_dot", diag=DIAG, off=OFF,
                                      out_dtype=dt[od]),
            lambda: k.stencil3d_apply_plain(x, kind="mv_dot", diag=DIAG,
                                            off=OFF, out_dtype=dt[od]),
            (od, "dot"), x)
        hold_mv_dot(torch, k, x, dt[od], f"{OFFSET_GRID} {xd}->{od} offset 1")
        del x
    log(f"kernel A mv_dot: {OFFSET_GRID} at offset 1 ok")
    # a stack of odd grids (the stack walk's scalar path in f32 and bf16),
    # a stack one value past 16 bytes (its scalar path in f64 too), and
    # the stacks of tiles of the sharded paths
    for shape, offset in ((ODD_STACK, 0), (OFFSET_STACK, 1),
                          *((stack, 0) for stack in SHARD_STACKS)):
        for xd, od in combos + [("f64", "f64")]:
            n = shape[0] * shape[1] * shape[2] * shape[3]
            x, b = (rand((n + offset,), xd)[offset:].view(shape)
                    for _ in range(2))
            for kind in STACK_KINDS:
                hold_stack(torch, k, kind, x, b, dt[od], od,
                           f"{kind} {xd}->{od} {shape} offset {offset}")
            del x, b
        log(f"kernel A stack: {shape} at offset {offset} ok")

    for shape in (FULL, ODD_EVEN, TINY):
        coarse = tuple(n // 2 for n in shape)
        for d in ("f32", "bf16"):
            x, b, e = rand(shape, d), rand(shape, d), rand(coarse, d)
            # kernel B rounds op by op in the plain version's order: bits
            run("stencil3d_residual_restrict", shape, (d, d),
                lambda: k.stencil3d_residual_restrict(x, b, diag=DIAG, off=OFF,
                                                      scale=4.0),
                lambda: k.stencil3d_residual_restrict_plain(
                    x, b, diag=DIAG, off=OFF, scale=4.0), ("bits",),
                inputs=(x, b), flops_per_point=15,
                library=lambda: (0.5 * k.cell_sums(k.stencil3d_apply(
                    x, b, kind="residual", diag=DIAG, off=OFF))))
            if shape == FULL and d == "f32":
                ms = median_ms(torch, lambda: k.stencil3d_residual_restrict(
                    x, b, diag=DIAG, off=OFF, scale=4.0))
                plain_ms = median_ms(
                    torch, lambda: k.stencil3d_residual_restrict_plain(
                        x, b, diag=DIAG, off=OFF, scale=4.0))
                comp_ms = median_ms(torch, lambda: 0.5 * k.cell_sums(
                    k.stencil3d_apply(x, b, kind="residual", diag=DIAG,
                                      off=OFF)))
                bnd = bound(nbytes(x, b) * 17 / 16, 15 * x.numel())["bound_ms"]
                device = graph_ms(torch, lambda: k.stencil3d_residual_restrict(
                    x, b, diag=DIAG, off=OFF, scale=4.0))
                log(f"stencil3d_residual_restrict f32 512^3: kernel {ms:.3f} "
                    f"ms (device {device:.4f} ms, {bnd / device:.0%} of its "
                    f"bound), plain {plain_ms:.3f} ms, composition (A "
                    f"residual + cell sums) {comp_ms:.3f} ms, bound "
                    f"{bnd:.3f} ms")
            run("stencil3d_prolong_jacobi", shape, (d, d),
                lambda: k.stencil3d_prolong_jacobi(x, b, e, diag=DIAG, off=OFF,
                                                   omega=OMEGA),
                lambda: k.stencil3d_prolong_jacobi_plain(
                    x, b, e, diag=DIAG, off=OFF, omega=OMEGA), (d,),
                inputs=(x, b, e), flops_per_point=23)
            del x, b, e
        log(f"kernels B, C: {shape} ok")
    for shape in C_SHAPES:
        coarse = tuple(n // 2 for n in shape)
        for d in ("f32", "bf16"):
            x, b, e = rand(shape, d), rand(shape, d), rand(coarse, d)
            run("stencil3d_prolong_jacobi", shape, (d, d),
                lambda: k.stencil3d_prolong_jacobi(x, b, e, diag=DIAG, off=OFF,
                                                   omega=OMEGA),
                lambda: k.stencil3d_prolong_jacobi_plain(
                    x, b, e, diag=DIAG, off=OFF, omega=OMEGA), (d,))
            del x, b, e
        log(f"kernel C: {shape} ok")
    for shape in B_SHAPES:
        for d in ("f32", "bf16"):
            x, b = rand(shape, d), rand(shape, d)
            run("stencil3d_residual_restrict", shape, (d, d),
                lambda: k.stencil3d_residual_restrict(x, b, diag=DIAG, off=OFF,
                                                      scale=4.0),
                lambda: k.stencil3d_residual_restrict_plain(
                    x, b, diag=DIAG, off=OFF, scale=4.0), ("bits",))
            del x, b
        log(f"kernel B: {shape} ok")
    for d in ("f32", "bf16"):
        # grids that start one element past a pair: kernels B's and C's
        # scalar paths
        n = ODD_EVEN[0] * ODD_EVEN[1] * ODD_EVEN[2]
        x, b = (rand((n + 1,), d)[1:].view(ODD_EVEN) for _ in range(2))
        e = rand(tuple(m // 2 for m in ODD_EVEN), d)
        run("stencil3d_prolong_jacobi", ODD_EVEN, (d, d),
            lambda: k.stencil3d_prolong_jacobi(x, b, e, diag=DIAG, off=OFF,
                                               omega=OMEGA),
            lambda: k.stencil3d_prolong_jacobi_plain(
                x, b, e, diag=DIAG, off=OFF, omega=OMEGA), (d,))
        run("stencil3d_residual_restrict", ODD_EVEN, (d, d),
            lambda: k.stencil3d_residual_restrict(x, b, diag=DIAG, off=OFF,
                                                  scale=4.0),
            lambda: k.stencil3d_residual_restrict_plain(
                x, b, diag=DIAG, off=OFF, scale=4.0), ("bits",))
        del x, b, e
    log("kernels B, C: grids at an odd offset ok")

    for shape in (FULL, ODD, TINY):
        # x and b as df pairs with a lo part of realistic size
        xs = [rand(shape, "f32") for _ in range(2)]
        xhi, xlo = xs[0], xs[1] * 2.0**-26
        bs = [rand(shape, "f32") for _ in range(2)]
        bhi, blo = bs[0], bs[1] * 2.0**-26
        # diag 6 / off -1 is the path; 5 and 7/-3 take the two-power and
        # Dekker products
        for diag, off in ((DIAG, OFF), (5.0, -1.0), (7.0, -3.0)):
            run("stencil3d_df_residual", shape, ("f32", "f32"),
                lambda: k.stencil3d_df_residual(xhi, xlo, bhi, blo, diag=diag,
                                                off=off),
                lambda: k.stencil3d_df_residual_plain(xhi, xlo, bhi, blo,
                                                      diag=diag, off=off),
                ("bits", "bits"), path=(diag, off) == (DIAG, OFF),
                inputs=(xhi, xlo, bhi, blo), flops_per_point=150)
        del xs, bs, xhi, xlo, bhi, blo
        log(f"kernel D: {shape} ok")
    torch.cuda.empty_cache()
    return report


def kernel_phase_2d(torch, dev) -> dict:
    """Kernel E (the 2D apply) and kernels F, G (VecMDot, VecMAXPY)
    against their plain versions; E must agree in every bit (both round
    each operation in the same order), F and G to the stated tolerances."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import fused
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d as e

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    report = new_report("thesis")

    def note(name, err):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)

    def timed(name, what, kernel, plain, json_entry=True, least=None,
              library=None):
        ms, plain_ms = median_ms(torch, kernel), median_ms(torch, plain)
        device = graph_ms(torch, kernel)
        lib = None if library is None else library_ms(torch, library, name)
        if json_entry:
            report[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib,
                                **least)
        log(f"{name} {what}: kernel {ms:.4f} ms (device {device:.4f} ms, "
            f"{least['bound_ms'] / device:.0%} of its bound), plain "
            f"{plain_ms:.3f} ms, library {lib}, bound "
            f"{least['bound_ms']:.4f} ms ({least['bound_by']})")

    def held(name, x, panel=False):
        out = e.stencil2d_apply(x, diag=4.0, off=-1.0, panel=panel)
        ref = e.stencil2d_apply_plain(x, diag=4.0, off=-1.0)
        torch.cuda.synchronize()
        note(name, check(torch, f"{name} {x.dtype} {tuple(x.shape)} at "
                         f"offset {x.storage_offset()}", out, ref, "bits"))

    for shape in E_SHAPES + E_MORE:
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
            for name, panel in (("stencil2d_apply[mv]", False),
                                ("stencil2d_apply[spmm]", True)):
                def kernel():
                    return e.stencil2d_apply(x, diag=4.0, off=-1.0, panel=panel)

                def plain():
                    return e.stencil2d_apply_plain(x, diag=4.0, off=-1.0)

                held(name, x, panel)
                main = shape == E_TIMED[name] and dtype == torch.float32
                if main or (shape in E_DEVICE and not panel and (
                        dtype == torch.float32 or shape == E_SHAPES[0])):
                    timed(name, f"{dtype} {shape}", kernel, plain,
                          json_entry=main,
                          least=bound(2 * nbytes(x), 9 * x.numel()),
                          library=(None if dtype == torch.bfloat16
                                   else stencil_conv(torch, x, 4.0, -1.0)))
            del x
        log(f"kernel E: {shape} ok")
    for shape in E_OFFSET:
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            buf = torch.randn(1 + math.prod(shape), generator=gen, device=dev,
                              dtype=torch.float32).to(dtype)
            held("stencil2d_apply[mv]", buf[1:].view(shape))
            del buf
        log(f"kernel E: {shape} at offset 1 ok")
    levels = []
    for side in E_LEVELS:
        x = torch.randn((1, side, side), generator=gen, device=dev,
                        dtype=torch.float32)
        held("stencil2d_apply[mv]", x)

        def kernel():
            return e.stencil2d_apply(x, diag=4.0, off=-1.0)

        levels.append((side, median_ms(torch, kernel), graph_ms(torch, kernel),
                       bound(2 * nbytes(x), 9 * x.numel())["bound_ms"]))
        del x
    log("kernel E, the W-cycle's levels in f32 (side, events ms, device ms, "
        "bound ms): " + "; ".join(f"{s}^2 {a:.4f} {d:.4f} {b:.2e}"
                                  for s, a, d, b in levels))

    types = ((torch.float32, torch.float32, "dot", "f32", 1e-6),
             (torch.bfloat16, torch.float32, "dot", "f32", 1e-6),
             (torch.float64, torch.float64, "dot64", "f64", 1e-12))
    for shape in FG_SHAPES:
        B, K, N = shape
        for vd, ad, dot_tol, tol, floor in types:
            V = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float64 if vd == torch.float64
                            else torch.float32).to(vd)
            w = torch.randn((B, N), generator=gen, device=dev, dtype=ad)
            a = torch.randn((B, K), generator=gen, device=dev, dtype=ad)
            norms = (torch.linalg.vector_norm(V.double(), dim=-1)
                     * torch.linalg.vector_norm(w.double(), dim=-1)[:, None])
            for ka in (1, K // 2, K):
                what = f"{vd}/{ad} {shape} k_active {ka}"
                h, hp = fused.mdot(V, w, ka), fused.mdot_plain(V, w, ka)
                again = fused.mdot(V, w, ka)
                torch.cuda.synchronize()
                if not torch.equal(h, again):
                    raise AssertionError(f"mdot {what}: not deterministic")
                dot_floor = floor * norms.to(ad)
                dot_floor[:, ka:] = 0.0
                note("mdot", check(torch, f"mdot {what}", h, hp, dot_tol,
                                   dot_floor.double()))
                y, yp = (fused.maxpy(V, a, w, ka),
                         fused.maxpy_plain(V, a, w, ka))
                torch.cuda.synchronize()
                note("maxpy", check(torch, f"maxpy {what}", y, yp, tol))
                del h, hp, again, y, yp
            if shape == FG_SHAPES[0]:
                main = vd == torch.float32
                # the library calls are the plain versions' own: bmm, baddbmm
                Vl = V.to(ad)
                timed("mdot", f"{vd}/{ad} {shape}",
                      lambda: fused.mdot(V, w, K),
                      lambda: fused.mdot_plain(V, w, K), json_entry=main,
                      least=bound(nbytes(V, w) + B * K * w.element_size(),
                                  2 * V.numel()),
                      library=lambda: torch.bmm(Vl, w[:, :, None]))
                timed("maxpy", f"{vd}/{ad} {shape}",
                      lambda: fused.maxpy(V, a, w, K),
                      lambda: fused.maxpy_plain(V, a, w, K), json_entry=main,
                      least=bound(nbytes(V, a, w, w), 2 * V.numel()),
                      library=lambda: torch.baddbmm(w[:, None, :],
                                                    a[:, None, :], Vl))
                del Vl
            del V, w, a, norms
        log(f"kernels F, G: {shape} ok")
    torch.cuda.empty_cache()
    kernel_n(torch, dev, timed, note)
    return report


def smoothed_panel(torch, dev, shape, dtype, seed):
    """``(R, t)``: ``R (batch, rows, s)`` with contiguous columns (the
    minimization's layout), successive iterates of a smoother on a random
    vector, each perturbed by 1e-3 of its mean magnitude, and ``t`` the
    next iterate plus 1% of noise: nearly collinear, as the multisplitting
    basis is.  Built in f64 on the card."""
    batch, rows, s = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def noise():
        return torch.randn((batch, rows), generator=gen, device=dev,
                           dtype=torch.float64)

    def smooth(v):
        w = 0.5 * v
        w[:, 1:] += 0.25 * v[:, :-1]
        w[:, :-1] += 0.25 * v[:, 1:]
        return w

    u = noise()
    for _ in range(8):
        u = smooth(u)
    cols = []
    for _ in range(s + 1):
        cols.append(u + 1e-3 * u.abs().mean() * noise())
        u = smooth(u)
    t = cols[s] + 1e-2 * cols[s].abs().mean() * noise()
    R = torch.stack(cols[:s], dim=1).to(dtype).transpose(1, 2)
    return R, t.to(dtype)


def qr_composition(torch, R, t):
    """What ``lstsq_qr`` ran on the card before kernel N: reduced QR, the
    rank rule, Q^T t, the triangle."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
        full_matmul,
    )

    q, r = torch.linalg.qr(R, mode="reduced")
    diag = torch.diagonal(r, dim1=-2, dim2=-1).abs()
    safe = diag > torch.finfo(R.dtype).eps * diag.amax(-1, keepdim=True)
    r = r + torch.diag_embed((~safe).to(R.dtype))
    y = full_matmul(q.transpose(-2, -1), t[..., None])[..., 0]
    return torch.linalg.solve_triangular(
        r, torch.where(safe, y, 0.0)[..., None], upper=True)[..., 0]


def kernel_n(torch, dev, timed, note) -> None:
    """Kernel N against the float64 least-squares residual (the excess
    ``(||t - R a|| - ||t - R a*||) / ||t - R a*||`` under 1e-5 in f32 and
    1e-12 in f64) and against its plain version (alpha to 5e-3 of its
    largest entry in f32, 1e-12 in f64: the panels' conditioning is
    2e3-2e4); two launches bit-equal; timed at the SMSM cell's panel."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import tsqr

    limits = {torch.float32: (1e-5, 5e-3), torch.float64: (1e-12, 1e-12)}
    for i, shape in enumerate(N_SHAPES):
        for dtype in (torch.float32, torch.float64):
            R, t = smoothed_panel(torch, dev, shape, dtype, 20 + i)
            a, again = tsqr.tsqr_lstsq(R, t), tsqr.tsqr_lstsq(R, t)
            plain = tsqr.tsqr_lstsq_plain(R, t)
            R64, t64 = R.double(), t.double()
            best = qr_composition(torch, R64, t64)
            torch.cuda.synchronize()
            if not torch.equal(a, again):
                raise AssertionError(f"tsqr {shape} {dtype}: not deterministic")

            def rnorm(x):
                return torch.linalg.vector_norm(
                    t64 - (R64 @ x.double()[..., None])[..., 0], dim=-1)

            r0 = rnorm(best)
            excess = float(((rnorm(a) - r0) / r0).abs().max())
            err = float(((a.double() - plain.double()).abs()
                         / plain.double().abs().amax(-1, keepdim=True)).max())
            excess_lib = float(((rnorm(qr_composition(torch, R, t)) - r0)
                                / r0).abs().max())
            lim_excess, lim_plain = limits[dtype]
            note("tsqr", float((a.double() - plain.double()).abs().max()))
            log(f"tsqr {dtype} {shape}: residual excess {excess:.2e} "
                f"(library {excess_lib:.2e}), against plain {err:.2e}")
            if not (excess <= lim_excess and err <= lim_plain):
                raise AssertionError(f"tsqr {shape} {dtype}: excess {excess}, "
                                     f"against plain {err}")
            if i == 0 and dtype == torch.float32:
                timed("tsqr", f"{dtype} {shape}",
                      lambda: tsqr.tsqr_lstsq(R, t),
                      lambda: tsqr.tsqr_lstsq_plain(R, t), json_entry=True,
                      least=bound(nbytes(R, t) + nbytes(a),
                                  2 * R.numel() * (shape[2] + 1)),
                      library=lambda: qr_composition(torch, R, t))
            del R, t, a, again, plain, R64, t64, best
            torch.cuda.empty_cache()
    log("kernel N: ok")


# ---------------------------------------------------------------------------
# Kernels J, K and L
# ---------------------------------------------------------------------------

FULL_2D = (8192, 8192)
ODD_2D = (37, 130)


def kernel_phase_fused(torch, k, dev) -> dict:
    """Kernel J (``stencil3d_axpy_mv_dot``) and kernels K and L (the 3D and
    2D applies with a fused residual norm) against their plain versions.

    J: p' must have the plain version's bits (both round the product and
    the sum on their own); A p' agrees to the f32 / bf16 / f64 tolerance of
    ``check`` and the dot to 1e-5; in f32 the triple must have the bits of
    ``z + beta * p`` followed by kernel A's ``mv_dot``; two launches give
    equal bits.  K, L: y must have the bits of kernel A's / kernel E's
    ``mv`` (and so, in 2D, of the plain version), the norm agrees to 1e-5
    (f64: 1e-12), two launches give equal bits.  Each is timed in f32 at
    the main path's shape beside the composition the port would run
    without it; no single PyTorch call computes any of the three."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import fused
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d as e

    report = new_report("fused")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    def note(name, err):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)

    def finish(name, what, kernel, plain, composed, composed_what, least):
        r = report[name]
        r.update(ms=median_ms(torch, kernel), plain_ms=median_ms(torch, plain),
                 **least)
        c_ms = median_ms(torch, composed)
        log(f"{name} {what}: kernel {r['ms']:.3f} ms (device "
            f"{graph_ms(torch, kernel):.4f} ms), plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), library none")
        log(f"{name} {what}: the composition without it ({composed_what}) "
            f"{c_ms:.3f} ms, {c_ms / r['ms']:.2f}x the kernel")

    # --- kernel J
    name = "stencil3d_axpy_mv_dot"
    for shape in (FULL, ODD, TINY):
        for d in ("f32", "bf16", "f64"):
            if shape == FULL and d == "f64":
                continue           # 1 GiB a grid; the path is f32
            z, p = rand(shape, dts[d]), rand(shape, dts[d])
            cdt = torch.float64 if d == "f64" else torch.float32
            betas = (0.0, -0.37, torch.tensor(0.61, dtype=cdt, device=dev))
            for beta in betas:
                what = f"{name} {d} {shape} beta {float(beta):+.2f}"
                pn, ap, dot = k.stencil3d_axpy_mv_dot(z, p, beta, diag=DIAG,
                                                      off=OFF)
                again = k.stencil3d_axpy_mv_dot(z, p, beta, diag=DIAG, off=OFF)
                rp, ra, rd = k.stencil3d_axpy_mv_dot_plain(z, p, beta,
                                                           diag=DIAG, off=OFF)
                torch.cuda.synchronize()
                for a, b in zip((pn, ap, dot), again):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{what}: two launches differ")
                check(torch, what + " p'", pn, rp, "bits")
                note(name, check(torch, what + " A p'", ap, ra, d))
                norm = torch.linalg.vector_norm
                floor = (1e-12 if d == "f64" else 1e-6) * float(
                    norm(rp.double()) * norm(ra.double()))
                # the plain dot is an f32 sum in every dtype
                check(torch, what + " dot", dot, rd, "dot", floor)
                if d == "f32":
                    # what cg computes without the hook
                    pe = z + beta * p
                    y, dd = k.stencil3d_apply(pe, kind="mv_dot", diag=DIAG,
                                              off=OFF)
                    torch.cuda.synchronize()
                    check(torch, what + " p' against the axpy", pn, pe, "bits")
                    check(torch, what + " A p' against mv_dot", ap, y, "bits")
                    check(torch, what + " dot against mv_dot", dot, dd, "bits")
                    del pe, y, dd
                del pn, ap, dot, again, rp, ra, rd
            if shape == FULL and d == "f32":
                beta = betas[2]
                finish(name, f"f32 {shape}",
                       lambda: k.stencil3d_axpy_mv_dot(z, p, beta, diag=DIAG,
                                                       off=OFF),
                       lambda: k.stencil3d_axpy_mv_dot_plain(z, p, beta,
                                                             diag=DIAG, off=OFF),
                       lambda: k.stencil3d_apply(
                           torch.add(z, p, alpha=0.61), kind="mv_dot",
                           diag=DIAG, off=OFF),
                       "torch.add(z, p, alpha=beta) + kernel A mv_dot",
                       bound(4 * nbytes(z), 17 * z.numel()))
            del z, p
        log(f"kernel J: {shape} ok")

    # --- kernel K
    name = "stencil3d_mv_norm"
    for shape in (FULL, ODD, TINY):
        for d in ("f32", "f64"):
            if shape == FULL and d == "f64":
                continue
            nx, ny, nz = shape
            g, bg = rand(shape, dts[d]), rand(shape, dts[d])
            x, b = g.reshape(-1), bg.reshape(-1)
            what = f"{name} {d} {shape}"

            def kernel():
                return fused.stencil3d_mv_norm(x, b, nx=nx, ny=ny, nz=nz,
                                               diag=DIAG, off=OFF)

            def plain():
                return fused.stencil3d_mv_norm_plain(x, b, nx=nx, ny=ny, nz=nz,
                                                     diag=DIAG, off=OFF)

            (y, sq), (y2, sq2), (yp, sqp) = kernel(), kernel(), plain()
            mv = k.stencil3d_apply(g, kind="mv", diag=DIAG, off=OFF)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(sq, sq2)):
                raise AssertionError(f"{what}: two launches differ")
            check(torch, what + " y against Stencil3D.mv", y, mv.reshape(-1),
                  "bits")
            note(name, check(torch, what + " y", y, yp, d))
            check(torch, what + " norm", sq, sqp,
                  "dot64" if d == "f64" else "dot")
            del y, y2, yp, mv
            if shape == FULL and d == "f32":
                def composed():
                    r = bg - k.stencil3d_apply(g, kind="mv", diag=DIAG, off=OFF)
                    return torch.sum(r * r)

                finish(name, f"f32 {shape}", kernel, plain, composed,
                       "kernel A mv + torch.sum((b - y)^2)",
                       bound(3 * nbytes(x), 16 * x.numel()))
            del g, bg, x, b
        log(f"kernel K: {shape} ok")

    # --- kernel L
    name = "stencil2d_mv_norm"
    for shape in (FULL_2D, (2048, 4096), ODD_2D):
        for d in ("f32", "f64"):
            m, n = shape
            g, bg = rand(shape, dts[d]), rand(shape, dts[d])
            x, b = g.reshape(-1), bg.reshape(-1)
            what = f"{name} {d} {shape}"

            def kernel():
                return fused.stencil2d_mv_norm(x, b, m=m, n=n, diag=4.0,
                                               off=-1.0)

            def plain():
                return fused.stencil2d_mv_norm_plain(x, b, m=m, n=n, diag=4.0,
                                                     off=-1.0)

            (y, sq), (y2, sq2), (yp, sqp) = kernel(), kernel(), plain()
            mv = e.stencil2d_apply(g[None], diag=4.0, off=-1.0)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(sq, sq2)):
                raise AssertionError(f"{what}: two launches differ")
            check(torch, what + " y against Stencil2D.mv", y, mv.reshape(-1),
                  "bits")
            note(name, check(torch, what + " y", y, yp, "bits"))
            check(torch, what + " norm", sq, sqp,
                  "dot64" if d == "f64" else "dot")
            del y, y2, yp, mv
            if shape == FULL_2D and d == "f32":
                def composed():
                    r = bg - e.stencil2d_apply(g[None], diag=4.0, off=-1.0)[0]
                    return torch.sum(r * r)

                finish(name, f"f32 {shape}", kernel, plain, composed,
                       "kernel E mv + torch.sum((b - y)^2)",
                       bound(3 * nbytes(x), 12 * x.numel()))
            del g, bg, x, b
        log(f"kernel L: {shape} ok")
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# Kernel M
# ---------------------------------------------------------------------------

def coarse_case(torch, dims, dtype, gen, batch=()):
    """A right-hand side on ``batch + dims`` and the coarse solve's stencil,
    bounds and coefficients, as ``vcycle`` gives them to kernel M."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import multigrid
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
        chebyshev_coefficients,
    )

    diag, off = (DIAG, OFF) if len(dims) == 3 else (4.0, -1.0)
    lmin, lmax = multigrid._dirichlet_bounds(dims, diag, off)
    b = torch.randn(batch + dims, generator=gen, device=gen.device,
                    dtype=torch.float64).to(dtype)
    kw = {"dims": dims, "diag": diag, "off": off,
          "coefs": chebyshev_coefficients(lmin, lmax, COARSE_ITERS, dtype)}
    return b, kw, (lmin, lmax)


def kernel_phase_coarse(torch, dev) -> dict:
    """Kernel M (the coarse Chebyshev solve in one launch) against its
    plain version and against the loop it replaces, ``chebyshev(A.mv, b,
    maxiter=40).x`` with kernel A or E as the matvec, bit for bit, at the
    coarsest grids of the paths (``COARSE_SHAPES``) in f32, bf16 and f64:
    the warp path at the grids of ``COARSE_WARP`` (at most 64 points), the
    block path at the others.  The device time a launch (a CUDA graph) at
    every grid; at 4^3 bf16 (the 512^3 cycle's) and 4x4 f32 (the 2048^2
    cycle's) also one launch at a time, a launch with no step (the floor
    the 40 steps add to), beside the loop; the loop with its two norms is
    the ``library`` yardstick (what the port ran before)."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import coarse
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import multigrid
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
        chebyshev,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
    report = {}
    for name in ("stencil3d_chebyshev", "stencil2d_chebyshev"):
        report.update(new_report_entry(name))
    for batch, dims in COARSE_SHAPES:
        name = f"stencil{len(dims)}d_chebyshev"
        for d, dtype in dts.items():
            b, kw, (lmin, lmax) = coarse_case(torch, dims, dtype, gen, batch)
            A = multigrid._make_op(dims, kw["diag"], kw["off"])
            what = f"kernel M {d} {batch + dims}"

            def kernel():
                return coarse.chebyshev_coarse(b, **kw)

            def plain():
                return coarse.chebyshev_coarse_plain(b, **kw)

            def loop():
                return chebyshev(A.mv, b, maxiter=COARSE_ITERS, lmin=lmin,
                                 lmax=lmax, batched=bool(batch)).x

            path = "warp" if dims in COARSE_WARP else "block"
            xp, xl = plain(), loop()
            x, x2 = kernel(), kernel()
            torch.cuda.synchronize()
            check(torch, f"{what} {path}, two launches", x2, x, "bits")
            check(torch, f"{what} {path} against the loop", x, xl, "bits")
            e = check(torch, f"{what} {path}", x, xp, "bits")
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
            log(f"{what}: {path} path, device ms a launch "
                f"{graph_ms(torch, kernel):.4f}")
            if (batch, dims, d) in COARSE_TIMED:
                r = report[name]
                r["ms"] = median_ms(torch, kernel)
                r["plain_ms"] = median_ms(torch, plain)
                r["library_ms"] = median_ms(torch, loop)
                # one read of b, one write of x; 40 steps of the stencil
                # (2 nd + 1 operations a point) and 6 of axpys
                flops = COARSE_ITERS * b.numel() * (2 * len(dims) + 7)
                r.update(bound(2 * nbytes(b), flops))
                g_kernel, g_loop = graph_ms(torch, kernel), graph_ms(torch, loop)
                no_step = dict(kw, coefs=(kw["coefs"][0], ()))
                g_floor = graph_ms(torch, lambda: coarse.chebyshev_coarse(
                    b, **no_step))
                log(f"{name} {d} {batch + dims}: a launch with no step "
                    f"{g_floor:.4f} device ms, so {COARSE_ITERS} steps "
                    f"{(g_kernel - g_floor) * 1e6 / COARSE_ITERS:.0f} ns a step")
                log(f"{name} {d} {batch + dims}: kernel {r['ms']:.4f} ms a "
                    f"launch ({g_kernel:.4f} device ms in a CUDA graph), plain "
                    f"{r['plain_ms']:.3f} ms, the loop with its norms "
                    f"{r['library_ms']:.3f} ms ({g_loop:.4f} device ms in a "
                    f"CUDA graph), bound {r['bound_ms']:.2e} ms "
                    f"({r['bound_by']})")
        log(f"kernel M: {batch + dims} ok")
    return report


# ---------------------------------------------------------------------------
# North-star phase
# ---------------------------------------------------------------------------

class record_levels:
    """Within the block, every call of the 3D wrappers of kernels A-D and
    of kernel M is counted in ``calls`` by (wrapper[kind], grid side), with
    the first call's argument shapes and dtypes and its keywords, for
    ``level_report`` to replay on fresh tensors (no tensor is kept: the
    solve's peak memory stays its own).  The wrappers are looked up on
    their modules at each call, so only Python calls are seen: a CUDA
    graph's replays are not."""

    NAMES = ("stencil3d_apply", "stencil3d_mv_cast",
             "stencil3d_residual_restrict", "stencil3d_prolong_jacobi",
             "stencil3d_df_residual", "chebyshev_coarse")

    def __init__(self, k, calls: dict):
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import coarse

        self.calls, self.saved = calls, {}
        self.modules = {name: coarse if name == "chebyshev_coarse" else k
                        for name in self.NAMES}

    def __enter__(self):
        for name in self.NAMES:
            fn = self.saved[name] = getattr(self.modules[name], name)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                label = _name + (f"[{kw['kind']}]" if "kind" in kw else "")
                key = (label, a[0].shape[0])
                if key not in self.calls:
                    self.calls[key] = [0, _fn, [(t.shape, t.dtype) for t in a],
                                       kw]
                self.calls[key][0] += 1
                return _fn(*a, **kw)

            setattr(self.modules[name], name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.modules[name], name, fn)


def graph_ms(torch, fn, reps: int = 20) -> float:
    """A call's device time alone: ``reps`` calls captured in one CUDA
    graph, the median of three replays timed with events.  No host time
    falls between the launches, so a small grid's kernel is timed too,
    which a batch of calls from the host cannot do once the host is the
    slower."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm-up off the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def level_report(torch, calls: dict) -> None:
    """Per kernel of A-D and M: its launches on each grid of one 512^3 solve and
    its device time weighted by them (each grid's call replayed alone in a
    CUDA graph)."""
    by_kernel = {}
    for (label, side), (count, fn, specs, kw) in sorted(
            calls.items(), key=lambda c: (c[0][0], -c[0][1])):
        a = [torch.randn(shape, device="cuda").to(dt) for shape, dt in specs]
        ms = graph_ms(torch, lambda: fn(*a, **kw))
        del a
        per = by_kernel.setdefault(label, [{}, 0.0])
        per[0][f"{side}^3"] = (count, round(ms, 4))
        per[1] += count * ms
    for label, (levels, total) in by_kernel.items():
        log(f"levels of one 512^3 solve: {label}: {total:.2f} device ms; "
            f"(launches, device ms a launch) by grid {levels}")


def e_launches_by_grid(torch, port, op, b_df) -> None:
    """Kernel E's launches on each grid of one eager 2D north-star solve
    (every launch from the host, so each is seen where the ctypes call is
    made) and its device time weighted by them, each grid's launch
    replayed alone in a CUDA graph."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d as e

    lib, seen = build.load("stencil2d"), {}
    launch = lib.stencil2d_apply

    def counted(dtype, x, y, batch, m, n, *rest):
        key = (dtype, batch, m, n)
        seen[key] = seen.get(key, 0) + 1
        return launch(dtype, x, y, batch, m, n, *rest)

    lib.stencil2d_apply = counted
    try:
        eager_northstar(port, op, b_df)
        torch.cuda.synchronize()
    finally:
        lib.stencil2d_apply = launch
    dts = {code: dt for dt, code in e._DTYPE_CODE.items()}
    total, levels = 0.0, {}
    for (code, batch, m, n), count in sorted(seen.items(),
                                             key=lambda c: -c[0][2]):
        x = torch.randn((batch, m, n), device="cuda").to(dts[code])
        ms = graph_ms(torch, lambda: e.stencil2d_apply(x, diag=4.0, off=-1.0))
        levels[f"{str(dts[code])[6:]} {batch}x{m}x{n}"] = (count, round(ms, 4))
        total += count * ms
        del x
    log(f"kernel E in one eager {op.m}x{op.n} solve: {sum(seen.values())} "
        f"launches, {total:.2f} device ms; (launches, device ms a launch) by "
        f"grid {levels}")


def eager_northstar(port, op, b_df):
    """The north-star solve without the program: ``df_iterative_refinement``
    around ``cg`` with the W-cycle, every kernel launched from the host, the
    PCG counts in ``pcg_iters``.  The same arithmetic as the program's."""
    Md = port.mg_preconditioner(op, return_rdot=True)
    iters = []

    def solve_f32(r):
        res = port.cg(op.mv, r, rtol=1e-4, maxiter=40, precond_dot=Md,
                      matvec_dot=getattr(op, "mv_dot", None))
        iters.append(res.iters)
        return res.x

    res = port.df_iterative_refinement(op, None, solve_f32, rtol=1e-8,
                                       b_df=b_df, return_host=False)
    res.pcg_iters = iters
    return res


def cycle_launches(levels) -> tuple:
    """``(coarse visits, first sweeps at levels 1 .. L-2)`` of one cycle:
    kernel M's launches and kernel A ``mv``'s (3D) a cycle."""
    n = len(levels.dims)
    if levels.cycle == "v" or n < 2:
        return 1, max(0, n - 2)
    return 2 ** (n - 2), 2 ** (n - 1) - 2


def program_of(op):
    """The cached program ``df_northstar_fused(op, b_df, rtol=1e-8,
    inner_rtol=1e-4)`` runs, with its capture time."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import refine

    return refine._df_fused_program(op, 1e-8, 6, 1e-4, 40, 2, 4, 40, "w")


def graphed_and_eager(torch, port, label, op, b_df, reps: int):
    """The graphed solve and the eager one in the same call, in turns
    (graphed, eager, eager, graphed, ...): equal PCG counts and x equal to
    the bit.  Returns the median times (s) of each, ``reps`` runs each."""
    times = {True: [], False: []}
    order = [True, False, False, True, True, False][:2 * reps]
    results = {}
    for graphed in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = (port.df_northstar_fused(op, b_df, rtol=1e-8, inner_rtol=1e-4)
               if graphed else eager_northstar(port, op, b_df))
        torch.cuda.synchronize()
        times[graphed].append(time.perf_counter() - t0)
        results[graphed] = res
    g, e = results[True], results[False]
    if list(g.pcg_iters) != list(e.pcg_iters) or g.passes != e.passes:
        raise AssertionError(f"{label}: graphed PCG {g.pcg_iters}, eager "
                             f"{e.pcg_iters}")
    for part, a, b in zip(("hi", "lo"), g.x, e.x):
        check(torch, f"{label}: graphed x{part} against the eager solve's",
              a, b, "bits")
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"{label}: graphed {med[True] * 1e3:.1f} ms "
        f"{[round(t * 1e3, 1) for t in times[True]]}, eager "
        f"(df_iterative_refinement around cg) {med[False] * 1e3:.1f} ms "
        f"{[round(t * 1e3, 1) for t in times[False]]}, in turns; PCG "
        f"{g.pcg_iters} both, x equal to the bit")
    return med[True], med[False]


def slice_phase(torch, port, k, dev) -> dict:
    """The 3D north-star through the graphed program at 256^3 and 512^3;
    the eager solve beside it; the launches by grid of the eager 512^3
    solve."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import multigrid
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import refine

    names = [name for name, _, _, _, path in ENTRIES if path == "northstar"]
    launches = {}
    for n in SLICE:
        refine._df_fused_program.cache_clear()   # the last size's graphs
        torch.cuda.empty_cache()
        op = port.poisson3d(n, n, n)
        bhi = op.mv(torch.ones((n, n, n), dtype=torch.float32, device=dev))
        b_df = (bhi, torch.zeros_like(bhi))

        def solve():
            return port.df_northstar_fused(op, b_df, rtol=1e-8,
                                           inner_rtol=1e-4)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k.reset_launch_counts()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = k.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
        capture_s = program_of(op).steps.capture_s
        missing = [m for m in names if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"{n}^3: kernels never launched: {missing}")
        launches = {m: counts[m] for m in names}
        cycles = sum(res.pcg_iters)
        visits, sweeps = cycle_launches(multigrid.plan(op))
        if (counts["stencil3d_chebyshev"], counts["stencil3d_apply[mv]"]) != (
                visits * cycles, sweeps * cycles):
            raise AssertionError(
                f"{n}^3: {counts['stencil3d_chebyshev']} launches of kernel M "
                f"and {counts['stencil3d_apply[mv]']} of A mv in {cycles} "
                f"cycles; expected {visits} and {sweeps} a cycle (no coarse "
                f"loop)")
        times = []
        k.reset_launch_counts()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        warm = k.launch_counts()
        if warm != {m: 3 * c for m, c in counts.items()}:
            raise AssertionError(f"{n}^3: three warm solves counted {warm}, "
                                 f"the first {counts}")
        solve_ms = statistics.median(times) * 1e3
        busy_share(torch, f"{n}^3 graphed", solve, solve_ms)
        replay_share(torch, f"{n}^3 graphed", program_of(op), res, solve_ms)
        graphed_and_eager(torch, port, f"{n}^3", op, b_df, 3)
        if n == SLICE[-1]:
            # the launches by grid of the eager solve, neither counted nor
            # timed: the recording wraps every call of kernels A-D and M
            calls = {}
            with record_levels(k, calls):
                eager_northstar(port, op, b_df)
            level_report(torch, calls)
            del calls

        xhi, xlo = res.x
        log(f"{n}^3: solution digest (sha256 of the bytes of xhi, xlo) "
            f"{digest(torch, xhi)} {digest(torch, xlo)}")
        x64 = xhi.double() + xlo.double()
        b64 = bhi.double()
        r = b64 - k.stencil3d_apply_plain(x64, kind="mv", diag=op.diag,
                                          off=op.off)
        rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))
        err = float((x64 - 1.0).abs().max())
        del x64, b64, r
        log(f"{n}^3: passes {res.passes}, PCG iterations {res.pcg_iters}, "
            f"host syncs {res.syncs}, df rel {res.rnorm / res.rnorm0:.3e}, "
            f"f64 rel {rel:.3e}, max|x-1| {err:.3e}")
        log(f"{n}^3: graphed solve {solve_ms:.1f} ms median of 3 "
            f"{[round(t * 1e3, 1) for t in times]} (first run "
            f"{first_s * 1e3:.1f} ms, of it {capture_s * 1e3:.1f} ms "
            f"capturing the two graphs), peak memory {peak / 2**30:.2f} GiB "
            f"allocated, {peak_reserved / 2**30:.2f} GiB reserved (with the "
            f"graph pool)")
        log(f"{n}^3: kernel launches per solve, graph replays included "
            f"{counts}")
        if not (res.converged and res.passes <= 3):
            raise AssertionError(f"{n}^3: converged={res.converged} in "
                                 f"{res.passes} passes")
        if list(res.pcg_iters) != [5, 6]:
            raise AssertionError(f"{n}^3: PCG iterations {res.pcg_iters}, "
                                 f"every earlier run took [5, 6]")
        if res.syncs != sum(res.pcg_iters) + 2 * res.passes + 2:
            raise AssertionError(f"{n}^3: {res.syncs} host syncs")
        if not rel <= 1e-8:
            raise AssertionError(f"{n}^3: f64 relative residual {rel:.3e}")
        if not err <= 1e-6:
            raise AssertionError(f"{n}^3: max|x - 1| = {err:.3e}")
        del op, bhi, b_df, res, xhi, xlo
    refine._df_fused_program.cache_clear()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Fused-direction, 2D north-star and cycle-precision phases
# ---------------------------------------------------------------------------

def digest(torch, t) -> str:
    """sha256 of a tensor's bytes, in its layout: two runs that give equal
    bits give equal digests."""
    import hashlib

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw).hexdigest()[:16]


def f64_check(torch, op, xhi, xlo, bhi, probe):
    """``(||b - A x|| / ||b||, max|x - 1|, ||b - A probe||)`` in f64 on the
    card through the plain applies, for a stencil operator, a double-float
    x and an f32 ``probe``."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d as e
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k

    def apply(x64):
        if hasattr(op, "m"):
            return e.stencil2d_apply_plain(x64[None], diag=op.diag,
                                           off=op.off)[0]
        return k.stencil3d_apply_plain(x64, kind="mv", diag=op.diag, off=op.off)

    norm = torch.linalg.vector_norm
    b64 = bhi.double()
    x64 = xhi.double() + xlo.double()
    rel = float(norm(b64 - apply(x64)) / norm(b64))
    err = float((x64 - 1.0).abs().max())
    del x64
    r_probe = float(norm(b64 - apply(probe.double())))
    return rel, err, r_probe


def probe_of(torch, xhi):
    """The solution moved off by 1e-3 of noise: b = A·1 is solved by an
    exactly representable x, whose residual is 0 and tests no norm."""
    gen = torch.Generator(device=xhi.device)
    gen.manual_seed(7)
    return xhi + 1e-3 * torch.randn(xhi.shape, generator=gen,
                                    device=xhi.device)


def expect_solution(label, res, rel, err) -> None:
    if not (res.converged and res.passes <= 3):
        raise AssertionError(f"{label}: converged={res.converged} in "
                             f"{res.passes} passes")
    if not rel <= 1e-8:
        raise AssertionError(f"{label}: f64 relative residual {rel:.3e}")
    if not err <= 1e-6:
        raise AssertionError(f"{label}: max|x - 1| = {err:.3e}")


def fused_direction_phase(torch, port, k, dev) -> dict:
    """The 512^3 north-star with PCG's direction update fused into the
    matvec (kernel J behind ``cg``'s ``matvec_axpy_dot`` hook), beside the
    same solve without the hook, then kernel K on the solution.  Returns
    the launches of J and K in the counted window."""
    n = SLICE[-1]
    op = port.poisson3d(n, n, n)
    bhi = op.mv(torch.ones((n, n, n), dtype=torch.float32, device=dev))
    b_df = (bhi, torch.zeros_like(bhi))
    Md = port.mg_preconditioner(op, return_rdot=True)

    def solve(hook: bool):
        iters = []

        def solve_f32(r):
            res = port.cg(op.mv, r, rtol=1e-4, maxiter=40, precond_dot=Md,
                          matvec_dot=op.mv_dot,
                          matvec_axpy_dot=op.axpy_mv_dot if hook else None)
            iters.append(res.iters)
            return res.x

        res = port.df_iterative_refinement(op, None, solve_f32, rtol=1e-8,
                                           b_df=b_df, return_host=False)
        return res, iters

    out = {}
    for hook in (True, False):
        label = f"{n}^3 {'with' if hook else 'without'} matvec_axpy_dot"
        torch.cuda.synchronize()
        k.reset_launch_counts()
        res, iters = solve(hook)
        xhi, xlo = res.x
        sq, probe = None, probe_of(torch, xhi)
        if hook:
            _, sq = port.residual_norm_sq(op, probe.reshape(-1),
                                          bhi.reshape(-1))
        torch.cuda.synchronize()
        counts = k.launch_counts()
        rel, err, r_hi = f64_check(torch, op, xhi, xlo, bhi, probe)
        del probe
        log(f"{label}: passes {res.passes}, PCG iterations {iters}, df rel "
            f"{res.rnorm / res.rnorm0:.3e}, f64 rel {rel:.3e}, max|x-1| "
            f"{err:.3e}; launches: axpy_mv_dot "
            f"{counts.get('stencil3d_axpy_mv_dot', 0)}, mv_dot "
            f"{counts.get('stencil3d_apply[mv_dot]', 0)}, mv_norm "
            f"{counts.get('stencil3d_mv_norm', 0)}")
        expect_solution(label, res, rel, err)
        j, md = (counts.get("stencil3d_axpy_mv_dot", 0),
                 counts.get("stencil3d_apply[mv_dot]", 0))
        if (j, md) != ((sum(iters), 0) if hook else (0, sum(iters))):
            raise AssertionError(f"{label}: {j} launches of J and {md} of "
                                 f"mv_dot in {sum(iters)} PCG iterations")
        if hook:
            got = float(sq) ** 0.5
            log(f"residual_norm_sq (kernel K) on x + 1e-3 noise: {got:.6e}, "
                f"f64 ||b - A x|| of the same {r_hi:.6e}")
            if not abs(got - r_hi) <= 1e-3 * r_hi:
                raise AssertionError("kernel K's norm is off the f64 residual")
            launches = {m: counts[m] for m in ("stencil3d_axpy_mv_dot",
                                               "stencil3d_mv_norm")}
        out[hook] = iters
        del res, xhi, xlo
    if out[True] != out[False]:
        raise AssertionError(f"PCG iterations differ: {out[True]} with the "
                             f"hook, {out[False]} without")
    if out[True] != [5, 6]:
        raise AssertionError(f"PCG iterations {out[True]}, every earlier run "
                             f"took [5, 6]")
    times = {True: [], False: []}
    for hook in (True, False, False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(hook)
        torch.cuda.synchronize()
        times[hook].append(time.perf_counter() - t0)
    log(f"{n}^3 solve, median of 3 taken in turns: with matvec_axpy_dot "
        f"{statistics.median(times[True]) * 1e3:.1f} ms "
        f"{[round(t * 1e3, 1) for t in times[True]]}, without "
        f"{statistics.median(times[False]) * 1e3:.1f} ms "
        f"{[round(t * 1e3, 1) for t in times[False]]}")
    torch.cuda.empty_cache()
    return launches


def northstar2d_phase(torch, port, dev) -> dict:
    """The 2D north-star.  ``df_northstar_fused`` with its defaults (W-cycle;
    bf16 at 8192^2 by the auto rule) through the graphed program at 2048^2
    (10 levels, 256 coarse visits a cycle; beside the eager solve, x equal
    to the bit) and at 8192^2 (12 levels, 1024 coarse visits a cycle),
    each counted once and timed 3 times; at 8192^2 also the refinement
    through ``df_iterative_refinement`` around PCG with one f32 V-cycle,
    counted and then timed 3 times.  Then kernel L beside the f64 residual,
    ``device_iterative_refinement`` (f64 residual on the card) around the
    same PCG, and the 2D double-float residual on the card against the
    CPU.  Returns the launches of kernels L and M (2D) of the 2048^2
    program's counted run."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import df64
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import multigrid
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import refine

    launches = {}
    for n, how in ((2048, "program"), (8192, "program"), (8192, "vcycle")):
        refine._df_fused_program.cache_clear()
        torch.cuda.empty_cache()
        op = port.poisson2d(n, n)
        bhi = op.mv(torch.ones((n, n), dtype=torch.float32, device=dev))
        b_df = (bhi, torch.zeros_like(bhi))
        label = (f"2D {n}^2 df_northstar_fused, defaults, graphed"
                 if how == "program" else f"2D {n}^2 df_iterative_refinement "
                 f"around PCG with an f32 V-cycle")
        M = port.mg_preconditioner(op, cycle="v", dtype=torch.float32)
        iters = []

        def solve_f32(r):
            res = port.cg(op.mv, r, rtol=1e-4, maxiter=40, precond=M)
            iters.append(res.iters)
            return res.x

        def solve():
            if how == "program":
                return port.df_northstar_fused(op, b_df, rtol=1e-8,
                                               inner_rtol=1e-4)
            del iters[:]
            res = port.df_iterative_refinement(op, None, solve_f32, rtol=1e-8,
                                               b_df=b_df, return_host=False)
            res.pcg_iters = list(iters)
            return res

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        xhi, xlo = res.x
        probe = probe_of(torch, xhi)
        _, sq = port.residual_norm_sq(op, probe.reshape(-1), bhi.reshape(-1))
        torch.cuda.synchronize()
        counts = build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
        rel, err, r_hi = f64_check(torch, op, xhi, xlo, bhi, probe)
        del probe
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        capture = (f", of it {program_of(op).steps.capture_s * 1e3:.1f} ms "
                   f"capturing the two graphs" if how == "program" else "")
        log(f"{label}: passes {res.passes}, PCG iterations {res.pcg_iters}, "
            f"host syncs {res.syncs}, df rel {res.rnorm / res.rnorm0:.3e}, "
            f"f64 rel {rel:.3e}, max|x-1| {err:.3e}")
        log(f"{label}: solve {statistics.median(times) * 1e3:.1f} ms median of "
            f"3 {[round(t * 1e3, 1) for t in times]} (first run "
            f"{first_s * 1e3:.1f} ms{capture}), peak memory "
            f"{peak / 2**30:.2f} GiB allocated, {peak_reserved / 2**30:.2f} GiB "
            f"reserved, launches {counts}")
        expect_solution(label, res, rel, err)
        got = float(sq) ** 0.5
        log(f"{label}: residual_norm_sq (kernel L) on x + 1e-3 noise "
            f"{got:.6e}, f64 ||b - A x|| of the same {r_hi:.6e}")
        if not abs(got - r_hi) <= 1e-3 * r_hi:
            raise AssertionError(f"{label}: kernel L's norm is off the f64 "
                                 f"residual")
        if not (counts.get("stencil2d_apply[mv]", 0) > 0
                and counts.get("stencil2d_mv_norm", 0) == 1):
            raise AssertionError(f"{label}: launches {counts}")
        visits = cycle_launches(multigrid.plan(
            op, cycle="w" if how == "program" else "v"))[0]
        if counts.get("stencil2d_chebyshev", 0) != visits * sum(res.pcg_iters):
            raise AssertionError(f"{label}: {counts.get('stencil2d_chebyshev')}"
                                 f" launches of kernel M, {visits} a cycle "
                                 f"expected")
        if how == "program":
            replay_share(torch, label, program_of(op), res,
                         statistics.median(times) * 1e3)
        if n == 2048:
            if list(res.pcg_iters) != [4, 5]:
                raise AssertionError(f"{label}: PCG iterations "
                                     f"{res.pcg_iters}, every earlier run "
                                     f"took [4, 5]")
            launches = {m: counts[m] for m in ("stencil2d_mv_norm",
                                               "stencil2d_chebyshev")}
            graphed_and_eager(torch, port, f"2D {n}^2", op, b_df, 1)
            e_launches_by_grid(torch, port, op, b_df)
        del res, xhi, xlo
        if how == "vcycle":
            # the f64 cross-check of the df path: residual in f64 on the card
            del iters[:]
            t0 = time.perf_counter()
            rd = port.device_iterative_refinement(op.mv, bhi.double(),
                                                  solve_f32, rtol=1e-8)
            log(f"2D {n}^2 device_iterative_refinement around the same PCG: "
                f"passes {rd.passes}, PCG iterations {iters}, "
                f"rel history {[f'{v:.2e}' for v in rd.rel_history]}, "
                f"max|x-1| {abs(rd.x - 1.0).max():.3e}, "
                f"{time.perf_counter() - t0:.2f} s (the f64 x comes back to "
                f"the host)")
            if not (rd.converged and rd.passes <= 3
                    and abs(rd.x - 1.0).max() <= 1e-6):
                raise AssertionError(f"{label}: device refinement failed")
            del rd
        del op, bhi, b_df, M
    refine._df_fused_program.cache_clear()
    torch.cuda.empty_cache()

    # the 2D df residual is plain tensor code: it must round on the card
    # as on the CPU (no contraction of a*b+c)
    m, n = 1024, 2048
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    parts = [torch.randn((m, n), generator=gen, device=dev) for _ in range(4)]
    xhi, xlo, bhi, blo = (parts[0], parts[1] * 2.0**-26, parts[2],
                          parts[3] * 2.0**-26)
    for diag, off in ((4.0, -1.0), (5.0, -1.0), (7.0, -3.0)):
        residual = df64.stencil2d_df_residual(m, n, diag, off)
        on_card = residual((bhi, blo), (xhi, xlo))
        on_cpu = residual((bhi.cpu(), blo.cpu()), (xhi.cpu(), xlo.cpu()))
        for name, a, b in zip(("hi", "lo"), on_card, on_cpu):
            check(torch, f"2D df residual {name} ({diag}, {off}) card "
                  f"against CPU", a.cpu(), b, "bits")
    log(f"2D df residual ({m}, {n}): the card's bits equal the CPU's")
    return launches


def cycle_precision_phase(torch, port, dev, card) -> None:
    """One multigrid cycle with f32 and with bf16 arithmetic on an f32
    residual, host clock around a synchronised call, median of 3 taken in
    turns: the reading behind ``multigrid._BF16_CYCLE_BYTES`` (level-0 f32
    bytes above which the auto precision is bf16)."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import multigrid

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    rows = []
    for dims, cycle, reps in (((128,) * 3, "w", 3), ((256,) * 3, "w", 3),
                              ((2048,) * 2, "w", 2), ((8192,) * 2, "v", 3),
                              ((8192,) * 2, "w", 1)):
        op = (port.poisson2d if len(dims) == 2 else port.poisson3d)(*dims)
        r = torch.randn(dims, generator=gen, device=dev)
        Ms = {d: port.mg_preconditioner(op, cycle=cycle, dtype=d)
              for d in (torch.float32, torch.bfloat16)}
        for M in Ms.values():      # warm: allocator and kernels
            if reps > 1:
                M(r)
        times = {d: [] for d in Ms}
        for _ in range(reps):
            for d, M in Ms.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                M(r)
                torch.cuda.synchronize()
                times[d].append((time.perf_counter() - t0) * 1e3)
        f32, bf16 = (statistics.median(times[d]) for d in Ms)
        mib = 4 * r.numel() / 2**20
        rows.append(f"{'x'.join(map(str, dims))} {cycle} ({mib:.0f} MiB): f32 "
                    f"{f32:.1f} ms, bf16 {bf16:.1f} ms, bf16/f32 "
                    f"{bf16 / f32:.2f}")
        del op, r, Ms
        torch.cuda.empty_cache()
    log(f"cycle precision ({card}; threshold "
        f"{multigrid._BF16_CYCLE_BYTES / 2**20:.0f} MiB): " + "; ".join(rows))
    # what the precision does to PCG in 2D, where the sweeps outside kernel
    # E are plain tensor code that rounds every operation
    rows = []
    for n, cycles in ((2048, ("v", "w")), (8192, ("v",))):
        op = port.poisson2d(n, n)
        b = op.mv(torch.ones((n, n), device=dev))
        b = b / torch.linalg.vector_norm(b)
        for cycle in cycles:
            for d, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                M = port.mg_preconditioner(op, cycle=cycle, dtype=d)
                res = port.cg(op.mv, b, rtol=1e-4, maxiter=40, precond=M)
                rows.append(f"{n}^2 {cycle} {name}: {res.iters}"
                            f"{'' if bool(res.converged) else ' (not converged)'}")
        del op, b
        torch.cuda.empty_cache()
    log("2D PCG iterations to rtol 1e-4 (maxiter 40) by cycle and cycle "
        "precision: " + "; ".join(rows))


# ---------------------------------------------------------------------------
# Golden phase
# ---------------------------------------------------------------------------

def golden_phase(torch, port, dev) -> None:
    """The golden sweep counts of the JAX package (``tests/test_golden.py``)
    in f64 on the card, every apply and Gram-Schmidt step through the
    kernels: exact, or the run fails."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

    op = port.block_poisson2d(32, 32)
    b = port.rhs_ones(op, torch.float64, dev)
    runs = {
        "SM": lambda: port.sm(op, b, rtol=1e-3, maxiter=2000),
        "AM": lambda: port.am(op, b, staleness=2, rtol=1e-3, maxiter=4000),
        "SMSM_LOCAL": lambda: port.smsm(op, b, scope="local", s=4, rtol=1e-3,
                                        maxiter=2000),
        "SMSM_SEMI_LOCAL": lambda: port.smsm(op, b, scope="semi_local", s=4,
                                             rtol=1e-3, maxiter=2000),
        "SMSM_GLOBAL": lambda: port.smsm(op, b, scope="global", s=4,
                                         rtol=1e-3, maxiter=2000),
    }
    for name, sweeps in GOLDEN:
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = runs[name]()
        torch.cuda.synchronize()
        counts = build.launch_counts()
        log(f"golden {name} 32^2 f64: {res.sweeps} sweeps (expected {sweeps}), "
            f"{res.cycles} cycles, {int(res.inner_iters)} inner iterations, "
            f"certified {res.certified}, {res.syncs} host syncs, "
            f"{time.perf_counter() - t0:.2f} s, launches {counts}")
        if not res.converged or res.sweeps != sweeps:
            raise AssertionError(f"golden {name}: {res.sweeps} sweeps, "
                                 f"converged {res.converged}")
        if name == "AM" and not res.certified:
            raise AssertionError("golden AM: not certified")
        missing = [m for m in ("stencil2d_apply[mv]", "mdot", "maxpy")
                   if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"golden {name}: never launched {missing}")


# ---------------------------------------------------------------------------
# Thesis phase
# ---------------------------------------------------------------------------

def residual_f64(torch, op, x, b) -> float:
    """||b - A x|| / ||b|| in f64 on the card, through the plain applies
    (``||b|| = ||r0||`` from the zero start)."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d as e
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k

    x64, b64 = x.double(), b.double().reshape(-1)
    if hasattr(op, "m"):
        ax = e.stencil2d_apply_plain(x64.reshape(1, op.m, op.n), diag=op.diag,
                                     off=op.off)
    else:
        ax = k.stencil3d_apply_plain(x64.reshape(op.nx, op.ny, op.nz),
                                     kind="mv", diag=op.diag, off=op.off)
    r = b64 - ax.reshape(-1)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


# each thesis run of this process by its label: ((sweeps, cycles), f64
# rel, the timed solve's seconds), for the cli phase to compare with
THESIS_RUNS: dict = {}


def thesis_phase(torch, port, dev) -> dict:
    """The thesis's configurations in f32; returns the launches of kernels
    E, F and G summed over the counted runs and keeps each run's counts in
    ``THESIS_RUNS``."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

    cheb = port.InnerConfig(method="chebyshev", maxiter=20)
    configs = [
        ("SMSM_GLOBAL 2D 4096^2", lambda: port.block_poisson2d(4096, 4096),
         lambda op, b: port.smsm(op, b, scope="global", s=4, rtol=1e-3,
                                 maxiter=2000), 1e-3,
         ("stencil2d_apply[mv]", "stencil2d_apply[spmm]", "mdot", "maxpy",
          "tsqr"),
         "TPU v5e: 52 sweeps with a bf16 basis (BENCHMARKS.md:28)"),
        ("AM 1024^2 staleness 2", lambda: port.block_poisson2d(1024, 1024),
         lambda op, b: port.am(op, b, staleness=2, rtol=1e-3, maxiter=4000),
         1e-3, ("stencil2d_apply[mv]", "mdot", "maxpy"),
         "TPU v5e: 282 sweeps (BENCHMARKS.md:70)"),
        ("SMSM_GLOBAL 3D 64^3 Chebyshev(20)",
         lambda: port.block_poisson3d(64, 64, 64),
         lambda op, b: port.smsm(op, b, scope="global", s=4, rtol=1e-5,
                                 maxiter=2000, inner=cheb), 1e-5,
         ("stencil3d_apply[mv]", "maxpy", "tsqr"),
         "TPU v5e: 48 sweeps to rel 8.6e-6 (BENCHMARKS.md:19)"),
    ]
    names = [name for name, _, _, _, path in ENTRIES if path == "thesis"]
    total = dict.fromkeys(names, 0)
    for label, make, solve, rtol, need, tpu in configs:
        op = make()
        b = port.rhs_ones(op, torch.float32, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = solve(op, b)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        missing = [m for m in need if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        for m in names:
            total[m] += counts.get(m, 0)
        times = []
        for _ in range(1 if label.startswith("AM") else 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(op, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rel = residual_f64(torch, op, res.x, b)
        THESIS_RUNS[label] = ((res.sweeps, res.cycles), rel,
                              statistics.median(times))
        err = float((res.x.double() - 1.0).abs().max())
        log(f"{label}: {res.sweeps} sweeps, {res.cycles} cycles, "
            f"{int(res.inner_iters)} inner iterations, {res.syncs} host "
            f"syncs, converged {res.converged}, certified {res.certified}, "
            f"tail sweeps {res.tail_sweeps}; f32 rel "
            f"{float(res.rnorm / res.rnorm0):.3e}, f64 rel {rel:.3e}, "
            f"max|x-1| {err:.3e} ({tpu})")
        log(f"{label}: solve {statistics.median(times) * 1e3:.1f} ms median "
            f"of {len(times)} {[round(t * 1e3, 1) for t in times]} (first run "
            f"{first_s * 1e3:.1f} ms), peak memory {peak / 2**30:.2f} GiB")
        log(f"{label}: kernel launches per solve {counts}")
        if "tsqr" in need:
            log(f"{label}: kernel N launches per solve {counts['tsqr']} "
                f"({res.cycles} cycles, one minimization a cycle)")
        if not res.converged or (res.certified is not None
                                 and not res.certified):
            raise AssertionError(f"{label}: converged {res.converged}, "
                                 f"certified {res.certified}")
        if not rel <= rtol:
            raise AssertionError(f"{label}: f64 relative residual {rel:.3e} "
                                 f"above {rtol}")
        del op, b, res
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# Inner-solve phase
# ---------------------------------------------------------------------------

def inner_phase(torch, port, dev) -> None:
    """Multisplitting with the inner solves that need the multigrid cycle
    on a strip, in f32, each run once and counted."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

    a_cycle = ("stencil3d_apply[mv]", "stencil3d_apply[residual]",
               "stencil3d_apply[jacobi]", "stencil3d_residual_restrict",
               "stencil3d_prolong_jacobi")
    configs = [
        ("SM 3D 64^3, inner gmres", lambda: port.block_poisson3d(64, 64, 64),
         lambda op, b: port.sm(op, b, rtol=1e-3), 1e-3,
         ("stencil3d_apply[mv]", "mdot", "maxpy"),
         "TPU v5e: ~105 sweeps / ~2100 inner iterations (BENCHMARKS.md:58)",
         None),
        ("SM 3D 64^3, inner gmres + pc='mg'",
         lambda: port.block_poisson3d(64, 64, 64),
         lambda op, b: port.sm(op, b, rtol=1e-3,
                               inner=port.InnerConfig(method="gmres", pc="mg")),
         1e-3, a_cycle + ("stencil3d_chebyshev", "mdot", "maxpy"),
         "TPU v5e: 51 sweeps / 510 inner iterations (BENCHMARKS.md:58)",
         51),   # pinned: the sweeps the TPU and every H100 run took
        ("SMSM_GLOBAL 2D 1024^2, inner cg + pc='mg'",
         lambda: port.block_poisson2d(1024, 1024),
         lambda op, b: port.smsm(
             op, b, scope="global", s=4, rtol=1e-3, maxiter=2000,
             inner=port.InnerConfig(method="cg", pc="mg")), 1e-3,
         ("stencil2d_apply[mv]", "stencil2d_apply[spmm]", "maxpy",
          "stencil2d_chebyshev"),
         "no TPU run of this configuration is recorded; at 4096^2 it took "
         "24 sweeps and 122 s on an H100", None),
    ]
    for label, make, solve, rtol, need, tpu, pinned in configs:
        op = make()
        b = port.rhs_ones(op, torch.float32, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = solve(op, b)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        counts = build.launch_counts()
        rel = residual_f64(torch, op, res.x, b)
        log(f"{label}: {res.sweeps} sweeps, {res.cycles} cycles, "
            f"{int(res.inner_iters)} inner iterations, {res.syncs} host "
            f"syncs, converged {res.converged}; f32 rel "
            f"{float(res.rnorm / res.rnorm0):.3e}, f64 rel {rel:.3e}, "
            f"max|x-1| {float((res.x.double() - 1.0).abs().max()):.3e} ({tpu})")
        log(f"{label}: solve {took:.2f} s (one run), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{counts}")
        missing = [m for m in need if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        if not res.converged or not rel <= rtol:
            raise AssertionError(f"{label}: converged {res.converged}, f64 "
                                 f"relative residual {rel:.3e} (rtol {rtol})")
        if pinned is not None and res.sweeps != pinned:
            raise AssertionError(f"{label}: {res.sweeps} sweeps, pinned at "
                                 f"{pinned}")
        del op, b, res
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Kernels H and I
# ---------------------------------------------------------------------------

SQUARE_N, DRAWS = 1 << 22, 10          # kernel H's structureless pattern
RECT = (200_003, 150_001)              # and its rectangular one
LONG_ROW, LONG_LEN = 777, 50_000
# kernel I: (nbr, bs, width, n_out, n_in); the first has the block
# structure of the block-Jacobi solve's matrix, the second is the JAX
# benchmark's.  The ``kernels`` line takes its numbers from the pack that
# the solve's routing builds (``api_phase``)
I_SHAPES = [(4096, 64, 8, None, None), (256, 128, 8, None, None),
            (2048, 8, 5, None, None), (1024, 16, 12, None, None),
            (40, 32, 3, 40 * 32 - 7, 37 * 32 - 11)]


def rectangular_csr(np, sp):
    """A 200,003 x 150,001 matrix with about 8 entries a row, every 7th
    row empty, one row of 50,000 entries, and a 4 in every column (in the
    column's own non-empty row) so that it has full column rank."""
    m, n = RECT
    rng = np.random.default_rng(11)
    nnz = 8 * m
    rows = rng.integers(0, m, nnz)
    keep = rows % 7 != 3
    rows, cols = rows[keep], rng.integers(0, n, nnz)[keep]
    vals = rng.standard_normal(nnz)[keep] * 0.1
    long_cols = rng.choice(n, LONG_LEN, replace=False)
    own = np.flatnonzero(np.arange(m) % 7 != 3)[:n]
    rows = np.concatenate([rows, np.full(LONG_LEN, LONG_ROW), own])
    cols = np.concatenate([cols, long_cols, np.arange(n)])
    vals = np.concatenate([vals, rng.standard_normal(LONG_LEN) * 0.01,
                           np.full(n, 4.0)])
    A = sp.coo_matrix((vals, (rows, cols)), shape=RECT).tocsr()
    A.sum_duplicates()
    return A


def hard_patterns(np, sp, chunk: int):
    """Kernel H's hard patterns, (label, scipy CSR): one row of 20,000
    entries among 100,000 empty ones, a 2-row matrix whose rows run over
    several chunks, and 64 rows of exactly one chunk each."""
    rng = np.random.default_rng(12)

    def of(lengths, ncols):
        indptr = np.concatenate([[0], np.cumsum(lengths)])
        indices = np.concatenate([np.sort(rng.choice(ncols, n, replace=False))
                                  for n in lengths if n])
        return sp.csr_matrix((rng.standard_normal(len(indices)), indices,
                              indptr), shape=(len(lengths), ncols))

    one = np.zeros(100_000, np.int64)
    one[31_337] = 20_000
    return [("one non-empty row", of(one, 50_000)),
            ("two rows", of([3_001, 5_000], 10_000)),
            ("rows of one chunk", of([chunk] * 64, 100_000))]


def hold(torch, what, kernel, plain, dtype, terms) -> float:
    """Raise unless two launches of ``kernel`` give equal bits and agree
    with ``plain`` to the tolerance of ``kernel_phase_sparse``; return
    the largest absolute difference."""
    out, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{what}: two launches differ")
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{what}: got {out.dtype}{tuple(out.shape)}, "
                             f"expected {ref.dtype}{tuple(ref.shape)}")
    o, r = out.double(), ref.double()
    if not torch.isfinite(o).all():
        raise AssertionError(f"{what}: non-finite output")
    eps = 1e-6 if dtype == torch.float32 else 1e-12
    err = (o - r).abs()
    limit = 10 * eps * r.abs() + eps * terms ** 0.5 * float(r.abs().max())
    if (err > limit).any():
        i = int(torch.argmax((err - limit).reshape(-1)))
        raise AssertionError(
            f"{what}: {int((err > limit).sum())} values out of tolerance; "
            f"worst kernel {o.reshape(-1)[i].item()!r} plain "
            f"{r.reshape(-1)[i].item()!r}")
    return float(err.max())


def routed_case(torch, entry, what, kernel, plain, library, terms, n_bytes,
                flops) -> None:
    """Hold a kernel against its plain version on the very tensors a
    prepared solver routed to it (f32, one vector), time both and the
    library call there, and make these the kernel's numbers in the
    ``kernels`` line (``entry`` is its row of the report)."""
    e = hold(torch, what, kernel, plain, torch.float32, terms)
    entry["max_abs_err"] = max(entry["max_abs_err"], e)
    entry.update(ms=median_ms(torch, kernel), plain_ms=median_ms(torch, plain),
                 library_ms=library_ms(torch, library, what),
                 **bound(n_bytes, flops))
    device = graph_ms(torch, kernel)
    log(f"{what}: ok, max error {e:.2e}, kernel {entry['ms']:.3f} ms (device "
        f"{device:.4f} ms, {entry['bound_ms'] / device:.0%} of its bound), plain "
        f"{entry['plain_ms']:.3f} ms, library {entry['library_ms']}, bound "
        f"{entry['bound_ms']:.3f} ms ({entry['bound_by']})")


def kernel_phase_sparse(torch, dev):
    """Kernels H (``csr_mv``) and I (``bsr_mv``) against their plain
    versions, f32 and f64, for 1 and 4 vectors (H also 5, and on its hard
    patterns); two launches must agree in every bit.  Tolerance, f32: |kernel - plain| <= 1e-5 |plain| +
    1e-6 sqrt(terms) max|plain|, where ``terms`` is the longest row (H) or
    ``width * bs`` (I): the sums are taken in another order and with FMA,
    and the plain version of H adds with atomics.  f64: the same with
    1e-11 and 1e-12.  Returns the report (largest errors; the times of
    the ``kernels`` line come from the routed tensors of ``api_phase``),
    and the rectangular matrix for the API phase."""
    import numpy as np
    import scipy.sparse as sp

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import AIJ
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import bsr, csr
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.calibrate import (
        structureless_coo,
    )

    report = new_report("api")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def compare(name, what, kernel, plain, dtype, terms):
        e = hold(torch, f"{name} {what}", kernel, plain, dtype, terms)
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
        return e

    # --- kernel H
    t0 = time.perf_counter()
    rows, cols, vals = structureless_coo(SQUARE_N, DRAWS, 7)
    square = AIJ.from_coo(rows, cols, vals, (SQUARE_N, SQUARE_N),
                          dtype=torch.float64, device=dev)
    rect_host = rectangular_csr(np, sp)
    rc = rect_host.tocoo()
    rect = AIJ.from_coo(rc.row, rc.col, rc.data, RECT, dtype=torch.float64,
                        device=dev)
    hard = []
    for label, a in hard_patterns(np, sp, csr.CHUNK):
        c = a.tocoo()
        hard.append((label, AIJ.from_coo(c.row, c.col, c.data, a.shape,
                                         dtype=torch.float64, device=dev)))
    log(f"kernel H: patterns built in {time.perf_counter() - t0:.1f} s "
        f"(square {square.nnz} nonzeros, rectangular {rect.nnz}; "
        + ", ".join(f"{label} {op.nnz}" for label, op in hard) + ")")
    for label, op in [("square", square), ("rectangular", rect)] + hard:
        for dtype in (torch.float32, torch.float64):
            for tr in (False, True):
                ptr, idx, dat, part, nout, nin = (
                    (op.t_indptr, op.t_indices, op.t_data, op.t_partition,
                     op.ncols, op.nrows)
                    if tr else
                    (op.indptr, op.indices, op.data, op.partition, op.nrows,
                     op.ncols))
                dat = dat.to(dtype)
                longest = int((ptr[1:] - ptr[:-1]).max())
                for k in (1, 4, 5):
                    x = torch.randn((k, nin) if k > 1 else (nin,),
                                    generator=gen, device=dev, dtype=dtype)
                    what = (f"{label}{' transpose' if tr else ''} {dtype} "
                            f"k={k}")
                    e = compare(
                        "csr_mv", what,
                        lambda: csr.csr_mv(ptr, idx, dat, x, nout,
                                           partition=part),
                        lambda: csr.csr_mv_plain(ptr, idx, dat, x, nout),
                        dtype, longest)
                    ms = median_ms(torch,
                                   lambda: csr.csr_mv(ptr, idx, dat, x, nout,
                                                      partition=part))
                    least = bound(
                        nbytes(ptr, idx, dat)
                        + k * (nout + nin) * dat.element_size(),
                        2 * k * dat.numel())
                    log(f"csr_mv {what}: ok, max error {e:.2e}, kernel "
                        f"{ms:.3f} ms, bound {least['bound_ms']:.3f} ms, "
                        f"longest row {longest}")
                    if (dtype, tr, k) == (torch.float32, False, 1) and \
                            label in ("square", "rectangular"):
                        A_lib = torch.sparse_csr_tensor(ptr, idx, dat,
                                                        size=(nout, nin))
                        ms, spread = repeat_ms(
                            torch, lambda: csr.csr_mv(ptr, idx, dat, x, nout,
                                                      partition=part))
                        plain_ms = median_ms(
                            torch, lambda: csr.csr_mv_plain(ptr, idx, dat, x,
                                                            nout))
                        lib = library_ms(torch, lambda: A_lib @ x, "csr_mv")
                        log(f"csr_mv f32 {label}, {op.nnz} nonzeros: "
                            f"kernel {ms:.3f} ms (3 medians of 20, "
                            f"spread {spread:.1%}), plain {plain_ms:.3f} ms, "
                            f"library (torch.sparse_csr_tensor @ x) {lib}, "
                            f"bound {least['bound_ms']:.3f} ms")
                        del A_lib
                    del x
                del dat
    del square, rect, hard, rows, cols, vals
    torch.cuda.empty_cache()

    # --- kernel I
    rng = np.random.default_rng(0)
    for shape in I_SHAPES:
        nbr, bs, width, n_out, n_in = shape
        ncb = nbr if n_in is None else -(-n_in // bs)
        n_out = nbr * bs if n_out is None else n_out
        n_in = ncb * bs if n_in is None else n_in
        idx_np = np.stack([np.sort(rng.choice(ncb, size=width, replace=False))
                           for _ in range(nbr)]).astype(np.int32)
        idx = torch.from_numpy(idx_np).to(dev)
        for dtype in (torch.float32, torch.float64):
            val = torch.randn((nbr, width, bs, bs), generator=gen, device=dev,
                              dtype=dtype)
            for k in (1, 4):
                x = torch.randn((k, n_in) if k > 1 else (n_in,), generator=gen,
                                device=dev, dtype=dtype)
                what = f"{shape} {dtype} k={k}"
                e = compare("bsr_mv", what,
                            lambda: bsr.bsr_mv(idx, val, x, n_out, n_in),
                            lambda: bsr.bsr_mv_plain(idx, val, x, n_out, n_in),
                            dtype, width * bs)
                ms = median_ms(torch,
                               lambda: bsr.bsr_mv(idx, val, x, n_out, n_in))
                least = bound(nbytes(idx, val)
                              + k * (n_out + n_in) * val.element_size(),
                              2 * k * val.numel())
                lib = None
                if k == 1 and dtype == torch.float32 and shape in I_SHAPES[:2]:
                    # torch's BSR tensor holds the blocks untransposed
                    A_lib = torch.sparse_bsr_tensor(
                        torch.arange(0, nbr * width + 1, width, device=dev,
                                     dtype=torch.int32),
                        idx.reshape(-1),
                        val.reshape(-1, bs, bs).transpose(1, 2).contiguous(),
                        size=(nbr * bs, ncb * bs))
                    lib = library_ms(torch, lambda: A_lib @ x[:, None],
                                     f"bsr_mv {what}")
                    del A_lib
                plain_ms = median_ms(
                    torch, lambda: bsr.bsr_mv_plain(idx, val, x, n_out, n_in))
                log(f"bsr_mv {what}: ok, max error {e:.2e}, kernel {ms:.3f} "
                    f"ms, plain {plain_ms:.3f} ms, library (torch BSR tensor "
                    f"@ x) {lib}, bound {least['bound_ms']:.3f} ms")
                del x
            del val
        del idx
    torch.cuda.empty_cache()
    return report, {"rect": rect_host}


# ---------------------------------------------------------------------------
# Calibration phase
# ---------------------------------------------------------------------------

def calibration_phase(torch, dev, card) -> None:
    """Measure the routing constants of ``core/calibration.py`` on this
    card through ``utils/calibrate.measure_calibration`` (f32, per stored
    value and relative to ``DIA.mv`` on the 5-point matrix of a 4096^2
    grid; every time the median of 3 medians of 20 CUDA-event timings,
    with their spread).  Prints the constants as one JSON line beside the
    shipped table and saves them with ``calibration.save`` under
    ``build/``, a file that ``MEDANE_TORCH_CALIBRATION`` can name; the
    solves that follow route by the shipped table."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import (
        calibration,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import (
        calibrate,
    )

    cal = calibrate.measure_calibration(device=dev, log=log)
    cal["card"] = card
    print("calibration " + json.dumps(cal), flush=True)
    used = calibration.load()
    log(f"calibration: shipped table {calibration.SHIPPED}")
    path = calibration.save(cal, path=str(
        ROOT / "build" / "torch_kernels" / "calibration.json"))
    log(f"calibration: saved to {path}; the solves below route by "
        f"{used.get('source', 'the shipped table')}: "
        f"{ {k: used[k] for k in cal if k in used} }")


# ---------------------------------------------------------------------------
# API phase
# ---------------------------------------------------------------------------

def hold_native_pack(np, A, bs: int) -> None:
    """The BSR pack of the API's block-sparse matrix at block size ``bs``,
    once by the native counting-sort pack that ``prepare`` packs with
    (``native.bsr_pack``) and once by the plain scipy/numpy one
    (``core/operators._bsr_pack_plain``), each timed on the host: their
    indices and values must agree in every bit."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch import native
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
        _bsr_pack_plain,
    )

    c = A.tocoo()
    t0 = time.perf_counter()
    i_n, v_n = native.bsr_pack(c.row, c.col, c.data, A.shape, bs)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    i_p, v_p = _bsr_pack_plain(c.row, c.col, c.data, A.shape, bs)
    plain_s = time.perf_counter() - t0
    same = np.array_equal(i_n, i_p) and np.array_equal(v_n, v_p)
    log(f"BSR pack of {A.nnz} nonzeros at bs {bs}: native.bsr_pack "
        f"{native_s:.2f} s, _bsr_pack_plain {plain_s:.2f} s on the host, "
        f"bit-equal {same}")
    if not same:
        raise AssertionError("native.bsr_pack and _bsr_pack_plain differ")


def block_sparse_spd(np, sp, nb: int, bs: int, seed: int = 5):
    """A block-sparse SPD matrix: every diagonal block ``Q diag(1..100)
    Q^T`` with a random orthogonal Q, and two random off-diagonal blocks
    of size 0.01 a block row, mirrored; assembled as block COO."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((nb, bs, bs)))
    diag = (q * np.logspace(0, 2, bs)) @ q.transpose(0, 2, 1)
    diag = 0.5 * (diag + diag.transpose(0, 2, 1))      # symmetric in every bit
    picks = np.stack([rng.choice(nb, size=2, replace=False)
                      for _ in range(nb)])
    br = np.repeat(np.arange(nb), 2)
    bc = picks.reshape(-1)
    keep = br != bc
    # one block per unordered pair: a later draw of the same pair would
    # overwrite the earlier one in an assignment-built matrix
    lo, hi = np.minimum(br, bc)[keep], np.maximum(br, bc)[keep]
    _, first = np.unique(lo * nb + hi, return_index=True)
    lo, hi = lo[first], hi[first]
    off = 0.01 * rng.standard_normal((len(lo), bs, bs))
    blocks = np.concatenate([diag, off, off.transpose(0, 2, 1)])
    brow = np.concatenate([np.arange(nb), lo, hi])
    bcol = np.concatenate([np.arange(nb), hi, lo])
    ii, jj = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
    rows = (brow[:, None, None] * bs + ii).reshape(-1)
    cols = (bcol[:, None, None] * bs + jj).reshape(-1)
    n = nb * bs
    return sp.coo_matrix((blocks.reshape(-1), (rows, cols)),
                         shape=(n, n)).tocsr()


def api_phase(torch, port, dev, cases, report) -> dict:
    """The one-call API on scipy matrices in f32; returns the launches of
    ``csr_mv`` and ``bsr_mv`` summed over the counted solves.  Before the
    AIJ and the BSR solve are counted, kernels H and I are held against
    their plain versions, and timed, on the tensors that ``prepare``
    routed to them: these are the kernels' numbers in ``report``."""
    import numpy as np
    import scipy.sparse as sp

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import (
        calibration,
        poisson,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import bsr, build, csr
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.calibrate import (
        structureless_coo,
    )

    total = {"csr_mv": 0, "bsr_mv": 0}

    def counted(label, run, need):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        x, info = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = build.launch_counts()
        missing = [m for m in need if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        for m in total:
            total[m] += counts.get(m, 0)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        log(f"{label}: operator {info['operator']}, method {info['method']}, "
            f"pc {info.get('pc')}, iterations "
            f"{np.asarray(info['iters']).tolist()}, converged "
            f"{info['converged']}, rel residual "
            f"{np.asarray(info['rel_residual']).tolist()}")
        log(f"{label}: solve {solve_s * 1e3:.1f} ms, one timed run (first "
            f"run {first_s * 1e3:.1f} ms), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{counts}")
        if not np.isfinite(x).all():
            raise AssertionError(f"{label}: non-finite solution")
        info["solve_ms"] = solve_s * 1e3
        info["launches"] = counts
        return x, info

    def expect(label, info, operator, bound_, key="rel_residual", iters=None):
        """``iters``: the iteration count (a list for a panel) every earlier
        run of this solve took."""
        worst = float(np.max(info[key]))
        if info["operator"] != operator or not info["converged"] \
                or not worst <= bound_:
            raise AssertionError(
                f"{label}: operator {info['operator']} (expected {operator}),"
                f" converged {info['converged']}, {key} {worst:.3e} (bound "
                f"{bound_})")
        if iters is not None and np.asarray(info["iters"]).tolist() != iters:
            raise AssertionError(f"{label}: {info['iters']} iterations, "
                                 f"expected {iters}")

    # 1. AIJ: structureless symmetric, strictly diagonally dominant
    t0 = time.perf_counter()
    n = SQUARE_N
    r, c, v = structureless_coo(n, DRAWS, 1)
    B = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    A = ((B + B.T) * 0.5).tocsr()
    A = (A + sp.eye(n, format="csr")
         * (abs(A).sum(axis=1).max() + 1.0)).tocsr()
    del B, r, c, v
    b = np.asarray(A @ np.ones(n))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = port.prepare(A, method="gmres", pc="jacobi", rtol=1e-6)
    torch.cuda.synchronize()
    log(f"AIJ n=2^22, {A.nnz} nonzeros: matrix built in {build_s:.1f} s, "
        f"prepare (routing, CSR and its transpose check, Jacobi) "
        f"{time.perf_counter() - t0:.1f} s on the host")
    op = prep._op
    if type(op).__name__ != "AIJ":
        raise AssertionError(f"routed to {type(op).__name__}, expected AIJ")
    xk = torch.randn(n, device=dev)
    A_lib = torch.sparse_csr_tensor(op.indptr, op.indices, op.data,
                                    size=(n, n))
    routed_case(
        torch, report["csr_mv"],
        f"csr_mv on the solve's matrix (n=2^22, {op.nnz} nonzeros, "
        f"{csr.csr_blocks(op.nnz)} chunks) f32 k=1",
        lambda: csr.csr_mv(op.indptr, op.indices, op.data, xk, n, n,
                           partition=op.partition),
        lambda: csr.csr_mv_plain(op.indptr, op.indices, op.data, xk, n, n),
        lambda: A_lib @ xk,
        terms=int((op.indptr[1:] - op.indptr[:-1]).max()),
        n_bytes=nbytes(op.indptr, op.indices, op.data) + 2 * n * 4,
        flops=2 * op.nnz)
    # what the gathers alone cost: one 32-byte sector a nonzero
    gather_ms = median_ms(torch, lambda: torch.index_select(xk, 0, op.indices))
    log(f"csr_mv on the solve's matrix: the gathers alone (torch.index_select "
        f"of x at its {op.nnz} columns) {gather_ms:.3f} ms")
    del A_lib, xk, op
    label = "solve AIJ gmres+jacobi n=2^22"
    x, info = counted(label, lambda: prep.solve(b),
                      ("csr_mv", "mdot", "maxpy"))
    expect(label, info, "AIJ", 2e-6, iters=7)
    log(f"{label}: max|x-1| {np.abs(x - 1).max():.3e}")
    busy_share(torch, label + " (host f64 check included)",
               lambda: prep.solve(b), info["solve_ms"])
    rng = np.random.default_rng(2)
    panel = np.stack([b] + [np.asarray(A @ rng.standard_normal(n))
                            for _ in range(3)], axis=1)
    label = "prepared AIJ solve, 4 right-hand sides"
    x, info = counted(label, lambda: prep.solve(panel),
                      ("csr_mv", "mdot", "maxpy"))
    expect(label, info, "AIJ", 2e-6, iters=[7, 7, 7, 7])
    del prep, A, b, panel, x
    torch.cuda.empty_cache()

    # 2. BSR: block-sparse SPD, block-Jacobi
    t0 = time.perf_counter()
    A = block_sparse_spd(np, sp, 4096, 64)
    b = np.asarray(A @ np.ones(A.shape[0]))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = port.prepare(A, rtol=1e-5, pc="bjacobi", pc_block_size=64)
    torch.cuda.synchronize()
    log(f"BSR n={A.shape[0]}, {A.nnz} nonzeros: matrix built in "
        f"{build_s:.1f} s, prepare (routing, block pack, symmetry check, "
        f"block inverses) {time.perf_counter() - t0:.1f} s on the host")
    op = prep._op
    if type(op).__name__ != "BSR":
        raise AssertionError(f"routed to {type(op).__name__}, expected BSR")
    nbr, width = op.indices.shape
    bs, n = op.bs, A.shape[0]
    # 64 x 64 dense blocks pack with the same fill at 8, 16, 32 and 64, so
    # the table's cheapest of those per stored value is the size to expect
    penalty = calibration.bsr_bs_penalty()
    cheapest = min((8, 16, 32, 64), key=lambda b: penalty[b])
    log(f"BSR routed to block size {bs}, {nbr} block rows of width {width}, "
        f"fill {op.nnz / A.nnz:.2f}; penalties {penalty}")
    if bs != cheapest:
        raise AssertionError(f"routed to block size {bs}, the table's "
                             f"cheapest is {cheapest}")
    hold_native_pack(np, A, bs)
    xk = torch.randn(n, device=dev)
    # torch's BSR tensor holds the blocks untransposed
    A_lib = torch.sparse_bsr_tensor(
        torch.arange(0, nbr * width + 1, width, device=dev,
                     dtype=torch.int32),
        op.indices.reshape(-1),
        op.values.reshape(-1, bs, bs).transpose(1, 2).contiguous(),
        size=(nbr * bs, nbr * bs))
    routed_case(
        torch, report["bsr_mv"],
        f"bsr_mv on the solve's pack (nbr {nbr}, bs {bs}, width {width}) "
        f"f32 k=1",
        lambda: bsr.bsr_mv(op.indices, op.values, xk, n, n),
        lambda: bsr.bsr_mv_plain(op.indices, op.values, xk, n, n),
        lambda: A_lib @ xk[:, None],
        terms=width * bs,
        n_bytes=nbytes(op.indices, op.values) + 2 * n * 4,
        flops=2 * op.nnz)
    del A_lib, xk, op
    torch.cuda.empty_cache()
    label = f"solve BSR gmres+bjacobi 4096 blocks of 64, packed at bs {bs}"
    x, info = counted(label, lambda: prep.solve(b),
                      ("bsr_mv", "mdot", "maxpy"))
    expect(label, info, "BSR", 1.5e-5)
    if not info["iters"] < 10:
        raise AssertionError(f"{label}: {info['iters']} iterations")
    del prep, A, b, x
    torch.cuda.empty_cache()

    # 3. DIA: 2D Poisson 1024^2 as scipy CSR, one-shot solve
    rows, cols, vals, shape = poisson.poisson2d_coo(1024, 1024)
    A = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    b = np.asarray(A @ np.ones(shape[0]))
    label = "solve DIA cg+jacobi 1024^2 (set-up inside)"
    x, info = counted(
        label, lambda: port.solve(A, b, method="cg", pc="jacobi", rtol=1e-6,
                                  assume_a="pos"), ())
    # CG's recurrence residual meets rtol 1e-6 and ``converged`` reports
    # that; over ~1,500 iterations in f32 the true residual stays above it
    # (condition number ~4e5; measured 5.4e-5), so the host f64 residual
    # is held to 1e-4 only
    expect(label, info, "DIA", 1e-4)
    del A, b, x

    # 4. LSQR on the rectangular pattern, consistent right-hand side
    A = cases["rect"]
    b = np.asarray(A @ np.ones(A.shape[1]))
    label = "lstsq lsqr 200003x150001 (set-up inside)"
    x, info = counted(label, lambda: port.lstsq(A, b, method="lsqr",
                                                rtol=1e-6), ("csr_mv",))
    expect(label, info, "AIJ", 1e-5, key="rel_opt", iters=8)
    # every LSQR iteration takes one product with A and one with A^T
    if info["launches"]["csr_mv"] < 2 * info["iters"]:
        raise AssertionError(f"{label}: {info['launches']} launches in "
                             f"{info['iters']} iterations")
    log(f"{label}: rel_opt {info['rel_opt']:.3e}, max|x-1| "
        f"{np.abs(x - 1).max():.3e}")
    if total["csr_mv"] == 0 or total["bsr_mv"] == 0:
        raise AssertionError(f"API phase launches {total}")
    return total


# ---------------------------------------------------------------------------
# Stacked phase
# ---------------------------------------------------------------------------

STACKED_DIA_N = 1024          # the banded cell: 2D Poisson, n x n
STACKED_BSR = (4096, 64)      # the blockable cell: blocks and block size
STACKED_ELL_N = 1 << 20       # the structureless cell
STRIP2D = (4096, 4096)        # StencilStrip2D of this grid, 2 blocks
STRIP3D = (256, 512, 512)     # StencilStrip3D (rows, ny, nz)
STACKED_KERNELS = ("csr_mv", "bsr_mv", "mdot", "maxpy")


def structureless_spd(np, sp, n: int, seed: int = 1):
    """The API phase's structureless matrix: ``DRAWS`` random entries a
    row, symmetrized, made strictly diagonally dominant."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.calibrate import (
        structureless_coo,
    )

    r, c, v = structureless_coo(n, DRAWS, seed)
    B = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    A = ((B + B.T) * 0.5).tocsr()
    return (A + sp.eye(n, format="csr")
            * (abs(A).sum(axis=1).max() + 1.0)).tocsr()


def stacked_phase(torch, port, dev, card) -> None:
    """General sparse matrices in the multisplitting drivers, in f32: the
    banded, blockable and structureless cells, kernels H and I held and
    timed on the stacked shapes, and the strip operators.  Every line
    carries the card's name and power limit."""
    import warnings

    import numpy as np
    import scipy.sparse as sp

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import bsr, build, csr
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k

    def say(msg: str) -> None:
        log(f"{msg} [{card}]")

    def split_route(label, A, expect, dtype=torch.float32, warn=False):
        """``A`` block-split into 2 and routed; raises unless the router
        chose ``expect`` (and warned when ``warn``)."""
        t0 = time.perf_counter()
        coo = A.tocoo()
        a_ii, a_ic = port.block_split_ell(coo.row, coo.col, coo.data,
                                          A.shape, nblocks=2, dtype=dtype,
                                          device=dev)
        split_s = time.perf_counter() - t0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            op = port.as_stacked_routed_operator(
                port.StackedELLOperator(a_ii=a_ii, a_ic=a_ic))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        del a_ii, a_ic
        got = type(op).__name__
        warned = [w for w in caught if issubclass(w.category, UserWarning)]
        if got != expect or bool(warned) != warn:
            raise AssertionError(f"{label}: routed to {got} (expected "
                                 f"{expect}), warnings {warned}")
        if got == "StackedDIAOperator":
            shape = (f"DIA offsets {op.dia_ii.offsets} + coupling "
                     f"{op.dia_ic.offsets}")
        elif got == "StackedBSROperator":
            nb, nbr, w = op.ii_idx.shape
            stored = op.ii_val.numel() + op.ic.values.numel()
            shape = (f"c {op.c}, {nb} x {nbr} block rows of width {w}, "
                     f"coupling width {op.ic.indices.shape[1]}, fill "
                     f"{stored / A.nnz:.2f}")
        else:
            shape = (f"ELL widths {op.a_ii.indices.shape[-1]} + "
                     f"{op.a_ic.indices.shape[-1]}, fill "
                     f"{(op.a_ii.values.numel() + op.a_ic.values.numel()) / A.nnz:.2f}"
                     f"; warned: {str(warned[0].message)[:80]}")
        say(f"{label}: n={A.shape[0]}, {A.nnz} nonzeros; host set-up "
            f"{setup_s:.1f} s (split {split_s:.1f} s, route and pack "
            f"{setup_s - split_s:.1f} s): {got}, {shape}")
        return op

    def rel_f64(A, x, b) -> float:
        """||b - A x|| / ||b|| in f64 on the host against the matrix."""
        x64 = x.double().cpu().numpy().reshape(-1)
        b64 = b.double().cpu().numpy().reshape(-1)
        return float(np.linalg.norm(b64 - A @ x64) / np.linalg.norm(b64))

    def run(label, A, op, solve, rtol, need, dtype=torch.float32, reps=1,
            profile=False):
        """One counted solve of ``b = A·1`` (``need``: kernels that must
        have launched), then ``reps`` timed ones, and with ``profile`` one
        more under the profiler for the device-busy share; returns the
        result."""
        b = port.rhs_ones(op, dtype, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = solve(op, b)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        missing = [m for m in need if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(op, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rel = rel_f64(A, res.x, b)
        timing = (f"solve {statistics.median(times) * 1e3:.1f} ms median of "
                  f"{reps} {[round(t * 1e3, 1) for t in times]}"
                  if reps else "not timed")
        say(f"{label}: {res.sweeps} sweeps, {res.cycles} cycles, "
            f"{int(res.inner_iters)} inner iterations, {res.syncs} host "
            f"syncs, converged {res.converged}; f64 rel {rel:.3e} (rtol "
            f"{rtol}); {timing} (first run {first_s * 1e3:.1f} ms); peak "
            f"memory {peak / 2**30:.2f} GiB; launches "
            f"{ {m: counts.get(m, 0) for m in STACKED_KERNELS} }")
        if not res.converged or not rel <= rtol:
            raise AssertionError(f"{label}: converged {res.converged}, f64 "
                                 f"relative residual {rel:.3e} (rtol {rtol})")
        if profile:
            # the card's activity alone: recording the eager solve's host
            # operations took 50 s of the script's time for the DIA cell
            busy_share(torch, f"{label} [{card}]", lambda: solve(op, b),
                       statistics.median(times) * 1e3, host_ops=False)
        return res

    def kernel_case(what, kernel, plain, library, terms, n_bytes, flops):
        """Hold a kernel against its plain version (``kernel_phase_sparse``'s
        tolerance) and time it, the plain version and the library call."""
        err = hold(torch, what, kernel, plain, torch.float32, terms)
        ms, plain_ms = median_ms(torch, kernel), median_ms(torch, plain)
        lib = library_ms(torch, library, what)
        bnd = bound(n_bytes, flops)
        device = graph_ms(torch, kernel)
        say(f"{what}: ok, max error {err:.2e}, kernel {ms:.3f} ms (device "
            f"{device:.4f} ms, {100 * bnd['bound_ms'] / device:.0f}% of its "
            f"bound), plain "
            f"{plain_ms:.3f} ms, library {lib if lib is None else round(lib, 3)}"
            f" ms, bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']}), "
            f"{100 * bnd['bound_ms'] / ms:.0f}% of it")

    def bsr_case(what, indices, values, n):
        nbr, width = indices.shape
        c = values.shape[-1]
        x = torch.randn(n, device=dev)
        # torch's BSR tensor holds the blocks untransposed
        lib = torch.sparse_bsr_tensor(
            torch.arange(0, nbr * width + 1, width, device=dev,
                         dtype=torch.int32), indices.reshape(-1),
            values.reshape(-1, c, c).transpose(1, 2).contiguous(),
            size=(nbr * c, -(-n // c) * c))
        xl = torch.nn.functional.pad(x, (0, lib.shape[1] - n))[:, None]
        kernel_case(f"bsr_mv on {what} ({nbr} block rows, c {c}, width "
                    f"{width}) f32 k=1",
                    lambda: bsr.bsr_mv(indices, values, x, n, n),
                    lambda: bsr.bsr_mv_plain(indices, values, x, n, n),
                    lambda: lib @ xl, width * c,
                    nbytes(indices, values) + 2 * n * 4, 2 * values.numel())

    def csr_case(what, m):
        x = torch.randn(m.ncols, device=dev)
        lib = torch.sparse_csr_tensor(m.indptr, m.indices, m.data,
                                      size=m.shape)
        kernel_case(f"csr_mv on {what} ({m.nrows} rows, {m.nnz} nonzeros, "
                    f"{csr.csr_blocks(m.nnz)} chunks) f32 k=1",
                    lambda: csr.csr_mv(m.indptr, m.indices, m.data, x,
                                       m.nrows, m.ncols,
                                       partition=m.partition),
                    lambda: csr.csr_mv_plain(m.indptr, m.indices, m.data, x,
                                             m.nrows, m.ncols),
                    lambda: lib @ x,
                    int((m.indptr[1:] - m.indptr[:-1]).max()),
                    nbytes(m.indptr, m.indices, m.data) + 2 * m.nrows * 4,
                    2 * m.nnz)

    # 1. banded -> DIA: the 2D Poisson matrix, beside the stencil strips
    n = STACKED_DIA_N
    rows, cols, vals, shape = poisson.poisson2d_coo(n, n)
    A = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    del rows, cols, vals
    glob = lambda op, b: port.smsm(op, b, scope="global", s=4,  # noqa: E731
                                   rtol=1e-3, maxiter=2000)
    sweeps = {}
    for dtype, reps in ((torch.float64, 0), (torch.float32, 3)):
        name = str(dtype).split(".")[-1]
        op = split_route(f"DIA cell {n}^2 {name}", A, "StackedDIAOperator",
                         dtype)
        st = port.block_poisson2d(n, n)
        sweeps[name] = (
            run(f"SMSM_GLOBAL {n}^2 {name} on StackedDIAOperator", A, op,
                glob, 1e-3, ("mdot", "maxpy"), dtype, reps,
                profile=bool(reps)).sweeps,
            run(f"SMSM_GLOBAL {n}^2 {name} on the stencil strips", A, st,
                glob, 1e-3, ("stencil2d_apply[mv]", "mdot", "maxpy"), dtype,
                reps).sweeps)
    say(f"SMSM_GLOBAL {n}^2 sweeps, DIA route / stencil: f64 "
        f"{sweeps['float64']}, f32 {sweeps['float32']}")
    if abs(sweeps["float64"][0] - sweeps["float64"][1]) > 2:
        raise AssertionError(f"DIA route f64: {sweeps['float64']} sweeps, "
                             f"more than 2 apart")
    run(f"SMSM_GLOBAL {n}^2 f32 on StackedDIAOperator, inner "
        f"pc='bjacobi' (64)", A, op,
        lambda op, b: port.smsm(op, b, scope="global", s=4, rtol=1e-3,
                                maxiter=2000, inner=port.InnerConfig(
                                    pc="bjacobi", pc_block_size=64)),
        1e-3, ("mdot", "maxpy"))
    del op, st, A
    torch.cuda.empty_cache()

    # 2. blockable -> BSR: the API phase's block-sparse matrix
    t0 = time.perf_counter()
    A = block_sparse_spd(np, sp, *STACKED_BSR)
    say(f"BSR cell: matrix built in {time.perf_counter() - t0:.1f} s")
    op = split_route(f"BSR cell {STACKED_BSR[0]} blocks of "
                     f"{STACKED_BSR[1]}", A, "StackedBSROperator")
    nb, nbr, w = op.ii_idx.shape
    bsr_case("the block-diagonal pack", op.merged_idx,
             op.ii_val.reshape((nb * nbr,) + op.ii_val.shape[2:]),
             nb * nbr * op.c)
    bsr_case("the coupling", op.ic.indices, op.ic.values, A.shape[0])
    bj = port.InnerConfig(pc="bjacobi", pc_block_size=64)
    # rtol 1e-5, as the API phase's solve of this matrix: f32 sums of its
    # rows stall the residual just above 1e-6 (printed below)
    run("SM on StackedBSROperator, inner gmres + pc='bjacobi' (64)", A, op,
        lambda op, b: port.sm(op, b, rtol=1e-5, maxiter=200, inner=bj),
        1e-5, ("bsr_mv", "mdot", "maxpy"), profile=True)
    b = port.rhs_ones(op, torch.float32, dev)
    probe = port.sm(op, b, rtol=1e-6, maxiter=40, inner=bj)
    say(f"SM on StackedBSROperator at rtol 1e-6: {probe.sweeps} sweeps, "
        f"converged {probe.converged}, f32 rel "
        f"{float(probe.rnorm / probe.rnorm0):.3e}, f64 rel "
        f"{rel_f64(A, probe.x, b):.3e}")
    del op, A, b, probe
    torch.cuda.empty_cache()

    # 3. structureless -> stays ELL, on kernel H
    t0 = time.perf_counter()
    A = structureless_spd(np, sp, STACKED_ELL_N)
    say(f"ELL cell: matrix built in {time.perf_counter() - t0:.1f} s")
    op = split_route(f"ELL cell n=2^{STACKED_ELL_N.bit_length() - 1}", A,
                     "StackedELLOperator", warn=True)
    csr_case("the block-diagonal CSR", op.csr_ii)
    csr_case("the coupling CSR", op.csr_ic)
    run("SM on StackedELLOperator, inner gmres + pc='jacobi'", A, op,
        lambda op, b: port.sm(op, b, rtol=1e-6, maxiter=200,
                              inner=port.InnerConfig(pc="jacobi")),
        1e-6, ("csr_mv", "mdot", "maxpy"), profile=True)
    del op, A
    torch.cuda.empty_cache()

    # 4. the strip operators
    build.reset_launch_counts()
    st = port.block_poisson2d(*STRIP2D)
    strip = port.strip2d(*STRIP2D)
    x = torch.randn((2, st.block_size), device=dev)
    full = st.full_mv(x)
    top, bottom = st.halos(x)
    for i in range(2):
        e = check(torch, f"StencilStrip2D{(strip.rows, strip.n)}.mv_full, "
                  f"strip {i}", strip.mv_full(x[i], top[i], bottom[i]),
                  full[i], "f32")
    s3 = port.StencilStrip3D(*STRIP3D)
    x3 = torch.randn(s3.shape[0], device=dev)
    e3 = check(torch, f"StencilStrip3D{STRIP3D}.mv", s3.mv(x3),
               k.stencil3d_apply_plain(x3.reshape(STRIP3D), kind="mv",
                                       diag=s3.diag, off=s3.off).reshape(-1),
               "f32")
    say(f"strip operators: ok (2D mv_full max error {e:.2e}, 3D mv "
        f"{e3:.2e}); launches {build.launch_counts()}")


def replay_share(torch, label: str, program, res, solve_ms: float) -> None:
    """The device-busy share of a warm graphed solve read from its graphs:
    each graph's replay timed alone with CUDA events (median of 5; no host
    time falls inside a replay), times its replays in the solve (one an
    iteration, one a pass), over the wall time.  The head of the solve (a
    few launches) is left out.  Replays after the solve overwrite the
    program's state, which the next solve sets anew."""
    per = {}
    for name, g in program.steps.graphs.items():
        ms = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        per[name] = statistics.median(ms)
    count = {"iteration": sum(res.pcg_iters), "tail": res.passes}
    device_ms = sum(per[n] * count[n] for n in per)
    log(f"{label}: device busy from the replays' events {device_ms:.1f} ms of "
        f"a {solve_ms:.1f} ms solve = {device_ms / solve_ms:.1%} (a replay: "
        + ", ".join(f"{n} {ms:.3f} ms x {count[n]}" for n, ms in per.items())
        + ")")


def busy_share(torch, label: str, run, solve_ms: float,
               host_ops: bool = True) -> None:
    """The share of a warm solve's wall time (``solve_ms``, taken without
    the profiler) in which the card ran a kernel: the device time of one
    more solve under ``torch.profiler``, summed by kernel.  ``host_ops``
    False records the card's activity alone (a solve of a million host
    operations costs minutes to record and sum with them)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    if device_ms == 0:
        log(f"{label}: profiler saw no device time: busy share not measured")
        return
    log(f"{label}: device busy {device_ms:.1f} ms of a {solve_ms:.1f} ms "
        f"solve = {device_ms / solve_ms:.1%} "
        f"(the profiled solve took {wall_ms:.1f} ms); top: "
        + "; ".join(f"{k[:48]} {ms:.1f} ms" for k, ms in rows[:6]))



# ---------------------------------------------------------------------------
# Async phase
# ---------------------------------------------------------------------------

def async_phase(torch, port, dev, card) -> None:
    """The genuinely asynchronous execution, all in f32 on 2D 1024^2 in 2
    blocks at rtol 1e-3 with the default inner GMRES(30), maxiter 20 (the
    reference's default experiment).  ``host_async_solve`` AM and
    AMAM_GLOBAL (s=4), one thread and one CUDA stream a block: each run
    must converge and be certified with the f64 relative residual under
    1e-3; each is run and timed once, that run counted (kernels E [mv], F
    and G, and E [spmm] for AMAM_GLOBAL, must launch): a run takes 20-75 s
    and the script's time limit is shared by every phase.  The busy share is read on a
    window of 10 sweeps a block, timed alone and then under the profiler
    (a whole run records ~10^5 kernels and takes minutes to sum).
    ``staged_multisplit_solve`` SMSM_GLOBAL must equal ``smsm`` in sweeps,
    x and history to the bit; its four stage shares are printed.
    ``launch_net_async`` with 2 processes on the card (each its own CUDA
    context): AM under the Alg-5.15 protocol on the native and on the
    Python router, then the bulk-synchronous schedule (SM over TCP);
    every rank must be certified and the merged x's f64 relative residual
    under 1e-3.  (The sync schedule with the global minimization is not
    run: it certifies in neither package at these sizes, PERF.md §6.)"""
    import numpy as np

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import (
        PhaseTimer,
    )

    rtol = 1e-3
    op = port.block_poisson2d(1024, 1024)
    b = port.rhs_ones(op, torch.float32, dev)
    need = ("stencil2d_apply[mv]", "mdot", "maxpy")
    for label, kw, kernels, runs in (
            ("host_async AM", {}, need, 1),
            ("host_async AMAM_GLOBAL s=4", {"minimization": "global", "s": 4},
             need + ("stencil2d_apply[spmm]",), 1)):
        def run(maxiter=4000):
            return port.host_async_solve(op, b, rtol=rtol, maxiter=maxiter,
                                         **kw)

        times = []
        for i in range(runs):
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                counts = build.launch_counts()
            rel = residual_f64(torch, op, res.x, b)
            log(f"{label} run {i}: converged {res.converged}, certified "
                f"{res.certified}, tail rounds {res.tail_rounds}, sweeps per "
                f"block {res.sweeps_per_block} (the emulated am, thesis "
                f"phase: 280), f32 rel {res.rnorm / res.rnorm0:.3e}, f64 rel "
                f"{rel:.3e}, {times[-1]:.2f} s (threads {res.elapsed_s:.2f} s)")
            if not (res.converged and res.certified) or not rel <= rtol:
                raise AssertionError(f"{label}: converged {res.converged}, "
                                     f"certified {res.certified}, rel {rel}")
        missing = [m for m in kernels if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        log(f"{label} [{card}]: wall {statistics.median(times):.2f} s, median "
            f"of {runs} {[round(t, 2) for t in times]} s; launches of the "
            f"first run {counts}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(maxiter=10)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
        busy_share(torch, f"{label}, 10 sweeps a block [{card}]",
                   lambda: run(maxiter=10), window_ms, host_ops=False)

    pt = PhaseTimer()
    t0 = time.perf_counter()
    st = port.staged_multisplit_solve(op, b, minimization="global", s=4,
                                      rtol=rtol, maxiter=2000, timer=pt)
    staged_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = port.smsm(op, b, scope="global", s=4, rtol=rtol, maxiter=2000,
                    record_history=True)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    same = (st.sweeps == ref.sweeps and torch.equal(st.x, ref.x)
            and torch.equal(st.history, ref.history[:st.cycles]))
    total = sum(t for _, t, _ in pt.items())
    log(f"staged SMSM_GLOBAL 1024^2 [{card}]: {st.sweeps} sweeps ({ref.sweeps}"
        f" unstaged), x and history bit-equal {same}; {staged_s:.2f} s "
        f"staged, {ref_s:.2f} s unstaged; stages: "
        + "; ".join(f"{name} {t:.3f} s in {c} calls ({t / total:.1%})"
                    for name, t, c in pt.items()))
    if not same:
        raise AssertionError("staged_multisplit_solve differs from smsm")

    for label, kw in (
            ("net_async AM protocol, native router", {"transport": "native"}),
            ("net_async AM protocol, Python router", {"transport": "python"}),
            ("net_async sync (SM over TCP)", {"schedule": "sync"})):
        t0 = time.perf_counter()
        ranks = port.launch_net_async(nblocks=2, m=1024, n=1024, rtol=rtol,
                                      maxiter=4000, dtype="float32",
                                      timeout_s=300, device="cuda", **kw)
        wall = time.perf_counter() - t0
        ranks = sorted(ranks, key=lambda r: r["rank"])
        blobs = [json.dumps(r) for r in ranks]
        t0 = time.perf_counter()
        for blob in blobs:
            json.loads(blob)
        parse_s = time.perf_counter() - t0
        x = torch.from_numpy(np.stack([np.asarray(r["x_block"], np.float32)
                                       for r in ranks])).to(dev)
        rel = residual_f64(torch, op, x, b)
        solve_s = max(r["elapsed_s"] for r in ranks)
        log(f"{label} [{card}]: " + "; ".join(
            f"rank {r['rank']} {r['sweeps']} sweeps, certified "
            f"{r['certified']}, tail rounds {r['tail_rounds']}, phase tag "
            f"{r['phase_tag']}, elapsed_s {r['elapsed_s']}" for r in ranks)
            + f"; f64 rel {rel:.3e}; launch {wall:.2f} s, of which start-up, "
            f"transport and result lines {wall - solve_s:.2f} s (parsing the "
            f"{sum(len(s) for s in blobs) / 1e6:.1f} MB of JSON again takes "
            f"{parse_s:.2f} s)")
        if not all(r["certified"] for r in ranks) or not rel <= rtol:
            raise AssertionError(f"{label}: certified "
                                 f"{[r['certified'] for r in ranks]}, rel {rel}")


# ---------------------------------------------------------------------------
# Sharded phase
# ---------------------------------------------------------------------------

SHARD_MESH = (2, 4)                     # ('block', 'intra'), 'local'
# the stacks of kernel A's tiles on that mesh: 64^3 and 256^3 in 8 shards
SHARD_STACKS = ((8, 8, 64, 64), (8, 32, 256, 256))
SHARD_BSR = (32768, 32)                 # kernel I's sharded pack: n, block


def sharded_counted(torch, build, label, run, need, reps: int = 1):
    """Run ``run`` once counted (counts set to 0 just before, read just
    after; every kernel of ``need`` must have launched), then ``reps``
    more times for the wall time.  Returns ``(result, counts, median s,
    first s)``."""
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = build.launch_counts()
    missing = [m for m in need if counts.get(m, 0) == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return res, counts, (statistics.median(times) if times else first), first


def shard_stack_case(torch, k, card, kind, x, b) -> None:
    """Kernel A's kind on a stack of shard tiles in one launch: held against
    its plain version and, bit for bit, the loop of one-tile launches
    (``hold_stack``); then timed in turns (stack, loop, conv3d, conv3d,
    loop, stack) one call at a time with events and, replayed in a CUDA
    graph, on the device alone, beside the bound; ``conv3d`` over the stack
    as a batch computes ``mv``, and no one call computes ``jacobi``."""
    torch.backends.cudnn.allow_tf32 = False     # the yardstick in full f32
    shape = tuple(x.shape)
    err = hold_stack(torch, k, kind, x, b, torch.float32, "f32",
                     f"sharded {kind} {shape}")
    rhs = kind == "jacobi"
    least = bound((3 if rhs else 2) * nbytes(x), (16 if rhs else 13) * x.numel())
    calls = {"stack": lambda: stack_apply(k, kind, x, b, torch.float32),
             "loop": lambda: stack_loop(torch, k, kind, x, b, torch.float32)}
    if not rhs:
        calls["conv3d"] = stencil_conv(torch, x, DIAG, OFF)
    order = list(calls) + list(reversed(calls))
    times = {name: [] for name in calls}
    for name in order:
        if name not in calls:
            continue
        if name == "conv3d":    # the library call: events, and no graph
            lib = library_ms(torch, calls[name], f"conv3d {shape}")
            if lib is None:
                del calls[name], times[name]
                continue
            times[name].append((lib, lib))
        else:
            times[name].append((median_ms(torch, calls[name]),
                                graph_ms(torch, calls[name])))
    mid = {name: (statistics.median(e for e, _ in t),
                  statistics.median(d for _, d in t))
           for name, t in times.items()}
    dev_ms = mid["stack"][1]
    log(f"sharded kernel stencil3d_apply[{kind}] stack {shape} [{card}]: max "
        f"abs err {err:.3e}, bits equal to a launch a tile; one launch "
        f"{mid['stack'][0]:.4f} ms (device {dev_ms:.4f} ms, "
        f"{least['bound_ms'] / dev_ms:.0%} of its bound); a launch a tile "
        f"{mid['loop'][0]:.4f} ms (device {mid['loop'][1]:.4f} ms); conv3d "
        + (f"{mid['conv3d'][0]:.4f} ms" if "conv3d" in mid else "none")
        + f"; bound {least['bound_ms']:.4f} ms ({least['bound_by']}); each "
        f"(events, device) in turns {times}")


def shard_kernels(torch, dev, card, aij, bsr_op) -> None:
    """Every kernel of the sharded paths against its plain version at the
    shard-stack shapes of the runs below, each timed beside its plain
    version, its bound and, where one PyTorch call computes the same
    function, that call (``conv2d``/``conv3d``, ``bmm``, ``baddbmm``, the
    sparse CSR and BSR products)."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import coarse, csr
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import bsr as bk
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import fused
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d as e
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
        chebyshev_coefficients,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.multigrid import (
        _dirichlet_bounds,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(10)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dtype)

    def held(name, shape, kernel, plain, tol, least, dot_floor=0.0,
             library=None):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if isinstance(out, tuple):
            out, ref = out[0], ref[0]
        err = check(torch, f"sharded {name} {shape}", out, ref, tol,
                    dot_floor)
        ms, pms = median_ms(torch, kernel), median_ms(torch, plain)
        lib = (None if library is None
               else library_ms(torch, library, f"sharded {name} {shape}"))
        log(f"sharded kernel {name} {shape} [{card}]: max abs err {err:.3e}; "
            f"{ms:.4f} ms, plain {pms:.4f} ms, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{least['bound_ms']:.4f} ms ({least['bound_by']})")

    # kernel E: the 4096^2 strips' shard stack, its s=4 panel, the 1024^2
    # f64 shards
    for shape, dtype, panel, name in (
            ((8, 512, 4096), torch.float32, False, "stencil2d_apply[mv]"),
            ((32, 512, 4096), torch.float32, True, "stencil2d_apply[spmm]"),
            ((8, 128, 1024), torch.float64, False, "stencil2d_apply[mv]")):
        x = rnd(shape, dtype)
        held(name, f"{dtype} {shape}",
             lambda: e.stencil2d_apply(x, diag=4.0, off=-1.0, panel=panel),
             lambda: e.stencil2d_apply_plain(x, diag=4.0, off=-1.0), "bits",
             bound(2 * nbytes(x), 9 * x.numel()),
             library=stencil_conv(torch, x, 4.0, -1.0))
    # kernel A: the stacks of the 8 tiles of the 64^3 and 256^3 shards,
    # kinds mv and jacobi
    for shape in SHARD_STACKS:
        x, b = rnd(shape), rnd(shape)
        for kind in ("mv", "jacobi"):
            shard_stack_case(torch, k, card, kind, x, b)
        del x, b
    # kernels B, C, M on the 256^3 plan's gathered coarse grid (8^3 -> 4^3)
    x, b, ec = rnd((8, 8, 8)), rnd((8, 8, 8)), rnd((4, 4, 4))
    held("stencil3d_residual_restrict", (8, 8, 8),
         lambda: k.stencil3d_residual_restrict(x, b, diag=DIAG, off=OFF,
                                               scale=4.0),
         lambda: k.stencil3d_residual_restrict_plain(x, b, diag=DIAG, off=OFF,
                                                     scale=4.0), "bits",
         bound(2 * nbytes(x) + nbytes(ec), 16 * x.numel()))
    held("stencil3d_prolong_jacobi", (8, 8, 8),
         lambda: k.stencil3d_prolong_jacobi(x, b, ec, diag=DIAG, off=OFF,
                                            omega=OMEGA),
         lambda: k.stencil3d_prolong_jacobi_plain(x, b, ec, diag=DIAG,
                                                  off=OFF, omega=OMEGA),
         "f32", bound(3 * nbytes(x) + nbytes(ec), 17 * x.numel()))
    coefs = chebyshev_coefficients(*_dirichlet_bounds((4, 4, 4), DIAG, OFF),
                                   COARSE_ITERS, torch.float32)
    held("stencil3d_chebyshev", (4, 4, 4),
         lambda: coarse.chebyshev_coarse(ec, dims=(4, 4, 4), diag=DIAG,
                                         off=OFF, coefs=coefs),
         lambda: coarse.chebyshev_coarse_plain(ec, dims=(4, 4, 4), diag=DIAG,
                                               off=OFF, coefs=coefs), "bits",
         bound(2 * nbytes(ec), COARSE_ITERS * 17 * ec.numel()))
    # kernels F, G: the 4096^2 shards' GMRES(30) basis at maxiter 20
    V, w, a = rnd((8, 21, 1 << 21)), rnd((8, 1 << 21)), rnd((8, 21))
    norms = (torch.linalg.vector_norm(V.double(), dim=-1)
             * torch.linalg.vector_norm(w.double(), dim=-1)[:, None])
    held("mdot", tuple(V.shape), lambda: fused.mdot(V, w, 21),
         lambda: fused.mdot_plain(V, w, 21), "dot",
         bound(nbytes(V, w), 2 * V.numel()), 1e-6 * norms,
         library=lambda: torch.bmm(V, w[:, :, None]))
    held("maxpy", tuple(V.shape), lambda: fused.maxpy(V, a, w, 21),
         lambda: fused.maxpy_plain(V, a, w, 21), "f32",
         bound(nbytes(V, w) + nbytes(w), 2 * V.numel()),
         library=lambda: torch.baddbmm(w[:, None, :], a[:, None, :], V))
    # kernel H: the 8 row strips of the n = 2^22 matrix (one launch over
    # the process's strips) against the gathered x
    ip, ix, dv, part = aij.rows(0, aij.ndev)
    xa = rnd((aij.n,))
    a_lib = torch.sparse_csr_tensor(ip, ix, dv, size=(aij.n, aij.n))
    held("csr_mv", f"{aij.n} rows, {dv.numel()} nonzeros",
         lambda: csr.csr_mv(ip, ix, dv, xa, aij.n, aij.n, partition=part),
         lambda: csr.csr_mv_plain(ip, ix, dv, xa, aij.n, aij.n), "f32",
         bound(nbytes(ip, ix, dv, xa, xa), 2 * dv.numel()),
         library=lambda: a_lib @ xa)
    del a_lib
    # kernel I: the block-ELL strips of the sharded general solve
    idx = bsr_op.idx.reshape(-1, bsr_op.idx.shape[-1]).contiguous()
    val = bsr_op.val.reshape(-1, *bsr_op.val.shape[2:]).contiguous()
    xb = rnd((bsr_op.n,))
    nbr, width, c = idx.shape[0], idx.shape[1], val.shape[-1]
    # torch's BSR tensor holds the blocks untransposed; a padded slot is a
    # zero block
    b_lib = torch.sparse_bsr_tensor(
        torch.arange(0, nbr * width + 1, width, device=dev,
                     dtype=torch.int32), idx.reshape(-1),
        val.reshape(-1, c, c).transpose(1, 2).contiguous(),
        size=(nbr * c, bsr_op.n))
    held("bsr_mv", f"{tuple(val.shape)}",
         lambda: bk.bsr_mv(idx, val, xb, bsr_op.n, bsr_op.n),
         lambda: bk.bsr_mv_plain(idx, val, xb, bsr_op.n, bsr_op.n), "f32",
         bound(nbytes(idx, val, xb, xb), 2 * val.numel()),
         library=lambda: b_lib @ xb[:, None])
    del b_lib


def sharded_bsr_matrix(np, sp):
    """A block-sparse SPD matrix of ``SHARD_BSR`` (n, block): each block
    row a dominant diagonal block and one coupling block, symmetrized."""
    n, c = SHARD_BSR
    nbr = n // c
    rng = np.random.default_rng(21)
    rows, cols = [], []
    for off in (0, 37):
        br = np.arange(nbr)
        bc = (br + off) % nbr
        i, j = np.meshgrid(np.arange(c), np.arange(c), indexing="ij")
        rows.append((br[:, None] * c + i.reshape(1, -1)).reshape(-1))
        cols.append((bc[:, None] * c + j.reshape(1, -1)).reshape(-1))
    r, cc = np.concatenate(rows), np.concatenate(cols)
    B = sp.coo_matrix((rng.standard_normal(len(r)) * 0.1, (r, cc)),
                      shape=(n, n)).tocsr()
    A = (B + B.T).tocsr()
    return (A + sp.eye(n, format="csr") * (abs(A).sum(axis=1).max() + 1.0)
            ).tocsr()


def sharded_phase(torch, port, dev, card) -> None:
    """The distribution layer on the card, every shard of a ``(2, 4)``
    ``'local'`` mesh in this process.  First every kernel of the sharded
    paths is held against its plain version at the shard-stack shapes
    (``shard_kernels``).  Then, each run counted once (the kernels its
    path needs must launch) and timed: SMSM_GLOBAL 2D 4096^2 (s=4, rtol
    1e-3, GMRES(30) maxiter 20, f32) beside the stacked ``smsm``, with the
    busy share; the same at 1024^2 in f64 with sweeps equal to the stacked
    solve's; AM 1024^2 staleness 2; ``sharded_gmres_solve`` (f32) and
    ``sharded_ca_gmres_solve`` (s=16, f64) on 3D 64^3; the sharded north-star
    ``sharded_df_northstar_fused`` on 256^3 beside the single-device
    ``df_northstar_fused`` (f64 rel <= 1e-8 in <= 3 passes);
    ``tiled_multisplit_solve`` SMSM_GLOBAL 2D 4096^2 on ``(2, 2, 2)``;
    ``sharded_aij_solve`` (CG) on the API phase's structureless n = 2^22
    matrix (kernel H on the 8 row strips); ``sharded_general_solve`` (CG +
    block-Jacobi) on a block-sparse matrix (kernel I);
    ``measure_collective_latency`` on the local mesh; 2 ``'dist'`` ranks
    on the card over gloo (``utils.multihost.launch``), SM 2D 1024^2 f64
    with sweeps equal to the local mesh's, the start-up time apart and the
    gloo ring latency; and ``dryrun_multichip(8)`` on the card."""
    import numpy as np
    import scipy.sparse as sp

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
        measure_collective_latency,
        shard_aij_from_scipy,
        shard_bjacobi_from_coo,
        shard_general_from_coo,
        sharded_aij_solve,
        sharded_ca_gmres_solve,
        sharded_general_solve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import multihost

    mesh = port.make_mesh(*SHARD_MESH, device=dev)
    t0 = time.perf_counter()
    A = structureless_spd(np, sp, SQUARE_N)
    aij = shard_aij_from_scipy(A, mesh.size, dtype=torch.float32, device=dev)
    Bm = sharded_bsr_matrix(np, sp)
    coo = Bm.tocoo()
    n_b, c_b = SHARD_BSR
    bsr_op = shard_general_from_coo(coo.row, coo.col, coo.data, n_b,
                                    mesh.size, c=c_b, dtype=torch.float32,
                                    device=dev)
    bsr_pc = shard_bjacobi_from_coo(coo.row, coo.col, coo.data, n_b,
                                    mesh.size, bs=c_b, dtype=torch.float32,
                                    device=dev)
    log(f"sharded: matrices built in {time.perf_counter() - t0:.1f} s "
        f"(n = 2^22 structureless, {A.nnz} nonzeros; block-sparse n = {n_b}, "
        f"blocks of {c_b}, {Bm.nnz} nonzeros)")
    shard_kernels(torch, dev, card, aij, bsr_op)

    e_need = ("stencil2d_apply[mv]", "stencil2d_apply[spmm]", "mdot", "maxpy")
    sm_need = ("stencil2d_apply[mv]", "mdot", "maxpy")
    for n, dtype in ((4096, torch.float32), (1024, torch.float64)):
        op = port.block_poisson2d(n, n)
        b = port.rhs_ones(op, dtype, dev)
        cfg = port.ShardedPoisson2D(n, n)
        label = f"SMSM_GLOBAL 2D {n}^2 {dtype}"
        sh, counts, wall, first = sharded_counted(
            torch, build, f"sharded {label}",
            lambda: port.sharded_multisplit_solve(
                mesh, cfg, b.reshape(n, n), minimization="global", s=4,
                rtol=1e-3, maxiter=2000), e_need, reps=2)
        st, _, st_wall, _ = sharded_counted(
            torch, build, f"stacked {label}",
            lambda: port.smsm(op, b, scope="global", s=4, rtol=1e-3,
                              maxiter=2000), e_need, reps=2)
        rel = residual_f64(torch, cfg, sh.x, b)
        log(f"sharded {label} mesh {SHARD_MESH} [{card}]: {sh.sweeps} sweeps "
            f"({st.sweeps} stacked), {sh.cycles} cycles, converged "
            f"{sh.converged}, f64 rel {rel:.3e}; wall {wall * 1e3:.1f} ms "
            f"(first {first * 1e3:.1f} ms), stacked {st_wall * 1e3:.1f} ms; "
            f"launches {counts}")
        if not (sh.converged and rel <= 1e-3 * 1.5):
            raise AssertionError(f"sharded {label}: converged "
                                 f"{sh.converged}, rel {rel}")
        if dtype == torch.float64 and sh.sweeps != st.sweeps:
            raise AssertionError(f"sharded {label}: {sh.sweeps} sweeps, "
                                 f"stacked {st.sweeps}")
        if n == 4096:
            busy_share(torch, f"sharded {label} [{card}]", lambda: (
                port.sharded_multisplit_solve(
                    mesh, cfg, b.reshape(n, n), minimization="global", s=4,
                    rtol=1e-3, maxiter=2000)), wall * 1e3, host_ops=False)
        del op, b, sh, st

    op = port.block_poisson2d(1024, 1024)
    b = port.rhs_ones(op, torch.float32, dev)
    cfg = port.ShardedPoisson2D(1024, 1024)
    am, counts, wall, _ = sharded_counted(
        torch, build, "sharded AM 1024^2",
        lambda: port.sharded_multisplit_solve(
            mesh, cfg, b.reshape(1024, 1024), schedule="async", staleness=2,
            rtol=1e-3, maxiter=4000), sm_need, reps=0)
    rel = residual_f64(torch, cfg, am.x, b)
    log(f"sharded AM 1024^2 staleness 2 f32 [{card}]: {am.sweeps} sweeps, "
        f"converged {am.converged}, f64 rel {rel:.3e}; wall {wall:.2f} s; "
        f"launches {counts}")
    if not (am.converged and rel <= 1e-3 * 1.5):
        raise AssertionError(f"sharded AM: converged {am.converged}, rel {rel}")

    # CA-GMRES's one Gram a cycle squares the basis's conditioning: at
    # s=16 it needs f64 (in f32 its Cholesky fails and the iterate
    # freezes, in both packages)
    cfg3 = port.ShardedPoisson3D(64, 64, 64)
    op3 = port.poisson3d(64, 64, 64)
    b3 = {t: op3.mv(torch.ones(64, 64, 64, device=dev, dtype=t))
          for t in (torch.float32, torch.float64)}
    for label, run, need, b3t in (
            ("sharded_gmres_solve 3D 64^3 GMRES(30) f32",
             lambda: port.sharded_gmres_solve(
                 mesh, cfg3, b3[torch.float32], restart=30, rtol=1e-5,
                 maxiter=2000),
             ("stencil3d_apply[mv]", "mdot", "maxpy"), b3[torch.float32]),
            ("sharded_ca_gmres_solve 3D 64^3 s=16 f64",
             lambda: sharded_ca_gmres_solve(
                 mesh, cfg3, b3[torch.float64], s=16, rtol=1e-5,
                 maxiter=2000),
             ("stencil3d_apply[mv]",), b3[torch.float64])):
        res, counts, wall, first = sharded_counted(torch, build, label, run,
                                                   need, reps=2)
        rel = residual_f64(torch, op3, res.x, b3t)
        log(f"{label} [{card}]: {int(res.iters)} iterations, converged "
            f"{bool(res.converged)}, f64 rel {rel:.3e}; wall "
            f"{wall * 1e3:.1f} ms (first {first * 1e3:.1f} ms); launches "
            f"{counts}")
        if not torch.isfinite(res.x).all() or not rel <= 1e-4:
            raise AssertionError(f"{label}: rel {rel}")

    ns_need = ("stencil3d_apply[mv]", "stencil3d_apply[jacobi]",
               "stencil3d_residual_restrict", "stencil3d_prolong_jacobi",
               "stencil3d_chebyshev")
    cfg256 = port.ShardedPoisson3D(256, 256, 256)
    ns, counts, wall, first = sharded_counted(
        torch, build, "sharded north-star 256^3",
        lambda: port.sharded_df_northstar_fused(mesh, cfg256, rtol=1e-8),
        ns_need, reps=2)
    op256 = port.poisson3d(256, 256, 256)
    single, _, s_wall, _ = sharded_counted(
        torch, build, "single-device north-star 256^3",
        lambda: port.df_northstar_fused(op256, rtol=1e-8, device=dev), (),
        reps=2)
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k

    x64 = ns.x[0].double() + ns.x[1].double()
    b64 = k.stencil3d_apply_plain(torch.ones_like(x64), kind="mv", diag=DIAG,
                                  off=OFF)
    rel = float(torch.linalg.vector_norm(b64 - k.stencil3d_apply_plain(
        x64, kind="mv", diag=DIAG, off=OFF)) / torch.linalg.vector_norm(b64))
    log(f"sharded_df_northstar_fused 256^3 mesh {SHARD_MESH} [{card}]: "
        f"{ns.passes} passes, PCG {ns.pcg_iters} (single-device "
        f"{single.passes} passes, PCG {single.pcg_iters}), df rel "
        f"{ns.rnorm / ns.rnorm0:.3e}, f64 rel {rel:.3e}, max|x-1| "
        f"{float((x64 - 1).abs().max()):.3e}; wall {wall * 1e3:.1f} ms "
        f"(first {first * 1e3:.1f} ms), single-device {s_wall * 1e3:.1f} ms;"
        f" kernel A launches: mv {counts.get('stencil3d_apply[mv]', 0)}, "
        f"jacobi {counts.get('stencil3d_apply[jacobi]', 0)}; launches {counts}")
    if not (ns.converged and rel <= 1e-8 and ns.passes <= 3):
        raise AssertionError(f"sharded north-star: passes {ns.passes}, rel "
                             f"{rel}")
    del ns, single, x64, b64

    tmesh = port.make_tiled_mesh(2, 2, 2, device=dev)
    op = port.block_poisson2d(4096, 4096)
    b = port.rhs_ones(op, torch.float32, dev)
    tl, counts, wall, first = sharded_counted(
        torch, build, "tiled SMSM_GLOBAL 4096^2",
        lambda: port.tiled_multisplit_solve(
            tmesh, 4096, 4096, b.reshape(4096, 4096), minimization="global",
            s=4, rtol=1e-3, maxiter=2000), e_need, reps=1)
    rel = residual_f64(torch, port.ShardedPoisson2D(4096, 4096), tl.x, b)
    log(f"tiled_multisplit_solve SMSM_GLOBAL 2D 4096^2 mesh (2, 2, 2) f32 "
        f"[{card}]: {tl.sweeps} sweeps, converged {tl.converged}, f64 rel "
        f"{rel:.3e}; wall {wall * 1e3:.1f} ms (first {first * 1e3:.1f} ms); "
        f"launches {counts}")
    if not (tl.converged and rel <= 1e-3 * 1.5):
        raise AssertionError(f"tiled: converged {tl.converged}, rel {rel}")
    del op, b, tl

    ba = torch.from_numpy(A @ np.ones(SQUARE_N)).to(dev, torch.float32)
    res, counts, wall, first = sharded_counted(
        torch, build, "sharded_aij_solve",
        lambda: sharded_aij_solve(mesh, aij, ba, method="cg", rtol=1e-5,
                                  maxiter=200), ("csr_mv",), reps=2)
    x = res.x.double().cpu().numpy()
    rel = float(np.linalg.norm(A @ np.ones(SQUARE_N) - A @ x)
                / np.linalg.norm(A @ np.ones(SQUARE_N)))
    log(f"sharded_aij_solve CG n = 2^22 structureless, 8 row strips [{card}]:"
        f" {int(res.iters)} iterations, converged {bool(res.converged)}, f64 "
        f"rel {rel:.3e}; wall {wall * 1e3:.1f} ms (first {first * 1e3:.1f} "
        f"ms); launches {counts}")
    if not (bool(res.converged) and rel <= 1e-5 * 1.5):
        raise AssertionError(f"sharded AIJ: rel {rel}")
    bb = torch.from_numpy(Bm @ np.ones(n_b)).to(dev, torch.float32)
    res, counts, wall, _ = sharded_counted(
        torch, build, "sharded_general_solve",
        lambda: sharded_general_solve(mesh, bsr_op, bb, method="cg",
                                      rtol=1e-5, pc=bsr_pc), ("bsr_mv",),
        reps=2)
    err = float((res.x - 1.0).abs().max())
    log(f"sharded_general_solve CG + block-Jacobi n = {n_b}, blocks of {c_b} "
        f"[{card}]: {int(res.iters)} iterations, converged "
        f"{bool(res.converged)}, max|x-1| {err:.3e}; wall {wall * 1e3:.1f} "
        f"ms; launches {counts}")
    if not (bool(res.converged) and err < 1e-3):
        raise AssertionError(f"sharded general: err {err}")

    for axis in ("block", "intra"):
        lat = measure_collective_latency(mesh, axis, rounds=100)
        log(f"measure_collective_latency 'local' {axis} [{card}]: {lat}")

    # the same SM on the local mesh and on 2 gloo ranks sharing the card
    inner = port.InnerConfig()
    cfg = port.ShardedPoisson2D(1024, 1024)
    b64 = port.rhs_ones(port.block_poisson2d(1024, 1024), torch.float64, dev)
    loc, counts, wall, _ = sharded_counted(
        torch, build, "local SM 1024^2 f64",
        lambda: port.sharded_multisplit_solve(mesh, cfg, b64.reshape(1024,
                                                                     1024),
                                              rtol=1e-3, inner=inner),
        sm_need, reps=0)
    x_file = ROOT / "build" / "sharded_dist_x.npy"
    x_file.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    ranks = multihost.launch(
        ["--alg", "SM", "--m", "1024", "--n", "1024", "--nblocks", "2",
         "--intra", "4", "--rtol", "1e-3", "--inner-restart",
         str(inner.restart), "--inner-maxiter", str(inner.maxiter),
         "--inner-rtol", str(inner.rtol), "--probe-rounds", "20",
         "--save-x", str(x_file)],
        num_processes=2, device="cuda", backend="gloo", timeout_s=300)
    launch_s = time.perf_counter() - t0
    x_gap = float(np.abs(np.load(x_file) - loc.x.cpu().numpy()).max())
    x_file.unlink()
    log(f"SM 2D 1024^2 f64 [{card}]: local mesh {loc.sweeps} sweeps, rnorm "
        f"{loc.rnorm.item()!r}, in {wall:.2f} s; 2 'dist' gloo ranks on the "
        f"card: " + "; ".join(
            f"rank {r['process_id']} {r['sweeps']} sweeps, rnorm "
            f"{r['rnorm']!r}, converged {r['converged']}, start-up "
            f"{r['startup_s']:.2f} s, solve {r['elapsed_s']:.2f} s, gloo ring "
            f"round along 'block' {r['collective_block']['per_round_us']:.1f}"
            f" us" for r in ranks) + f"; launch wall {launch_s:.2f} s; "
        f"max|x_dist - x_local| {x_gap:.3e}")
    if any(r["sweeps"] != loc.sweeps or not r["converged"] for r in ranks):
        raise AssertionError(f"dist SM: {[r['sweeps'] for r in ranks]} sweeps,"
                             f" local {loc.sweeps}")

    t0 = time.perf_counter()
    dryrun_multichip(8, device=dev)
    log(f"dryrun_multichip(8) on the card [{card}]: "
        f"{time.perf_counter() - t0:.1f} s")



# ---------------------------------------------------------------------------
# CLI phase
# ---------------------------------------------------------------------------

CLI_MATRIX_N = 1 << 20        # the structureless matrix of the --matrix runs


def cli_phase(torch, port, dev, card) -> None:
    """The port's command line (``utils/cli.py``) on the card: each run
    through ``main(argv + ["--json"])`` in this process, counted once (the
    kernels its path needs must launch), beside the same configuration
    called directly (``config_from_args`` gives the ``RunConfig``; then
    ``multisplit_solve``, ``gmres``, ``df_iterative_refinement`` around
    ``cg``, the sharded solves, ``staged_multisplit_solve``; for AM the
    thesis phase's ``am`` run where that phase ran before): sweeps,
    cycles or iterations must be equal (the CLI adds no arithmetic), the
    record's ``rel_rnorm`` under its rtol and the direct call's residual,
    recomputed in f64 on the card (on the host against the matrix for
    ``--matrix``), under it too.  Then one ``bulk.run_one`` subprocess on
    the card, whose record must say ``cuda:0``.  Prints each run's wall
    time: the CLI's whole call (set-up included), its solve
    (``elapsed_s``) and the direct call's solve, each ending in a
    synchronisation."""
    import contextlib
    import io
    import warnings

    import numpy as np
    import scipy.sparse as sp

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.staged import (
        staged_multisplit_solve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.general import (
        shard_general_from_coo,
        sharded_general_solve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import bulk, cli
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import (
        PhaseTimer,
    )

    e_mv, e_spmm = "stencil2d_apply[mv]", "stencil2d_apply[spmm]"
    fg = ("mdot", "maxpy")
    matrix = ROOT / "build" / "cli_structureless.npz"
    flame = ROOT / "build" / "cli_flame.html"
    matrix.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    A = structureless_spd(np, sp, CLI_MATRIX_N)
    sp.save_npz(matrix, A, compressed=False)
    log(f"cli: structureless n = 2^20 matrix ({A.nnz} nonzeros) written in "
        f"{time.perf_counter() - t0:.1f} s")
    ones = np.ones(A.shape[0])
    b_host = A @ ones

    def timer():
        """Seconds on the host clock after the card's queued work."""
        torch.cuda.synchronize()
        return time.perf_counter()

    def cfg_of(argv):
        return cli.config_from_args(cli.build_parser().parse_args(argv))

    def multisplit(cfg, solver=port.multisplit_solve, **extra):
        op = (port.block_poisson2d(cfg.m, cfg.n, cfg.nblocks) if cfg.dim == 2
              else port.block_poisson3d(cfg.m, cfg.n, cfg.nz, cfg.nblocks))
        b = port.rhs_ones(op, torch.float32 if cfg.dtype == "float32"
                          else torch.float64, dev)
        t0 = timer()
        res = solver(
            op, b, schedule=cfg.schedule,
            staleness=cfg.staleness if cfg.schedule == "async" else 1,
            minimization=cfg.minimization, s=cfg.s,
            inner=cfg.inner_config(), outer=cfg.outer_config(),
            rtol=cfg.rtol, atol=cfg.atol, maxiter=cfg.maxiter,
            min_convergence_count=cfg.min_convergence_count, **extra)
        t = timer() - t0
        return ((res.sweeps, res.cycles), residual_f64(torch, op, res.x, b),
                t)

    def sharded_sm(cfg):
        mesh = port.make_mesh(cfg.nblocks, cfg.intra, device=dev)
        opcfg = port.ShardedPoisson2D(cfg.m, cfg.n)
        b = port.rhs_ones(port.block_poisson2d(cfg.m, cfg.n), torch.float64,
                          dev)
        t0 = timer()
        res = port.sharded_multisplit_solve(
            mesh, opcfg, b.reshape(cfg.m, cfg.n), rtol=cfg.rtol,
            atol=cfg.atol, maxiter=cfg.maxiter, inner=cfg.inner_config(),
            outer=cfg.outer_config(),
            min_convergence_count=cfg.min_convergence_count)
        t = timer() - t0
        return ((res.sweeps, res.cycles), residual_f64(torch, opcfg, res.x, b),
                t)

    def mgpcg_df(cfg):
        gop = port.poisson3d(cfg.m, cfg.n, cfg.nz)
        M = port.mg_preconditioner(gop)
        b = port.rhs_ones(port.block_poisson3d(cfg.m, cfg.n, cfg.nz),
                          torch.float32, dev).reshape(gop.dims)
        pcg = []

        def solve32(r):
            res = port.cg(gop.mv, r, maxiter=cfg.inner_maxiter,
                          rtol=cfg.inner_rtol, precond=M)
            pcg.append(int(res.iters))
            return res.x

        t0 = timer()
        res = port.df_iterative_refinement(
            gop, None, solve32, rtol=cfg.rtol,
            b_df=(b, torch.zeros_like(b)), return_host=False)
        t = timer() - t0
        x64 = res.x[0].double() + res.x[1].double()
        b64 = k.stencil3d_apply_plain(torch.ones_like(x64), kind="mv",
                                      diag=DIAG, off=OFF)
        rel = float(torch.linalg.vector_norm(b64 - k.stencil3d_apply_plain(
            x64, kind="mv", diag=DIAG, off=OFF))
            / torch.linalg.vector_norm(b64))
        log(f"cli MGPCG direct: passes {res.passes}, PCG {pcg}, max|x-1| "
            f"{float((x64 - 1).abs().max()):.3e}")
        return (res.passes,), rel, t

    def host_rel(x):
        x = x.double().cpu().numpy().reshape(-1)
        return float(np.linalg.norm(b_host - A @ x) / np.linalg.norm(b_host))

    def gmres_matrix(cfg):
        coo = A.tocoo()
        a_ii, a_ic = port.block_split_ell(coo.row, coo.col, coo.data, A.shape,
                                          nblocks=cfg.nblocks,
                                          dtype=torch.float32, device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            op = port.as_stacked_routed_operator(
                port.StackedELLOperator(a_ii=a_ii, a_ic=a_ic))
        if type(op).__name__ != "StackedELLOperator":
            raise AssertionError(f"cli --matrix: routed to "
                                 f"{type(op).__name__}, not the stacked ELL")
        d = np.asarray(A.diagonal(), np.float64)
        dinv = torch.as_tensor(1.0 / d, dtype=torch.float32, device=dev)
        b = torch.as_tensor(b_host, dtype=torch.float32, device=dev)
        t0 = timer()
        res = port.gmres(lambda v: op.global_mv(dinv * v), b,
                         restart=cfg.inner_restart, maxiter=cfg.maxiter,
                         rtol=cfg.rtol)
        x = dinv * res.x
        t = timer() - t0
        return (int(res.iters),), host_rel(x), t

    def sharded_matrix(cfg):
        mesh = port.make_mesh(cfg.nblocks, cfg.intra, device=dev)
        coo = A.tocoo()
        d = np.asarray(A.diagonal(), np.float64)
        gop = shard_general_from_coo(coo.row, coo.col, coo.data / d[coo.col],
                                     A.shape[0], mesh.size,
                                     dtype=torch.float32, device=dev)
        b = torch.as_tensor(b_host, dtype=torch.float32, device=dev)
        unscale = torch.as_tensor(1.0 / d, dtype=torch.float32, device=dev)
        t0 = timer()
        res = sharded_general_solve(mesh, gop, b, method="gmres",
                                    restart=cfg.inner_restart,
                                    maxiter=cfg.maxiter, rtol=cfg.rtol)
        x = unscale * res.x.reshape(-1)
        t = timer() - t0
        return (int(res.iters),), host_rel(x), t

    def staged(cfg):
        return multisplit(cfg, staged_multisplit_solve, timer=PhaseTimer())

    def am(cfg):
        """The thesis phase's AM 1024^2 solve where it ran in this process
        (``am(op, b, staleness=2, rtol=1e-3, maxiter=4000)``: the CLI's
        configuration, whose maxiter of 10000 the solve never reaches),
        else the configuration called directly."""
        if "AM 1024^2 staleness 2" in THESIS_RUNS:
            log("cli AM 1024^2: the direct call is the thesis phase's run")
            return THESIS_RUNS["AM 1024^2 staleness 2"]
        return multisplit(cfg)

    runs = [
        # (label, argv, direct call, record fields to compare, kernels)
        ("AM 1024^2 staleness 2", ["--alg", "AM", "--m", "1024", "--n",
                                   "1024", "--rtol", "1e-3", "--staleness",
                                   "2"], am, ("sweeps", "cycles"),
         (e_mv, *fg)),
        ("SMSM_GLOBAL 4096^2", ["--alg", "SMSM_GLOBAL", "--m", "4096", "--n",
                                "4096", "--rtol", "1e-3"], multisplit,
         ("sweeps", "cycles"), (e_mv, e_spmm, *fg)),
        ("MGPCG 3D 256^3 rtol 1e-8 f32", ["--alg", "MGPCG", "--dim", "3",
                                          "--m", "256", "--n", "256", "--nz",
                                          "256", "--rtol", "1e-8"], mgpcg_df,
         ("refine_passes",),
         ("stencil3d_apply[mv]", "stencil3d_residual_restrict",
          "stencil3d_prolong_jacobi", "stencil3d_df_residual",
          "stencil3d_chebyshev")),
        ("SM 3D 64^3 rtol 1e-5", ["--alg", "SM", "--dim", "3", "--m", "64",
                                  "--n", "64", "--nz", "64", "--rtol",
                                  "1e-5"], multisplit, ("sweeps", "cycles"),
         ("stencil3d_apply[mv]", *fg)),
        ("GMRES --matrix n=2^20 --pc-type jacobi",
         ["--alg", "GMRES", "--matrix", str(matrix), "--pc-type", "jacobi"],
         gmres_matrix, ("sweeps",), ("csr_mv", *fg)),
        ("GMRES --matrix n=2^20 --pc-type jacobi sharded (2, 4)",
         ["--alg", "GMRES", "--matrix", str(matrix), "--pc-type", "jacobi",
          "--backend", "sharded", "--nblocks", "2", "--intra", "4"],
         sharded_matrix, ("sweeps",), ("bsr_mv", *fg)),
        ("SM sharded (2, 4) 1024^2 f64", ["--alg", "SM", "--backend",
                                          "sharded", "--nblocks", "2",
                                          "--intra", "4", "--m", "1024",
                                          "--n", "1024", "--dtype",
                                          "float64"], sharded_sm,
         ("sweeps", "cycles"), (e_mv, *fg)),
        ("SMSM_GLOBAL 1024^2 --flame", ["--alg", "SMSM_GLOBAL", "--m", "1024",
                                        "--n", "1024", "--flame", str(flame)],
         staged, ("sweeps", "cycles"), (e_mv, e_spmm, *fg)),
    ]
    for label, argv, direct, fields, need in runs:
        cfg = cfg_of(argv)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([*argv, "--json"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = build.launch_counts()
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        missing = [m for m in need if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"cli {label}: kernels never launched: "
                                 f"{missing}")
        got, rel, direct_s = direct(cfg)
        mine = tuple(rec[f] for f in fields)
        log(f"cli {label} [{card}]: rc {rc}, {dict(zip(fields, mine))} "
            f"(direct {dict(zip(fields, got))}), converged "
            f"{rec['converged']}, record rel {rec['rel_rnorm']:.3e}, direct "
            f"f64 rel {rel:.3e} (rtol {cfg.rtol}); wall: CLI call "
            f"{cli_s:.2f} s, its solve {rec['elapsed_s']:.2f} s, direct "
            f"solve {direct_s:.2f} s; device {rec['device']}; launches "
            f"{counts}")
        if rc != 0 or not rec["converged"] or rec.get("certified") is False:
            raise AssertionError(f"cli {label}: rc {rc}, record {rec}")
        if mine != tuple(got):
            raise AssertionError(f"cli {label}: {mine} against the direct "
                                 f"call's {tuple(got)}")
        if not (rec["rel_rnorm"] <= cfg.rtol and rel <= cfg.rtol):
            raise AssertionError(f"cli {label}: rel {rec['rel_rnorm']} / "
                                 f"f64 {rel} above {cfg.rtol}")
        if rec["device"] != str(dev):
            raise AssertionError(f"cli {label}: ran on {rec['device']}")
        if label.startswith("MGPCG") and not (
                rec["refine_passes"] <= 3 and rec["error_vs_ones"] < 1e-5):
            raise AssertionError(f"cli {label}: {rec}")
    text = flame.read_text()
    stages = ("I_Solver", "Exchange", "O_Solver", "Convergence")
    if not all(st in text for st in stages):
        raise AssertionError(f"cli --flame: {flame} lacks a stage of "
                             f"{stages}")
    log(f"cli --flame: {flame.name} ({len(text)} bytes) names {stages}")
    del A
    matrix.unlink()

    t0 = time.perf_counter()
    env = {"PYTHONPATH": os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    rec = bulk.run_one(["--alg", "SM", "--m", "256", "--n", "256"],
                       timeout_s=300, env=env)
    log(f"cli bulk.run_one SM 256^2 [{card}]: {rec} ("
        f"{time.perf_counter() - t0:.1f} s)")
    if not (rec.get("returncode") == 0 and rec.get("converged")
            and rec.get("device") == "cuda:0"):
        raise AssertionError(f"bulk.run_one on the card: {rec}")


if __name__ == "__main__":
    main()
