"""Kernel O, ``givens_step`` (``csrc/givens.cu``): the small-state work of
one Arnoldi step of ``solvers.krylov.gmres``, one launch a step.

For each system it applies the accumulated Givens rotations to the new
Hessenberg column, forms the rotation that annihilates its last entry,
rotates the least-squares right-hand side ``g``, and commits ``H[:, :, j]``,
``cs[:, j]``, ``sn[:, j]``, ``g``, ``iters``, ``rnorm`` and ``converged``
where the system is active (``~converged & (iters < maxiter)``, written to
``active`` for the basis commit that follows).  ``hcol`` is ``(nsys, m+1)``
with ``hcol[:, j+1]`` already holding the new direction's norm; ``happy``
is the step's happy-breakdown flag and ``tol`` each system's threshold.

It replaces no kernel of the JAX package, where XLA fuses the step; in the
port it takes the place of about ``37 + 9 j`` PyTorch kernels a step, each
a launch on a few values.  Its bound is latency: one launch and one chain
of rounded operations per system.

Every state tensor but ``hcol`` is updated in place, so a caller owns what
it passes; ``hcol`` is only read.  The wrapper checks its arguments, then
takes its plain version (PyTorch's ops, one at a time, as GMRES ran them
inline) for tensors on the CPU and launches the kernel, bit-equal to the
plain version, for CUDA tensors; any other dtype, shape or stride raises.  Each
launch adds one to ``launch_counts()["givens_step"]``.
"""

from __future__ import annotations

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

_CODE = {torch.float32: 0, torch.float64: 2}


def _check(hcol, happy, tol, H, cs, sn, g, iters, rnorm, converged, active,
           j: int) -> None:
    if hcol.dim() != 2 or hcol.shape[1] < 2:
        raise ValueError(f"hcol must be (nsys, m+1), got {tuple(hcol.shape)}")
    nsys, m = hcol.shape[0], hcol.shape[1] - 1
    if hcol.dtype not in _CODE:
        raise ValueError(f"the Givens state takes {tuple(_CODE)}, got "
                         f"{hcol.dtype}")
    if not 0 <= j < m:
        raise ValueError(f"step {j} outside a cycle of {m}")
    want = (("H", H, (nsys, m + 1, m), hcol.dtype),
            ("cs", cs, (nsys, m), hcol.dtype),
            ("sn", sn, (nsys, m), hcol.dtype),
            ("g", g, (nsys, m + 1), hcol.dtype),
            ("tol", tol, (nsys,), hcol.dtype),
            ("rnorm", rnorm, (nsys,), hcol.dtype),
            ("iters", iters, (nsys,), torch.int32),
            ("happy", happy, (nsys,), torch.bool),
            ("converged", converged, (nsys,), torch.bool),
            ("active", active, (nsys,), torch.bool))
    for name, t, shape, dtype in (("hcol", hcol, tuple(hcol.shape),
                                   hcol.dtype),) + want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
        if t.device != hcol.device:
            raise ValueError(f"{name} is on {t.device}, hcol on "
                             f"{hcol.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def givens_step_plain(hcol, happy, tol, maxiter: int, j: int, H, cs, sn, g,
                      iters, rnorm, converged, active) -> None:
    """Plain version of ``givens_step``: GMRES's own lines, each op a
    PyTorch kernel, on a copy of ``hcol``; takes its arguments unchecked."""
    hcol = hcol.clone()
    active.copy_(~converged & (iters < maxiter))
    # the accumulated rotations; slots >= j are the identity
    for i in range(j):
        hi, hi1 = hcol[:, i], hcol[:, i + 1]
        t1 = cs[:, i] * hi + sn[:, i] * hi1
        t2 = -sn[:, i] * hi + cs[:, i] * hi1
        hcol[:, i] = t1
        hcol[:, i + 1] = t2
    # the new rotation, annihilating hcol[j+1]
    a_, b_ = hcol[:, j], hcol[:, j + 1]
    denom = torch.sqrt(a_ * a_ + b_ * b_)
    pos = denom > 0
    safe = torch.where(pos, denom, 1.0)
    c_new = torch.where(pos, a_ / safe, 1.0)
    s_new = torch.where(pos, b_ / safe, 0.0)
    hcol[:, j] = denom
    hcol[:, j + 1] = 0.0
    gj = g[:, j]
    g_new = g.clone()
    g_new[:, j] = c_new * gj
    g_new[:, j + 1] = -s_new * gj
    rnorm_new = g_new[:, j + 1].abs()
    # masked commit: a frozen system keeps what it had (column j of the
    # JAX H starts at zero)
    H[:, :, j] = torch.where(active[:, None], hcol, 0.0)
    cs[:, j] = torch.where(active, c_new, 1.0)
    sn[:, j] = torch.where(active, s_new, 0.0)
    g.copy_(torch.where(active[:, None], g_new, g))
    iters.copy_(torch.where(active, iters + 1, iters))
    rnorm.copy_(torch.where(active, rnorm_new, rnorm))
    converged.copy_(converged | (active & ((rnorm_new <= tol) | happy)))


def givens_step(hcol, happy, tol, maxiter: int, j: int, H, cs, sn, g, iters,
                rnorm, converged, active) -> None:
    """Kernel O: step ``j`` of a GMRES cycle's Givens work, one launch for
    every system; ``H``, ``cs``, ``sn``, ``g``, ``iters``, ``rnorm``,
    ``converged`` and ``active`` are written in place, ``hcol`` is read."""
    _check(hcol, happy, tol, H, cs, sn, g, iters, rnorm, converged, active, j)
    if not build.on_cuda(hcol):
        givens_step_plain(hcol, happy, tol, maxiter, j, H, cs, sn, g, iters,
                          rnorm, converged, active)
        return
    lib = build.load("givens")
    nsys, m = H.shape[0], H.shape[2]
    rc = lib.givens_step(_CODE[hcol.dtype], hcol.data_ptr(), happy.data_ptr(),
                         tol.data_ptr(), H.data_ptr(), cs.data_ptr(),
                         sn.data_ptr(), g.data_ptr(), iters.data_ptr(),
                         rnorm.data_ptr(), converged.data_ptr(),
                         active.data_ptr(), nsys, m, j, maxiter,
                         build.stream(hcol))
    build.check(lib, rc, "givens_step")
    build.count("givens_step")
