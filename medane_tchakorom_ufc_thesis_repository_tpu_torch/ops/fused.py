"""The fused reductions: GMRES's Gram-Schmidt pair (VecMDot, VecMAXPY) on
a batch of systems, and the stencil applies with a fused residual norm.

Counterpart of the JAX package's ``ops/fused_pallas.py``: ``mdot_pallas``,
``maxpy_pallas``, ``stencil3d_mv_norm_pallas``, ``stencil2d_mv_norm_pallas``
and ``residual_norm_sq``.  Hand-written CUDA kernels:

* ``mdot`` (kernel F, ``csrc/mdot.cu``): ``h[b, k] = sum_n V[b, k, n] w[b, n]``;
* ``maxpy`` (kernel G, ``csrc/mdot.cu``): ``y[b] = y0[b] + sum_k alphas[b, k] V[b, k]``;
* ``stencil3d_mv_norm`` (kernel K, the kind ``mv_norm`` of kernel A in
  ``csrc/stencil3d.cu``) and ``stencil2d_mv_norm`` (kernel L, kernel E's
  template with the norm, ``csrc/stencil2d.cu``): ``(A x, ||b - A x||^2)``
  in one pass over flat f32 or f64 ``x`` and ``b``; ``y`` has the bits of
  the operator's ``mv``, the norm is summed from per-block partials in a
  fixed order.  ``residual_norm_sq(op, x, b)`` picks between them.

``V`` is a ``(batch, K, N)`` basis stored in f32, bf16 or f64, with unit
stride along N (a basis stored as ``(K, batch, N)`` is passed as its
``permute(1, 0, 2)`` view, read in place); ``w``,
``alphas``, ``y0`` and the results are in the accumulation type, f32 or
f64, and every product and sum is taken in it.  As the JAX GMRES does with
a reduced-precision basis (``v.astype(vdtype)`` before its
``dot_general``), ``w`` and ``alphas`` are first rounded to ``V``'s type.
Only the first ``k_active`` rows of ``V`` are read: the JAX basis is zero
beyond them, so the values are the same, and ``mdot`` returns 0 there.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises.  Each launch adds one to
``launch_counts()`` under its own name.
"""

from __future__ import annotations

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil2d import (
    stencil2d_apply_plain,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil3d import (
    stencil3d_apply_plain,
)

_V_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_ACC_CODE = {torch.float32: 0, torch.float64: 2}


def _check(V, vecs, acc: torch.dtype, k_active: int) -> None:
    if V.dim() != 3 or min(V.shape) < 1:
        raise ValueError(f"V must be a non-empty (batch, K, N) basis, got "
                         f"shape {tuple(V.shape)}")
    batch, K, N = V.shape
    if V.dtype not in _V_CODE:
        raise ValueError(f"V must be one of {tuple(_V_CODE)}, got {V.dtype}")
    if acc not in _ACC_CODE:
        raise ValueError(f"the accumulation type must be one of "
                         f"{tuple(_ACC_CODE)}, got {acc}")
    if V.dtype == torch.float64 and acc != torch.float64:
        raise ValueError("an f64 basis needs an f64 accumulation type")
    if not 0 <= k_active <= K:
        raise ValueError(f"k_active must be in [0, {K}], got {k_active}")
    for name, t, shape in vecs:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != acc:
            raise ValueError(f"{name} is {t.dtype}, expected {acc}")
        if t.device != V.device:
            raise ValueError(f"{name} is on {t.device}, V on {V.device}")
    if V.stride(2) != 1:
        raise ValueError("V must have unit stride along N")
    for name, t, _ in vecs:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _round_to(t: torch.Tensor, vdtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the basis type and back to its own."""
    return t.to(vdtype).to(t.dtype)


# ---------------------------------------------------------------------------
# Kernel F: mdot
# ---------------------------------------------------------------------------

def mdot_plain(V: torch.Tensor, w: torch.Tensor, k_active: int) -> torch.Tensor:
    """Plain version of ``mdot``: ``(batch, K)`` in ``w``'s dtype, the
    dots of the first ``k_active`` rows, 0 beyond them."""
    batch, K, N = V.shape
    _check(V, (("w", w, (batch, N)),), w.dtype, k_active)
    h = torch.zeros((batch, K), dtype=w.dtype, device=w.device)
    Va = V[:, :k_active].to(w.dtype)
    h[:, :k_active] = torch.bmm(Va, _round_to(w, V.dtype)[:, :, None])[:, :, 0]
    return h


def mdot(V: torch.Tensor, w: torch.Tensor, k_active: int) -> torch.Tensor:
    """Kernel F (replaces ``fused_pallas.mdot_pallas``): VecMDot of each
    system's basis ``V[b]`` against ``w[b]``, ``(batch, K)`` in ``w``'s
    dtype.  Partial sums per block, then a fixed-order second pass: the
    same values from run to run."""
    batch, K, N = V.shape
    _check(V, (("w", w, (batch, N)),), w.dtype, k_active)
    if not build.on_cuda(V):
        return mdot_plain(V, w, k_active)
    lib = build.load("mdot")
    h = torch.empty((batch, K), dtype=w.dtype, device=w.device)
    partials = torch.empty(lib.mdot_partials_count(batch, K, N),
                           dtype=w.dtype, device=w.device)
    rc = lib.mdot(_V_CODE[V.dtype], _ACC_CODE[w.dtype], V.data_ptr(),
                  w.data_ptr(), partials.data_ptr(), h.data_ptr(), batch,
                  V.stride(0), V.stride(1), K, N, k_active, build.stream(V))
    build.check(lib, rc, "mdot")
    build.count("mdot")
    return h


# ---------------------------------------------------------------------------
# Kernel G: maxpy
# ---------------------------------------------------------------------------

def maxpy_plain(V: torch.Tensor, alphas: torch.Tensor, y0: torch.Tensor,
                k_active: int) -> torch.Tensor:
    """Plain version of ``maxpy``: ``y0 + sum_{k < k_active} alphas[:, k]
    V[:, k]`` in ``y0``'s dtype, the rows summed first and ``y0`` added
    last."""
    batch, K, N = V.shape
    _check(V, (("alphas", alphas, (batch, K)), ("y0", y0, (batch, N))),
           y0.dtype, k_active)
    a = _round_to(alphas[:, :k_active], V.dtype)
    Va = V[:, :k_active].to(y0.dtype)
    return y0 + torch.bmm(a[:, None, :], Va)[:, 0, :]


def maxpy(V: torch.Tensor, alphas: torch.Tensor, y0: torch.Tensor,
          k_active: int) -> torch.Tensor:
    """Kernel G (replaces ``fused_pallas.maxpy_pallas``): VecMAXPY
    ``y0[b] + sum_k alphas[b, k] V[b, k]`` for each system, one pass over
    the first ``k_active`` rows of ``V``; ``(batch, N)`` in ``y0``'s
    dtype."""
    batch, K, N = V.shape
    _check(V, (("alphas", alphas, (batch, K)), ("y0", y0, (batch, N))),
           y0.dtype, k_active)
    if not build.on_cuda(V):
        return maxpy_plain(V, alphas, y0, k_active)
    lib = build.load("mdot")
    y = torch.empty_like(y0)
    rc = lib.maxpy(_V_CODE[V.dtype], _ACC_CODE[y0.dtype], V.data_ptr(),
                   alphas.data_ptr(), y0.data_ptr(), y.data_ptr(), batch,
                   V.stride(0), V.stride(1), K, N, k_active, build.stream(V))
    build.check(lib, rc, "maxpy")
    build.count("maxpy")
    return y


# ---------------------------------------------------------------------------
# Kernels K and L: the applies with a fused residual norm
# ---------------------------------------------------------------------------

_NORM_CODE = {torch.float32: 0, torch.float64: 2}


def _check_norm(x: torch.Tensor, b: torch.Tensor, size: int) -> None:
    for name, t in (("x", x), ("b", b)):
        if tuple(t.shape) != (size,):
            raise ValueError(f"{name} must be flat ({size},), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _NORM_CODE:
        raise ValueError(f"the fused residual norm takes {tuple(_NORM_CODE)}, "
                         f"got {x.dtype}")
    if b.dtype != x.dtype or b.device != x.device:
        raise ValueError(f"b is {b.dtype} on {b.device}, expected {x.dtype} "
                         f"on {x.device}")


def _norm_sq(b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    r = b - y
    return torch.sum(r * r)


def stencil3d_mv_norm_plain(x: torch.Tensor, b: torch.Tensor, *, nx: int,
                            ny: int, nz: int, diag: float = 6.0,
                            off: float = -1.0):
    """Plain version of ``stencil3d_mv_norm``: the plain apply, then the
    sum of ``(b - y)^2`` in ``x``'s dtype."""
    _check_norm(x, b, nx * ny * nz)
    y = stencil3d_apply_plain(x.reshape(nx, ny, nz), kind="mv", diag=diag,
                              off=off).reshape(-1)
    return y, _norm_sq(b, y)


def stencil3d_mv_norm(x: torch.Tensor, b: torch.Tensor, *, nx: int, ny: int,
                      nz: int, diag: float = 6.0, off: float = -1.0):
    """Kernel K (replaces ``fused_pallas.stencil3d_mv_norm_pallas``):
    ``(A x, ||b - A x||^2)`` for the 7-point stencil in one pass; ``x`` and
    ``b`` flat ``(nx*ny*nz,)`` f32 or f64, ``y`` flat with the bits of
    ``Stencil3D.mv``, the norm a 0-d tensor of ``x``'s dtype."""
    _check_norm(x, b, nx * ny * nz)
    if not build.on_cuda(x):
        return stencil3d_mv_norm_plain(x, b, nx=nx, ny=ny, nz=nz, diag=diag,
                                       off=off)
    lib = build.load("stencil3d")
    y = torch.empty_like(x)
    partials = torch.empty(lib.stencil3d_apply_partials(nx, ny, nz),
                           dtype=x.dtype, device=x.device)
    out = torch.empty((), dtype=x.dtype, device=x.device)
    code = _NORM_CODE[x.dtype]
    rc = lib.stencil3d_apply(6, code, code, x.data_ptr(), b.data_ptr(),
                             y.data_ptr(), partials.data_ptr(),
                             out.data_ptr(), nx, ny, nz, 0, 0, 0, diag, off,
                             0.0, build.stream(x))
    build.check(lib, rc, "stencil3d_mv_norm")
    build.count("stencil3d_mv_norm")
    return y, out


def stencil2d_mv_norm_plain(x: torch.Tensor, b: torch.Tensor, *, m: int,
                            n: int, diag: float = 4.0, off: float = -1.0):
    """Plain version of ``stencil2d_mv_norm``: the plain apply, then the
    sum of ``(b - y)^2`` in ``x``'s dtype."""
    _check_norm(x, b, m * n)
    y = stencil2d_apply_plain(x.reshape(1, m, n), diag=diag,
                              off=off).reshape(-1)
    return y, _norm_sq(b, y)


def stencil2d_mv_norm(x: torch.Tensor, b: torch.Tensor, *, m: int, n: int,
                      diag: float = 4.0, off: float = -1.0):
    """Kernel L (replaces ``fused_pallas.stencil2d_mv_norm_pallas``):
    ``(A x, ||b - A x||^2)`` for the 5-point stencil in one pass; ``x`` and
    ``b`` flat ``(m*n,)`` f32 or f64, ``y`` flat with the bits of
    ``Stencil2D.mv``, the norm a 0-d tensor of ``x``'s dtype."""
    _check_norm(x, b, m * n)
    if not build.on_cuda(x):
        return stencil2d_mv_norm_plain(x, b, m=m, n=n, diag=diag, off=off)
    lib = build.load("stencil2d")
    count = lib.stencil2d_mv_norm_partials(m, n)
    if count < 0:
        raise ValueError(f"a ({m}, {n}) grid exceeds the kernel's launch grid")
    y = torch.empty_like(x)
    partials = torch.empty(count, dtype=x.dtype, device=x.device)
    out = torch.empty((), dtype=x.dtype, device=x.device)
    rc = lib.stencil2d_mv_norm(_NORM_CODE[x.dtype], x.data_ptr(), b.data_ptr(),
                               y.data_ptr(), partials.data_ptr(),
                               out.data_ptr(), m, n, diag, off,
                               build.stream(x))
    build.check(lib, rc, "stencil2d_mv_norm")
    build.count("stencil2d_mv_norm")
    return y, out


def residual_norm_sq(op, x: torch.Tensor, b: torch.Tensor):
    """``(A x, ||b - A x||^2)`` (the JAX ``fused_pallas.residual_norm_sq``):
    one fused pass for a ``Stencil2D`` (kernel L) or ``Stencil3D`` (kernel
    K) with flat ``x`` and ``b``, the two-pass form for any other
    operator."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
        Stencil2D,
        Stencil3D,
    )

    if isinstance(op, Stencil2D):
        return stencil2d_mv_norm(x, b, m=op.m, n=op.n, diag=op.diag,
                                 off=op.off)
    if isinstance(op, Stencil3D):
        return stencil3d_mv_norm(x, b, nx=op.nx, ny=op.ny, nz=op.nz,
                                 diag=op.diag, off=op.off)
    y = op.mv(x)
    return y, _norm_sq(b, y)
