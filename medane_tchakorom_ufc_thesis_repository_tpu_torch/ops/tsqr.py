"""Kernel N, ``tsqr_lstsq`` (``csrc/tsqr.cu``): the direct tall-skinny least
squares ``argmin_a ||t - R a||`` of the multisplitting minimization, by a
Householder TSQR over ``[R | t]`` that never forms Q.

It replaces no kernel of the JAX package, whose ``lstsq_qr`` leaves the QR
to XLA; on the card it takes the place of ``torch.linalg.qr`` + ``Q^T t`` +
``solve_triangular`` for the panels ``solvers.lstsq.lstsq_qr`` routes to it
(CUDA, at most ``MAX_COLS`` columns, at least as many rows as columns).

``R`` is ``(rows, s)`` or ``(batch, rows, s)`` with any strides (the
minimization's ``Rcols.reshape(s, n).T`` is read in place, column by
column), ``t`` ``(rows,)`` or ``(batch, rows)``; f32 or f64, every
operation in that type.  The answer applies the rank rule of
``apply_rank_rule``, the port's one copy of it.

The wrapper takes its plain version, the same two-level tree in PyTorch
(a QR of each row block, then a fixed pairwise tree of QRs of stacked
triangles), only for tensors on the CPU; for CUDA tensors it launches the
kernel (a row pass and a finish, two launches) or raises.  Each launch adds
one to ``launch_counts()["tsqr"]``.
"""

from __future__ import annotations

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

MAX_COLS = 31
_CODE = {torch.float32: 0, torch.float64: 2}
# row blocks of the plain version's first level
PLAIN_BLOCKS = 8


def _check(R: torch.Tensor, t: torch.Tensor) -> None:
    if R.dim() not in (2, 3) or t.dim() != R.dim() - 1:
        raise ValueError(f"R must be (rows, s) or (batch, rows, s) and t one "
                         f"dimension less, got {tuple(R.shape)} and "
                         f"{tuple(t.shape)}")
    if tuple(t.shape) != tuple(R.shape[:-1]):
        raise ValueError(f"t has shape {tuple(t.shape)}, expected "
                         f"{tuple(R.shape[:-1])}")
    if R.dtype not in _CODE or t.dtype != R.dtype:
        raise ValueError(f"R and t must share one of {tuple(_CODE)}, got "
                         f"{R.dtype} and {t.dtype}")
    if t.device != R.device:
        raise ValueError(f"t is on {t.device}, R on {R.device}")
    rows, s = R.shape[-2:]
    if not 1 <= s <= MAX_COLS or rows < s:
        raise ValueError(f"R needs 1 to {MAX_COLS} columns and at least as "
                         f"many rows, got {rows} x {s}")
    if R.dim() == 3 and R.shape[0] < 1:
        raise ValueError("empty batch")


def takes(R: torch.Tensor, t: torch.Tensor) -> bool:
    """Whether ``tsqr_lstsq`` takes these operands (shapes, dtypes,
    devices), wherever they lie."""
    try:
        _check(R, t)
    except ValueError:
        return False
    return True


def apply_rank_rule(r: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``argmin_a ||t - R a||`` from the triangle ``r`` of a QR of ``R``
    and ``y = Q^T t`` (each with any leading batch axes): the rank rule,
    where ``|r_jj| <= eps * max_i |r_ii|`` ``r_jj`` becomes ``r_jj + 1``
    and ``y_j`` becomes 0, then the back-substitution.  The other entries
    of that row of ``r`` stay, so ``a_j`` is not set to 0.  Every direct
    least squares of the port ends here (``solvers/lstsq.lstsq_qr``,
    ``tsqr_lstsq_plain``, CA-GMRES's cycle)."""
    diag = torch.diagonal(r, dim1=-2, dim2=-1).abs()
    safe = diag > torch.finfo(r.dtype).eps * diag.amax(-1, keepdim=True)
    r = r + torch.diag_embed((~safe).to(r.dtype))
    return torch.linalg.solve_triangular(
        r, torch.where(safe, y, 0.0)[..., None], upper=True)[..., 0]


def tsqr_lstsq_plain(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Plain version of ``tsqr_lstsq``: the R factor of ``[R | t]`` from a
    QR of each of ``PLAIN_BLOCKS`` row blocks, then a fixed pairwise tree
    of QRs of the stacked factors; its leading ``s x s`` triangle and the
    last column's first ``s`` entries (``Q^T t``) go through the rank
    rule."""
    _check(R, t)
    s = R.shape[-1]
    A = torch.cat([R, t[..., None]], dim=-1)
    tri = [torch.linalg.qr(blk, mode="r")[1]
           for blk in torch.tensor_split(A, PLAIN_BLOCKS, dim=-2)
           if blk.shape[-2]]
    while len(tri) > 1:
        tri = [torch.linalg.qr(torch.cat(tri[i:i + 2], dim=-2), mode="r")[1]
               if i + 1 < len(tri) else tri[i] for i in range(0, len(tri), 2)]
    f = tri[0]
    return apply_rank_rule(f[..., :s, :s], f[..., :s, s])


def tsqr_lstsq(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Kernel N: ``argmin_a ||t - R a||`` for each panel, ``(s,)`` or
    ``(batch, s)`` in ``R``'s dtype.  Every sum in a fixed order: the same
    answer from run to run."""
    _check(R, t)
    if not build.on_cuda(R):
        return tsqr_lstsq_plain(R, t)
    lib = build.load("tsqr")
    Rb = R if R.dim() == 3 else R[None]
    tb = t if t.dim() == 2 else t[None]
    batch, rows, s = Rb.shape
    code = _CODE[R.dtype]
    count = lib.tsqr_partials_count(code, batch, rows, s)
    if count < 1:
        raise RuntimeError(f"tsqr_lstsq: no launch shape for {batch} x {rows} "
                           f"x {s} {R.dtype} on {R.device}")
    partials = torch.empty(count, dtype=R.dtype, device=R.device)
    alpha = torch.empty((batch, s), dtype=R.dtype, device=R.device)
    rc = lib.tsqr_lstsq(code, Rb.data_ptr(), tb.data_ptr(), partials.data_ptr(),
                        alpha.data_ptr(), batch, rows, s, Rb.stride(1),
                        Rb.stride(2), Rb.stride(0), tb.stride(1), tb.stride(0),
                        build.stream(R))
    build.check(lib, rc, "tsqr_lstsq")
    build.count("tsqr")
    return alpha if R.dim() == 3 else alpha[0]
