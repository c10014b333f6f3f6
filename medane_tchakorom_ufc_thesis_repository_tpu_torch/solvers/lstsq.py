"""Direct tall-skinny least squares (port of the JAX package's
``solvers/lstsq.py``): ``min_a ||rhs - R a||`` for an ``(n, s)`` panel
``R`` with small ``s`` (4..30), the multisplitting minimization.

Both take a leading batch axis.  On the card, ``lstsq_qr`` hands a panel
of at most 31 columns and at least as many rows to kernel N
(``ops/tsqr.py``), a one-pass TSQR that never forms Q; every other panel,
and every panel on the CPU, goes through ``torch.linalg.qr``.

Every product runs in full precision: an f32 matmul on the card must not
use TF32, which keeps about three decimal digits (the GPU form of the
TPU's bf16-operand trap, which the JAX package guards with
``Precision.HIGHEST``).  The products go through ``full_matmul``, which
raises if PyTorch is set to allow TF32; kernel N uses no tensor cores.
"""

from __future__ import annotations

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build, tsqr


def full_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full precision."""
    if (a.is_cuda and a.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the least-squares products need full f32; TF32 is allowed "
            "(torch.backends.cuda.matmul.allow_tf32)")
    return torch.matmul(a, b)


def lstsq_normal(R: torch.Tensor, rhs: torch.Tensor,
                 l2: float = 0.0) -> torch.Tensor:
    """argmin_a ||rhs - R a|| via the normal equations and Cholesky.
    ``l2`` adds Tikhonov damping; a jitter of ``eps * trace / s`` keeps the
    factorization alive on a nearly rank-deficient basis.

    A Gram matrix that is still not positive definite gives an all-NaN
    answer for that batch member, as ``jax.scipy.linalg.cho_factor`` does
    in the JAX package: no exception and no host read."""
    Rt = R.transpose(-2, -1)
    g = full_matmul(Rt, R)
    s = g.shape[-1]
    eye = torch.eye(s, dtype=g.dtype, device=g.device)
    if l2:
        g = g + l2 * eye
    jitter = torch.finfo(g.dtype).eps * torch.diagonal(
        g, dim1=-2, dim2=-1).sum(-1) / s
    g = g + jitter[..., None, None] * eye
    c, info = torch.linalg.cholesky_ex(g)
    # cholesky_ex leaves a partial factor where it fails (info > 0)
    c = torch.where((info != 0)[..., None, None], torch.nan, c)
    return torch.cholesky_solve(full_matmul(Rt, rhs[..., None]), c)[..., 0]


def lstsq_qr(R: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """argmin_a ||rhs - R a|| via reduced QR and the rank rule
    (``ops/tsqr.apply_rank_rule``, as the JAX package's ``lstsq_qr``)."""
    if tsqr.takes(R, rhs) and build.on_cuda(R):
        return tsqr.tsqr_lstsq(R, rhs)
    q, r = torch.linalg.qr(R, mode="reduced")
    return tsqr.apply_rank_rule(
        r, full_matmul(q.transpose(-2, -1), rhs[..., None])[..., 0])
