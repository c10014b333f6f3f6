"""Double-float (two-f32) arithmetic for f64-accurate residuals.

Port of the JAX package's ``solvers/df64.py``.  A value is an
unevaluated sum ``hi + lo`` of two f32 tensors (~2^-48 relative
precision), and every addition goes through an error-free transformation
(Knuth's two-sum).  Refinement needs only its residual ``r = b - A x``
this accurate; the solves stay in f32.

The operation order of every function here is the JAX package's, so the
same f32 inputs give the same bits on the CPU.  On the card the 3D
residual is kernel D (``ops/stencil3d.stencil3d_df_residual``), which
follows ``_df_residual_core_3d`` step for step; the rest, the 2D residual
included (plain array code in the JAX package too), stays plain PyTorch,
whose elementwise kernels round every operation on its own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d

DF = Tuple[torch.Tensor, torch.Tensor]  # (hi, lo), value = hi + lo

# coefficients whose product with a df is exact component by component
_EXACT_SCALES = (1.0, 2.0, 4.0, 0.5, 0.25)


def scaled_norm(x: torch.Tensor, axes=None) -> torch.Tensor:
    """f32-safe 2-norm (0-d tensor): scale by the max first, since the
    squares of ~1e-11 values underflow the f32 range.  ``axes`` names the
    mesh axes of the JAX package's sharded form; this port runs on one
    device, so only None is taken."""
    if axes is not None:
        raise NotImplementedError(
            "scaled_norm over mesh axes belongs to the sharded solvers "
            "(parallel/), which are not ported")
    m = torch.clamp_min(torch.amax(torch.abs(x)), 1e-30)
    ss = torch.sum(torch.square(x / m))
    return m * torch.sqrt(ss)


def two_sum(a, b) -> DF:
    """Error-free transformation: a + b = s + e exactly (Knuth, 6 flops,
    no ordering of the magnitudes needed)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def df_from_f64(x64, device=None) -> DF:
    """Split an f64 array into an (hi, lo) f32 pair on ``device`` (None:
    the current CUDA device): hi = round(x), lo = round(x - hi), done in
    numpy."""
    device = resolve(device)
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return (torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device))


def df_to_f64(d: DF) -> np.ndarray:
    hi, lo = d
    return (hi.detach().cpu().numpy().astype(np.float64)
            + lo.detach().cpu().numpy().astype(np.float64))


def df_add(a: DF, b: DF) -> DF:
    """df + df -> df (Dekker/Bailey add: ~11 flops, ~2^-48 accurate)."""
    ahi, alo = a
    bhi, blo = b
    s, e = two_sum(ahi, bhi)
    e = e + (alo + blo)
    return two_sum(s, e)


def df_add_f32(a: DF, b) -> DF:
    ahi, alo = a
    s, e = two_sum(ahi, b)
    e = e + alo
    return two_sum(s, e)


def df_neg(a: DF) -> DF:
    return -a[0], -a[1]


def df_scale_pow2(a: DF, c: float) -> DF:
    """Multiply by a power of two (exact in both components)."""
    return a[0] * c, a[1] * c


def df_mul_f32(a: DF, s) -> DF:
    """df * f32 scalar by Dekker's split two-product (no FMA needed).
    ``s``: a 0-d f32 tensor, or a number (rounded to f32 first)."""
    ahi, alo = a
    if not isinstance(s, torch.Tensor):
        s = torch.tensor(s, dtype=ahi.dtype, device=ahi.device)
    p = ahi * s
    c = 4097.0   # 2^12 + 1: the f32 split point
    ah = c * ahi - (c * ahi - ahi)
    at = ahi - ah
    sh = c * s - (c * s - s)
    st = s - sh
    err = ((ah * sh - p) + ah * st + at * sh) + at * st
    e = err + alo * s
    return two_sum(p, e)


def _int_coeff_parts(c: float) -> Optional[list]:
    """``c`` as a signed sum of at most two of the powers 4, 2, 1 taken
    greedily, or None when it is not (then the product is Dekker's)."""
    if c == 0.0:
        raise ValueError("a zero stencil coefficient has no df product")
    ac = abs(c)
    sign = 1.0 if c >= 0 else -1.0
    parts = []
    for p2 in (4.0, 2.0, 1.0):
        if ac >= p2:
            parts.append(p2)
            ac -= p2
    if ac != 0.0 or len(parts) > 2:
        return None
    return [sign * p for p in parts]


def _int_coeff_mul(x: torch.Tensor, c: float) -> DF:
    """Exact ``c * x`` for small-integer stencil coefficients, as a df:
    each power-of-two product is exact, combined with one two-sum; other
    coefficients take a Dekker product."""
    parts = _int_coeff_parts(c)
    if parts is None:
        return df_mul_f32((x, torch.zeros_like(x)), c)
    if len(parts) == 1:
        return parts[0] * x, torch.zeros_like(x)
    return two_sum(parts[0] * x, parts[1] * x)


def _df_combine(hi, lo, coeff: float) -> DF:
    """(hi + lo) * coeff as a df, exact for power-of-two/unit coeffs."""
    if abs(coeff) in _EXACT_SCALES:
        return hi * coeff, lo * coeff
    d = _int_coeff_mul(hi, coeff)
    return df_add_f32(d, coeff * lo)


def stencil2d_df_residual(m: int, n: int, diag: float, off: float):
    """Return ``residual((bhi, blo), (xhi, xlo)) -> (rhi, rlo)``, the
    double-float ``b - A x`` of the 2D 5-point stencil on grid-shaped
    ``(m, n)`` f32 components, in the JAX package's operation order (same
    bits on the CPU)."""

    def residual(b: DF, x: DF) -> DF:
        xhi, xlo = (t.reshape(m, n) for t in x)
        bhi, blo = (t.reshape(m, n) for t in b)

        def taps(g):
            p = F.pad(g, (1, 1, 1, 1))
            return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]

        # neighbour sum: a two-sum tree on hi, plain f32 on lo
        p = F.pad(xhi, (1, 1, 1, 1))
        s1, e1 = two_sum(p[:-2, 1:-1], p[2:, 1:-1])
        s2, e2 = two_sum(p[1:-1, :-2], p[1:-1, 2:])
        nh, e3 = two_sum(s1, s2)
        nl = (e1 + e2 + e3) + taps(xlo)
        ndf = _df_combine(nh, nl, off)
        ddf = _int_coeff_mul(xhi, diag)
        ddf = df_add_f32(ddf, diag * xlo)
        ax = df_add(ddf, ndf)
        return df_add((bhi, blo), df_neg(ax))

    return residual


def _df_residual_core_3d(phi, plo, bhi_s, blo_s, diag: float, off: float) -> DF:
    """The 3D EFT residual tree on zero-padded (nx+2, ny+2, nz+2) hi/lo
    windows against the unpadded b components."""
    def taps(p):
        return (
            p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
            + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
            + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:]
        )

    s1, e1 = two_sum(phi[:-2, 1:-1, 1:-1], phi[2:, 1:-1, 1:-1])
    s2, e2 = two_sum(phi[1:-1, :-2, 1:-1], phi[1:-1, 2:, 1:-1])
    s3, e3 = two_sum(phi[1:-1, 1:-1, :-2], phi[1:-1, 1:-1, 2:])
    t1, e4 = two_sum(s1, s2)
    nh, e5 = two_sum(t1, s3)
    nl = (((e1 + e2) + (e3 + e4)) + e5) + taps(plo)
    ndf = _df_combine(nh, nl, off)
    xhi_c = phi[1:-1, 1:-1, 1:-1]
    xlo_c = plo[1:-1, 1:-1, 1:-1]
    ddf = _int_coeff_mul(xhi_c, diag)
    ddf = df_add_f32(ddf, diag * xlo_c)
    ax = df_add(ddf, ndf)
    return df_add((bhi_s, blo_s), df_neg(ax))


def stencil3d_df_residual(nx: int, ny: int, nz: int, diag: float, off: float):
    """Return ``residual((bhi, blo), (xhi, xlo)) -> (rhi, rlo)``, the
    double-float ``b - A x`` of the 3D 7-point stencil on grid-shaped
    f32 components (kernel D on the card)."""

    def residual(b: DF, x: DF) -> DF:
        return stencil3d.stencil3d_df_residual(
            x[0].reshape(nx, ny, nz), x[1].reshape(nx, ny, nz),
            b[0].reshape(nx, ny, nz), b[1].reshape(nx, ny, nz),
            diag=diag, off=off)

    return residual


def df_residual_for(op):
    """The double-float residual function of a ``Stencil2D`` or
    ``Stencil3D`` operator."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
        Stencil2D,
        Stencil3D,
    )

    if isinstance(op, Stencil2D):
        return stencil2d_df_residual(op.m, op.n, op.diag, op.off)
    if isinstance(op, Stencil3D):
        return stencil3d_df_residual(op.nx, op.ny, op.nz, op.diag, op.off)
    raise TypeError(f"df residual supports Stencil2D/Stencil3D, got "
                    f"{type(op).__name__}")
