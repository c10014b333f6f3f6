"""The 3D 7-point stencil kernels: wrappers, plain versions, launch counts.

Counterpart of the 3D half of the JAX package's ``ops/stencil_pallas.py``.
Five hand-written CUDA kernels (``csrc/stencil3d.cu``,
``csrc/df_residual.cu``) serve six wrappers:

* ``stencil3d_apply`` (kernel A): ``A x`` with the fused epilogues of
  kinds ``mv``, ``mv_dot``, ``residual``, ``jacobi`` and ``jacobi_dot``;
  the kinds without a dot take a stack ``(T, nx, ny, nz)`` of grids in
  one launch (the shards' tiles and the stacked strips), the dot kinds one
  grid (``mv_dot`` walks the stack walk's tiles with the column walk's
  summation order; on f32/bf16 storage ``jacobi_dot`` is a warp walk of
  its own, with one partial sum a warp);
* ``stencil3d_mv_cast`` (kernel A, kind ``mv_cast``): ``(A x, x)`` both
  written at a narrower type, the entry of a bf16 multigrid cycle; it
  takes a stack too;
* ``stencil3d_residual_restrict`` (kernel B);
* ``stencil3d_prolong_jacobi`` (kernel C);
* ``stencil3d_df_residual`` (kernel D): double-float ``b - A x``;
* ``stencil3d_axpy_mv_dot`` (kernel J): PCG's direction update fused
  into the apply, ``(p', A p', p' · A p')`` with ``p' = z + beta p``.

(Kernel K, the apply with the fused residual norm, is a further kind of
kernel A; its wrapper ``stencil3d_mv_norm`` is in ``ops/fused.py``.)

Each wrapper has a ``*_plain`` PyTorch version of the same function
beside it.  A wrapper takes its plain version only for tensors on the
CPU; for CUDA tensors it launches its kernel or raises.  Grids are
contiguous ``(nx, ny, nz)`` tensors, stacks contiguous ``(T, nx, ny, nz)``
tensors, each grid with zero outside it.  Storage is f32 or bf16 with f32
arithmetic; kernels A and J and the plain versions also take f64 and
then compute in f64 (kernels B and C do not, on the card).  The taps are
summed in one order everywhere:
``diag*c + off*((((x- + x+) + y-) + y+) + (z- + z+))``.

Every kernel launch adds one to its entry in ``launch_counts()`` (the
port's counts of all wrappers, kept in ``ops/build.py``); plain calls
count nothing; a launch over a stack counts once.  The warp walks
(kernels B and C, and the kind ``jacobi_dot``) take their launch geometry
from ``walk_slab``, kernel A's kinds without a dot from ``stack_geometry``,
its kind ``mv_dot`` from ``dot_geometry``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

KINDS = ("mv", "mv_dot", "residual", "jacobi", "jacobi_dot")
_DOT_KINDS = ("mv_dot", "jacobi_dot")       # one grid a launch
_KIND_CODE = {"mv": 0, "mv_dot": 1, "residual": 2, "jacobi": 3,
              "jacobi_dot": 4, "mv_cast": 5}
_WITH_RHS = ("residual", "jacobi", "jacobi_dot")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_CPU_DTYPES = tuple(_DTYPE_CODE)
_NARROW_DTYPES = (torch.float32, torch.bfloat16)   # kernels B and C

# the port's launch counts, shared by every wrapper (``ops/build.py``)
launch_counts = build.launch_counts
reset_launch_counts = build.reset_launch_counts


# ---------------------------------------------------------------------------
# Checks shared by the wrappers
# ---------------------------------------------------------------------------

def _check_grid(name: str, t: torch.Tensor, like: Optional[torch.Tensor] = None,
                shape=None, stack: bool = False) -> None:
    """``stack``: a ``(T, nx, ny, nz)`` stack is taken as well as a grid."""
    if not (t.dim() == 3 or stack and t.dim() == 4) or min(t.shape) < 1:
        what = "grid or (T, nx, ny, nz) stack" if stack else "grid"
        raise ValueError(f"{name} must be a non-empty (nx, ny, nz) {what}, "
                         f"got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if like is not None:
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, expected {like.device}")
        if t.dtype != like.dtype:
            raise ValueError(f"{name} is {t.dtype}, expected {like.dtype}")


def _check_dtype(dtype: torch.dtype, cuda: bool, f64: bool = False) -> None:
    """``f64``: whether the CUDA kernel at hand computes in f64 too."""
    allowed = _NARROW_DTYPES if cuda and not f64 else _CPU_DTYPES
    if dtype not in allowed:
        where = "this CUDA kernel takes" if cuda else "the plain versions take"
        raise ValueError(f"{where} {allowed}, got {dtype}")


def _check_pair(xdt: torch.dtype, odt: torch.dtype, cuda: bool) -> None:
    """Kernel A's storage types: f32 and bf16 mix, f64 goes with f64."""
    _check_dtype(xdt, cuda, f64=True)
    _check_dtype(odt, cuda, f64=True)
    if cuda and (xdt == torch.float64) != (odt == torch.float64):
        raise ValueError(f"on the card f64 goes with f64 only, got {xdt} "
                         f"in and {odt} out")


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for f32/bf16 storage, f64 for f64 (plain versions only)."""
    return torch.promote_types(dtype, torch.float32)


def _apply(c: torch.Tensor, diag: float, off: float) -> torch.Tensor:
    """``A c`` in ``c``'s dtype, zero Dirichlet boundary, on each grid of
    ``c`` (its last three axes; a leading axis is a stack, each grid
    padded on its own)."""
    p = F.pad(c, (1, 1, 1, 1, 1, 1))
    i, lo, hi = slice(1, -1), slice(None, -2), slice(2, None)
    taps = ((((p[..., lo, i, i] + p[..., hi, i, i]) + p[..., i, lo, i])
             + p[..., i, hi, i]) + (p[..., i, i, lo] + p[..., i, i, hi]))
    return diag * c + off * taps


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a.to(torch.float32) * b.to(torch.float32))


def cell_sums(r: torch.Tensor) -> torch.Tensor:
    """Sum over each 2x2x2 cell of an even grid: x pairs, then y pairs,
    then z pairs (the order kernel B adds in)."""
    r = r[0::2] + r[1::2]
    r = r[:, 0::2] + r[:, 1::2]
    return r[:, :, 0::2] + r[:, :, 1::2]


def replicate(e: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant prolongation: each coarse value fills its
    2x2x2 cell of the fine grid."""
    for ax in range(3):
        e = e.repeat_interleave(2, dim=ax)
    return e


# ---------------------------------------------------------------------------
# Kernel A: stencil3d_apply
# ---------------------------------------------------------------------------

def _check_apply(x, extras, kind, omega):
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    want = 1 if kind in _WITH_RHS else 0
    if len(extras) != want:
        raise ValueError(f"kind {kind!r} takes {want} extra operand(s), "
                         f"got {len(extras)}")
    if (omega is None) == kind.startswith("jacobi"):
        raise ValueError(f"omega is required by the jacobi kinds and only "
                         f"by them (kind {kind!r}, omega {omega!r})")
    _check_grid("x", x, stack=kind not in _DOT_KINDS)
    for e in extras:
        _check_grid("b", e, like=x, shape=x.shape, stack=True)


def stencil3d_apply_plain(x: torch.Tensor, *extras: torch.Tensor, kind: str,
                          diag: float, off: float,
                          omega: Optional[float] = None,
                          out_dtype: Optional[torch.dtype] = None):
    """Plain version of ``stencil3d_apply``: ``mv`` → ``A x``;
    ``mv_dot`` → ``(A x, x·Ax)``; ``residual`` → ``b - A x``; ``jacobi``
    → ``x + omega (b - A x)``; ``jacobi_dot`` → ``(x', b·x')``.  The dots
    are f32 sums of f32 products taken before the cast to ``out_dtype``.
    A stack is computed grid by grid in one pass, each grid with the bits
    it has alone."""
    _check_apply(x, extras, kind, omega)
    odt = x.dtype if out_dtype is None else out_dtype
    c = x.to(_compute_dtype(x.dtype))
    v = _apply(c, diag, off)
    dot = None
    if kind == "residual":
        v = extras[0].to(c.dtype) - v
    elif kind in ("jacobi", "jacobi_dot"):
        bb = extras[0].to(c.dtype)
        v = c + omega * (bb - v)
        if kind == "jacobi_dot":
            dot = _dot_f32(bb, v)
    elif kind == "mv_dot":
        dot = _dot_f32(c, v)
    y = v.to(odt)
    return (y, dot) if dot is not None else y


def stencil3d_apply(x: torch.Tensor, *extras: torch.Tensor, kind: str,
                    diag: float, off: float, omega: Optional[float] = None,
                    out_dtype: Optional[torch.dtype] = None):
    """Kernel A (replaces ``stencil_pallas.stencil3d_apply_pallas``).
    ``x`` is an ``(nx, ny, nz)`` grid or, for the kinds without a dot, a
    contiguous ``(T, nx, ny, nz)`` stack of grids, each with zero outside
    it, computed in one launch.  ``extras`` is ``(b,)`` for the residual
    and Jacobi kinds, of ``x``'s dtype and shape; ``out_dtype`` (default
    ``x.dtype``) may differ.  The dot kinds return ``(y, dot)`` with
    ``dot`` a 0-d f32 tensor (f64 grids sum in f64 on the card and round
    the sum to f32)."""
    _check_apply(x, extras, kind, omega)
    odt = x.dtype if out_dtype is None else out_dtype
    cuda = build.on_cuda(x)
    _check_pair(x.dtype, odt, cuda)
    if not cuda:
        return stencil3d_apply_plain(x, *extras, kind=kind, diag=diag, off=off,
                                     omega=omega, out_dtype=out_dtype)
    lib = build.load("stencil3d")
    y = torch.empty(x.shape, dtype=odt, device=x.device)
    if kind not in _DOT_KINDS:
        _launch_stack(lib, kind, x, extras[0] if extras else None, y, None,
                      diag, off, omega)
        build.count(f"stencil3d_apply[{kind}]")
        return y
    if kind == "jacobi_dot" and x.dtype != torch.float64:
        return y, _jacobi_dot_walk(lib, x, extras[0], y, diag, off, omega)
    nx, ny, nz = x.shape
    cdt = _compute_dtype(x.dtype)
    partials = torch.empty(lib.stencil3d_apply_partials(nx, ny, nz), dtype=cdt,
                           device=x.device)
    dot = torch.empty((), dtype=cdt, device=x.device)
    # mv_dot: the dot walk's tile and slab; f64 jacobi_dot ignores them
    geometry = dot_geometry(x.shape, x.dtype) if kind == "mv_dot" else (0, 0, 0)
    rc = lib.stencil3d_apply(
        _KIND_CODE[kind], _DTYPE_CODE[x.dtype], _DTYPE_CODE[odt], x.data_ptr(),
        extras[0].data_ptr() if extras else None, y.data_ptr(),
        partials.data_ptr(), dot.data_ptr(), nx, ny, nz, *geometry, diag, off,
        0.0 if omega is None else omega, build.stream(x))
    build.check(lib, rc, f"stencil3d_apply[{kind}]")
    build.count(f"stencil3d_apply[{kind}]")
    return y, dot.to(torch.float32)


# kernel A's kinds without a dot (csrc/stencil3d.cu stack_kernel): a block
# owns a tile of at most STACK_THREADS threads, one 16-byte vector of z
# points each, in at most STACK_ROWS rows, and walks a slab of at most
# STACK_SLAB x planes; slabs are halved (down to 2) while the launch would
# have fewer than STACK_MIN_BLOCKS blocks: two waves of 4 resident blocks
# (the kernel's register cap) on each of the H100's 132 SMs
STACK_THREADS, STACK_ROWS, STACK_SLAB = 256, 64, 32
STACK_MIN_BLOCKS = 2 * 4 * 132


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def stack_geometry(shape, dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(tzv, ty, slab)`` of kernel A's stack walk on a ``(T, nx, ny,
    nz)`` stack of ``dtype``: tzv 16-byte vectors along z (a power of two,
    as many as nz takes, up to 32) by ty rows (a power of two, as many as ny
    takes, up to ``STACK_THREADS // tzv`` and ``STACK_ROWS``), and the x
    planes a block walks."""
    t, nx, ny, nz = shape
    v = 128 // torch.finfo(dtype).bits
    tzv = min(32, _pow2_at_least(-(-nz // v)))
    ty = min(STACK_THREADS // tzv, STACK_ROWS, _pow2_at_least(ny))
    tiles = t * -(-ny // ty) * -(-nz // (tzv * v))
    slab = STACK_SLAB
    while slab > 2 and tiles * -(-nx // slab) < STACK_MIN_BLOCKS:
        slab //= 2
    return tzv, ty, slab


# kernel A's kind mv_dot (csrc/stencil3d.cu stack_kernel, kind MV_DOT):
# the stack walk on one grid, its dot summed in boxes of DOT_BOX_Z z points
# by DOT_BOX_Y rows by DOT_BOX_X x planes in the order the column walk
# summed it (a box is one of its blocks), so a tile is whole boxes and a
# slab whole boxes; the slab is halved, down to one box, while the launch
# has fewer than STACK_MIN_BLOCKS blocks
DOT_BOX_X, DOT_BOX_Y, DOT_BOX_Z = 16, 8, 32


def dot_geometry(shape, dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(tzv, ty, slab)`` of kernel A's dot walk on an ``(nx, ny, nz)``
    grid of ``dtype``: tzv 16-byte vectors along z (a power of two, as many
    as nz takes, at least a box's ``DOT_BOX_Z`` points and up to 32) by ty
    rows (a power of two, as many as ny takes, at least ``DOT_BOX_Y``, up to
    ``STACK_THREADS // tzv`` and ``STACK_ROWS``), and the x planes a block
    walks (``STACK_SLAB``, halved down to ``DOT_BOX_X``).  The C launcher
    refuses a tile or slab that is not whole boxes."""
    nx, ny, nz = shape
    v = 128 // torch.finfo(dtype).bits
    tzv = min(32, max(DOT_BOX_Z // v, _pow2_at_least(-(-nz // v))))
    ty = max(DOT_BOX_Y, min(STACK_THREADS // tzv, STACK_ROWS,
                            _pow2_at_least(ny)))
    tiles = -(-ny // ty) * -(-nz // (tzv * v))
    slab = STACK_SLAB
    while slab > DOT_BOX_X and tiles * -(-nx // slab) < STACK_MIN_BLOCKS:
        slab //= 2
    return tzv, ty, slab


def _launch_stack(lib, kind, x, b, y, y2, diag, off, omega) -> None:
    """One launch of kernel A's stack walk over ``x`` (a grid, or a stack
    of grids), writing ``y`` (and ``y2``, the cast copy, for ``mv_cast``)."""
    stack = x.shape if x.dim() == 4 else (1, *x.shape)
    tzv, ty, slab = stack_geometry(stack, x.dtype)
    rc = lib.stencil3d_apply_stack(
        _KIND_CODE[kind], _DTYPE_CODE[x.dtype], _DTYPE_CODE[y.dtype],
        x.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        None if y2 is None else y2.data_ptr(), *stack, tzv, ty, slab, diag,
        off, 0.0 if omega is None else omega, build.stream(x))
    build.check(lib, rc, f"stencil3d_apply[{kind}]")


def _jacobi_dot_walk(lib, x, b, y, diag, off, omega) -> torch.Tensor:
    """Kind ``jacobi_dot`` on f32/bf16 storage: the warp walk
    (``csrc/stencil3d.cu`` ``stencil3d_jacobi_dot``), one partial sum a
    warp; writes ``y`` and returns the f32 dot."""
    nx, ny, nz = x.shape
    slab = walk_slab(x.shape)
    partials = torch.empty(lib.stencil3d_jacobi_dot_partials(nx, ny, nz, slab),
                           dtype=torch.float32, device=x.device)
    dot = torch.empty((), dtype=torch.float32, device=x.device)
    rc = lib.stencil3d_jacobi_dot(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[y.dtype], x.data_ptr(), b.data_ptr(),
        y.data_ptr(), partials.data_ptr(), dot.data_ptr(), nx, ny, nz, slab,
        diag, off, omega, build.stream(x))
    build.check(lib, rc, "stencil3d_apply[jacobi_dot]")
    build.count("stencil3d_apply[jacobi_dot]")
    return dot


# ---------------------------------------------------------------------------
# Kernel A, kind mv_cast: stencil3d_mv_cast
# ---------------------------------------------------------------------------

def stencil3d_mv_cast_plain(x: torch.Tensor, *, diag: float, off: float,
                            out_dtype: torch.dtype
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A x, x)``, both rounded to ``out_dtype``."""
    _check_grid("x", x, stack=True)
    y = _apply(x.to(_compute_dtype(x.dtype)), diag, off)
    return y.to(out_dtype), x.to(out_dtype)


def stencil3d_mv_cast(x: torch.Tensor, *, diag: float, off: float,
                      out_dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A, kind ``mv_cast`` (replaces
    ``stencil_pallas.stencil3d_mv_cast_pallas``): one read of ``x`` (a
    grid or a stack of grids), two writes at ``out_dtype``."""
    _check_grid("x", x, stack=True)
    cuda = build.on_cuda(x)
    _check_pair(x.dtype, out_dtype, cuda)
    if not cuda:
        return stencil3d_mv_cast_plain(x, diag=diag, off=off,
                                       out_dtype=out_dtype)
    lib = build.load("stencil3d")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    c = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _launch_stack(lib, "mv_cast", x, None, y, c, diag, off, None)
    build.count("stencil3d_mv_cast")
    return y, c


# ---------------------------------------------------------------------------
# Kernel B: stencil3d_residual_restrict
# ---------------------------------------------------------------------------

def _check_even(x: torch.Tensor) -> None:
    if any(n % 2 for n in x.shape):
        raise ValueError(f"the grid must have even dims, got {tuple(x.shape)}")


def stencil3d_residual_restrict_plain(x: torch.Tensor, b: torch.Tensor, *,
                                      diag: float, off: float,
                                      scale: float = 1.0) -> torch.Tensor:
    """``(scale/8) * sum over each 2x2x2 cell of (b - A x)`` on the
    ``(nx/2, ny/2, nz/2)`` grid, in ``x``'s dtype: sums over x pairs,
    then y pairs, then z pairs, rounded once."""
    _check_grid("x", x)
    _check_grid("b", b, like=x, shape=x.shape)
    _check_even(x)
    cdt = _compute_dtype(x.dtype)
    r = b.to(cdt) - _apply(x.to(cdt), diag, off)
    return ((scale / 8.0) * cell_sums(r)).to(x.dtype)


def stencil3d_residual_restrict(x: torch.Tensor, b: torch.Tensor, *,
                                diag: float, off: float,
                                scale: float = 1.0) -> torch.Tensor:
    """Kernel B (replaces
    ``stencil_pallas.stencil3d_residual_restrict_pallas``), with the
    plain version's bits: every product and sum rounded on its own in
    the same order."""
    _check_grid("x", x)
    _check_grid("b", b, like=x, shape=x.shape)
    _check_even(x)
    cuda = build.on_cuda(x)
    _check_dtype(x.dtype, cuda)
    if not cuda:
        return stencil3d_residual_restrict_plain(x, b, diag=diag, off=off,
                                                 scale=scale)
    nx, ny, nz = x.shape
    lib = build.load("stencil3d")
    rc_ = torch.empty((nx // 2, ny // 2, nz // 2), dtype=x.dtype,
                      device=x.device)
    rc = lib.stencil3d_residual_restrict(
        _DTYPE_CODE[x.dtype], x.data_ptr(), b.data_ptr(), rc_.data_ptr(), nx,
        ny, nz, walk_slab(x.shape), diag, off, scale / 8.0, build.stream(x))
    build.check(lib, rc, "stencil3d_residual_restrict")
    build.count("stencil3d_residual_restrict")
    return rc_


# ---------------------------------------------------------------------------
# Kernel C: stencil3d_prolong_jacobi
# ---------------------------------------------------------------------------

def _check_prolong(x, b, e):
    _check_grid("x", x)
    _check_grid("b", b, like=x, shape=x.shape)
    _check_even(x)
    _check_grid("e", e, like=x, shape=tuple(n // 2 for n in x.shape))


def stencil3d_prolong_jacobi_plain(x: torch.Tensor, b: torch.Tensor,
                                   e: torch.Tensor, *, diag: float,
                                   off: float, omega: float) -> torch.Tensor:
    """``m + omega (b - A m)`` with ``m = x + P e`` (``P`` piecewise
    constant from the coarse ``e``); ``m`` stays in the compute dtype."""
    _check_prolong(x, b, e)
    cdt = _compute_dtype(x.dtype)
    m = x.to(cdt) + replicate(e.to(cdt))
    out = m + omega * (b.to(cdt) - _apply(m, diag, off))
    return out.to(x.dtype)


# the block of the warp walks (kernels B and C, kernel A's jacobi_dot on
# f32/bf16): a tile of WALK_TY fine rows by WALK_TZ fine z points
# (csrc/stencil3d.cu: 4 rows a lane, 4 warps; a z pair a lane, 32 lanes),
# walking at most WALK_SLAB x planes
WALK_TY, WALK_TZ, WALK_SLAB = 16, 64, 16
WALK_MIN_BLOCKS = 1024   # about 8 blocks for each of the H100's 132 SMs


def walk_slab(shape) -> int:
    """The x planes a block of the warp walks takes on an ``(nx, ny,
    nz)`` grid: ``WALK_SLAB``, halved (down to 2) while the grid would
    have fewer than ``WALK_MIN_BLOCKS`` blocks, so that the cycle's small
    levels run as many short walks instead of a few long ones.  Always
    even: kernel B walks its planes in pairs from an even plane."""
    nx, ny, nz = shape
    tiles = -(-ny // WALK_TY) * -(-nz // WALK_TZ)
    slab = WALK_SLAB
    while slab > 2 and tiles * -(-nx // slab) < WALK_MIN_BLOCKS:
        slab //= 2
    return slab


def stencil3d_prolong_jacobi(x: torch.Tensor, b: torch.Tensor,
                             e: torch.Tensor, *, diag: float, off: float,
                             omega: float) -> torch.Tensor:
    """Kernel C (replaces
    ``stencil_pallas.stencil3d_prolong_jacobi_pallas``).  ``e`` is the
    coarse ``(nx/2, ny/2, nz/2)`` correction in ``x``'s dtype."""
    _check_prolong(x, b, e)
    cuda = build.on_cuda(x)
    _check_dtype(x.dtype, cuda)
    if not cuda:
        return stencil3d_prolong_jacobi_plain(x, b, e, diag=diag, off=off,
                                              omega=omega)
    nx, ny, nz = x.shape
    lib = build.load("stencil3d")
    out = torch.empty_like(x)
    rc = lib.stencil3d_prolong_jacobi(
        _DTYPE_CODE[x.dtype], x.data_ptr(), b.data_ptr(), e.data_ptr(),
        out.data_ptr(), nx, ny, nz, walk_slab(x.shape), diag, off,
        omega, build.stream(x))
    build.check(lib, rc, "stencil3d_prolong_jacobi")
    build.count("stencil3d_prolong_jacobi")
    return out


# ---------------------------------------------------------------------------
# Kernel D: stencil3d_df_residual
# ---------------------------------------------------------------------------

def _check_df(xhi, xlo, bhi, blo):
    _check_grid("xhi", xhi)
    if xhi.dtype != torch.float32:
        raise ValueError(f"the df residual takes f32 components, got {xhi.dtype}")
    for name, t in (("xlo", xlo), ("bhi", bhi), ("blo", blo)):
        _check_grid(name, t, like=xhi, shape=xhi.shape)


def stencil3d_df_residual_plain(xhi, xlo, bhi, blo, *, diag: float,
                                off: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Double-float ``b - A x``: ``df64._df_residual_core_3d`` on the
    zero-padded ``x`` components."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import df64

    _check_df(xhi, xlo, bhi, blo)
    pad = (1, 1, 1, 1, 1, 1)
    return df64._df_residual_core_3d(F.pad(xhi, pad), F.pad(xlo, pad), bhi,
                                     blo, diag, off)


def _coeff_mode(c: float, allow_scale: bool) -> Tuple[int, float, float, float]:
    """How kernel D multiplies by ``c`` (``df64._int_coeff_mul`` /
    ``df64._df_combine``): (mode, p0, p1, c), mode 0 one power of two,
    1 two, 2 Dekker product, 3 exact scaling."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import df64

    if allow_scale and abs(c) in df64._EXACT_SCALES:
        return 3, 0.0, 0.0, c
    parts = df64._int_coeff_parts(c)
    if parts is None:
        return 2, 0.0, 0.0, c
    if len(parts) == 1:
        return 0, parts[0], 0.0, c
    return 1, parts[0], parts[1], c


def stencil3d_df_residual(xhi, xlo, bhi, blo, *, diag: float,
                          off: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D (replaces ``stencil_pallas.stencil3d_df_residual_pallas``):
    ``(rhi, rlo)``, bit for bit the plain version."""
    _check_df(xhi, xlo, bhi, blo)
    if not build.on_cuda(xhi):
        return stencil3d_df_residual_plain(xhi, xlo, bhi, blo, diag=diag,
                                           off=off)
    nx, ny, nz = xhi.shape
    lib = build.load("df_residual")
    rhi = torch.empty_like(xhi)
    rlo = torch.empty_like(xhi)
    rc = lib.stencil3d_df_residual(
        xhi.data_ptr(), xlo.data_ptr(), bhi.data_ptr(), blo.data_ptr(),
        rhi.data_ptr(), rlo.data_ptr(), nx, ny, nz,
        *_coeff_mode(diag, False), *_coeff_mode(off, True), build.stream(xhi))
    build.check(lib, rc, "stencil3d_df_residual")
    build.count("stencil3d_df_residual")
    return rhi, rlo


# ---------------------------------------------------------------------------
# Kernel J: stencil3d_axpy_mv_dot
# ---------------------------------------------------------------------------

def _check_axpy(z: torch.Tensor, p: torch.Tensor, beta) -> torch.Tensor:
    """Check the grids; return ``beta`` as a 0-d tensor of the arithmetic
    type on ``z``'s device (a tensor stays on its device: no host read)."""
    _check_grid("z", z)
    _check_grid("p", p, like=z, shape=z.shape)
    cdt = _compute_dtype(z.dtype)
    if isinstance(beta, torch.Tensor):
        if beta.numel() != 1:
            raise ValueError(f"beta must be a scalar, got shape "
                             f"{tuple(beta.shape)}")
        if beta.device != z.device:
            raise ValueError(f"beta is on {beta.device}, expected {z.device}")
        return beta.reshape(()).to(cdt)
    return torch.tensor(float(beta), dtype=cdt, device=z.device)


def stencil3d_axpy_mv_dot_plain(z: torch.Tensor, p: torch.Tensor, beta, *,
                                diag: float, off: float):
    """Plain version of ``stencil3d_axpy_mv_dot``: ``p' = z + beta p`` in
    the arithmetic type, product and sum each rounded on its own;
    ``A p'`` and the dot ``p' · A p'`` from that unrounded ``p'``; ``p'``
    and ``A p'`` come back in ``z``'s dtype, the dot (an f32 sum of f32
    products, as every dot of the plain versions) in the arithmetic type:
    f32, or f64 for f64 grids."""
    beta = _check_axpy(z, p, beta)
    _check_dtype(z.dtype, False)
    cdt = beta.dtype
    pn = z.to(cdt) + beta * p.to(cdt)
    ap = _apply(pn, diag, off)
    return pn.to(z.dtype), ap.to(z.dtype), _dot_f32(pn, ap).to(cdt)


def stencil3d_axpy_mv_dot(z: torch.Tensor, p: torch.Tensor, beta, *,
                          diag: float, off: float):
    """Kernel J (replaces ``stencil_pallas.stencil3d_axpy_mv_dot_pallas``):
    ``(p', A p', p' · A p')`` with ``p' = z + beta p`` in one pass over
    ``z`` and ``p``.  ``beta`` is a number or a one-element tensor on
    ``z``'s device, which the kernel reads from device memory.  ``p'`` and
    ``A p'`` are new tensors in ``z``'s dtype (f32, bf16 or f64); the dot
    is a 0-d tensor of the arithmetic type (f32, or f64 for f64 grids),
    summed from per-block partials in a fixed order."""
    beta = _check_axpy(z, p, beta)
    cuda = build.on_cuda(z)
    _check_dtype(z.dtype, cuda, f64=True)
    if not cuda:
        return stencil3d_axpy_mv_dot_plain(z, p, beta, diag=diag, off=off)
    nx, ny, nz = z.shape
    lib = build.load("stencil3d")
    pn, ap = torch.empty_like(z), torch.empty_like(z)
    partials = torch.empty(lib.stencil3d_apply_partials(nx, ny, nz),
                           dtype=beta.dtype, device=z.device)
    dot = torch.empty((), dtype=beta.dtype, device=z.device)
    rc = lib.stencil3d_axpy_mv_dot(
        _DTYPE_CODE[z.dtype], z.data_ptr(), p.data_ptr(), beta.data_ptr(),
        pn.data_ptr(), ap.data_ptr(), partials.data_ptr(), dot.data_ptr(), nx,
        ny, nz, diag, off, build.stream(z))
    build.check(lib, rc, "stencil3d_axpy_mv_dot")
    build.count("stencil3d_axpy_mv_dot")
    return pn, ap, dot
