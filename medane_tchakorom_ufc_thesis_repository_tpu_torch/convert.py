"""Carry state across from the JAX package.

The solvers have no weights: an operator (its shape and coefficients, or
the arrays of an assembled format), a preconditioner's block inverses,
the right-hand side (a double-float pair for the north-star, a stacked
``(nblocks, block_size)`` array for multisplitting), a multigrid cycle's
level description, a start and a result are the whole state.  These helpers take them from the JAX
package's objects or from numpy arrays, and give a multisplitting result
back as numpy, so that both packages work from the same numbers.
Nothing here imports JAX: a JAX operator is read by its attributes, and
arrays arrive as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
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
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.blockops import (
    StackedBSROperator,
    StackedDIAOperator,
    StackedELLOperator,
    StackedStencil2D,
    StackedStencil3D,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
    MultisplitResult,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.general import (
    ShardedBlockJacobi,
    ShardedGeneralBSR,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.sharded import (
    ShardedPoisson2D,
    ShardedPoisson3D,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.bjacobi import (
    BlockJacobi,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import (
    KrylovResult,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.multigrid import (
    MGLevels,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.refine import (
    RefineResult,
)

# the port's operators, by the JAX class name, with the fields they take
_OPERATORS = {
    "Stencil2D": (Stencil2D, ("m", "n")),
    "Stencil3D": (Stencil3D, ("nx", "ny", "nz")),
    "StackedStencil2D": (StackedStencil2D, ("m", "n", "nblocks")),
    "StackedStencil3D": (StackedStencil3D, ("nx", "ny", "nz", "nblocks")),
    "StencilStrip2D": (StencilStrip2D, ("rows", "n")),
    "StencilStrip3D": (StencilStrip3D, ("rows", "ny", "nz")),
    "ShardedPoisson2D": (ShardedPoisson2D, ("m", "n")),
    "ShardedPoisson3D": (ShardedPoisson3D, ("nx", "ny", "nz")),
}
# the sharded general operators: (class, array fields, plain int fields)
_SHARDED = {
    "ShardedGeneralBSR": (ShardedGeneralBSR, ("idx", "val"), ("n",)),
    "ShardedBlockJacobi": (ShardedBlockJacobi, ("inv",), ()),
}
# MultisplitResult fields that are arrays (the rest are counts and flags)
_RESULT_ARRAYS = ("x", "inner_iters", "rnorm", "rnorm0", "local_rnorms",
                  "outer_rnorm", "history")
_RESULT_FLAGS = ("converged", "certified")


# the assembled formats and the stacked sparse operators: (class, array
# fields, plain fields); a field holding another of these formats is
# converted with it
_ASSEMBLED = {
    "DenseOp": (DenseOp, ("a",), ()),
    "ELL": (ELL, ("indices", "values"), ("ncols",)),
    "DIA": (DIA, ("data",), ("offsets",)),
    "BSR": (BSR, ("indices", "values", "indices_t", "values_t"),
            ("nrows", "ncols")),
    "StackedELLOperator": (StackedELLOperator, ("a_ii", "a_ic"), ()),
    "StackedDIAOperator": (StackedDIAOperator, ("dia_ii", "dia_ic"),
                           ("nblocks",)),
    "StackedBSROperator": (StackedBSROperator,
                           ("ii_idx", "ii_val", "ii_diag", "ic"),
                           ("nblocks", "block_size")),
}


def from_jax_operator(op, device=None):
    """The port's operator with the class, shape and values of the JAX
    package's ``op``: a matrix-free stencil (``Stencil2D``, ``Stencil3D``,
    ``StackedStencil2D``, ``StackedStencil3D``, ``StencilStrip2D``,
    ``StencilStrip3D``), an assembled format (``DenseOp``, ``ELL``,
    ``DIA``, ``BSR``) or a stacked sparse operator
    (``StackedELLOperator``, ``StackedDIAOperator``,
    ``StackedBSROperator``), whose arrays land on ``device`` (None: the
    current CUDA device).  A BSR pack that shares its transpose pack keeps
    sharing it.  The sharded configurations (``ShardedPoisson2D/3D``) and
    the sharded general operators (``ShardedGeneralBSR``,
    ``ShardedBlockJacobi``: their numpy arrays) come across too.  The JAX
    ``AIJ`` and ``ShardedAIJ`` keep only their routed plans: build the
    port's from the COO triplets with ``aij_from_coo`` and
    ``parallel.general.shard_aij_from_coo``."""
    name = type(op).__name__
    if name in _SHARDED:
        cls, arrays, plain = _SHARDED[name]
        return cls(**{f: tensor_from_numpy(np.asarray(getattr(op, f)), device)
                      for f in arrays},
                   **{f: int(getattr(op, f)) for f in plain})
    if name in _ASSEMBLED:
        cls, arrays, plain = _ASSEMBLED[name]
        seen = {}
        kw = {}
        for f in arrays:
            a = getattr(op, f)
            if id(a) not in seen:
                seen[id(a)] = (
                    from_jax_operator(a, device)
                    if type(a).__name__ in _ASSEMBLED
                    else tensor_from_numpy(np.asarray(a), device))
            kw[f] = seen[id(a)]
        for f in plain:
            v = getattr(op, f)
            kw[f] = tuple(int(o) for o in v) if f == "offsets" else int(v)
        return cls(**kw)
    if name not in _OPERATORS:
        raise TypeError(f"{name} is not ported; ported: "
                        f"{tuple(_OPERATORS) + tuple(_ASSEMBLED)}")
    cls, dims = _OPERATORS[name]
    return cls(*(int(getattr(op, d)) for d in dims), diag=float(op.diag),
               off=float(op.off))


def aij_from_coo(rows, cols, vals, shape, dtype: torch.dtype = torch.float32,
                 with_rmv: bool = True, device=None) -> AIJ:
    """The port's ``AIJ`` from the COO triplets that the JAX package's
    ``AIJ.from_coo`` was given."""
    return AIJ.from_coo(np.asarray(rows), np.asarray(cols), np.asarray(vals),
                        shape, dtype=dtype, with_rmv=with_rmv, device=device)


def block_jacobi_from_jax(pc, device=None) -> BlockJacobi:
    """The port's ``BlockJacobi`` with the JAX one's block inverses."""
    return BlockJacobi(
        inv_blocks=tensor_from_numpy(np.asarray(pc.inv_blocks), device),
        n=int(pc.n))


_KRYLOV_FIELDS = ("x", "iters", "resnorm", "resnorm0", "converged")


def krylov_result_from_numpy(fields: dict, device=None) -> KrylovResult:
    """The port's ``KrylovResult`` from a mapping of the JAX
    ``KrylovResult``'s fields as numpy values (``syncs``, which JAX does
    not count, is 0)."""
    return KrylovResult(**{f: tensor_from_numpy(fields[f], device)
                           for f in _KRYLOV_FIELDS})


def krylov_result_to_numpy(res: KrylovResult) -> dict:
    """Every field of the port's ``KrylovResult``, tensors as numpy."""
    return {f.name: (getattr(res, f.name).cpu().numpy()
                     if isinstance(getattr(res, f.name), torch.Tensor)
                     else getattr(res, f.name))
            for f in dataclasses.fields(res)}


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A contiguous tensor on ``device`` (None: the current CUDA device)
    holding ``a``'s values and dtype
    (bf16 arrays, which numpy knows only through ``ml_dtypes``, arrive
    exactly through f32)."""
    a = np.asarray(a)
    device = resolve(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")   # torch shares only writable memory
    return torch.from_numpy(a).to(device)


def df_pair_from_numpy(hi, lo, device=None):
    """A double-float (hi, lo) pair of f32 tensors on ``device``."""
    hi, lo = np.asarray(hi), np.asarray(lo)
    if hi.dtype != np.float32 or lo.dtype != np.float32:
        raise ValueError(f"df components must be f32, got {hi.dtype}, {lo.dtype}")
    return tensor_from_numpy(hi, device), tensor_from_numpy(lo, device)


def multisplit_result_from_numpy(fields: dict, device=None) -> MultisplitResult:
    """The port's ``MultisplitResult`` from a mapping of the JAX
    ``MultisplitResult``'s fields as numpy values (a missing or None
    field stays None; ``syncs``, which JAX does not count, is 0)."""
    kw = {}
    for f in dataclasses.fields(MultisplitResult):
        v = fields.get(f.name)
        if v is None:
            continue
        if f.name in _RESULT_ARRAYS:
            kw[f.name] = tensor_from_numpy(v, device)
        elif f.name in _RESULT_FLAGS:
            kw[f.name] = bool(v)
        else:
            kw[f.name] = int(v)
    return MultisplitResult(**kw)


def multisplit_result_to_numpy(res: MultisplitResult) -> dict:
    """Every field of the port's ``MultisplitResult``: arrays as numpy
    (on the host), counts and flags as they are."""
    return {f.name: (getattr(res, f.name).cpu().numpy()
                     if isinstance(getattr(res, f.name), torch.Tensor)
                     else getattr(res, f.name))
            for f in dataclasses.fields(res)}


def mg_levels_from_fields(fields) -> MGLevels:
    """The port's ``MGLevels`` from the JAX one (read by its attributes)
    or from a mapping of its fields: ``dims`` (an integer array or nested
    sequence, fine to coarse), ``diag``, ``off``, ``nu``, ``coarse_iters``,
    ``cycle`` and ``transfers``."""
    get = fields.get if isinstance(fields, dict) else (
        lambda f, default=None: getattr(fields, f, default))
    return MGLevels(
        dims=tuple(tuple(int(n) for n in d) for d in get("dims")),
        diag=float(get("diag")), off=float(get("off")), nu=int(get("nu")),
        coarse_iters=int(get("coarse_iters")), cycle=str(get("cycle", "w")),
        transfers=str(get("transfers", "pwc")))


def mg_levels_to_fields(levels: MGLevels) -> dict:
    """The fields of the port's ``MGLevels``, ``dims`` as an integer
    array: what ``mg_levels_from_fields`` reads, and what builds the JAX
    ``MGLevels`` with ``dims`` turned back into tuples."""
    d = dataclasses.asdict(levels)
    d["dims"] = np.asarray(levels.dims, np.int64)
    return d


def refine_result_from_numpy(fields: dict, device=None) -> RefineResult:
    """The port's ``RefineResult`` from a mapping of the JAX
    ``RefineResult``'s fields as numpy values.  ``x`` is the f64 solution
    (kept as numpy) or a double-float ``(hi, lo)`` pair of f32 arrays,
    which lands on ``device`` (None: the current CUDA device);
    ``pcg_iters`` and ``syncs``, which JAX does not report, default to
    empty and 0."""
    x = fields["x"]
    if isinstance(x, (tuple, list)):
        x = df_pair_from_numpy(*x, device=device)
    else:
        x = np.asarray(x, np.float64)
    return RefineResult(
        x, int(fields["passes"]), [float(v) for v in fields["rel_history"]],
        float(fields["rnorm"]), float(fields["rnorm0"]),
        bool(fields["converged"]),
        pcg_iters=[int(v) for v in fields.get("pcg_iters", ())],
        syncs=int(fields.get("syncs", 0)))


def refine_result_to_numpy(res: RefineResult) -> dict:
    """Every field of the port's ``RefineResult``; a double-float ``x``
    comes back as its ``(hi, lo)`` pair of numpy arrays."""
    d = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}
    if isinstance(res.x, (tuple, list)):
        d["x"] = tuple(t.detach().cpu().numpy() for t in res.x)
    return d
