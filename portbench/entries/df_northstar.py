"""Entry ``df_northstar``: ``df_northstar_fused(op, (bhi, blo), rtol=...,
inner_rtol=...)``, the double-float refined MG-PCG program (two CUDA
graphs on the card, kernels A-D and M in 3D, E, L and M in 2D), on the
configuration's whole 2D or 3D grid.

The right-hand side goes in as its f32 ``(hi, lo)`` pair; the solution
comes back as the pair ``(xhi, xlo)``, ``x = xhi + xlo``."""

from __future__ import annotations

import types

import torch


def build(config: dict, params: dict, device):
    """The operator of the configuration's grid, and the solve's
    parameters."""
    import medane_tchakorom_ufc_thesis_repository_tpu_torch as port

    grid = [int(n) for n in config["grid"]]
    make = {"poisson2d": port.poisson2d, "poisson3d": port.poisson3d}
    op = make[config["operator"]](*grid)
    return types.SimpleNamespace(op=op, params=dict(params), port=port)


def inputs(config: dict, b64: torch.Tensor):
    """The f32 pair ``(hi, lo)`` with ``hi + lo`` = ``b64`` to ~2^-48."""
    hi = b64.to(torch.float32)
    lo = (b64 - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def given(pair) -> torch.Tensor:
    """The right-hand side as the port was given it, in f64."""
    return pair[0].to(torch.float64) + pair[1].to(torch.float64)


def solve(state, pair):
    return state.port.df_northstar_fused(state.op, pair, **state.params)


def answer(result):
    return tuple(result.x)


def converged(result) -> bool:
    return bool(result.converged)


def counts(result) -> dict:
    return {"refine.pcg_iters": sum(result.pcg_iters),
            "refine.host_syncs": result.syncs,
            "refine.passes": result.passes}


def answer_f64(config: dict, pair) -> torch.Tensor:
    return pair[0].to(torch.float64) + pair[1].to(torch.float64)


def control(pair):
    """The answer held in f32, the precision below double-float."""
    x = (pair[0].to(torch.float64) + pair[1].to(torch.float64)).to(torch.float32)
    return x, torch.zeros_like(x)


def close(state) -> None:
    """Free the program the solves ran through: its static buffers and
    graph pool."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import refine

    refine._df_fused_program.cache_clear()
    state.op = None
