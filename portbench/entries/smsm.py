"""Entry ``smsm``: ``smsm(op, b, scope=..., s=..., rtol=..., maxiter=...,
inner=InnerConfig(...))``, the thesis's synchronous multisplitting with a
synchronous minimization, on ``block_poisson2d`` / ``block_poisson3d``
row strips of the configuration's grid (``blocks`` of them).

The right-hand side goes in as the stacked f32 ``b`` of shape
``(blocks, block_size)``, the grid's rows in order; the solution comes
back stacked the same way."""

from __future__ import annotations

import types

import torch


def build(config: dict, params: dict, device):
    import medane_tchakorom_ufc_thesis_repository_tpu_torch as port

    grid = [int(n) for n in config["grid"]]
    make = {"poisson2d": port.block_poisson2d, "poisson3d": port.block_poisson3d}
    op = make[config["operator"]](*grid, nblocks=int(config["blocks"]))
    p = dict(params)
    inner = port.InnerConfig(**p.pop("inner", {}))
    return types.SimpleNamespace(op=op, params=p, inner=inner, port=port,
                                 grid=grid)


def inputs(config: dict, b64: torch.Tensor):
    blocks = int(config["blocks"])
    return (b64.to(torch.float32).reshape(blocks, b64.numel() // blocks),)


def given(inp) -> torch.Tensor:
    return inp[0].to(torch.float64)


def solve(state, inp):
    return state.port.smsm(state.op, inp[0], inner=state.inner, **state.params)


def answer(result):
    return (result.x,)


def converged(result) -> bool:
    return bool(result.converged)


def counts(result) -> dict:
    return {"multisplit.sweeps": result.sweeps,
            "multisplit.cycles": result.cycles,
            "multisplit.inner_iters": int(result.inner_iters),
            "multisplit.host_syncs": result.syncs}


def answer_f64(config: dict, ans) -> torch.Tensor:
    return ans[0].to(torch.float64).reshape([int(n) for n in config["grid"]])


def control(ans):
    """The answer held in bf16, the precision below f32."""
    return (ans[0].to(torch.bfloat16).to(ans[0].dtype),)


def close(state) -> None:
    state.op = None
