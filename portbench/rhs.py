"""The right-hand sides of every cell, made on the device.

A traffic mix names a pool of ``pool`` right-hand sides, member ``j``
made from ``(pool_seed, j)``; ``--seed`` orders them.  The window solves
the pool over and over, each pass through it in an order of its own
drawn from ``(seed, pass)``, and closes at the end of a pass: every run
of a cell does the same work, whatever its seed, in another order.  (The
work of one solve depends on its right-hand side: in 2D a bf16-cycle
MG-PCG pass takes 5 to 40 iterations by b, and SMSM_GLOBAL 3 or 4
cycles.)

Member ``j`` is ``b = A u`` in f64 by the reference's stencil, with
``u = 1 + sum of `modes` separable sine modes + white noise``: integer
wavenumbers drawn in ``1..kmax`` per axis, amplitudes drawn from
``N(0, amplitude^2)``, noise of standard deviation ``noise``.  Every
frequency is present, as in a pressure-Poisson right-hand side.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.stencil import poisson_apply


def _draws(pool_seed: int, member: int, ndim: int, spec: dict):
    """``(torch seed, wavenumbers (modes, ndim), amplitudes (modes,))``."""
    rng = np.random.default_rng(np.random.SeedSequence([pool_seed % 2**64, member]))
    torch_seed = int(rng.integers(0, 2**63 - 1))
    waves = rng.integers(1, int(spec["kmax"]) + 1, size=(int(spec["modes"]), ndim))
    amps = rng.normal(0.0, float(spec["amplitude"]), size=int(spec["modes"]))
    return torch_seed, waves, amps


def _sines(n: int, waves: np.ndarray, device) -> torch.Tensor:
    """``(n, modes)``: ``sin(pi k (i + 1) / (n + 1))`` for each mode's ``k``."""
    i = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    k = torch.as_tensor(waves, dtype=torch.float64, device=device)
    return torch.sin(i[:, None] * k[None, :] * (math.pi / (n + 1)))


def solution(dims, spec: dict, member: int, device) -> torch.Tensor:
    """The f64 grid ``u`` of pool member ``member``."""
    dims = tuple(int(n) for n in dims)
    if len(dims) not in (2, 3):
        raise ValueError(f"a 2D or 3D grid is needed, got {dims}")
    torch_seed, waves, amps = _draws(int(spec["pool_seed"]), member, len(dims), spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed)
    u = torch.randn(dims, dtype=torch.float64, device=device, generator=gen)
    u.mul_(float(spec["noise"])).add_(1.0)
    a = torch.as_tensor(amps, dtype=torch.float64, device=device)
    factors = [_sines(n, waves[:, axis], device) for axis, n in enumerate(dims)]
    # all modes in one rank-`modes` update: u += (a * S_lead) @ S_last^T
    lead = factors[0] * a
    for f in factors[1:-1]:
        lead = (lead[:, None, :] * f[None, :, :]).reshape(-1, lead.shape[1])
    u.view(-1, dims[-1]).addmm_(lead, factors[-1].T)
    return u


def make(dims, spec: dict, stencil: dict, member: int, device) -> torch.Tensor:
    """The f64 right-hand side ``b = A u`` of pool member ``member``."""
    u = solution(dims, spec, member, device)
    return poisson_apply(u, float(stencil["diag"]), float(stencil["off"]))


def member(seed: int, k: int, pool: int) -> int:
    """The pool member that solve ``k`` of a run with ``seed`` solves: pass
    ``k // pool`` through the pool in its own order."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 3, k // pool]))
    return int(rng.permutation(pool)[k % pool])
