"""Measure the operator-routing constants on the current device (port of
the JAX package's ``utils/calibrate.py``).

``core.calibration`` ships constants measured on one H100.  This module
measures them again on whatever card (or, for the tests, CPU) it runs on,
and saves them where ``core.calibration`` looks:

    python -m medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.calibrate \\
        [--save] [--out PATH] [--stored 268435456] [--device cuda]

Every time is per stored value and relative to ``DIA.mv`` on the 5-point
matrix of a ``dia_grid``-squared grid (the slice path):

* ``bsr_bs_penalty`` -- kernel I (``ops.bsr.bsr_mv``) by block size, on
  block rows of ``width`` random blocks holding ``stored`` values in all;
* ``aij_relative_cost`` -- kernel H (``AIJ.mv``) on a structureless
  square pattern, ``aij_n`` rows of ``draws`` random entries;
* ``ell_relative_cost`` -- ``ELL.mv`` on a structureless pattern of
  ``ell_n`` rows;
* ``max_dense_n`` -- the largest ``n`` of ``dense_ns`` up to which
  ``DenseOp.mv`` was no slower than kernel H on a structureless pattern,
  never above the shipped value (above it the n² storage decides).

On a card each time is the median of ``rounds`` medians of ``reps``
launches timed with CUDA events, printed with the spread of the medians;
on the CPU ``time.perf_counter`` times the calls.  Without ``--save``
this is a dry run: it prints the JSON, so that the numbers can be read
before they steer any routing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import (
    calibration,
    poisson,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    AIJ,
    DenseOp,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import bsr

__all__ = ["measure_calibration", "main"]


def _median_ms(fn, dev: torch.device, reps: int) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(dev)
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _repeat_ms(fn, dev, reps: int, rounds: int):
    """The median of ``rounds`` medians of ``reps`` calls, and their
    spread ((largest - smallest) / median)."""
    ms = [_median_ms(fn, dev, reps) for _ in range(rounds)]
    mid = statistics.median(ms)
    return mid, (max(ms) - min(ms)) / mid


def structureless_coo(n: int, draws: int, seed: int):
    """A random pattern with no band or block structure: ``draws * n``
    (row, column, value) draws, duplicates and all."""
    rng = np.random.default_rng(seed)
    nnz = n * draws
    return (rng.integers(0, n, nnz), rng.integers(0, n, nnz),
            rng.standard_normal(nnz))


def coalesced(rows, cols, vals, n: int):
    """COO triplets with duplicates summed."""
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    c = a.tocoo()
    return c.row, c.col, c.data


def measure_calibration(dia_grid: int = 4096, stored: int = 1 << 28,
                        block_sizes=(8, 16, 32, 64, 128), width: int = 8,
                        aij_n: int = 1 << 22, ell_n: int = 1 << 20,
                        draws: int = 10,
                        dense_ns=tuple(1 << e for e in range(8, 15)),
                        reps: int = 20, rounds: int = 3, seed: int = 0,
                        device=None, log=print) -> dict:
    """Run the measurements in f32 on ``device`` (None: the current card)
    and return a calibration dict that ``core.calibration.save``
    persists.  The defaults are the sizes the shipped table was measured
    at: working sets far beyond the card's 50 MB L2, launches of 0.4 ms
    and more but for the dense crossover."""
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    rng = np.random.default_rng(seed + 4)
    spreads = {}

    def timed(fn):
        return _repeat_ms(fn, dev, reps, rounds)

    dia = poisson.poisson2d_dia(dia_grid, dia_grid, device=dev)
    x = torch.randn(dia.shape[1], generator=gen, device=dev)
    dia_ms, spreads["dia"] = timed(lambda: dia.mv(x))
    unit = dia_ms / dia.data.numel()
    log(f"calibration: DIA.mv {dia_grid}^2, {dia.data.numel()} stored "
        f"values: {dia_ms:.3f} ms (spread {spreads['dia']:.1%})")
    del dia, x

    penalty = {}
    for bs in block_sizes:
        nbr = stored // (width * bs * bs)
        # width distinct block columns a row, ascending from a random start
        steps = rng.integers(1, nbr // width, size=(nbr, width))
        cols = (np.cumsum(steps, axis=1) + np.arange(nbr)[:, None]) % nbr
        idx = torch.from_numpy(np.sort(cols, axis=1).astype(np.int32)).to(dev)
        val = torch.randn((nbr, width, bs, bs), generator=gen, device=dev)
        x = torch.randn(nbr * bs, generator=gen, device=dev)
        ms, spreads[f"bsr{bs}"] = timed(
            lambda: bsr.bsr_mv(idx, val, x, nbr * bs, nbr * bs))
        penalty[bs] = ms / val.numel() / unit
        log(f"calibration: bsr_mv bs={bs} nbr={nbr}: {ms:.3f} ms (spread "
            f"{spreads[f'bsr{bs}']:.1%}), {penalty[bs]:.3f}x DIA per stored "
            f"value")
        del idx, val, x

    aij = AIJ.from_coo(*structureless_coo(aij_n, draws, seed + 7),
                       (aij_n, aij_n), with_rmv=False, device=dev)
    x = torch.randn(aij_n, generator=gen, device=dev)
    aij_ms, spreads["aij"] = timed(lambda: aij.mv(x))
    aij_cost = aij_ms / aij.nnz / unit
    log(f"calibration: csr_mv n={aij_n}, {aij.nnz} nonzeros: {aij_ms:.3f} ms "
        f"(spread {spreads['aij']:.1%}), {aij_cost:.3f}x DIA per nonzero")
    del aij, x

    rows, cols, vals = structureless_coo(ell_n, draws, seed + 8)
    ell = poisson.coo_to_ell(*coalesced(rows, cols, vals, ell_n),
                             (ell_n, ell_n), device=dev)
    x = torch.randn(ell_n, generator=gen, device=dev)
    ell_ms, spreads["ell"] = timed(lambda: ell.mv(x))
    true_nnz = int(torch.count_nonzero(ell.values))
    ell_cost = ell_ms / true_nnz / unit
    log(f"calibration: ELL.mv n={ell_n} width {ell.indices.shape[1]}, "
        f"{true_nnz} nonzeros: {ell_ms:.3f} ms (spread {spreads['ell']:.1%}),"
        f" {ell_cost:.2f}x DIA per nonzero")
    del ell, x

    max_dense_n, still = 0, True
    for n in dense_ns:
        op = AIJ.from_coo(*structureless_coo(n, draws, seed + 9 + n), (n, n),
                          with_rmv=False, device=dev)
        dense = DenseOp(a=op.to_dense())
        x = torch.randn(n, generator=gen, device=dev)
        d_ms, d_spread = timed(lambda: dense.mv(x))
        c_ms, c_spread = timed(lambda: op.mv(x))
        log(f"calibration: n={n}: DenseOp.mv {d_ms:.4f} ms (spread "
            f"{d_spread:.1%}), csr_mv {c_ms:.4f} ms (spread {c_spread:.1%})")
        still = still and d_ms <= c_ms
        if still:
            max_dense_n = n
        del op, dense, x
    cap = calibration.SHIPPED["max_dense_n"]
    max_dense_n = min(max_dense_n or cap, cap)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"
    return {
        "device_kind": kind.replace(" ", "_").replace("/", "_"),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "stored_budget": stored,
        "dia_ms": dia_ms,
        "bsr_bs_penalty": {str(k): round(v, 3) for k, v in penalty.items()},
        "aij_relative_cost": round(aij_cost, 3),
        "ell_relative_cost": round(ell_cost, 3),
        "max_dense_n": int(max_dense_n),
        "spread": {k: round(v, 4) for k, v in spreads.items()},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="measure the routing calibration on the current device")
    p.add_argument("--save", action="store_true",
                   help="persist to the per-device-kind cache path")
    p.add_argument("--out", default=None,
                   help="explicit output path (implies --save)")
    p.add_argument("--stored", type=int, default=1 << 28,
                   help="BSR stored-value budget per block size")
    p.add_argument("--device", default=None,
                   help="cuda (default: the current card) or cpu")
    args = p.parse_args(argv)

    cal = measure_calibration(stored=args.stored, device=args.device,
                              log=lambda m: print(m, file=sys.stderr))
    print(json.dumps(cal, indent=2, sort_keys=True))
    if args.save or args.out:
        path = calibration.save(cal, args.out)
        print(f"saved: {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
