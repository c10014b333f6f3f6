#!/usr/bin/env python3
"""Drive the PyTorch port's 3D Poisson north-star on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It imports the port (``medane_tchakorom_ufc_thesis_repository_tpu_torch``)
from this checkout and nothing of JAX, and:

1. finds a CUDA device, or exits non-zero;
2. prints the card's name and power limit (``nvidia-smi``);
3. builds the four CUDA kernels from ``csrc/`` and prints the build time;
4. kernel phase: holds every kernel and kind against its plain PyTorch
   version on the card, at 512^3, at an odd shape and at 4^3, for every
   dtype combination of the path; times kernel and plain at 512^3 (CUDA
   events, median of 20);
5. slice phase: ``df_northstar_fused(op, b_df, rtol=1e-8,
   inner_rtol=1e-4)`` at 256^3 and 512^3 with b = A·1.  The first run
   at each size is counted: every kernel must have been launched.  It
   must converge in at most 3 passes, to a relative residual <= 1e-8
   recomputed in f64 on the card, with max|x - 1| <= 1e-6.  The solve
   time is the median of 3 more runs.

Any failure raises.  The line before the last is a JSON object of the
kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "medane_tchakorom_ufc_thesis_repository_tpu_torch"
REF = "medane_tchakorom_ufc_thesis_repository_tpu/ops/stencil_pallas.py"

# kernel entries: (name, source, replaced TPU kernel, dtypes timed at 512^3)
ENTRIES = [
    ("stencil3d_apply[mv]", "stencil3d.cu", f"{REF}:441", ("f32", "f32")),
    ("stencil3d_apply[mv_dot]", "stencil3d.cu", f"{REF}:441", ("f32", "f32")),
    ("stencil3d_apply[residual]", "stencil3d.cu", f"{REF}:441",
     ("bf16", "bf16")),
    ("stencil3d_apply[jacobi]", "stencil3d.cu", f"{REF}:441", ("bf16", "bf16")),
    ("stencil3d_apply[jacobi_dot]", "stencil3d.cu", f"{REF}:441",
     ("bf16", "f32")),
    ("stencil3d_mv_cast", "stencil3d.cu", f"{REF}:607", ("f32", "bf16")),
    ("stencil3d_residual_restrict", "stencil3d.cu", f"{REF}:1140",
     ("bf16", "bf16")),
    ("stencil3d_prolong_jacobi", "stencil3d.cu", f"{REF}:1094",
     ("bf16", "bf16")),
    ("stencil3d_df_residual", "df_residual.cu", f"{REF}:867", ("f32", "f32")),
]
FULL = (512, 512, 512)
ODD = (37, 24, 130)
ODD_EVEN = (38, 24, 130)   # kernels B and C need even dims
TINY = (4, 4, 4)
SLICE = (256, 512)          # north-star grid sizes
DIAG, OFF = 6.0, -1.0
OMEGA = (6.0 / 7.0) / DIAG


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import medane_tchakorom_ufc_thesis_repository_tpu_torch as port

    if Path(port.__file__).resolve().parent != ROOT / PKG:
        raise RuntimeError(f"{PKG} was imported from {port.__file__}, "
                           f"not from this checkout")
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    import logging
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout)
    t0 = time.perf_counter()
    build.load_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    report = kernel_phase(torch, k, dev)
    launches = slice_phase(torch, port, k, dev)
    kernels = []
    for name, src, replaces, _ in ENTRIES:
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def check(torch, what: str, out, ref, tol: str, dot_floor: float = 0.0) -> float:
    """Raise unless the kernel's ``out`` agrees with the plain ``ref``;
    return the largest absolute difference.

    f32: rtol 1e-6, with an absolute floor of 1e-6 * max|ref| because the
    tap order and FMA contraction differ and a residual can cancel to
    near zero.  bf16: 1 bf16 ulp of ref plus the same floor.  dot: rtol
    1e-5, with an absolute floor ``dot_floor`` (1e-6 * |a| |b| of the dot's
    operands: the two sum in different orders and a small dot can
    cancel).  bits: equal bit patterns."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{what}: got {out.dtype}{tuple(out.shape)}, "
                             f"expected {ref.dtype}{tuple(ref.shape)}")
    if tol == "bits":
        same = torch.equal(out.view(torch.int32), ref.view(torch.int32))
        if not same:
            n = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
            raise AssertionError(f"{what}: {n} values differ in their bits")
    o, r = out.double(), ref.double()
    if not torch.isfinite(o).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (o - r).abs()
    floor = 1e-6 * float(r.abs().max())
    if tol == "f32":
        bound = 1e-6 * r.abs() + floor
    elif tol == "bf16":
        ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
        bound = torch.where(r == 0, 0.0, ulp) + floor
    elif tol == "dot":
        bound = 1e-5 * r.abs() + dot_floor
    elif tol == "bits":
        bound = torch.zeros_like(r)
    else:
        raise ValueError(tol)
    bad = err > bound
    if bad.any():
        i = int(torch.argmax((err - bound).reshape(-1)))
        raise AssertionError(
            f"{what}: {int(bad.sum())} values out of tolerance ({tol}); worst "
            f"kernel {o.reshape(-1)[i].item()!r} plain {r.reshape(-1)[i].item()!r}")
    return float(err.max())


def median_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_phase(torch, k, dev) -> dict:
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dt[dtype])

    report = {name: {"max_abs_err": 0.0, "ms": None, "plain_ms": None}
              for name, *_ in ENTRIES}
    timed = {name: dts for name, _, _, dts in ENTRIES}
    combos = [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32"),
              ("f32", "bf16")]

    def run(name, shape, dts, kernel, plain, tols, dot_operand=None,
            path=True):
        """Compare; ``max_abs_err`` takes the array outputs, not the dots.
        Time at 512^3 in the path's dtypes (and coefficients: ``path``)."""
        outs = kernel()
        refs = plain()
        torch.cuda.synchronize()
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = refs if isinstance(refs, tuple) else (refs,)
        what = f"{name} {dts} {shape}"
        for o, r, tol in zip(outs, refs, tols):
            if tol == "dot":
                norm = torch.linalg.vector_norm
                floor = 1e-6 * float(norm(dot_operand.double())
                                     * norm(refs[0].double()))
                check(torch, what, o, r, tol, floor)
                continue
            e = check(torch, what, o, r, tol)
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
        if shape == FULL and dts == timed[name] and path:
            report[name]["ms"] = median_ms(torch, kernel)
            report[name]["plain_ms"] = median_ms(torch, plain)
            log(f"{name} {dts} 512^3: kernel {report[name]['ms']:.3f} ms, "
                f"plain {report[name]['plain_ms']:.3f} ms")

    for shape in (FULL, ODD, TINY):
        for xd, od in combos:
            x = rand(shape, xd)
            b = rand(shape, xd)
            odt = dt[od]
            for kind in k.KINDS:
                ex = (b,) if kind in ("residual", "jacobi", "jacobi_dot") else ()
                om = OMEGA if kind.startswith("jacobi") else None
                tols = ((od, "dot") if kind.endswith("_dot") else (od,))
                operand = b if kind == "jacobi_dot" else x
                run(f"stencil3d_apply[{kind}]", shape, (xd, od),
                    lambda: k.stencil3d_apply(x, *ex, kind=kind, diag=DIAG,
                                              off=OFF, omega=om,
                                              out_dtype=odt),
                    lambda: k.stencil3d_apply_plain(x, *ex, kind=kind,
                                                    diag=DIAG, off=OFF,
                                                    omega=om, out_dtype=odt),
                    tols, operand)
            # the cycle's first sweep: the modified coefficients of A2
            d2, o2 = 2 * OMEGA - OMEGA * OMEGA * DIAG, -OMEGA * OMEGA * OFF
            run("stencil3d_mv_cast", shape, (xd, od),
                lambda: k.stencil3d_mv_cast(x, diag=d2, off=o2, out_dtype=odt),
                lambda: k.stencil3d_mv_cast_plain(x, diag=d2, off=o2,
                                                  out_dtype=odt),
                (od, od))
            del x, b
        log(f"kernel A: {shape} ok")

    for shape in (FULL, ODD_EVEN, TINY):
        coarse = tuple(n // 2 for n in shape)
        for d in ("f32", "bf16"):
            x, b, e = rand(shape, d), rand(shape, d), rand(coarse, d)
            run("stencil3d_residual_restrict", shape, (d, d),
                lambda: k.stencil3d_residual_restrict(x, b, diag=DIAG, off=OFF,
                                                      scale=4.0),
                lambda: k.stencil3d_residual_restrict_plain(
                    x, b, diag=DIAG, off=OFF, scale=4.0), (d,))
            run("stencil3d_prolong_jacobi", shape, (d, d),
                lambda: k.stencil3d_prolong_jacobi(x, b, e, diag=DIAG, off=OFF,
                                                   omega=OMEGA),
                lambda: k.stencil3d_prolong_jacobi_plain(
                    x, b, e, diag=DIAG, off=OFF, omega=OMEGA), (d,))
            del x, b, e
        log(f"kernels B, C: {shape} ok")

    for shape in (FULL, ODD, TINY):
        # x and b as df pairs with a lo part of realistic size
        xs = [rand(shape, "f32") for _ in range(2)]
        xhi, xlo = xs[0], xs[1] * 2.0**-26
        bs = [rand(shape, "f32") for _ in range(2)]
        bhi, blo = bs[0], bs[1] * 2.0**-26
        # diag 6 / off -1 is the path; 5 and 7/-3 take the two-power and
        # Dekker products
        for diag, off in ((DIAG, OFF), (5.0, -1.0), (7.0, -3.0)):
            run("stencil3d_df_residual", shape, ("f32", "f32"),
                lambda: k.stencil3d_df_residual(xhi, xlo, bhi, blo, diag=diag,
                                                off=off),
                lambda: k.stencil3d_df_residual_plain(xhi, xlo, bhi, blo,
                                                      diag=diag, off=off),
                ("bits", "bits"), path=(diag, off) == (DIAG, OFF))
        del xs, bs, xhi, xlo, bhi, blo
        log(f"kernel D: {shape} ok")
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# Slice phase
# ---------------------------------------------------------------------------

def slice_phase(torch, port, k, dev) -> dict:
    names = [name for name, *_ in ENTRIES]
    launches = {}
    for n in SLICE:
        op = port.poisson3d(n, n, n)
        bhi = op.mv(torch.ones((n, n, n), dtype=torch.float32, device=dev))
        b_df = (bhi, torch.zeros_like(bhi))

        def solve():
            return port.df_northstar_fused(op, b_df, rtol=1e-8,
                                           inner_rtol=1e-4)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k.reset_launch_counts()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = k.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        missing = [m for m in names if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"{n}^3: kernels never launched: {missing}")
        launches = {m: counts[m] for m in names}
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)

        xhi, xlo = res.x
        x64 = xhi.double() + xlo.double()
        b64 = bhi.double()
        r = b64 - k.stencil3d_apply_plain(x64, kind="mv", diag=op.diag,
                                          off=op.off)
        rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))
        err = float((x64 - 1.0).abs().max())
        del x64, b64, r
        log(f"{n}^3: passes {res.passes}, PCG iterations {res.pcg_iters}, "
            f"host syncs {res.syncs}, df rel {res.rnorm / res.rnorm0:.3e}, "
            f"f64 rel {rel:.3e}, max|x-1| {err:.3e}")
        log(f"{n}^3: solve {statistics.median(times) * 1e3:.1f} ms median of "
            f"3 {[round(t * 1e3, 1) for t in times]} (first run "
            f"{first_s * 1e3:.1f} ms), peak memory {peak / 2**30:.2f} GiB")
        log(f"{n}^3: kernel launches per solve {counts}")
        if not (res.converged and res.passes <= 3):
            raise AssertionError(f"{n}^3: converged={res.converged} in "
                                 f"{res.passes} passes")
        if not rel <= 1e-8:
            raise AssertionError(f"{n}^3: f64 relative residual {rel:.3e}")
        if not err <= 1e-6:
            raise AssertionError(f"{n}^3: max|x - 1| = {err:.3e}")
        del op, bhi, b_df, res, xhi, xlo
        torch.cuda.empty_cache()
    return launches


if __name__ == "__main__":
    main()
