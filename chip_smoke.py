#!/usr/bin/env python3
"""Drive the PyTorch port's two slices on one NVIDIA GPU: the 3D Poisson
north-star and the thesis's two-stage multisplitting solvers.

Run from the root of a checkout:

    python3 chip_smoke.py

It imports the port (``medane_tchakorom_ufc_thesis_repository_tpu_torch``)
from this checkout and nothing of JAX, and:

1. finds a CUDA device, or exits non-zero;
2. prints the card's name and power limit (``nvidia-smi``);
3. builds the CUDA kernels from ``csrc/`` (one ``nvcc`` per source, all
   started together) and prints the build time;
4. kernel phase: holds every kernel and kind against its plain PyTorch
   version on the card, for every dtype combination of the paths:
   kernels A-D at 512^3, at an odd shape and at 4^3; kernel E (the 2D
   apply) at 8192^2, the two 2048x4096 strips of 4096^2, an s=4 panel
   of 4096^2, 3x37x130 and 4x4 in f32 and f64; kernels F and G (VecMDot
   and VecMAXPY) on the GMRES(20) basis of 4096^2 strips, (2, 21, 2^23),
   with a f32, bf16 and f64 basis at several live-row counts, and at an
   odd length.  Times kernel and plain at the paths' shapes (CUDA events,
   median of 20);
5. north-star phase: ``df_northstar_fused(op, b_df, rtol=1e-8,
   inner_rtol=1e-4)`` at 256^3 and 512^3 with b = A·1.  The first run
   at each size is counted: kernels A-D must have been launched.  It
   must converge in at most 3 passes, to a relative residual <= 1e-8
   recomputed in f64 on the card, with max|x - 1| <= 1e-6.  The solve
   time is the median of 3 more runs;
6. golden phase: SM, AM (staleness 2), SMSM_LOCAL, SMSM_SEMI_LOCAL and
   SMSM_GLOBAL on the 2D 32^2 strips in f64, through the kernels: the
   sweep counts must be exactly 42, 88, 36, 12 and 12;
7. thesis phase, in f32: SMSM_GLOBAL 2D 4096^2 (2 blocks, s=4, rtol
   1e-3), AM 1024^2 (staleness 2, rtol 1e-3) and SMSM_GLOBAL 3D 64^3
   with Chebyshev(20) inner solves (rtol 1e-5), b = A·1.  The first run
   of each is counted: every kernel of its path must have been launched.
   Each must converge (AM certified), to ||b - A x|| / ||r0|| under its
   rtol recomputed in f64 on the card.  Prints sweeps, cycles, inner
   iterations, host syncs, launches, the solve time (median of 3 more
   runs) and peak memory.

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
FUSED = "medane_tchakorom_ufc_thesis_repository_tpu/ops/fused_pallas.py"

# kernel entries: (name, source, replaced TPU kernel, dtypes timed, the
# path whose counted runs give its launches)
ENTRIES = [
    ("stencil3d_apply[mv]", "stencil3d.cu", f"{REF}:441", ("f32", "f32"),
     "northstar"),
    ("stencil3d_apply[mv_dot]", "stencil3d.cu", f"{REF}:441", ("f32", "f32"),
     "northstar"),
    ("stencil3d_apply[residual]", "stencil3d.cu", f"{REF}:441",
     ("bf16", "bf16"), "northstar"),
    ("stencil3d_apply[jacobi]", "stencil3d.cu", f"{REF}:441", ("bf16", "bf16"),
     "northstar"),
    ("stencil3d_apply[jacobi_dot]", "stencil3d.cu", f"{REF}:441",
     ("bf16", "f32"), "northstar"),
    ("stencil3d_mv_cast", "stencil3d.cu", f"{REF}:607", ("f32", "bf16"),
     "northstar"),
    ("stencil3d_residual_restrict", "stencil3d.cu", f"{REF}:1140",
     ("bf16", "bf16"), "northstar"),
    ("stencil3d_prolong_jacobi", "stencil3d.cu", f"{REF}:1094",
     ("bf16", "bf16"), "northstar"),
    ("stencil3d_df_residual", "df_residual.cu", f"{REF}:867", ("f32", "f32"),
     "northstar"),
    ("stencil2d_apply[mv]", "stencil2d.cu", f"{REF}:269", ("f32", "f32"),
     "thesis"),
    ("stencil2d_apply[spmm]", "stencil2d.cu", f"{FUSED}:156", ("f32", "f32"),
     "thesis"),
    ("mdot", "mdot.cu", f"{FUSED}:408", ("f32", "f32"), "thesis"),
    ("maxpy", "mdot.cu", f"{FUSED}:439", ("f32", "f32"), "thesis"),
]
FULL = (512, 512, 512)
ODD = (37, 24, 130)
ODD_EVEN = (38, 24, 130)   # kernels B and C need even dims
TINY = (4, 4, 4)
SLICE = (256, 512)          # north-star grid sizes
DIAG, OFF = 6.0, -1.0
# kernel E: (batch, m, n) shapes; the timed ones: the strips of 4096^2
# for [mv], the s=4 panel for [spmm]
E_SHAPES = [(1, 8192, 8192), (2, 2048, 4096), (4, 4096, 4096), (3, 37, 130),
            (1, 4, 4)]
E_TIMED = {"stencil2d_apply[mv]": (2, 2048, 4096),
           "stencil2d_apply[spmm]": (4, 4096, 4096)}
# kernels F, G: the GMRES(20) basis of the 4096^2 strips, and an odd length
FG_SHAPES = [(2, 21, 8_388_608), (3, 7, 1_000_003)]
GOLDEN = (("SM", 42), ("AM", 88), ("SMSM_LOCAL", 36),
          ("SMSM_SEMI_LOCAL", 12), ("SMSM_GLOBAL", 12))
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
    report.update(kernel_phase_2d(torch, dev))
    launches = slice_phase(torch, port, k, dev)
    golden_phase(torch, port, dev)
    launches.update(thesis_phase(torch, port, dev))
    kernels = []
    for name, src, replaces, _, _ in ENTRIES:
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
    near zero.  f64: the same at 1e-12.  bf16: 1 bf16 ulp of ref plus the
    f32 floor.  dot: rtol 1e-5 (dot64: 1e-12), with an absolute floor
    ``dot_floor`` (1e-6, or 1e-12 in f64, times |a| |b| of the dot's
    operands: the two sum in different orders and a small dot can
    cancel).  bits: equal bit patterns."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{what}: got {out.dtype}{tuple(out.shape)}, "
                             f"expected {ref.dtype}{tuple(ref.shape)}")
    if tol == "bits":
        as_int = {4: torch.int32, 8: torch.int64}[out.element_size()]
        diff = out.view(as_int) != ref.view(as_int)
        if diff.any():
            raise AssertionError(f"{what}: {int(diff.sum())} values differ in "
                                 f"their bits")
    o, r = out.double(), ref.double()
    if not torch.isfinite(o).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (o - r).abs()
    floor = 1e-6 * float(r.abs().max())
    if tol == "f32":
        bound = 1e-6 * r.abs() + floor
    elif tol == "f64":
        bound = 1e-12 * r.abs() + 1e-12 * float(r.abs().max())
    elif tol == "bf16":
        ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
        bound = torch.where(r == 0, 0.0, ulp) + floor
    elif tol == "dot":
        bound = 1e-5 * r.abs() + dot_floor
    elif tol == "dot64":
        bound = 1e-12 * r.abs() + dot_floor
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
              for name, _, _, _, path in ENTRIES if path == "northstar"}
    timed = {name: dts for name, _, _, dts, _ in ENTRIES}
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


def kernel_phase_2d(torch, dev) -> dict:
    """Kernel E (the 2D apply) and kernels F, G (VecMDot, VecMAXPY)
    against their plain versions; E must agree in every bit (both round
    each operation in the same order), F and G to the stated tolerances."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import fused
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d as e

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    report = {name: {"max_abs_err": 0.0, "ms": None, "plain_ms": None}
              for name, _, _, _, path in ENTRIES if path == "thesis"}

    def note(name, err):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)

    def timed(name, what, kernel, plain, json_entry=True):
        ms, plain_ms = median_ms(torch, kernel), median_ms(torch, plain)
        if json_entry:
            report[name].update(ms=ms, plain_ms=plain_ms)
        log(f"{name} {what}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

    for shape in E_SHAPES:
        for dtype in (torch.float32, torch.float64):
            x = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            for name, panel in (("stencil2d_apply[mv]", False),
                                ("stencil2d_apply[spmm]", True)):
                def kernel():
                    return e.stencil2d_apply(x, diag=4.0, off=-1.0, panel=panel)

                def plain():
                    return e.stencil2d_apply_plain(x, diag=4.0, off=-1.0)

                out, ref = kernel(), plain()
                torch.cuda.synchronize()
                note(name, check(torch, f"{name} {dtype} {shape}", out, ref,
                                 "bits"))
                del out, ref
                if shape == E_TIMED[name] or (shape == E_SHAPES[0]
                                              and not panel):
                    timed(name, f"{dtype} {shape}", kernel, plain,
                          json_entry=shape == E_TIMED[name]
                          and dtype == torch.float32)
            del x
        log(f"kernel E: {shape} ok")

    types = ((torch.float32, torch.float32, "dot", "f32", 1e-6),
             (torch.bfloat16, torch.float32, "dot", "f32", 1e-6),
             (torch.float64, torch.float64, "dot64", "f64", 1e-12))
    for shape in FG_SHAPES:
        B, K, N = shape
        for vd, ad, dot_tol, tol, floor in types:
            V = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float64 if vd == torch.float64
                            else torch.float32).to(vd)
            w = torch.randn((B, N), generator=gen, device=dev, dtype=ad)
            a = torch.randn((B, K), generator=gen, device=dev, dtype=ad)
            norms = (torch.linalg.vector_norm(V.double(), dim=-1)
                     * torch.linalg.vector_norm(w.double(), dim=-1)[:, None])
            for ka in (1, K // 2, K):
                what = f"{vd}/{ad} {shape} k_active {ka}"
                h, hp = fused.mdot(V, w, ka), fused.mdot_plain(V, w, ka)
                again = fused.mdot(V, w, ka)
                torch.cuda.synchronize()
                if not torch.equal(h, again):
                    raise AssertionError(f"mdot {what}: not deterministic")
                dot_floor = floor * norms.to(ad)
                dot_floor[:, ka:] = 0.0
                note("mdot", check(torch, f"mdot {what}", h, hp, dot_tol,
                                   dot_floor.double()))
                y, yp = (fused.maxpy(V, a, w, ka),
                         fused.maxpy_plain(V, a, w, ka))
                torch.cuda.synchronize()
                note("maxpy", check(torch, f"maxpy {what}", y, yp, tol))
                del h, hp, again, y, yp
            if shape == FG_SHAPES[0]:
                main = vd == torch.float32
                timed("mdot", f"{vd}/{ad} {shape}",
                      lambda: fused.mdot(V, w, K),
                      lambda: fused.mdot_plain(V, w, K), json_entry=main)
                timed("maxpy", f"{vd}/{ad} {shape}",
                      lambda: fused.maxpy(V, a, w, K),
                      lambda: fused.maxpy_plain(V, a, w, K), json_entry=main)
            del V, w, a, norms
        log(f"kernels F, G: {shape} ok")
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# North-star phase
# ---------------------------------------------------------------------------

def slice_phase(torch, port, k, dev) -> dict:
    names = [name for name, _, _, _, path in ENTRIES if path == "northstar"]
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


# ---------------------------------------------------------------------------
# Golden phase
# ---------------------------------------------------------------------------

def golden_phase(torch, port, dev) -> None:
    """The golden sweep counts of the JAX package (``tests/test_golden.py``)
    in f64 on the card, every apply and Gram-Schmidt step through the
    kernels: exact, or the run fails."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

    op = port.block_poisson2d(32, 32)
    b = port.rhs_ones(op, torch.float64, dev)
    runs = {
        "SM": lambda: port.sm(op, b, rtol=1e-3, maxiter=2000),
        "AM": lambda: port.am(op, b, staleness=2, rtol=1e-3, maxiter=4000),
        "SMSM_LOCAL": lambda: port.smsm(op, b, scope="local", s=4, rtol=1e-3,
                                        maxiter=2000),
        "SMSM_SEMI_LOCAL": lambda: port.smsm(op, b, scope="semi_local", s=4,
                                             rtol=1e-3, maxiter=2000),
        "SMSM_GLOBAL": lambda: port.smsm(op, b, scope="global", s=4,
                                         rtol=1e-3, maxiter=2000),
    }
    for name, sweeps in GOLDEN:
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = runs[name]()
        torch.cuda.synchronize()
        counts = build.launch_counts()
        log(f"golden {name} 32^2 f64: {res.sweeps} sweeps (expected {sweeps}), "
            f"{res.cycles} cycles, {int(res.inner_iters)} inner iterations, "
            f"certified {res.certified}, {res.syncs} host syncs, "
            f"{time.perf_counter() - t0:.2f} s, launches {counts}")
        if not res.converged or res.sweeps != sweeps:
            raise AssertionError(f"golden {name}: {res.sweeps} sweeps, "
                                 f"converged {res.converged}")
        if name == "AM" and not res.certified:
            raise AssertionError("golden AM: not certified")
        missing = [m for m in ("stencil2d_apply[mv]", "mdot", "maxpy")
                   if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"golden {name}: never launched {missing}")


# ---------------------------------------------------------------------------
# Thesis phase
# ---------------------------------------------------------------------------

def residual_f64(torch, op, x, b) -> float:
    """||b - A x|| / ||b|| in f64 on the card, through the plain applies
    (``||b|| = ||r0||`` from the zero start)."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d as e
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k

    x64, b64 = x.double(), b.double().reshape(-1)
    if hasattr(op, "m"):
        ax = e.stencil2d_apply_plain(x64.reshape(1, op.m, op.n), diag=op.diag,
                                     off=op.off)
    else:
        ax = k.stencil3d_apply_plain(x64.reshape(op.nx, op.ny, op.nz),
                                     kind="mv", diag=op.diag, off=op.off)
    r = b64 - ax.reshape(-1)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def thesis_phase(torch, port, dev) -> dict:
    """The thesis's configurations in f32; returns the launches of kernels
    E, F and G summed over the counted runs."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

    cheb = port.InnerConfig(method="chebyshev", maxiter=20)
    configs = [
        ("SMSM_GLOBAL 2D 4096^2", lambda: port.block_poisson2d(4096, 4096),
         lambda op, b: port.smsm(op, b, scope="global", s=4, rtol=1e-3,
                                 maxiter=2000), 1e-3,
         ("stencil2d_apply[mv]", "stencil2d_apply[spmm]", "mdot", "maxpy"),
         "TPU v5e: 52 sweeps with a bf16 basis (BENCHMARKS.md:28)"),
        ("AM 1024^2 staleness 2", lambda: port.block_poisson2d(1024, 1024),
         lambda op, b: port.am(op, b, staleness=2, rtol=1e-3, maxiter=4000),
         1e-3, ("stencil2d_apply[mv]", "mdot", "maxpy"),
         "TPU v5e: 282 sweeps (BENCHMARKS.md:70)"),
        ("SMSM_GLOBAL 3D 64^3 Chebyshev(20)",
         lambda: port.block_poisson3d(64, 64, 64),
         lambda op, b: port.smsm(op, b, scope="global", s=4, rtol=1e-5,
                                 maxiter=2000, inner=cheb), 1e-5,
         ("stencil3d_apply[mv]", "maxpy"),
         "TPU v5e: 48 sweeps to rel 8.6e-6 (BENCHMARKS.md:19)"),
    ]
    names = [name for name, _, _, _, path in ENTRIES if path == "thesis"]
    total = dict.fromkeys(names, 0)
    for label, make, solve, rtol, need, tpu in configs:
        op = make()
        b = port.rhs_ones(op, torch.float32, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = solve(op, b)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        missing = [m for m in need if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        for m in names:
            total[m] += counts.get(m, 0)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(op, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rel = residual_f64(torch, op, res.x, b)
        err = float((res.x.double() - 1.0).abs().max())
        log(f"{label}: {res.sweeps} sweeps, {res.cycles} cycles, "
            f"{int(res.inner_iters)} inner iterations, {res.syncs} host "
            f"syncs, converged {res.converged}, certified {res.certified}, "
            f"tail sweeps {res.tail_sweeps}; f32 rel "
            f"{float(res.rnorm / res.rnorm0):.3e}, f64 rel {rel:.3e}, "
            f"max|x-1| {err:.3e} ({tpu})")
        log(f"{label}: solve {statistics.median(times) * 1e3:.1f} ms median "
            f"of 3 {[round(t * 1e3, 1) for t in times]} (first run "
            f"{first_s * 1e3:.1f} ms), peak memory {peak / 2**30:.2f} GiB")
        log(f"{label}: kernel launches per solve {counts}")
        if not res.converged or (res.certified is not None
                                 and not res.certified):
            raise AssertionError(f"{label}: converged {res.converged}, "
                                 f"certified {res.certified}")
        if not rel <= rtol:
            raise AssertionError(f"{label}: f64 relative residual {rel:.3e} "
                                 f"above {rtol}")
        del op, b, res
        torch.cuda.empty_cache()
    return total


if __name__ == "__main__":
    main()
