#!/usr/bin/env python3
"""Drive the PyTorch port's three slices on one NVIDIA GPU: the 3D Poisson
north-star, the thesis's two-stage multisplitting solvers, and the
one-call solve API over general sparse matrices.

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
   odd length; kernel H (the CSR product) on a structureless square
   pattern, n = 2^22 with 10 draws a row, and on a rectangular
   200,003 x 150,001 pattern with empty rows and one row of 50,000
   entries, forward and transpose; kernel I (the block-ELL product) at
   (nb 256, bs 128, width 8), (nb 4096, bs 64, width 8), bs 8 and 16, and
   a shape not divisible by bs; H and I in f32 and f64, for 1 and 4
   vectors, two launches giving equal bits.  Times kernel, plain and,
   where one PyTorch call computes the same function, that call, at the
   paths' shapes (CUDA events, median of 20), beside the least time the
   card could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s);
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
   runs) and peak memory;
8. calibration phase: the per-stored-value times of kernel I by block
   size, of kernel H and of ``ELL.mv`` relative to ``DIA.mv``, and the
   largest n at which ``DenseOp.mv`` is no slower than kernel H: the
   constants of ``core/calibration.py``, each the median of 3 medians
   with their spread, printed as one JSON line and saved under
   ``build/`` (the solves that follow route by the shipped table);
9. API phase, in f32, on scipy matrices made from a seed: GMRES with
   Jacobi on a structureless symmetric diagonally dominant matrix of
   n = 2^22 (AIJ; one right-hand side, then a panel of 4), GMRES with
   block-Jacobi on a block-sparse SPD matrix of 4096 blocks of 64 (BSR),
   CG with Jacobi on the 1024^2 2D Poisson matrix (DIA), and LSQR on the
   rectangular pattern (AIJ, forward and transpose).  The first solve of
   each is counted: every kernel on its route must have been launched,
   it must converge on the stated operator, and the residual measured on
   the host in f64 against the input matrix must lie under the bound.
   Prints iterations, launches, set-up and solve times (median of 3 more
   solves), peak memory, and the device-busy share of one AIJ solve.

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
AIJ_REF = "medane_tchakorom_ufc_thesis_repository_tpu/ops/aij_pallas.py"
BSR_REF = "medane_tchakorom_ufc_thesis_repository_tpu/ops/bsr_pallas.py"

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
    ("csr_mv", "csr_mv.cu", f"{AIJ_REF}:307", ("f32", "f32"), "api"),
    ("bsr_mv", "bsr_mv.cu", f"{BSR_REF}:51", ("f32", "f32"), "api"),
]
# the card's published peaks: memory rate, and f32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12
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

    t_all = time.perf_counter()
    report = kernel_phase(torch, k, dev)
    report.update(kernel_phase_2d(torch, dev))
    sparse_report, cases = kernel_phase_sparse(torch, dev)
    report.update(sparse_report)
    launches = slice_phase(torch, port, k, dev)
    golden_phase(torch, port, dev)
    launches.update(thesis_phase(torch, port, dev))
    calibration_phase(torch, port, dev, cases["csr_ms_per_nnz"], card)
    launches.update(api_phase(torch, port, dev, cases, report))
    kernels = []
    for name, src, replaces, _, _ in ENTRIES:
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"whole run: {time.perf_counter() - t_all:.1f} s after the build")
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


def repeat_ms(torch, fn, rounds: int = 3):
    """The median of ``rounds`` medians of 20, and their spread
    ((largest - smallest) / median)."""
    ms = [median_ms(torch, fn) for _ in range(rounds)]
    mid = statistics.median(ms)
    return mid, (max(ms) - min(ms)) / mid


def new_report(path: str) -> dict:
    return {name: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                   "bound_ms": None, "bound_by": None, "library_ms": None}
            for name, _, _, _, p in ENTRIES if p == path}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the f32
    peak, whichever is longer."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def library_ms(torch, fn, what: str):
    """The time of one PyTorch call computing the same function, or None
    when the installed PyTorch refuses it (said in the log)."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"{what}: no library call ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:120]})")
        return None
    return median_ms(torch, fn)


def stencil_conv(torch, x, diag: float, off: float):
    """``x -> A x`` for a batch ``(B, *grid)`` of 2D or 3D grids as one
    convolution with the 5- or 7-point kernel and zero padding, in full
    f32: the one-call counterpart of the stencil applies."""
    import torch.nn.functional as F

    nd = x.dim() - 1
    w = torch.zeros((3,) * nd, dtype=x.dtype, device=x.device)
    mid = (1,) * nd
    w[mid] = diag
    for d in range(nd):
        for o in (0, 2):
            i = list(mid)
            i[d] = o
            w[tuple(i)] = off
    conv = F.conv2d if nd == 2 else F.conv3d
    w = w[None, None]

    def call():
        return conv(x[:, None], w, padding=1)[:, 0]

    return call


def kernel_phase(torch, k, dev) -> dict:
    torch.backends.cudnn.allow_tf32 = False     # the yardsticks in full f32
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dt[dtype])

    report = new_report("northstar")
    timed = {name: dts for name, _, _, dts, _ in ENTRIES}
    combos = [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32"),
              ("f32", "bf16")]

    def run(name, shape, dts, kernel, plain, tols, dot_operand=None,
            path=True, inputs=(), flops_per_point=13, library=None):
        """Compare; ``max_abs_err`` takes the array outputs, not the dots.
        Time at 512^3 in the path's dtypes (and coefficients: ``path``);
        the bound counts ``inputs`` and the outputs once each."""
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
            r = report[name]
            r["ms"] = median_ms(torch, kernel)
            r["plain_ms"] = median_ms(torch, plain)
            r.update(bound(nbytes(*inputs, *outs),
                           flops_per_point * inputs[0].numel()))
            if library is not None:
                r["library_ms"] = library_ms(torch, library, name)
            log(f"{name} {dts} 512^3: kernel {r['ms']:.3f} ms, plain "
                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")

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
                    tols, operand, inputs=(x, *ex),
                    flops_per_point=13 + 2 * len(ex) + 2 * kind.endswith("dot"),
                    library=(stencil_conv(torch, x[None], DIAG, OFF)
                             if kind == "mv" and xd == od == "f32" else None))
            # the cycle's first sweep: the modified coefficients of A2
            d2, o2 = 2 * OMEGA - OMEGA * OMEGA * DIAG, -OMEGA * OMEGA * OFF
            run("stencil3d_mv_cast", shape, (xd, od),
                lambda: k.stencil3d_mv_cast(x, diag=d2, off=o2, out_dtype=odt),
                lambda: k.stencil3d_mv_cast_plain(x, diag=d2, off=o2,
                                                  out_dtype=odt),
                (od, od), inputs=(x,))
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
                    x, b, diag=DIAG, off=OFF, scale=4.0), (d,),
                inputs=(x, b), flops_per_point=15)
            run("stencil3d_prolong_jacobi", shape, (d, d),
                lambda: k.stencil3d_prolong_jacobi(x, b, e, diag=DIAG, off=OFF,
                                                   omega=OMEGA),
                lambda: k.stencil3d_prolong_jacobi_plain(
                    x, b, e, diag=DIAG, off=OFF, omega=OMEGA), (d,),
                inputs=(x, b, e), flops_per_point=23)
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
                ("bits", "bits"), path=(diag, off) == (DIAG, OFF),
                inputs=(xhi, xlo, bhi, blo), flops_per_point=150)
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
    report = new_report("thesis")

    def note(name, err):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)

    def timed(name, what, kernel, plain, json_entry=True, least=None,
              library=None):
        ms, plain_ms = median_ms(torch, kernel), median_ms(torch, plain)
        lib = None if library is None else library_ms(torch, library, name)
        if json_entry:
            report[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib,
                                **least)
        log(f"{name} {what}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library {lib}" + (f", bound {least['bound_ms']:.3f} ms "
                                f"({least['bound_by']})" if least else ""))

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
                          and dtype == torch.float32,
                          least=bound(2 * nbytes(x), 9 * x.numel()),
                          library=stencil_conv(torch, x, 4.0, -1.0))
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
                # the library calls are the plain versions' own: bmm, baddbmm
                Vl = V.to(ad)
                timed("mdot", f"{vd}/{ad} {shape}",
                      lambda: fused.mdot(V, w, K),
                      lambda: fused.mdot_plain(V, w, K), json_entry=main,
                      least=bound(nbytes(V, w) + B * K * w.element_size(),
                                  2 * V.numel()),
                      library=lambda: torch.bmm(Vl, w[:, :, None]))
                timed("maxpy", f"{vd}/{ad} {shape}",
                      lambda: fused.maxpy(V, a, w, K),
                      lambda: fused.maxpy_plain(V, a, w, K), json_entry=main,
                      least=bound(nbytes(V, a, w, w), 2 * V.numel()),
                      library=lambda: torch.baddbmm(w[:, None, :],
                                                    a[:, None, :], Vl))
                del Vl
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


# ---------------------------------------------------------------------------
# Kernels H and I
# ---------------------------------------------------------------------------

SQUARE_N, DRAWS = 1 << 22, 10          # kernel H's structureless pattern
RECT = (200_003, 150_001)              # and its rectangular one
LONG_ROW, LONG_LEN = 777, 50_000
# kernel I: (nbr, bs, width, n_out, n_in); the first has the block
# structure of the block-Jacobi solve's matrix, the second is the JAX
# benchmark's.  The ``kernels`` line takes its numbers from the pack that
# the solve's routing builds (``api_phase``)
I_SHAPES = [(4096, 64, 8, None, None), (256, 128, 8, None, None),
            (2048, 8, 5, None, None), (1024, 16, 12, None, None),
            (40, 32, 3, 40 * 32 - 7, 37 * 32 - 11)]


def structureless_coo(np, n: int, draws: int, seed: int):
    """A random pattern with no band or block structure: ``draws * n``
    (row, column, value) draws, duplicates and all."""
    rng = np.random.default_rng(seed)
    nnz = n * draws
    return (rng.integers(0, n, nnz), rng.integers(0, n, nnz),
            rng.standard_normal(nnz))


def rectangular_csr(np, sp):
    """A 200,003 x 150,001 matrix with about 8 entries a row, every 7th
    row empty, one row of 50,000 entries, and a 4 in every column (in the
    column's own non-empty row) so that it has full column rank."""
    m, n = RECT
    rng = np.random.default_rng(11)
    nnz = 8 * m
    rows = rng.integers(0, m, nnz)
    keep = rows % 7 != 3
    rows, cols = rows[keep], rng.integers(0, n, nnz)[keep]
    vals = rng.standard_normal(nnz)[keep] * 0.1
    long_cols = rng.choice(n, LONG_LEN, replace=False)
    own = np.flatnonzero(np.arange(m) % 7 != 3)[:n]
    rows = np.concatenate([rows, np.full(LONG_LEN, LONG_ROW), own])
    cols = np.concatenate([cols, long_cols, np.arange(n)])
    vals = np.concatenate([vals, rng.standard_normal(LONG_LEN) * 0.01,
                           np.full(n, 4.0)])
    A = sp.coo_matrix((vals, (rows, cols)), shape=RECT).tocsr()
    A.sum_duplicates()
    return A


def hold(torch, what, kernel, plain, dtype, terms) -> float:
    """Raise unless two launches of ``kernel`` give equal bits and agree
    with ``plain`` to the tolerance of ``kernel_phase_sparse``; return
    the largest absolute difference."""
    out, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{what}: two launches differ")
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{what}: got {out.dtype}{tuple(out.shape)}, "
                             f"expected {ref.dtype}{tuple(ref.shape)}")
    o, r = out.double(), ref.double()
    if not torch.isfinite(o).all():
        raise AssertionError(f"{what}: non-finite output")
    eps = 1e-6 if dtype == torch.float32 else 1e-12
    err = (o - r).abs()
    limit = 10 * eps * r.abs() + eps * terms ** 0.5 * float(r.abs().max())
    if (err > limit).any():
        i = int(torch.argmax((err - limit).reshape(-1)))
        raise AssertionError(
            f"{what}: {int((err > limit).sum())} values out of tolerance; "
            f"worst kernel {o.reshape(-1)[i].item()!r} plain "
            f"{r.reshape(-1)[i].item()!r}")
    return float(err.max())


def routed_case(torch, entry, what, kernel, plain, library, terms, n_bytes,
                flops) -> None:
    """Hold a kernel against its plain version on the very tensors a
    prepared solver routed to it (f32, one vector), time both and the
    library call there, and make these the kernel's numbers in the
    ``kernels`` line (``entry`` is its row of the report)."""
    e = hold(torch, what, kernel, plain, torch.float32, terms)
    entry["max_abs_err"] = max(entry["max_abs_err"], e)
    entry.update(ms=median_ms(torch, kernel), plain_ms=median_ms(torch, plain),
                 library_ms=library_ms(torch, library, what),
                 **bound(n_bytes, flops))
    log(f"{what}: ok, max error {e:.2e}, kernel {entry['ms']:.3f} ms, plain "
        f"{entry['plain_ms']:.3f} ms, library {entry['library_ms']}, bound "
        f"{entry['bound_ms']:.3f} ms ({entry['bound_by']})")


def kernel_phase_sparse(torch, dev):
    """Kernels H (``csr_mv``) and I (``bsr_mv``) against their plain
    versions, f32 and f64, for 1 and 4 vectors; two launches must agree
    in every bit.  Tolerance, f32: |kernel - plain| <= 1e-5 |plain| +
    1e-6 sqrt(terms) max|plain|, where ``terms`` is the longest row (H) or
    ``width * bs`` (I): the sums are taken in another order and with FMA,
    and the plain version of H adds with atomics.  f64: the same with
    1e-11 and 1e-12.  Returns the report (largest errors; the times of
    the ``kernels`` line come from the routed tensors of ``api_phase``),
    and the rectangular matrix and kernel H's time per nonzero for the
    later phases."""
    import numpy as np
    import scipy.sparse as sp

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import AIJ
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import bsr, csr

    report = new_report("api")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def compare(name, what, kernel, plain, dtype, terms):
        e = hold(torch, f"{name} {what}", kernel, plain, dtype, terms)
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
        return e

    # --- kernel H
    t0 = time.perf_counter()
    rows, cols, vals = structureless_coo(np, SQUARE_N, DRAWS, 7)
    square = AIJ.from_coo(rows, cols, vals, (SQUARE_N, SQUARE_N),
                          dtype=torch.float64, device=dev)
    rect_host = rectangular_csr(np, sp)
    rc = rect_host.tocoo()
    rect = AIJ.from_coo(rc.row, rc.col, rc.data, RECT, dtype=torch.float64,
                        device=dev)
    log(f"kernel H: patterns built in {time.perf_counter() - t0:.1f} s "
        f"(square {square.nnz} nonzeros, rectangular {rect.nnz})")
    for label, op in (("square", square), ("rectangular", rect)):
        for dtype in (torch.float32, torch.float64):
            for tr in (False, True):
                ptr, idx, dat, nout, nin = (
                    (op.t_indptr, op.t_indices, op.t_data, op.ncols, op.nrows)
                    if tr else
                    (op.indptr, op.indices, op.data, op.nrows, op.ncols))
                dat = dat.to(dtype)
                longest = int((ptr[1:] - ptr[:-1]).max())
                for k in (1, 4):
                    x = torch.randn((k, nin) if k > 1 else (nin,),
                                    generator=gen, device=dev, dtype=dtype)
                    what = (f"{label}{' transpose' if tr else ''} {dtype} "
                            f"k={k}")
                    e = compare(
                        "csr_mv", what,
                        lambda: csr.csr_mv(ptr, idx, dat, x, nout),
                        lambda: csr.csr_mv_plain(ptr, idx, dat, x, nout),
                        dtype, longest)
                    ms = median_ms(torch,
                                   lambda: csr.csr_mv(ptr, idx, dat, x, nout))
                    least = bound(
                        nbytes(ptr, idx, dat)
                        + k * (nout + nin) * dat.element_size(),
                        2 * k * dat.numel())
                    log(f"csr_mv {what}: ok, max error {e:.2e}, kernel "
                        f"{ms:.3f} ms, bound {least['bound_ms']:.3f} ms, "
                        f"longest row {longest}")
                    if (label, dtype, tr, k) == ("square", torch.float32,
                                                 False, 1):
                        A_lib = torch.sparse_csr_tensor(ptr, idx, dat,
                                                        size=(nout, nin))
                        square_ms, spread = repeat_ms(
                            torch, lambda: csr.csr_mv(ptr, idx, dat, x, nout))
                        plain_ms = median_ms(
                            torch, lambda: csr.csr_mv_plain(ptr, idx, dat, x,
                                                            nout))
                        lib = library_ms(torch, lambda: A_lib @ x, "csr_mv")
                        log(f"csr_mv f32 n=2^22, {square.nnz} nonzeros: "
                            f"kernel {square_ms:.3f} ms (3 medians of 20, "
                            f"spread {spread:.1%}), plain {plain_ms:.3f} ms, "
                            f"library (torch.sparse_csr_tensor @ x) {lib}, "
                            f"bound {least['bound_ms']:.3f} ms")
                        del A_lib
                    del x
                del dat
    square_ms_per_nnz = square_ms / square.nnz
    del square, rect, rows, cols, vals
    torch.cuda.empty_cache()

    # --- kernel I
    rng = np.random.default_rng(0)
    for shape in I_SHAPES:
        nbr, bs, width, n_out, n_in = shape
        ncb = nbr if n_in is None else -(-n_in // bs)
        n_out = nbr * bs if n_out is None else n_out
        n_in = ncb * bs if n_in is None else n_in
        idx_np = np.stack([np.sort(rng.choice(ncb, size=width, replace=False))
                           for _ in range(nbr)]).astype(np.int32)
        idx = torch.from_numpy(idx_np).to(dev)
        for dtype in (torch.float32, torch.float64):
            val = torch.randn((nbr, width, bs, bs), generator=gen, device=dev,
                              dtype=dtype)
            for k in (1, 4):
                x = torch.randn((k, n_in) if k > 1 else (n_in,), generator=gen,
                                device=dev, dtype=dtype)
                what = f"{shape} {dtype} k={k}"
                e = compare("bsr_mv", what,
                            lambda: bsr.bsr_mv(idx, val, x, n_out, n_in),
                            lambda: bsr.bsr_mv_plain(idx, val, x, n_out, n_in),
                            dtype, width * bs)
                ms = median_ms(torch,
                               lambda: bsr.bsr_mv(idx, val, x, n_out, n_in))
                least = bound(nbytes(idx, val)
                              + k * (n_out + n_in) * val.element_size(),
                              2 * k * val.numel())
                lib = None
                if k == 1 and dtype == torch.float32 and shape in I_SHAPES[:2]:
                    # torch's BSR tensor holds the blocks untransposed
                    A_lib = torch.sparse_bsr_tensor(
                        torch.arange(0, nbr * width + 1, width, device=dev,
                                     dtype=torch.int32),
                        idx.reshape(-1),
                        val.reshape(-1, bs, bs).transpose(1, 2).contiguous(),
                        size=(nbr * bs, ncb * bs))
                    lib = library_ms(torch, lambda: A_lib @ x[:, None],
                                     f"bsr_mv {what}")
                    del A_lib
                plain_ms = median_ms(
                    torch, lambda: bsr.bsr_mv_plain(idx, val, x, n_out, n_in))
                log(f"bsr_mv {what}: ok, max error {e:.2e}, kernel {ms:.3f} "
                    f"ms, plain {plain_ms:.3f} ms, library (torch BSR tensor "
                    f"@ x) {lib}, bound {least['bound_ms']:.3f} ms")
                del x
            del val
        del idx
    torch.cuda.empty_cache()
    return report, {"rect": rect_host, "csr_ms_per_nnz": square_ms_per_nnz}


# ---------------------------------------------------------------------------
# Calibration phase
# ---------------------------------------------------------------------------

def calibration_phase(torch, port, dev, csr_ms_per_nnz, card) -> None:
    """Measure the routing constants of ``core/calibration.py`` on this
    card, in f32, per stored value and relative to ``DIA.mv`` on the
    5-point matrix of a 4096^2 grid.  The shapes are long enough (0.5 ms
    and more a launch, but for the dense crossover) that a median repeats
    to a few percent; every time is the median of 3 medians of 20, printed
    with their spread.  Prints the constants as one JSON line and saves
    them with ``calibration.save`` under ``build/``, a file that
    ``MEDANE_TORCH_CALIBRATION`` can name."""
    import numpy as np

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import (
        calibration,
        poisson,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import AIJ
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import bsr

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rng = np.random.default_rng(4)
    spreads = {}

    dia = poisson.poisson2d_dia(4096, 4096, device=dev)
    x = torch.randn(dia.shape[1], generator=gen, device=dev)
    dia_ms, spreads["dia"] = repeat_ms(torch, lambda: dia.mv(x))
    unit = dia_ms / dia.data.numel()
    log(f"calibration: DIA.mv 4096^2, {dia.data.numel()} stored values: "
        f"{dia_ms:.3f} ms (spread {spreads['dia']:.1%})")
    del dia, x

    penalty = {}
    for bs in (8, 16, 32, 64, 128):
        width = 8
        nbr = (1 << 28) // (width * bs * bs)
        # 8 distinct block columns a row, ascending from a random start
        steps = rng.integers(1, nbr // width, size=(nbr, width))
        cols = (np.cumsum(steps, axis=1) + np.arange(nbr)[:, None]) % nbr
        idx = torch.from_numpy(np.sort(cols, axis=1).astype(np.int32)).to(dev)
        val = torch.randn((nbr, width, bs, bs), generator=gen, device=dev)
        x = torch.randn(nbr * bs, generator=gen, device=dev)
        ms, spreads[f"bsr{bs}"] = repeat_ms(
            torch, lambda: bsr.bsr_mv(idx, val, x, nbr * bs, nbr * bs))
        penalty[bs] = ms / val.numel() / unit
        log(f"calibration: bsr_mv bs={bs} nbr={nbr}: {ms:.3f} ms (spread "
            f"{spreads[f'bsr{bs}']:.1%}), {penalty[bs]:.3f}x DIA per stored "
            f"value")
        del idx, val, x

    # kernel H's time on the n = 2^22 pattern, from the kernel phase
    aij_cost = csr_ms_per_nnz / unit
    log(f"calibration: csr_mv n=2^22: {aij_cost:.3f}x DIA per nonzero")

    n = 1 << 20
    rows, cols, vals = structureless_coo(np, n, DRAWS, 8)
    ell = poisson.coo_to_ell(*_coalesced(np, rows, cols, vals, n), (n, n),
                             device=dev)
    x = torch.randn(n, generator=gen, device=dev)
    ell_ms, spreads["ell"] = repeat_ms(torch, lambda: ell.mv(x))
    true_nnz = int(torch.count_nonzero(ell.values))
    ell_cost = ell_ms / true_nnz / unit
    log(f"calibration: ELL.mv n=2^20 width {ell.indices.shape[1]}, "
        f"{true_nnz} nonzeros: {ell_ms:.3f} ms (spread "
        f"{spreads['ell']:.1%}), {ell_cost:.2f}x DIA per nonzero")
    del ell, x

    max_dense_n, still = 0, True
    for e in range(8, 15):
        n = 1 << e
        rows, cols, vals = structureless_coo(np, n, DRAWS, 9 + e)
        op = AIJ.from_coo(rows, cols, vals, (n, n), with_rmv=False,
                          device=dev)
        dense = port.DenseOp(a=op.to_dense())
        x = torch.randn(n, generator=gen, device=dev)
        d_ms, d_spread = repeat_ms(torch, lambda: dense.mv(x))
        c_ms, c_spread = repeat_ms(torch, lambda: op.mv(x))
        log(f"calibration: n={n}: DenseOp.mv {d_ms:.4f} ms (spread "
            f"{d_spread:.1%}), csr_mv {c_ms:.4f} ms (spread {c_spread:.1%})")
        still = still and d_ms <= c_ms
        if still:
            max_dense_n = n
        del op, dense, x
    torch.cuda.empty_cache()
    cal = {"card": card, "device_kind": torch.cuda.get_device_name(0),
           "dia_ms": dia_ms,
           "bsr_bs_penalty": {str(k): round(v, 3) for k, v in penalty.items()},
           "aij_relative_cost": round(aij_cost, 3),
           "ell_relative_cost": round(ell_cost, 3),
           "max_dense_n": max_dense_n,
           "spread": {k: round(v, 4) for k, v in spreads.items()}}
    print("calibration " + json.dumps(cal), flush=True)
    used = calibration.load()
    path = calibration.save(cal, path=str(
        ROOT / "build" / "torch_kernels" / "calibration.json"))
    log(f"calibration: saved to {path}; the solves below route by "
        f"{used.get('source', 'the shipped table')}: "
        f"{ {k: used[k] for k in cal if k in used} }")


def _coalesced(np, rows, cols, vals, n):
    """COO triplets with duplicates summed."""
    import scipy.sparse as sp

    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    c = a.tocoo()
    return c.row, c.col, c.data


# ---------------------------------------------------------------------------
# API phase
# ---------------------------------------------------------------------------

def block_sparse_spd(np, sp, nb: int, bs: int, seed: int = 5):
    """A block-sparse SPD matrix: every diagonal block ``Q diag(1..100)
    Q^T`` with a random orthogonal Q, and two random off-diagonal blocks
    of size 0.01 a block row, mirrored; assembled as block COO."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((nb, bs, bs)))
    diag = (q * np.logspace(0, 2, bs)) @ q.transpose(0, 2, 1)
    diag = 0.5 * (diag + diag.transpose(0, 2, 1))      # symmetric in every bit
    picks = np.stack([rng.choice(nb, size=2, replace=False)
                      for _ in range(nb)])
    br = np.repeat(np.arange(nb), 2)
    bc = picks.reshape(-1)
    keep = br != bc
    # one block per unordered pair: a later draw of the same pair would
    # overwrite the earlier one in an assignment-built matrix
    lo, hi = np.minimum(br, bc)[keep], np.maximum(br, bc)[keep]
    _, first = np.unique(lo * nb + hi, return_index=True)
    lo, hi = lo[first], hi[first]
    off = 0.01 * rng.standard_normal((len(lo), bs, bs))
    blocks = np.concatenate([diag, off, off.transpose(0, 2, 1)])
    brow = np.concatenate([np.arange(nb), lo, hi])
    bcol = np.concatenate([np.arange(nb), hi, lo])
    ii, jj = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
    rows = (brow[:, None, None] * bs + ii).reshape(-1)
    cols = (bcol[:, None, None] * bs + jj).reshape(-1)
    n = nb * bs
    return sp.coo_matrix((blocks.reshape(-1), (rows, cols)),
                         shape=(n, n)).tocsr()


def api_phase(torch, port, dev, cases, report) -> dict:
    """The one-call API on scipy matrices in f32; returns the launches of
    ``csr_mv`` and ``bsr_mv`` summed over the counted solves.  Before the
    AIJ and the BSR solve are counted, kernels H and I are held against
    their plain versions, and timed, on the tensors that ``prepare``
    routed to them: these are the kernels' numbers in ``report``."""
    import numpy as np
    import scipy.sparse as sp

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import (
        calibration,
        poisson,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import bsr, build, csr

    total = {"csr_mv": 0, "bsr_mv": 0}

    def counted(label, run, need):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        x, info = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = build.launch_counts()
        missing = [m for m in need if counts.get(m, 0) == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        for m in total:
            total[m] += counts.get(m, 0)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        log(f"{label}: operator {info['operator']}, method {info['method']}, "
            f"pc {info.get('pc')}, iterations "
            f"{np.asarray(info['iters']).tolist()}, converged "
            f"{info['converged']}, rel residual "
            f"{np.asarray(info['rel_residual']).tolist()}")
        log(f"{label}: solve {statistics.median(times) * 1e3:.1f} ms median "
            f"of 3 {[round(t * 1e3, 1) for t in times]} (first run "
            f"{first_s * 1e3:.1f} ms), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{counts}")
        if not np.isfinite(x).all():
            raise AssertionError(f"{label}: non-finite solution")
        info["solve_ms"] = statistics.median(times) * 1e3
        info["launches"] = counts
        return x, info

    def expect(label, info, operator, bound_, key="rel_residual"):
        worst = float(np.max(info[key]))
        if info["operator"] != operator or not info["converged"] \
                or not worst <= bound_:
            raise AssertionError(
                f"{label}: operator {info['operator']} (expected {operator}),"
                f" converged {info['converged']}, {key} {worst:.3e} (bound "
                f"{bound_})")

    # 1. AIJ: structureless symmetric, strictly diagonally dominant
    t0 = time.perf_counter()
    n = SQUARE_N
    r, c, v = structureless_coo(np, n, DRAWS, 1)
    B = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    A = ((B + B.T) * 0.5).tocsr()
    A = (A + sp.eye(n, format="csr")
         * (abs(A).sum(axis=1).max() + 1.0)).tocsr()
    del B, r, c, v
    b = np.asarray(A @ np.ones(n))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = port.prepare(A, method="gmres", pc="jacobi", rtol=1e-6)
    torch.cuda.synchronize()
    log(f"AIJ n=2^22, {A.nnz} nonzeros: matrix built in {build_s:.1f} s, "
        f"prepare (routing, CSR and its transpose check, Jacobi) "
        f"{time.perf_counter() - t0:.1f} s on the host")
    op = prep._op
    if type(op).__name__ != "AIJ":
        raise AssertionError(f"routed to {type(op).__name__}, expected AIJ")
    xk = torch.randn(n, device=dev)
    A_lib = torch.sparse_csr_tensor(op.indptr, op.indices, op.data,
                                    size=(n, n))
    routed_case(
        torch, report["csr_mv"],
        f"csr_mv on the solve's matrix (n=2^22, {op.nnz} nonzeros, "
        f"{csr.group_lanes(op.nnz, n)} lanes a row) f32 k=1",
        lambda: csr.csr_mv(op.indptr, op.indices, op.data, xk, n, n),
        lambda: csr.csr_mv_plain(op.indptr, op.indices, op.data, xk, n, n),
        lambda: A_lib @ xk,
        terms=int((op.indptr[1:] - op.indptr[:-1]).max()),
        n_bytes=nbytes(op.indptr, op.indices, op.data) + 2 * n * 4,
        flops=2 * op.nnz)
    del A_lib, xk, op
    label = "solve AIJ gmres+jacobi n=2^22"
    x, info = counted(label, lambda: prep.solve(b),
                      ("csr_mv", "mdot", "maxpy"))
    expect(label, info, "AIJ", 2e-6)
    log(f"{label}: max|x-1| {np.abs(x - 1).max():.3e}")
    busy_share(torch, label, lambda: prep.solve(b), info["solve_ms"])
    rng = np.random.default_rng(2)
    panel = np.stack([b] + [np.asarray(A @ rng.standard_normal(n))
                            for _ in range(3)], axis=1)
    label = "prepared AIJ solve, 4 right-hand sides"
    x, info = counted(label, lambda: prep.solve(panel),
                      ("csr_mv", "mdot", "maxpy"))
    expect(label, info, "AIJ", 2e-6)
    del prep, A, b, panel, x
    torch.cuda.empty_cache()

    # 2. BSR: block-sparse SPD, block-Jacobi
    t0 = time.perf_counter()
    A = block_sparse_spd(np, sp, 4096, 64)
    b = np.asarray(A @ np.ones(A.shape[0]))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = port.prepare(A, rtol=1e-5, pc="bjacobi", pc_block_size=64)
    torch.cuda.synchronize()
    log(f"BSR n={A.shape[0]}, {A.nnz} nonzeros: matrix built in "
        f"{build_s:.1f} s, prepare (routing, block pack, symmetry check, "
        f"block inverses) {time.perf_counter() - t0:.1f} s on the host")
    op = prep._op
    if type(op).__name__ != "BSR":
        raise AssertionError(f"routed to {type(op).__name__}, expected BSR")
    nbr, width = op.indices.shape
    bs, n = op.bs, A.shape[0]
    # 64 x 64 dense blocks pack with the same fill at 8, 16, 32 and 64, so
    # the table's cheapest of those per stored value is the size to expect
    penalty = calibration.bsr_bs_penalty()
    cheapest = min((8, 16, 32, 64), key=lambda b: penalty[b])
    log(f"BSR routed to block size {bs}, {nbr} block rows of width {width}, "
        f"fill {op.nnz / A.nnz:.2f}; penalties {penalty}")
    if bs != cheapest:
        raise AssertionError(f"routed to block size {bs}, the table's "
                             f"cheapest is {cheapest}")
    xk = torch.randn(n, device=dev)
    # torch's BSR tensor holds the blocks untransposed
    A_lib = torch.sparse_bsr_tensor(
        torch.arange(0, nbr * width + 1, width, device=dev,
                     dtype=torch.int32),
        op.indices.reshape(-1),
        op.values.reshape(-1, bs, bs).transpose(1, 2).contiguous(),
        size=(nbr * bs, nbr * bs))
    routed_case(
        torch, report["bsr_mv"],
        f"bsr_mv on the solve's pack (nbr {nbr}, bs {bs}, width {width}) "
        f"f32 k=1",
        lambda: bsr.bsr_mv(op.indices, op.values, xk, n, n),
        lambda: bsr.bsr_mv_plain(op.indices, op.values, xk, n, n),
        lambda: A_lib @ xk[:, None],
        terms=width * bs,
        n_bytes=nbytes(op.indices, op.values) + 2 * n * 4,
        flops=2 * op.nnz)
    del A_lib, xk, op
    torch.cuda.empty_cache()
    label = f"solve BSR gmres+bjacobi 4096 blocks of 64, packed at bs {bs}"
    x, info = counted(label, lambda: prep.solve(b),
                      ("bsr_mv", "mdot", "maxpy"))
    expect(label, info, "BSR", 1.5e-5)
    if not info["iters"] < 10:
        raise AssertionError(f"{label}: {info['iters']} iterations")
    del prep, A, b, x
    torch.cuda.empty_cache()

    # 3. DIA: 2D Poisson 1024^2 as scipy CSR, one-shot solve
    rows, cols, vals, shape = poisson.poisson2d_coo(1024, 1024)
    A = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    b = np.asarray(A @ np.ones(shape[0]))
    label = "solve DIA cg+jacobi 1024^2 (set-up inside)"
    x, info = counted(
        label, lambda: port.solve(A, b, method="cg", pc="jacobi", rtol=1e-6,
                                  assume_a="pos"), ())
    # CG's recurrence residual meets rtol 1e-6 and ``converged`` reports
    # that; over ~1,500 iterations in f32 the true residual stays above it
    # (condition number ~4e5; measured 5.4e-5), so the host f64 residual
    # is held to 1e-4 only
    expect(label, info, "DIA", 1e-4)
    del A, b, x

    # 4. LSQR on the rectangular pattern, consistent right-hand side
    A = cases["rect"]
    b = np.asarray(A @ np.ones(A.shape[1]))
    label = "lstsq lsqr 200003x150001 (set-up inside)"
    x, info = counted(label, lambda: port.lstsq(A, b, method="lsqr",
                                                rtol=1e-6), ("csr_mv",))
    expect(label, info, "AIJ", 1e-5, key="rel_opt")
    # every LSQR iteration takes one product with A and one with A^T
    if info["launches"]["csr_mv"] < 2 * info["iters"]:
        raise AssertionError(f"{label}: {info['launches']} launches in "
                             f"{info['iters']} iterations")
    log(f"{label}: rel_opt {info['rel_opt']:.3e}, max|x-1| "
        f"{np.abs(x - 1).max():.3e}")
    if total["csr_mv"] == 0 or total["bsr_mv"] == 0:
        raise AssertionError(f"API phase launches {total}")
    return total


def busy_share(torch, label: str, run, solve_ms: float) -> None:
    """The share of a warm solve's wall time (``solve_ms``, taken without
    the profiler) in which the card ran a kernel: the device time of one
    more solve under ``torch.profiler``, summed by kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    if device_ms == 0:
        log(f"{label}: profiler saw no device time: busy share not measured")
        return
    log(f"{label}: device busy {device_ms:.1f} ms of a {solve_ms:.1f} ms "
        f"solve (host f64 check included) = {device_ms / solve_ms:.1%} "
        f"(the profiled solve took {wall_ms:.1f} ms); top: "
        + "; ".join(f"{k[:48]} {ms:.1f} ms" for k, ms in rows[:6]))


if __name__ == "__main__":
    main()
