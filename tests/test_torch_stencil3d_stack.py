"""Port parity for kernel A over a stack of grids (``ops/stencil3d.py``).

``stencil3d_apply`` (kinds ``mv``, ``residual``, ``jacobi``) and
``stencil3d_mv_cast`` take a contiguous ``(T, nx, ny, nz)`` stack of grids,
each with zero outside it, and compute it in one launch on the card.  Here
the plain version, which the wrappers run for CPU tensors, is held:

* against the JAX package's Pallas kernels in interpret mode, grid by grid
  (the tolerances of ``test_torch_stencil3d.py``: f32 rtol 1e-6 with an
  absolute floor of 1e-6 * max|ref|, bf16 2 ulps plus that floor);
* against the JAX stacked operator's ``diag_mv`` and the JAX sharded
  MG-PCG's per-tile interior apply and Jacobi sweep (f64 to 1e-12; f32 to
  the f32 tolerance above);
* against a loop of single-grid plain calls, bit for bit.

The three stacked 3D call sites (``parallel.sharded.stack_apply``,
``parallel.mgpcg._interior_jacobi``, ``models.blockops.StackedStencil3D``)
must call the wrapper once a stack and never ``torch.stack``.  The CUDA
kernel itself is held against the plain version and the loop of one-grid
launches on the card by ``chip_smoke.py`` (phases ``kernels`` and
``sharded``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops as jbo
from medane_tchakorom_ufc_thesis_repository_tpu.ops import stencil_pallas as sp
from medane_tchakorom_ufc_thesis_repository_tpu.parallel import mgpcg as jmgpcg
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import mgpcg
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import sharded

# one intra-op thread a process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

DIAG, OFF = 6.0, -1.0
OMEGA = (6.0 / 7.0) / DIAG
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f64": jnp.float64}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
RHS_KINDS = ("residual", "jacobi")
STACK_KINDS = ("mv", "residual", "jacobi", "mv_cast")


@pytest.fixture()
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _assert_close(t, j, tol):
    got = t.to(torch.float64).numpy()
    ref = np.asarray(j, np.float64)
    assert got.shape == ref.shape
    floor = 1e-6 * np.abs(ref).max()
    if tol == "f32":
        bound = 1e-6 * np.abs(ref) + floor
    elif tol == "bf16":
        ulp = np.ldexp(1.0, np.frexp(np.abs(ref))[1] - 8)
        bound = 2 * np.where(ref == 0, 0.0, ulp) + floor
    else:  # f64
        bound = 1e-12 * np.abs(ref) + 1e-12 * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= bound), np.max(np.abs(got - ref) - bound)


def _apply(fn, kind, x, b, out_dtype):
    """``fn`` (the wrapper or the plain version) on the kind's operands;
    ``mv_cast`` goes to its own entry point and gives ``(y, cast x)``."""
    if kind == "mv_cast":
        cast = (k.stencil3d_mv_cast if fn is k.stencil3d_apply
                else k.stencil3d_mv_cast_plain)
        return cast(x, diag=DIAG, off=OFF, out_dtype=out_dtype)
    extras = (b,) if kind in RHS_KINDS else ()
    return fn(x, *extras, kind=kind, diag=DIAG, off=OFF,
              omega=OMEGA if kind == "jacobi" else None, out_dtype=out_dtype)


def _pieces(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.usefixtures("_interpret")
class TestStackVersusPallas:
    SHAPE = (3, 16, 16, 16)

    @pytest.mark.parametrize("d", ["f32", "bf16"])
    @pytest.mark.parametrize("kind", ["mv", "residual", "jacobi"])
    def test_apply(self, kind, d):
        x, b = _np(self.SHAPE, 1), _np(self.SHAPE, 2)
        xt = torch.from_numpy(x).to(TDT[d])
        bt = torch.from_numpy(b).to(TDT[d])
        yt = _apply(k.stencil3d_apply_plain, kind, xt, bt, TDT[d])
        assert yt.shape == self.SHAPE and yt.dtype == TDT[d]
        nx, ny, nz = self.SHAPE[1:]
        for g in range(self.SHAPE[0]):
            extras = ((jnp.asarray(b[g]).astype(JDT[d]),)
                      if kind in RHS_KINDS else ())
            yj = sp.stencil3d_apply_pallas(
                jnp.asarray(x[g]).astype(JDT[d]), *extras, nx=nx, ny=ny,
                nz=nz, diag=DIAG, off=OFF, kind=kind,
                omega=OMEGA if kind == "jacobi" else None, out_dtype=JDT[d])
            _assert_close(yt[g], yj, d)

    def test_mv_cast(self):
        x = _np(self.SHAPE, 3)
        yt, ct = k.stencil3d_mv_cast_plain(
            torch.from_numpy(x).float(), diag=DIAG, off=OFF,
            out_dtype=torch.bfloat16)
        nx, ny, nz = self.SHAPE[1:]
        for g in range(self.SHAPE[0]):
            yj, cj = sp.stencil3d_mv_cast_pallas(
                jnp.asarray(x[g]).astype(jnp.float32), nx=nx, ny=ny, nz=nz,
                diag=DIAG, off=OFF, out_dtype=jnp.bfloat16)
            _assert_close(yt[g], yj, "bf16")
            np.testing.assert_array_equal(ct[g].float().numpy(),
                                          np.asarray(cj, np.float32))


class TestStackVersusJax:
    @pytest.mark.parametrize("d", ["f32", "f64"])
    def test_stacked_operator_diag_mv(self, d):
        nx, ny, nz, nb = 16, 6, 10, 4
        x = _np((nb, nx // nb * ny * nz), 4)
        jop = jbo.StackedStencil3D(nx, ny, nz, nblocks=nb)
        top = blockops.StackedStencil3D(nx, ny, nz, nblocks=nb)
        yj = jop.diag_mv(jnp.asarray(x, JDT[d]))
        _assert_close(top.diag_mv(torch.from_numpy(x).to(TDT[d])), yj, d)

    @pytest.mark.parametrize("d", ["f32", "f64"])
    def test_sharded_interior_apply_and_sweep(self, d):
        # a (2, 4) strip mesh's tiles of a 32 x 6 x 10 grid
        shape = (2, 4, 4, 6, 10)
        x, b = _np(shape, 5), _np(shape, 6)
        xt = torch.from_numpy(x).to(TDT[d])
        bt = torch.from_numpy(b).to(TDT[d])
        y = sharded.stack_apply(xt, 3, DIAG, OFF)
        s = mgpcg._interior_jacobi(xt, bt, OMEGA, 3, DIAG, OFF)
        for i in range(2):
            for j in range(4):
                xj, bj = jnp.asarray(x[i, j], JDT[d]), jnp.asarray(b[i, j], JDT[d])
                _assert_close(y[i, j], jmgpcg._interior_grid_mv(xj, DIAG, OFF),
                              d)
                _assert_close(
                    s[i, j],
                    jmgpcg._interior_jacobi_sweep(xj, bj, OMEGA, DIAG, OFF), d)


class TestStackVersusLoop:
    """The plain stack is bit-equal to a loop of single-grid calls."""

    @pytest.mark.parametrize("xd,od", [("f32", "f32"), ("bf16", "bf16"),
                                       ("bf16", "f32"), ("f32", "bf16"),
                                       ("f64", "f64")])
    @pytest.mark.parametrize("shape", [(1, 6, 5, 8), (3, 6, 5, 8),
                                       (8, 4, 8, 8), (3, 7, 3, 13)])
    @pytest.mark.parametrize("kind", STACK_KINDS)
    def test_bits(self, kind, shape, xd, od):
        x = torch.from_numpy(_np(shape, 7)).to(TDT[xd])
        b = torch.from_numpy(_np(shape, 8)).to(TDT[xd])
        out = _pieces(_apply(k.stencil3d_apply, kind, x, b, TDT[od]))
        each = [_pieces(_apply(k.stencil3d_apply, kind, x[g], b[g], TDT[od]))
                for g in range(shape[0])]
        for i, o in enumerate(out):
            assert o.shape == shape and o.dtype == TDT[od]
            ref = torch.stack([e[i] for e in each])
            assert torch.equal(o.view(torch.int8), ref.view(torch.int8))

    def test_plain_single_grid_unchanged(self):
        """A 3-D grid still goes through as before: the same values as the
        grid taken as a stack of one."""
        x = torch.from_numpy(_np((5, 6, 7), 9))
        b = torch.from_numpy(_np((5, 6, 7), 10))
        for kind in ("mv", "residual", "jacobi"):
            one = _apply(k.stencil3d_apply_plain, kind, x, b, x.dtype)
            stack = _apply(k.stencil3d_apply_plain, kind, x[None], b[None],
                           x.dtype)
            assert one.shape == x.shape
            assert torch.equal(one, stack[0])


class TestCallSites:
    """Each stacked 3D call site calls kernel A's wrapper once a stack,
    and the result is the loop over its grids."""

    @pytest.fixture()
    def calls(self, monkeypatch):
        seen = []

        def counted(x, *extras, **kw):
            seen.append((tuple(x.shape), kw["kind"]))
            return k.stencil3d_apply(x, *extras, **kw)

        def no_stack(*a, **kw):
            raise AssertionError("torch.stack on a stacked 3D apply")

        for module in (sharded, mgpcg, blockops):
            monkeypatch.setattr(module, "stencil3d_apply", counted)
        monkeypatch.setattr(torch, "stack", no_stack)
        return seen

    def test_sharded_stack_apply(self, calls):
        g = torch.from_numpy(_np((2, 4, 3, 5, 6), 11))
        y = sharded.stack_apply(g, 3, DIAG, OFF)
        assert calls == [((8, 3, 5, 6), "mv")]
        assert y.shape == g.shape
        for i in range(2):
            for j in range(4):
                assert torch.equal(y[i, j], k.stencil3d_apply_plain(
                    g[i, j].contiguous(), kind="mv", diag=DIAG, off=OFF))

    def test_mgpcg_interior_jacobi(self, calls):
        # the tiled mesh's layout (nb, ir, ic, lx, ly, nz)
        x = torch.from_numpy(_np((2, 2, 2, 4, 3, 6), 12))
        b = torch.from_numpy(_np((2, 2, 2, 4, 3, 6), 13))
        y = mgpcg._interior_jacobi(x, b, OMEGA, 3, DIAG, OFF)
        assert calls == [((8, 4, 3, 6), "jacobi")]
        xs, bs, ys = (t.reshape(8, 4, 3, 6) for t in (x, b, y))
        for t in range(8):
            assert torch.equal(ys[t], k.stencil3d_apply_plain(
                xs[t], bs[t], kind="jacobi", diag=DIAG, off=OFF, omega=OMEGA))

    def test_stacked_operator(self, calls):
        op = blockops.StackedStencil3D(12, 5, 6, nblocks=3)
        x = torch.from_numpy(_np((3, op.block_size), 14))
        y = op.diag_mv(x)
        panel = torch.from_numpy(_np((2, 3, op.block_size), 15))
        yp = op.diag_mv(panel)
        full = op.full_mv(x)
        assert calls == [((3, 4, 5, 6), "mv"), ((6, 4, 5, 6), "mv"),
                         ((1, 12, 5, 6), "mv")]
        grids = x.reshape(3, 4, 5, 6)
        for t in range(3):
            assert torch.equal(y.reshape(3, 4, 5, 6)[t], k.stencil3d_apply_plain(
                grids[t], kind="mv", diag=DIAG, off=OFF))
        assert yp.shape == panel.shape and full.shape == x.shape
        assert torch.equal(full.reshape(12, 5, 6), k.stencil3d_apply_plain(
            x.reshape(12, 5, 6), kind="mv", diag=DIAG, off=OFF))


class TestWrapper:
    def test_cpu_stack_takes_plain_and_counts_nothing(self):
        k.reset_launch_counts()
        x = torch.from_numpy(_np((4, 3, 5, 6), 16)).float()
        b = torch.from_numpy(_np((4, 3, 5, 6), 17)).float()
        assert torch.equal(
            k.stencil3d_apply(x, b, kind="residual", diag=DIAG, off=OFF),
            k.stencil3d_apply_plain(x, b, kind="residual", diag=DIAG, off=OFF))
        y, c = k.stencil3d_mv_cast(x, diag=DIAG, off=OFF,
                                   out_dtype=torch.bfloat16)
        assert y.shape == c.shape == x.shape
        assert k.launch_counts() == {}

    @pytest.mark.parametrize("case", [
        "mv_dot_stack", "jacobi_dot_stack", "noncontiguous_stack",
        "rhs_other_shape", "rhs_one_grid_of_stack", "five_dims",
        "mv_cast_noncontiguous", "plain_dot_stack"])
    def test_rejects(self, case):
        x = torch.zeros(3, 4, 4, 6)
        b = torch.zeros(3, 4, 4, 6)
        calls = {
            "mv_dot_stack": lambda: k.stencil3d_apply(
                x, kind="mv_dot", diag=DIAG, off=OFF),
            "jacobi_dot_stack": lambda: k.stencil3d_apply(
                x, b, kind="jacobi_dot", diag=DIAG, off=OFF, omega=OMEGA),
            "noncontiguous_stack": lambda: k.stencil3d_apply(
                x.transpose(0, 1), kind="mv", diag=DIAG, off=OFF),
            "rhs_other_shape": lambda: k.stencil3d_apply(
                x, torch.zeros(3, 4, 4, 5), kind="jacobi", diag=DIAG,
                off=OFF, omega=OMEGA),
            "rhs_one_grid_of_stack": lambda: k.stencil3d_apply(
                x, b[0], kind="residual", diag=DIAG, off=OFF),
            "five_dims": lambda: k.stencil3d_apply(
                x[None], kind="mv", diag=DIAG, off=OFF),
            "mv_cast_noncontiguous": lambda: k.stencil3d_mv_cast(
                x[:, :, :, ::2], diag=DIAG, off=OFF, out_dtype=torch.bfloat16),
            "plain_dot_stack": lambda: k.stencil3d_apply_plain(
                x, kind="mv_dot", diag=DIAG, off=OFF),
        }
        with pytest.raises(ValueError):
            calls[case]()


class TestStackGeometry:
    """The launch geometry the C entry point accepts: tzv a power of two
    up to 32, ty up to 64 with tzv ty <= 256 threads, a ring under 48 KB
    (``csrc/stencil3d.cu`` ``launch_stack``), and slabs halved only while
    the launch has fewer than ``STACK_MIN_BLOCKS`` blocks."""

    @pytest.mark.parametrize("shape,dtype,want", [
        ((8, 32, 256, 256), torch.float32, (32, 8, 8)),
        ((1, 512, 512, 512), torch.float32, (32, 8, 32)),
        ((1, 512, 512, 512), torch.bfloat16, (32, 8, 32)),
        ((8, 8, 64, 64), torch.float32, (16, 16, 2)),
        ((3, 37, 24, 130), torch.float32, (32, 8, 2)),
    ])
    def test_shapes_of_the_paths(self, shape, dtype, want):
        assert k.stack_geometry(shape, dtype) == want

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float64])
    def test_limits(self, dtype):
        rng = np.random.default_rng(18)
        size = torch.finfo(dtype).bits // 8
        v = 16 // size
        for _ in range(300):
            t, nx, ny, nz = (int(n) for n in rng.integers(1, [9, 600, 600, 600]))
            tzv, ty, slab = k.stack_geometry((t, nx, ny, nz), dtype)
            assert tzv & (tzv - 1) == 0 and 1 <= tzv <= 32
            assert ty & (ty - 1) == 0 and 1 <= ty <= k.STACK_ROWS
            assert tzv * ty <= k.STACK_THREADS
            tz = tzv * v
            ring = 4 * ((ty + 2) * (tz + 2 * v) + ty * tz) * size
            assert ring <= 48 * 1024
            tiles = t * -(-ny // ty) * -(-nz // tz)
            assert slab in (2, 4, 8, 16, 32)
            assert tiles * -(-nx // slab) >= k.STACK_MIN_BLOCKS or slab == 2
            # a deeper slab would have had too few blocks
            if slab < k.STACK_SLAB:
                assert tiles * -(-nx // (2 * slab)) < k.STACK_MIN_BLOCKS
