"""Port parity for the 3D stencil kernels (``ops/stencil3d.py``).

The kernels' plain PyTorch versions, which the wrappers run for CPU
tensors, are held against the JAX package's Pallas kernels in interpret
mode (as ``tests/test_pallas.py`` runs them), on the same inputs made
with numpy from a seed.  The operator's methods are held against the JAX
``Stencil3D`` in f64.  The CUDA kernels themselves are held against the
plain versions on the card by ``chip_smoke.py``.

Tolerances: f32 rtol 1e-6 with an absolute floor of 1e-6 * max|ref|
(the summation orders differ and a residual can cancel to near zero);
bf16 2 bf16 ulps plus the same floor, because the two round at
different points; dots rtol 1e-5.  The Pallas restriction rounds its
partial sums over a cell to bf16 twice before the output, the port only
the output, so in bf16 its ulps are taken at the scale of those partial
sums, (scale/8) * sum |b - A x| over the cell.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as jops
from medane_tchakorom_ufc_thesis_repository_tpu.ops import stencil_pallas as sp
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import multigrid as jmg
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import Stencil3D
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import multigrid as tmg

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)

DIAG, OFF = 6.0, -1.0
OMEGA = (6.0 / 7.0) / DIAG
SHAPES = [(16, 16, 16), (16, 16, 32)]
# the Pallas B and C kernels need ny % 32 == 0 in bf16 (twice the bf16
# sublane tile), so their bf16 cases use ny = 32
SHAPES_BC_BF16 = [(16, 32, 16), (16, 32, 32)]
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture()
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(a, d):
    """The same values as a JAX array and a torch tensor of dtype ``d``."""
    return jnp.asarray(a).astype(JDT[d]), torch.from_numpy(a).to(TDT[d])


def _assert_close(t, j, tol, ulp_scale=None):
    got = t.to(torch.float64).numpy()
    ref = np.asarray(j, np.float64)
    assert got.shape == ref.shape
    floor = 1e-6 * np.abs(ref).max()
    if tol == "f32":
        bound = 1e-6 * np.abs(ref) + floor
    elif tol == "bf16":
        at = np.abs(ref) if ulp_scale is None else ulp_scale
        ulp = np.ldexp(1.0, np.frexp(at)[1] - 8)
        bound = 2 * np.where(at == 0, 0.0, ulp) + floor
    else:  # dot
        bound = 1e-5 * np.abs(ref)
    assert np.all(np.abs(got - ref) <= bound), np.max(np.abs(got - ref) - bound)


APPLY_CASES = [
    ("mv", "f32", "f32"), ("mv", "bf16", "bf16"),
    ("mv_dot", "f32", "f32"), ("mv_dot", "bf16", "bf16"),
    ("residual", "f32", "f32"), ("residual", "bf16", "bf16"),
    ("jacobi", "f32", "f32"), ("jacobi", "bf16", "bf16"),
    ("jacobi_dot", "f32", "f32"), ("jacobi_dot", "bf16", "f32"),
]


@pytest.mark.usefixtures("_interpret")
class TestPlainVersusPallas:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("kind,xd,od", APPLY_CASES)
    def test_apply(self, kind, xd, od, shape):
        xj, xt = _pair(_np(shape, 1), xd)
        bj, bt = _pair(_np(shape, 2), xd)
        ex = kind in ("residual", "jacobi", "jacobi_dot")
        om = OMEGA if kind.startswith("jacobi") else None
        outj = sp.stencil3d_apply_pallas(
            xj, *((bj,) if ex else ()), nx=shape[0], ny=shape[1], nz=shape[2],
            diag=DIAG, off=OFF, kind=kind, omega=om, out_dtype=JDT[od])
        outt = k.stencil3d_apply_plain(
            xt, *((bt,) if ex else ()), kind=kind, diag=DIAG, off=OFF,
            omega=om, out_dtype=TDT[od])
        if kind.endswith("_dot"):
            (yj, dj), (yt, dt_) = outj, outt
            assert dt_.dtype == torch.float32 and dt_.dim() == 0
            _assert_close(dt_, dj, "dot")
        else:
            yj, yt = outj, outt
        assert yt.dtype == TDT[od]
        _assert_close(yt, yj, od)

    @pytest.mark.parametrize("shape", SHAPES)
    def test_mv_cast(self, shape):
        xj, xt = _pair(_np(shape, 3), "f32")
        yj, cj = sp.stencil3d_mv_cast_pallas(
            xj, nx=shape[0], ny=shape[1], nz=shape[2], diag=DIAG, off=OFF,
            out_dtype=jnp.bfloat16)
        yt, ct = k.stencil3d_mv_cast_plain(xt, diag=DIAG, off=OFF,
                                           out_dtype=torch.bfloat16)
        assert yt.dtype == ct.dtype == torch.bfloat16
        _assert_close(yt, yj, "bf16")
        np.testing.assert_array_equal(ct.float().numpy(),
                                      np.asarray(cj, np.float32))

    @pytest.mark.parametrize("d,shape", [("f32", s) for s in SHAPES]
                             + [("bf16", s) for s in SHAPES_BC_BF16])
    def test_residual_restrict(self, d, shape):
        xj, xt = _pair(_np(shape, 4), d)
        bj, bt = _pair(_np(shape, 5), d)
        rj = sp.stencil3d_residual_restrict_pallas(
            xj, bj, nx=shape[0], ny=shape[1], nz=shape[2], diag=DIAG, off=OFF,
            scale=4.0)
        rt = k.stencil3d_residual_restrict_plain(xt, bt, diag=DIAG, off=OFF,
                                                 scale=4.0)
        assert rt.shape == tuple(n // 2 for n in shape) and rt.dtype == TDT[d]
        r = (bt.float() - k.stencil3d_apply_plain(
            xt.float(), kind="mv", diag=DIAG, off=OFF)).abs()
        cell = (4.0 / 8.0) * k.cell_sums(r)
        _assert_close(rt, rj, d, ulp_scale=cell.double().numpy())

    @pytest.mark.parametrize("d,shape", [("f32", s) for s in SHAPES]
                             + [("bf16", s) for s in SHAPES_BC_BF16])
    def test_prolong_jacobi(self, d, shape):
        coarse = tuple(n // 2 for n in shape)
        xj, xt = _pair(_np(shape, 6), d)
        bj, bt = _pair(_np(shape, 7), d)
        ej, et = _pair(_np(coarse, 8), d)
        yj = sp.stencil3d_prolong_jacobi_pallas(
            xj, bj, ej, nx=shape[0], ny=shape[1], nz=shape[2], diag=DIAG,
            off=OFF, omega=OMEGA)
        yt = k.stencil3d_prolong_jacobi_plain(xt, bt, et, diag=DIAG, off=OFF,
                                              omega=OMEGA)
        assert yt.dtype == TDT[d]
        _assert_close(yt, yj, d)


# the warp walks' edge shapes: 2^3, the cycle's 8^3, and a grid whose dims
# are no multiple of the walk's tile; the Pallas kernels refuse most of
# them (ny % 8, 16 or 32), and there the JAX package's own route at that
# shape, its XLA formulation on the same values in f32, is the reference
EDGE_SHAPES = [(2, 2, 2), (8, 8, 8), (38, 24, 130)]
JD_COMBOS = [("f32", "f32"), ("bf16", "f32"), ("bf16", "bf16"),
             ("f32", "bf16")]


def _pallas_or(pallas, xla):
    """The Pallas kernel's output in interpret mode, or ``xla()`` where
    the kernel refuses the shape."""
    try:
        with pltpu.force_tpu_interpret_mode():
            return pallas(), True
    except ValueError as e:
        assert "needs" in str(e), e
        return xla(), False


class TestPlainVersusJaxAtEdgeShapes:
    @pytest.mark.parametrize("shape", EDGE_SHAPES)
    @pytest.mark.parametrize("d", ["f32", "bf16"])
    def test_residual_restrict(self, d, shape):
        xj, xt = _pair(_np(shape, 16), d)
        bj, bt = _pair(_np(shape, 17), d)
        jop = jops.Stencil3D(*shape, diag=DIAG, off=OFF)
        rj, pallas = _pallas_or(
            lambda: sp.stencil3d_residual_restrict_pallas(
                xj, bj, nx=shape[0], ny=shape[1], nz=shape[2], diag=DIAG,
                off=OFF, scale=4.0),
            lambda: 4.0 * jmg._restrict(jop.residual(
                xj.astype(jnp.float32), bj.astype(jnp.float32)), shape))
        assert not pallas      # no edge shape meets the Pallas tiling
        rt = k.stencil3d_residual_restrict_plain(xt, bt, diag=DIAG, off=OFF,
                                                 scale=4.0)
        assert rt.shape == tuple(n // 2 for n in shape) and rt.dtype == TDT[d]
        _assert_close(rt, rj, d)

    @pytest.mark.parametrize("shape", EDGE_SHAPES)
    @pytest.mark.parametrize("xd,od", JD_COMBOS)
    def test_jacobi_dot(self, xd, od, shape):
        xj, xt = _pair(_np(shape, 18), xd)
        bj, bt = _pair(_np(shape, 19), xd)
        jop = jops.Stencil3D(*shape, diag=DIAG, off=OFF)
        (yj, dj), _ = _pallas_or(
            lambda: sp.stencil3d_apply_pallas(
                xj, bj, nx=shape[0], ny=shape[1], nz=shape[2], diag=DIAG,
                off=OFF, kind="jacobi_dot", omega=OMEGA, out_dtype=JDT[od]),
            lambda: jop.jacobi_sweep_dot(xj.astype(jnp.float32),
                                         bj.astype(jnp.float32), OMEGA))
        yt, dt_ = k.stencil3d_apply_plain(xt, bt, kind="jacobi_dot",
                                          diag=DIAG, off=OFF, omega=OMEGA,
                                          out_dtype=TDT[od])
        assert yt.dtype == TDT[od] and dt_.dtype == torch.float32
        _assert_close(yt, yj, od)
        _assert_close(dt_, dj, "dot")


class TestWalkSlab:
    """``walk_slab``, the x planes a block of the warp walks (kernels B
    and C, kernel A's jacobi_dot) takes: even, so that kernel B's pairs of
    planes start on an even plane; its blocks cover every plane exactly
    once; halved only while the grid has too few blocks."""

    LEVELS_512 = [(n, n, n) for n in (512, 256, 128, 64, 32, 16, 8, 4)]

    @pytest.mark.parametrize("shape", LEVELS_512 + [
        (2, 2, 2), (38, 24, 130), (514, 258, 130), (37, 24, 130),
        (4, 4, 4), (2, 16, 64)])
    def test_even_and_covers_every_plane_once(self, shape):
        nx, ny, nz = shape
        slab = k.walk_slab(shape)
        assert slab % 2 == 0 and 2 <= slab <= k.WALK_SLAB
        planes = np.zeros(nx, int)
        starts = range(0, nx, slab)
        for i0 in starts:
            i1 = min(i0 + slab, nx)
            planes[i0:i1] += 1
            if nx % 2 == 0:
                assert i0 % 2 == 0 and (i1 - i0) % 2 == 0
        assert (planes == 1).all()
        tiles = -(-ny // k.WALK_TY) * -(-nz // k.WALK_TZ)
        blocks = tiles * len(starts)
        assert slab == 2 or blocks >= k.WALK_MIN_BLOCKS
        if slab < k.WALK_SLAB:   # a longer slab would have too few blocks
            assert tiles * -(-nx // (2 * slab)) < k.WALK_MIN_BLOCKS

    def test_the_w_cycle_levels(self):
        # 512^3 and 256^3 walk 16 planes a block (8192 and 1024 blocks);
        # from 128^3 down the slab is 2
        assert [k.walk_slab(s) for s in self.LEVELS_512] == \
            [16, 16, 2, 2, 2, 2, 2, 2]


class TestOperatorF64:
    """``Stencil3D``'s methods against the JAX operator in f64 (its XLA
    formulations on the CPU), flat and grid-shaped."""

    SHAPE = (6, 8, 10)

    def _ops(self):
        return jops.Stencil3D(*self.SHAPE), Stencil3D(*self.SHAPE)

    @pytest.mark.parametrize("flat", [False, True])
    @pytest.mark.parametrize("method", ["mv", "mv_dot", "residual",
                                        "jacobi_sweep", "jacobi_sweep_dot"])
    def test_methods(self, method, flat):
        jop, top = self._ops()
        x = np.random.default_rng(9).standard_normal(self.SHAPE)
        b = np.random.default_rng(10).standard_normal(self.SHAPE)
        if flat:
            x, b = x.reshape(-1), b.reshape(-1)
        args = {"mv": (), "mv_dot": (), "residual": (b,),
                "jacobi_sweep": (b, OMEGA), "jacobi_sweep_dot": (b, OMEGA)}
        rest = args[method]
        outj = getattr(jop, method)(jnp.asarray(x), *[
            jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in rest])
        outt = getattr(top, method)(torch.from_numpy(x), *[
            torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in rest])
        if method.endswith("_dot"):
            (yj, dj), (yt, dt_) = outj, outt
            # both packages take these dots as f32 sums
            np.testing.assert_allclose(float(dt_), float(dj), rtol=1e-5)
        else:
            yj, yt = outj, outt
        assert tuple(yt.shape) == x.shape and yt.dtype == torch.float64
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-12,
                                   atol=1e-12)

    def test_residual_restrict_and_prolong_jacobi(self):
        shape = (8, 6, 10)
        coarse = tuple(n // 2 for n in shape)
        rng = np.random.default_rng(11)
        x, b = rng.standard_normal(shape), rng.standard_normal(shape)
        e = rng.standard_normal(coarse)
        jop, top = jops.Stencil3D(*shape), Stencil3D(*shape)
        xt, bt, et = (torch.from_numpy(a) for a in (x, b, e))
        # the JAX cycle's unfused forms
        rj = 4.0 * jmg._restrict(jop.residual(jnp.asarray(x), jnp.asarray(b)),
                                 shape)
        np.testing.assert_allclose(top.residual_restrict(xt, bt, 4.0).numpy(),
                                   np.asarray(rj), rtol=1e-12, atol=1e-12)
        m = jnp.asarray(x) + jmg._prolong(jnp.asarray(e), coarse)
        pj = jop.jacobi_sweep(m, jnp.asarray(b), OMEGA)
        np.testing.assert_allclose(top.prolong_jacobi(xt, bt, et, OMEGA).numpy(),
                                   np.asarray(pj), rtol=1e-12, atol=1e-12)
        # the port's unfused transfer helpers compose to the same values
        rt = 4.0 * tmg._restrict(top.residual(xt, bt), shape)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12,
                                   atol=1e-12)

    def test_mv_cast_and_metadata(self):
        jop, top = self._ops()
        x = _np(self.SHAPE, 12)
        y, c = top.mv_cast(torch.from_numpy(x), torch.bfloat16)
        assert y.dtype == c.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            c.float().numpy(), np.asarray(jnp.asarray(x).astype(jnp.bfloat16),
                                          np.float32))
        assert top.shape == jop.shape and top.nnz == jop.nnz


class TestWrappers:
    def test_cpu_takes_plain_and_counts_nothing(self):
        k.reset_launch_counts()
        x = torch.from_numpy(_np((4, 4, 6), 13))
        b = torch.from_numpy(_np((4, 4, 6), 14))
        e = torch.from_numpy(_np((2, 2, 3), 15))
        torch.testing.assert_close(
            k.stencil3d_apply(x, b, kind="jacobi", diag=DIAG, off=OFF,
                              omega=OMEGA),
            k.stencil3d_apply_plain(x, b, kind="jacobi", diag=DIAG, off=OFF,
                                    omega=OMEGA), rtol=0, atol=0)
        k.stencil3d_mv_cast(x, diag=DIAG, off=OFF, out_dtype=torch.bfloat16)
        k.stencil3d_residual_restrict(x, b, diag=DIAG, off=OFF)
        k.stencil3d_prolong_jacobi(x, b, e, diag=DIAG, off=OFF, omega=OMEGA)
        k.stencil3d_df_residual(x, b, x, b, diag=DIAG, off=OFF)
        assert k.launch_counts() == {}

    @pytest.mark.parametrize("case", [
        "meta_device", "bad_kind", "missing_rhs", "missing_omega",
        "stray_omega", "noncontiguous", "shape_mismatch", "dtype_mismatch",
        "odd_restrict", "coarse_shape", "df_f64", "int_dtype"])
    def test_rejects(self, case):
        x = torch.zeros(4, 4, 6)
        b = torch.zeros(4, 4, 6)
        calls = {
            "meta_device": lambda: k.stencil3d_apply(
                torch.zeros(4, 4, 6, device="meta"), kind="mv", diag=DIAG,
                off=OFF),
            "bad_kind": lambda: k.stencil3d_apply(x, kind="mv_cast", diag=DIAG,
                                                  off=OFF),
            "missing_rhs": lambda: k.stencil3d_apply(x, kind="residual",
                                                     diag=DIAG, off=OFF),
            "missing_omega": lambda: k.stencil3d_apply(x, b, kind="jacobi",
                                                       diag=DIAG, off=OFF),
            "stray_omega": lambda: k.stencil3d_apply(x, kind="mv", diag=DIAG,
                                                     off=OFF, omega=0.1),
            "noncontiguous": lambda: k.stencil3d_apply(
                x.transpose(0, 2), kind="mv", diag=DIAG, off=OFF),
            "shape_mismatch": lambda: k.stencil3d_apply(
                x, torch.zeros(4, 4, 4), kind="residual", diag=DIAG, off=OFF),
            "dtype_mismatch": lambda: k.stencil3d_apply(
                x, b.double(), kind="residual", diag=DIAG, off=OFF),
            "odd_restrict": lambda: k.stencil3d_residual_restrict(
                torch.zeros(3, 4, 6), torch.zeros(3, 4, 6), diag=DIAG,
                off=OFF),
            "coarse_shape": lambda: k.stencil3d_prolong_jacobi(
                x, b, torch.zeros(2, 2, 2), diag=DIAG, off=OFF, omega=OMEGA),
            "df_f64": lambda: k.stencil3d_df_residual(
                x.double(), x.double(), x.double(), x.double(), diag=DIAG,
                off=OFF),
            "int_dtype": lambda: k.stencil3d_apply(
                torch.zeros(4, 4, 6, dtype=torch.int32), kind="mv", diag=DIAG,
                off=OFF),
        }
        with pytest.raises(ValueError):
            calls[case]()


class TestBuild:
    def test_library_name_tracks_source_and_flags(self, tmp_path, monkeypatch):
        for name in build.SIGNATURES:
            (tmp_path / f"{name}.cu").write_text("// v1\n")
        monkeypatch.setattr(build, "CSRC", tmp_path)
        first = {n: build.library_path(n) for n in build.SIGNATURES}
        assert first["stencil3d"] != first["df_residual"]
        assert first["stencil3d"].parent == build.BUILD_DIR
        (tmp_path / "stencil3d.cu").write_text("// v2\n")
        assert build.library_path("stencil3d") != first["stencil3d"]
        assert build.library_path("df_residual") == first["df_residual"]
        # the df file alone is built without FMA contraction
        assert "-fmad=false" in build.EXTRA_FLAGS["df_residual"]
        assert "-fmad=false" not in build.EXTRA_FLAGS["stencil3d"]

    def test_signatures_cover_every_entry_point(self):
        for name, sigs in build.SIGNATURES.items():
            src = (build.CSRC / f"{name}.cu").read_text()
            for fn, (argtypes, _) in sigs.items():
                head = src.split(f" {fn}(", 1)
                assert len(head) == 2, fn
                params = head[1].split(")", 1)[0]
                assert len(params.split(",")) == len(argtypes), fn
