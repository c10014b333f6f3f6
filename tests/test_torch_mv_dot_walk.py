"""Kernel A's kind ``mv_dot`` on the dot walk (``ops/stencil3d.py``
``dot_geometry``, ``csrc/stencil3d.cu`` ``stack_kernel`` with
``dot_flush``).

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds its y
bit for bit against the kind ``mv`` and its dot against kernel J's.  Here:

* the walk's geometry on every branch: tiles and slabs of whole boxes
  (32 z points, 8 rows, 16 x planes: the column walk's blocks, whose
  order the dot keeps), the slab halved down to one box, odd ``nz``,
  grids smaller than a box, each dtype's vector;
* a host emulation of which block writes which partial: every box of the
  grid exactly once, at the column walk's index;
* the summation order: the dot walk's box tree (shuffles at thread
  offsets, the smaller steps in registers, the closed form of the second
  stage) against ``block_sum``'s lane tree, bit for bit in f32 and f64;
* the plain ``mv_dot`` against JAX's ``stencil3d_apply_pallas(kind=
  "mv_dot")`` in interpret mode at partial-box shapes, or where the
  Pallas kernel refuses the shape (``ny`` off its sublane tile) against
  the JAX package's own route there, ``Stencil3D.mv_dot``.  Tolerances as
  ``tests/test_torch_stencil3d.py``: y to its dtype, the dot rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as jops
from medane_tchakorom_ufc_thesis_repository_tpu.ops import stencil_pallas as sp
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)

DIAG, OFF = 6.0, -1.0
DTYPES = [torch.float32, torch.bfloat16, torch.float64]


def _v(dtype) -> int:
    """Values of ``dtype`` in a 16-byte vector."""
    return 128 // torch.finfo(dtype).bits


class TestDotGeometry:
    """``dot_geometry``: the tile and slab the C launcher accepts for the
    dot walk (``launch_stack`` with ``MV_DOT``): the stack walk's limits,
    and whole boxes."""

    @pytest.mark.parametrize("shape,dtype,want", [
        ((512, 512, 512), torch.float32, (32, 8, 32)),     # 4 boxes along z
        ((512, 512, 512), torch.bfloat16, (32, 8, 32)),    # 8
        ((512, 512, 512), torch.float64, (32, 8, 32)),     # 2
        ((256, 256, 256), torch.float32, (32, 8, 16)),     # halved once
        ((37, 24, 130), torch.float32, (32, 8, 16)),
        ((37, 24, 130), torch.float64, (32, 8, 16)),
        ((9, 10, 64), torch.float32, (16, 16, 16)),
        ((4, 4, 4), torch.float32, (8, 8, 16)),            # under one box
        ((4, 4, 4), torch.bfloat16, (4, 8, 16)),
        ((4, 4, 4), torch.float64, (16, 8, 16)),
    ])
    def test_shapes_of_the_paths(self, shape, dtype, want):
        assert k.dot_geometry(shape, dtype) == want

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_limits_and_whole_boxes(self, dtype):
        rng = np.random.default_rng(31)
        v = _v(dtype)
        size = 16 // v
        for _ in range(300):
            nx, ny, nz = (int(n) for n in rng.integers(1, [700, 700, 700]))
            tzv, ty, slab = k.dot_geometry((nx, ny, nz), dtype)
            tz = tzv * v
            # the stack walk's limits (stencil3d_apply_stack's checks)
            assert tzv & (tzv - 1) == 0 and 1 <= tzv <= 32
            assert ty & (ty - 1) == 0 and 1 <= ty <= k.STACK_ROWS
            assert tzv * ty <= k.STACK_THREADS
            # whole boxes, in whole warps
            assert tz % k.DOT_BOX_Z == 0 and ty % k.DOT_BOX_Y == 0
            assert slab % k.DOT_BOX_X == 0 and slab in (16, 32)
            assert (tzv * ty) % 32 == 0
            # the ring and the box rows' sums under 48 KB
            ring = 4 * (ty + 2) * (tz + 2 * v) * size
            rows = k.STACK_THREADS // (k.DOT_BOX_Z // v) * max(size, 4)
            assert ring + rows <= 48 * 1024
            # as many vectors and rows as the grid takes, a box at least
            assert tzv == min(32, max(k.DOT_BOX_Z // v,
                                      k._pow2_at_least(-(-nz // v))))
            assert ty == max(k.DOT_BOX_Y, min(k.STACK_THREADS // tzv,
                                              k.STACK_ROWS,
                                              k._pow2_at_least(ny)))
            tiles = -(-ny // ty) * -(-nz // tz)
            blocks = tiles * -(-nx // slab)
            assert slab == k.DOT_BOX_X or blocks >= k.STACK_MIN_BLOCKS
            if slab < k.STACK_SLAB:   # a deeper slab had too few blocks
                assert tiles * -(-nx // (2 * slab)) < k.STACK_MIN_BLOCKS

    @pytest.mark.parametrize("nx", [16, 64, 100, 513])
    def test_the_slab_stops_at_one_box(self, nx):
        # 256^2 planes make 64 tiles in f32: never 1056 blocks at 16
        # planes a slab below nx = 264, so those slabs stay at 16
        tzv, ty, slab = k.dot_geometry((nx, 256, 256), torch.float32)
        assert (tzv, ty) == (32, 8)
        assert slab == (32 if 64 * -(-nx // 32) >= k.STACK_MIN_BLOCKS else 16)

    @pytest.mark.parametrize("nz", [1, 3, 31, 33, 129, 131])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_odd_nz(self, nz, dtype):
        v = _v(dtype)
        tzv, _, _ = k.dot_geometry((20, 20, nz), dtype)
        need = -(-nz // v)       # vectors the row takes, the last one short
        assert tzv * v >= min(nz, 32 * v)
        assert tzv >= k.DOT_BOX_Z // v and (tzv * v) % k.DOT_BOX_Z == 0
        assert tzv == min(32, max(k.DOT_BOX_Z // v, k._pow2_at_least(need)))

    @pytest.mark.parametrize("shape", [(1, 1, 1), (2, 3, 5), (15, 7, 31)])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_grids_smaller_than_a_box(self, shape, dtype):
        # one box: one tile of one box row, one slab of one box
        tzv, ty, slab = k.dot_geometry(shape, dtype)
        assert (tzv * _v(dtype), ty, slab) == (k.DOT_BOX_Z, k.DOT_BOX_Y,
                                               k.DOT_BOX_X)

    @pytest.mark.parametrize("dtype,v,box_threads", [
        (torch.float32, 4, 8), (torch.bfloat16, 8, 4), (torch.float64, 2, 16)])
    def test_each_dtypes_vector(self, dtype, v, box_threads):
        assert _v(dtype) == v and k.DOT_BOX_Z // v == box_threads
        # the smallest tile is one box row wide: box_threads vectors
        assert k.dot_geometry((8, 8, 1), dtype)[0] == box_threads


def _blocks(shape, geometry, v):
    """The dot walk's blocks on ``shape``: (i0, i1, j0, k0) of each, in
    ``stack_kernel``'s order (slab fastest, then z, then y)."""
    nx, ny, nz = shape
    tzv, ty, slab = geometry
    tz = tzv * v
    for t_y in range(-(-ny // ty)):
        for t_z in range(-(-nz // tz)):
            for s in range(-(-nx // slab)):
                i0 = s * slab
                yield i0, min(i0 + slab, nx), t_y * ty, t_z * tz


class TestPartialsLayout:
    """Which block writes which partial: ``dot_flush`` after each plane
    that ends a box (every 16th, and the slab's last), for each box of the
    tile inside the grid, at index ``bx + gx (by + gy bz)`` (the column
    walk's ``apply_grid`` layout, ``stencil3d_apply_partials`` of them)."""

    @pytest.mark.parametrize("shape", [
        (512, 512, 512), (256, 256, 256), (37, 24, 130), (4, 4, 4),
        (17, 9, 33), (33, 200, 100), (9, 10, 64), (48, 16, 96)])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_every_box_once(self, shape, dtype):
        nx, ny, nz = shape
        v = _v(dtype)
        tzv, ty, slab = k.dot_geometry(shape, dtype)
        gx, gy, gz = (-(-nz // k.DOT_BOX_Z), -(-ny // k.DOT_BOX_Y),
                      -(-nx // k.DOT_BOX_X))
        written = np.zeros(gx * gy * gz, int)
        planes = 0
        for i0, i1, j0, k0 in _blocks(shape, (tzv, ty, slab), v):
            assert i0 % k.DOT_BOX_X == 0     # slabs start on a box
            flushes = [i for i in range(i0, i1)
                       if (i + 1) % k.DOT_BOX_X == 0 or i + 1 == i1]
            planes += i1 - i0
            for i in flushes:
                for by in range(ty // k.DOT_BOX_Y):
                    for bz in range(tzv * v // k.DOT_BOX_Z):
                        px, py = k0 // k.DOT_BOX_Z + bz, j0 // k.DOT_BOX_Y + by
                        if px < gx and py < gy:
                            written[px + gx * (py + gy * (i // k.DOT_BOX_X))] += 1
        assert (written == 1).all()
        assert planes == nx * -(-ny // ty) * -(-nz // (tzv * v))


def _fma(a, b, c, dt):
    """a b + c in ``dt`` (in f32 the f64 product is exact; the rounding of
    the emulation is the same on both sides of the comparison)."""
    return dt(np.float64(a) * np.float64(b) + np.float64(c))


def _add(a, b, dt):
    return dt(dt(a) + dt(b))


def _shfl_tree(vals, dt):
    """``block_sum``'s warp tree on 32 lane values: each offset 16 .. 1,
    lane l adds lane l + o's value (its own where l + o is past 31, as
    ``__shfl_down_sync`` gives it); lane 0's result."""
    v = list(vals)
    for o in (16, 8, 4, 2, 1):
        v = [_add(v[l], v[l + o] if l + o < 32 else v[l], dt)
             for l in range(32)]
    return v[0]


def _column_walk_box(c, y, dt):
    """The column walk's partial of one box: products summed over the
    planes a point, then block_sum over the 8 x 32 threads."""
    planes, rows, zs = c.shape
    acc = np.zeros((rows, zs), dt)
    for i in range(planes):
        for r in range(rows):
            for z in range(zs):
                acc[r, z] = _fma(c[i, r, z], y[i, r, z], acc[r, z], dt)
    warp = [_shfl_tree(acc[r], dt) for r in range(rows)]
    return _shfl_tree(warp + [dt(0)] * (32 - rows), dt)


def _dot_walk_box(c, y, dt, v):
    """The dot walk's partial of the same box: thread t of a box row holds
    points t v .. t v + v - 1; shuffles at thread offsets o / v for o >= v,
    register steps below; the 8 row sums in the closed form of
    ``dot_flush``."""
    planes, rows, zs = c.shape
    nt = zs // v
    row_sums = []
    for r in range(rows):
        a = [[dt(0)] * v for _ in range(nt)]
        for i in range(planes):
            for t in range(nt):
                for e in range(v):
                    z = t * v + e
                    a[t][e] = _fma(c[i, r, z], y[i, r, z], a[t][e], dt)
        o = 16
        while o >= v:
            # thread t takes thread t + d's vector; past the box row the
            # lanes belong to other boxes, which thread 0's sum never reads
            d = o // v
            a = [[_add(a[t][e], a[t + d][e], dt) if t + d < nt else a[t][e]
                  for e in range(v)] for t in range(nt)]
            o //= 2
        o = v // 2
        while o >= 1:
            a[0] = [_add(a[0][e], a[0][e + o], dt) if e < o else a[0][e]
                    for e in range(v)]
            o //= 2
        row_sums.append(a[0][0])
    w = [_add(_add(s, 0, dt), 0, dt) for s in row_sums]
    return _add(_add(_add(w[0], w[4], dt), _add(w[2], w[6], dt), dt),
                _add(_add(w[1], w[5], dt), _add(w[3], w[7], dt), dt), dt)


class TestBoxOrder:
    """The dot walk's box tree has ``block_sum``'s bits: the summation
    order ``dot_flush`` writes out, emulated on the host, against the
    column walk's lane tree, in f32 (V = 4, 8: f32 and bf16 storage) and
    f64 (V = 2), with zeros, signed zeros and partial boxes among the
    values."""

    @pytest.mark.parametrize("dt,v", [(np.float32, 4), (np.float32, 8),
                                      (np.float64, 2)])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_equal_bits(self, dt, v, seed):
        rng = np.random.default_rng(40 + seed)
        shape = (k.DOT_BOX_X, k.DOT_BOX_Y, k.DOT_BOX_Z)
        c = rng.standard_normal(shape).astype(dt)
        y = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, shape)
             ).astype(dt)
        # points outside the grid (the last rows and z points) add
        # nothing, as the kernel's idle points; a row of -0 products
        c[:, 6:, :] = 0
        c[:, :, 27:] = 0
        c[:, 5, :] = -0.0
        y[:, 5, :] = 1.0
        got = _dot_walk_box(c, y, dt, v)
        want = _column_walk_box(c, y, dt)
        assert np.asarray(got, dt).tobytes() == np.asarray(want, dt).tobytes()


# partial-box shapes: nz not a multiple of 32, ny not of 8, nx not of 16;
# (17, 16, 37) in f32 and bf16 and (33, 24, 65) in f32 meet the Pallas
# kernel's ny tiling, so partial boxes in x and z run through it
PARTIAL_SHAPES = [(17, 16, 37), (20, 12, 40), (33, 24, 65), (4, 4, 4)]
COMBOS = [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32"), ("f32", "bf16")]
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_close(t, j, tol):
    """``tests/test_torch_stencil3d.py``'s tolerances: f32 rtol 1e-6 with
    a floor of 1e-6 max|ref|, bf16 2 ulps plus the floor, dot rtol 1e-5."""
    got = t.to(torch.float64).numpy()
    ref = np.asarray(j, np.float64)
    assert got.shape == ref.shape
    floor = 1e-6 * np.abs(ref).max()
    if tol == "f32":
        bound = 1e-6 * np.abs(ref) + floor
    elif tol == "bf16":
        ulp = np.ldexp(1.0, np.frexp(np.abs(ref))[1] - 8)
        bound = 2 * np.where(ref == 0, 0.0, ulp) + floor
    else:  # dot
        bound = 1e-5 * np.abs(ref)
    assert np.all(np.abs(got - ref) <= bound), np.max(np.abs(got - ref) - bound)


class TestPlainVersusJax:
    @pytest.mark.parametrize("shape", PARTIAL_SHAPES)
    @pytest.mark.parametrize("xd,od", COMBOS)
    def test_mv_dot(self, xd, od, shape):
        x = _np(shape, 50)
        xj = jnp.asarray(x).astype(JDT[xd])
        xt = torch.from_numpy(x).to(TDT[xd])
        pallas = shape[1] % sp.sublane_granularity(JDT[xd]) == 0
        if pallas:
            with pltpu.force_tpu_interpret_mode():
                yj, dj = sp.stencil3d_apply_pallas(
                    xj, nx=shape[0], ny=shape[1], nz=shape[2], diag=DIAG,
                    off=OFF, kind="mv_dot", out_dtype=JDT[od])
        else:   # the JAX package's route at this shape, in f32
            jop = jops.Stencil3D(*shape, diag=DIAG, off=OFF)
            yj, dj = jop.mv_dot(xj.astype(jnp.float32))
        yt, dt_ = k.stencil3d_apply_plain(xt, kind="mv_dot", diag=DIAG,
                                          off=OFF, out_dtype=TDT[od])
        assert yt.dtype == TDT[od] and yt.shape == shape
        assert dt_.dtype == torch.float32 and dt_.dim() == 0
        _assert_close(yt, yj, od)
        _assert_close(dt_, dj, "dot")


class TestWrapper:
    def test_cpu_takes_plain_and_counts_nothing(self):
        k.reset_launch_counts()
        x = torch.from_numpy(_np((5, 9, 33), 51))
        y, d = k.stencil3d_apply(x, kind="mv_dot", diag=DIAG, off=OFF)
        yp, dp = k.stencil3d_apply_plain(x, kind="mv_dot", diag=DIAG, off=OFF)
        assert torch.equal(y, yp) and torch.equal(d, dp)
        assert k.launch_counts() == {}
