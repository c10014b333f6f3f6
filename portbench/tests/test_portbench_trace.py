"""The idle union, the gaps, the roofline share and the launch shim on
synthetic events."""

import contextlib

import pytest
import torch

from conftest import ROOT
from portbench import registry, trace

torch.set_num_threads(1)


def test_symbol_of():
    assert trace.symbol_of("void stack_kernel<0, float, float, true>(float const*)") \
        == "stack_kernel"
    assert trace.symbol_of("void at::native::vectorized_elementwise_kernel<4>(int)") \
        == "vectorized_elementwise_kernel"
    assert trace.symbol_of("Memcpy DtoH (Device -> Pinned)") == "Memcpy"
    assert trace.symbol_of("tile_kernel") == "tile_kernel"
    assert trace.symbol_of("void (anonymous namespace)::prolong_jacobi_kernel<__nv_bfloat16,"
                           " true>(__nv_bfloat16 const*)") == "prolong_jacobi_kernel"
    assert trace.symbol_of("void geqr2_gmem_domino<float, float, 9>(int)") \
        == "geqr2_gmem_domino"


def test_merge_is_the_union():
    assert trace.merge([(5, 7), (0, 2), (1, 3), (7, 8), (10, 11)]) == \
        [(0, 3), (5, 8), (10, 11)]
    assert trace.merge([]) == []


def test_reduce_busy_idle_and_gaps():
    ev = trace.Events(
        device=[("void a_kernel<1>()", 10, 20), ("void b()", 15, 30),
                ("void a_kernel<1>()", 40, 45), ("void c()", 95, 130),
                ("void early()", 0, 5),               # before every range
                ("void late()", 200, 210)],           # between ranges
        host=[("aten::mul", 8, 12), ("aten::item", 30, 41),
              ("cudaStreamSynchronize", 31, 40), ("aten::sum", 60, 70)],
        ranges=[(10, 100), (150, 160)])
    r = trace.reduce(ev)
    # range 1: busy [10, 30] + [40, 45] + [95, 100] (clipped) = 30 of 90
    # range 2: nothing = 0 of 10
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx(30e-6)
    assert r.by_name == pytest.approx({"void a_kernel<1>()": 15e-6, "void b()": 15e-6,
                                       "void c()": 35e-6})
    gaps = dict(trace.top(r.gaps))
    # gaps: [30, 40] -> innermost op at 35 is the sync; [45, 95] at 70 ->
    # aten::sum ends at 70 (still running); [150, 160] -> no op
    assert gaps["cudaStreamSynchronize"] == pytest.approx(10e-6)
    assert gaps["aten::sum"] == pytest.approx(50e-6)
    assert gaps["host (no op)"] == pytest.approx(10e-6)


def test_top_keeps_ten_largest():
    pairs = [(f"k{i}", float(i)) for i in range(15)] + [("k14", 1.0)]
    out = trace.top(pairs)
    assert len(out) == 10 and out[0] == ["k14", 15.0] and out[-1][0] == "k5"


def test_roofline_and_split():
    by_name = {"void stack_kernel<f>()": 2e-3, "void tile_kernel<f>()": 1e-3,
               "void at::native::elementwise_kernel<4>()": 5e-3}
    counted = {"stack_kernel", "tile_kernel"}
    share = trace.roofline(0.5 * trace.PEAK_BYTES_S * 3e-3, by_name, counted)
    assert share == pytest.approx(50.0)
    assert trace.roofline(1.0, {"void x()": 1.0}, counted) is None
    own, other = trace.split_device_time(by_name, counted | {"chebyshev_warp_kernel"})
    assert (own, other) == pytest.approx((3e-3, 5e-3))


def test_port_symbols_hold_every_counted_symbol():
    import medane_tchakorom_ufc_thesis_repository_tpu_torch as port
    from pathlib import Path

    own = trace.port_symbols(Path(port.__file__).parent)
    assert {"stack_kernel", "tile_kernel", "chebyshev_warp_kernel",
            "df_residual_kernel", "mdot_partials", "csr_chunk_kernel"} <= own
    for kf in registry.kernel_files(ROOT).values():
        assert set(kf.SYMBOLS) <= own, kf.FUNCTION


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_shim_counts_eager_launches_and_graph_replays():
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d

    orig = stencil2d.stencil2d_apply
    shim = trace.LaunchShim(registry.kernel_files(ROOT))
    shim.install()
    try:
        assert stencil2d.stencil2d_apply is not orig
        assert blockops.stencil2d_apply is stencil2d.stencil2d_apply
        x = torch.zeros((2, 8, 16))
        g = build.CountedGraph(_Graph(), contextlib.nullcontext)
        g.capture(lambda: blockops.stencil2d_apply(x, diag=4.0, off=-1.0))
        stencil2d.stencil2d_apply(x[:1], diag=4.0, off=-1.0)   # untraced
        assert shim.records == []
        shim.tracing = True
        stencil2d.stencil2d_apply(x[:1].contiguous(), diag=4.0, off=-1.0,
                                  panel=True)
        g.replay()
        g.replay()
        shim.tracing = False
        g.replay()
    finally:
        shim.uninstall()
    assert stencil2d.stencil2d_apply is orig and blockops.stencil2d_apply is orig
    assert shim.records == [("stencil2d_apply[spmm]", 2 * 128 * 4, "float32[1, 8, 16]"),
                            ("stencil2d_apply[mv]", 2 * 256 * 4, "float32[2, 8, 16]"),
                            ("stencil2d_apply[mv]", 2 * 256 * 4, "float32[2, 8, 16]")]
    assert g.graph.replays == 3
