"""Kernel C, ``ops/stencil3d.stencil3d_prolong_jacobi``: reads x and b on
the fine grid and the coarse correction e, writes one fine grid."""

MODULE = "medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil3d"
FUNCTION = "stencil3d_prolong_jacobi"
SYMBOLS = ("prolong_jacobi_kernel",)


def launch(p):
    x, b, e = p["x"], p["b"], p["e"]
    n = sum(t.numel() * t.element_size() for t in (x, b, e))
    return "stencil3d_prolong_jacobi", n + x.numel() * x.element_size()
