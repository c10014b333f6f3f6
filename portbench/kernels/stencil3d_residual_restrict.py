"""Kernel B, ``ops/stencil3d.stencil3d_residual_restrict``: reads x and b
on the fine grid, writes the restricted residual on the grid of half the
sides (an eighth of the points) in x's dtype."""

MODULE = "medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil3d"
FUNCTION = "stencil3d_residual_restrict"
SYMBOLS = ("residual_restrict_kernel",)


def launch(p):
    x, b = p["x"], p["b"]
    size = x.element_size()
    return ("stencil3d_residual_restrict",
            x.numel() * size + b.numel() * b.element_size()
            + (x.numel() // 8) * size)
