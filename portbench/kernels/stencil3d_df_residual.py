"""Kernel D, ``ops/stencil3d.stencil3d_df_residual``: reads the f32 pairs
of x and b, writes the f32 pair of the residual: six f32 grids."""

MODULE = "medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil3d"
FUNCTION = "stencil3d_df_residual"
SYMBOLS = ("df_residual_kernel",)


def launch(p):
    xhi = p["xhi"]
    return "stencil3d_df_residual", 6 * xhi.numel() * xhi.element_size()
