"""Kernel A, kind ``mv_cast``, ``ops/stencil3d.stencil3d_mv_cast``: reads
x once, writes ``A x`` and ``x`` at ``out_dtype``."""

MODULE = "medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil3d"
FUNCTION = "stencil3d_mv_cast"
SYMBOLS = ("stack_kernel",)


def launch(p):
    import torch

    x = p["x"]
    out_size = torch.empty((), dtype=p["out_dtype"]).element_size()
    return "stencil3d_mv_cast", x.numel() * (x.element_size() + 2 * out_size)
