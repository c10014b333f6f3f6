"""Kernel E, ``ops/stencil2d.stencil2d_apply``: ``A x`` on each grid of a
``(batch, m, n)`` stack (``[mv]``) or basis panel (``[spmm]``); reads x,
writes y."""

MODULE = "medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil2d"
FUNCTION = "stencil2d_apply"
SYMBOLS = ("tile_kernel",)


def launch(p):
    x = p["x"]
    kind = "spmm" if p["panel"] else "mv"
    return f"stencil2d_apply[{kind}]", 2 * x.numel() * x.element_size()
