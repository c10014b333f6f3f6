"""Kernel M, ``ops/coarse.chebyshev_coarse``: the coarsest grid's
Chebyshev steps in one launch; reads b, writes x.  Its time is the 40
dependent steps, not the bytes: it lowers the share it is summed into."""

MODULE = "medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.coarse"
FUNCTION = "chebyshev_coarse"
SYMBOLS = ("chebyshev_warp_kernel", "chebyshev_coarse_kernel")


def launch(p):
    b, dims = p["b"], tuple(p["dims"])
    return f"chebyshev_coarse[{len(dims)}d]", 2 * b.numel() * b.element_size()
