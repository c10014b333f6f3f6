"""Kernel G, ``ops/fused.maxpy``: ``y0[b] + sum_{k < k_active} alphas[b, k]
V[b, k]``; reads the first ``k_active`` rows of V, their alphas and y0,
writes y."""

MODULE = "medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.fused"
FUNCTION = "maxpy"
SYMBOLS = ("maxpy_kernel",)


def launch(p):
    V, alphas, y0 = p["V"], p["alphas"], p["y0"]
    k_active = int(p["k_active"])
    batch, K, N = V.shape
    n = batch * k_active * (N * V.element_size() + alphas.element_size())
    return "maxpy", n + 2 * y0.numel() * y0.element_size()
