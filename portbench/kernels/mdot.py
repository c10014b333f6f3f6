"""Kernel F, ``ops/fused.mdot``: the dots of the first ``k_active`` rows
of each basis ``V[b]`` (``(batch, K, N)``) with ``w[b]``; reads those rows
and w, writes ``h`` of ``(batch, K)``."""

MODULE = "medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.fused"
FUNCTION = "mdot"
SYMBOLS = ("mdot_partials", "mdot_finish")


def launch(p):
    V, w, k_active = p["V"], p["w"], int(p["k_active"])
    batch, K, N = V.shape
    n = batch * k_active * N * V.element_size() + w.numel() * w.element_size()
    return "mdot", n + batch * K * w.element_size()
