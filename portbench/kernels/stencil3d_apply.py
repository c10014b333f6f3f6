"""Kernel A, ``ops/stencil3d.stencil3d_apply``: ``mv`` (y = A x), ``mv_dot``
(and x·Ax), ``residual`` (b - A x), ``jacobi`` (x + omega (b - A x)),
``jacobi_dot`` (and b·x').  Reads x (and b), writes y at ``out_dtype``,
and the dot kinds one scalar of the arithmetic type."""

MODULE = "medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil3d"
FUNCTION = "stencil3d_apply"
SYMBOLS = ("stack_kernel", "apply_kernel", "jacobi_dot_kernel", "sum_partials")


def launch(p):
    x, extras, kind = p["x"], p["extras"], p["kind"]
    out = x.dtype if p["out_dtype"] is None else p["out_dtype"]
    out_size = _size(out)
    n = x.numel() * x.element_size() + x.numel() * out_size
    n += sum(e.numel() * e.element_size() for e in extras)
    if kind in ("mv_dot", "jacobi_dot"):
        n += 8 if x.element_size() == 8 else 4
    return f"stencil3d_apply[{kind}]", n


def _size(dtype) -> int:
    import torch

    return torch.empty((), dtype=dtype).element_size()
