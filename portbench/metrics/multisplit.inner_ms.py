"""``multisplit.inner_ms``: device-clock ms a solve in the inner sweeps
(``multisplit.I_Solver``: each block's GMRES and the basis column), idle
inside them included."""

from portbench.spans import device_s, totals


def read(ctx):
    got = totals("multisplit.I_Solver")
    if got is None:
        return None
    return 1e3 * device_s(got, "multisplit.I_Solver") / ctx.solves
