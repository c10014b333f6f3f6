"""``multisplit.minimize_ms``: device-clock ms a solve in the s-step
minimization (``multisplit.O_Solver``: the basis's full matvec, the
tall-skinny QR, the two ``maxpy``), idle inside it included."""

from portbench.spans import device_s, totals


def read(ctx):
    got = totals("multisplit.O_Solver")
    if got is None:
        return None
    return 1e3 * device_s(got, "multisplit.O_Solver") / ctx.solves
