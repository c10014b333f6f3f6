"""``multisplit.sync_wait_ms``: host ms a solve blocked in the reads of
device values that the solve counts (``multisplit.sync`` in the driver,
``krylov.sync`` in the inner and outer solvers): the solve's wall time
less this is what the host spent ahead of the card."""

from portbench.spans import host_s, totals


def read(ctx):
    got = totals("multisplit.solve")
    if got is None:
        return None
    wait = host_s(got, "multisplit.sync") + host_s(got, "krylov.sync")
    return 1e3 * wait / ctx.solves
