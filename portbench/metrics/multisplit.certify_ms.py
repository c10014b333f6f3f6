"""``multisplit.certify_ms``: device-clock ms a solve in the certification
tail of an asynchronous run (``multisplit.Certify``: the true residual on
the true coupling, its reads and the lockstep sweeps it takes), idle
inside it included."""

from portbench.spans import device_s, totals


def read(ctx):
    got = totals("multisplit.Certify")
    if got is None:
        return None
    return 1e3 * device_s(got, "multisplit.Certify") / ctx.solves
