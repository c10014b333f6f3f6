"""``multisplit.sweeps``: the count the entry reports under this name, per traced
solve."""


def read(ctx):
    values = [c["multisplit.sweeps"] for c in ctx.counts if "multisplit.sweeps" in c]
    if not values or len(values) != len(ctx.counts):
        return None
    return sum(values) / len(values)
