"""``multisplit.inner_iters``: the count the entry reports under this name, per traced
solve."""


def read(ctx):
    values = [c["multisplit.inner_iters"] for c in ctx.counts if "multisplit.inner_iters" in c]
    if not values or len(values) != len(ctx.counts):
        return None
    return sum(values) / len(values)
