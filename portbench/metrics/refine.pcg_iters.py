"""``refine.pcg_iters``: the count the entry reports under this name, per traced
solve."""


def read(ctx):
    values = [c["refine.pcg_iters"] for c in ctx.counts if "refine.pcg_iters" in c]
    if not values or len(values) != len(ctx.counts):
        return None
    return sum(values) / len(values)
