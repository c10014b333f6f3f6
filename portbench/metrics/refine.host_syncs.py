"""``refine.host_syncs``: the count the entry reports under this name, per traced
solve."""


def read(ctx):
    values = [c["refine.host_syncs"] for c in ctx.counts if "refine.host_syncs" in c]
    if not values or len(values) != len(ctx.counts):
        return None
    return sum(values) / len(values)
