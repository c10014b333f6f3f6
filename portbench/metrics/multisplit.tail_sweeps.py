"""``multisplit.tail_sweeps``: the count the entry reports under this name
(the sweeps of an asynchronous run's certification tail), per traced
solve."""


def read(ctx):
    values = [c["multisplit.tail_sweeps"] for c in ctx.counts
              if c.get("multisplit.tail_sweeps") is not None]
    if not values or len(values) != len(ctx.counts):
        return None
    return sum(values) / len(values)
