"""``refine.launch_ms``: host ms a solve inside the refinement program's
graph replays (``refine.replay``): the launches, during which the card
waits for its next graph."""

from portbench.spans import host_s, totals


def read(ctx):
    got = totals("refine.replay")
    if got is None:
        return None
    return 1e3 * host_s(got, "refine.replay") / ctx.solves
