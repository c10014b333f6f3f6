"""``refine.loop_idle_ms``: device ms a solve between the refinement
program's graph replays: ``refine.passes``'s device time (the pass loop,
its host reads included) less that of every ``refine.replay`` in it. The
host reads' wake-up and the loop's Python; the launches lie inside the
replays."""

from portbench.spans import device_s, totals


def read(ctx):
    got = totals("refine.passes")
    if got is None:
        return None
    idle = device_s(got, "refine.passes") - device_s(got, "refine.replay")
    return 1e3 * idle / ctx.solves
