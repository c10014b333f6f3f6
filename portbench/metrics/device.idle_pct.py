"""``device.idle_pct``: the share of the solves' ranges in which no
operation ran on the device (the ranges minus the union of the device
intervals)."""

from portbench.trace import idle_pct as read  # noqa: F401
