"""``kernels.roofline_pct``: the port's launches in the traced solves,
their bytes over 3.35 TB/s, as a share of the device time of the kernels
whose wrappers have a count file (``portbench/kernels``)."""

from portbench.trace import roofline_pct as read  # noqa: F401
