"""``kernels.roofline_pct`` in the cells whose solve the host drives launch by launch
(they report ``solve_s.host_driven``): the same reading."""

from portbench.trace import roofline_pct as read  # noqa: F401
