"""``device.idle_pct`` in the cells whose solve the host drives launch by launch
(they report ``solve_s.host_driven``): the same reading."""

from portbench.trace import idle_pct as read  # noqa: F401
