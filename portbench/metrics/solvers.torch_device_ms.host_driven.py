"""``solvers.torch_device_ms`` in the cells whose solve the host drives launch by launch
(they report ``solve_s.host_driven``): the same reading."""

from portbench.trace import other_device_ms as read  # noqa: F401
