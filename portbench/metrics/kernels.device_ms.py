"""``kernels.device_ms``: device milliseconds a solve in the port's own
kernels (every ``__global__`` function of its ``csrc/``)."""

from portbench.trace import own_device_ms as read  # noqa: F401
