"""``solvers.torch_device_ms``: device milliseconds a solve in everything
that is not one of the port's own kernels: PyTorch's elementwise kernels
and reductions, cuBLAS, cuSOLVER, copies and sets."""

from portbench.trace import other_device_ms as read  # noqa: F401
