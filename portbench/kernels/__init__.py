"""Byte counts of the port's kernel wrappers, one file a wrapper.

Each file names the wrapper (``MODULE``, ``FUNCTION``), the device symbols
its kernels carry (``SYMBOLS``: the ``__global__`` function names, as the
profiler shows them before any template arguments), and
``launch(p) -> (label, bytes)``, ``p`` the call's arguments by parameter
name (defaults filled in; ``*extras`` as a tuple): the bytes one launch must
move at the call's shapes and dtypes, each input read once and each
output written once.  The harness wraps ``FUNCTION`` wherever the port
binds it and sums these counts over the traced solves."""
