"""The benchmark's plain reference: f64 Poisson stencils in plain PyTorch
and NumPy.  It imports nothing of the port and takes nothing the port
made: it is given the right-hand side the benchmark handed to the port and
the solution the port returned, and it computes everything else again."""
