"""Tools around the solvers: calibration, profiling, multi-process launch."""
