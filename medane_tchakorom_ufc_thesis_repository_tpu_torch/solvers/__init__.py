"""Solvers: CG, Chebyshev, geometric multigrid, double-float refinement."""
