"""Tools around the solvers (port of the JAX package's ``utils``): run
configuration, the ``isolve`` command line, profiling, checkpoints,
reports, bulk runs, scaling harnesses, calibration, multi-process launch.
"""

from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import (  # noqa: F401
    PhaseTimer,
)


def __getattr__(name):
    # the run configuration imports the solvers, which import
    # ``utils.profiling``: it loads on first use, not with the package
    if name in ("RunConfig", "default_config"):
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import (
            config,
        )

        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
