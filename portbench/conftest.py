"""The tiny grids of configurations declared after the benchmark tests'
``TINY`` table (``tests/conftest.py``), merged into that table as pytest
loads it, so that the shared ``tiny_root`` fixture shrinks every declared
configuration whichever test file runs.  The harness never imports this
file."""

from pathlib import Path

NEW_TINY = {"poisson2d_1024": [32, 32]}

_TESTS_CONFTEST = Path(__file__).resolve().parent / "tests" / "conftest.py"


def add_tiny_grids(module) -> None:
    """Give ``module.TINY`` a grid for each configuration it lacks."""
    for name, grid in NEW_TINY.items():
        module.TINY.setdefault(name, grid)


def pytest_plugin_registered(plugin):
    path = getattr(plugin, "__file__", None)
    if path and Path(path).resolve() == _TESTS_CONFTEST:
        add_tiny_grids(plugin)
