"""Finds every piece of a cell by its name: ``BENCHMARK.json`` at the root
of the checkout, a configuration by its ``file``, a traffic mix as
``portbench/traffic/<name>.json``, an entry as
``portbench/entries/<name>.py``, a per-layer metric as
``portbench/metrics/<name>.py`` and the kernel byte counts as every
``portbench/kernels/*.py``.  Adding a cell, configuration, mix, entry,
metric or count is adding files and entries: nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(root: Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(root: Path, name: str) -> dict:
    return json.loads((_dir(root) / "traffic" / f"{name}.json").read_text())


def _dir(root: Path) -> Path:
    return Path(root) / HERE.name


def _module(path: Path, kind: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    tag = re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(root: Path, name: str) -> ModuleType:
    return _module(_dir(root) / "entries" / f"{name}.py", "entry")


def metric(root: Path, name: str) -> ModuleType:
    return _module(_dir(root) / "metrics" / f"{name}.py", "metric")


def kernel_files(root: Path) -> Dict[str, ModuleType]:
    return {p.stem: _module(p, "kernel")
            for p in sorted((_dir(root) / "kernels").glob("*.py"))
            if not p.name.startswith("_")}


def metrics_for(bench: dict, section: str, cell: str) -> list:
    """The metrics of ``section`` that cell ``cell`` reports: those without
    a ``workloads`` key and those that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
