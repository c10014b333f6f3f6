"""CPU tests of the port's benchmark (``python -m pytest portbench/tests``).

Tests marked ``card`` need the NVIDIA card and skip without it; each
decides inside its fixture, never while the module is imported."""

import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the NVIDIA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda:0")


TINY = {"poisson3d_512": [16, 16, 16], "poisson2d_4096": [32, 32]}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark beside which each configuration has a tiny
    twin (``<config>.tiny``) and each cell a twin on it
    (``<cell>.tiny``): new files and new entries, no edit of a file."""
    import json

    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in list(bench["configs"]):
        cfg = json.loads((root / c["file"]).read_text())
        cfg["grid"] = TINY[c["name"]]
        name = f"{c['name']}.tiny"
        path = f"portbench/configs/{name}.json"
        (root / path).write_text(json.dumps(cfg))
        bench["configs"].append(dict(c, name=name, file=path))
    for w in list(bench["workloads"]):
        bench["workloads"].append(dict(w, name=f"{w['name']}.tiny",
                                       config=f"{w['config']}.tiny"))
    # the MG-PCG mix on the 2D grid, a cell by one new entry alone
    bench["workloads"].append({"name": "p2d_4096.mgpcg_df.tiny",
                               "config": "poisson2d_4096.tiny",
                               "traffic": "mgpcg_df", "chips": 1, "why": "test"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [f"{w}.tiny" for w in m["workloads"]]
            if "ns3d_512.stream" in m["workloads"]:
                m["workloads"].append("p2d_4096.mgpcg_df.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
