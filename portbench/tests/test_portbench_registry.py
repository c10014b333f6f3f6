"""Discovery by name, a cell added by files alone, and BENCHMARK.json
against the benchmark's contract."""

import json
import re
import shutil

import pytest
import torch

from conftest import ROOT
from portbench import harness, registry

torch.set_num_threads(1)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per")


def bench():
    return registry.load(ROOT)


def test_every_cell_finds_its_pieces_by_name():
    b = bench()
    for w in b["workloads"]:
        cfg = registry.config(ROOT, b, w["config"])
        mix = registry.traffic(ROOT, w["traffic"])
        entry = registry.entry(ROOT, mix["entry"])
        for fn in ("build", "inputs", "given", "solve", "answer", "converged",
                   "counts", "answer_f64", "control", "close"):
            assert callable(getattr(entry, fn)), (mix["entry"], fn)
        assert cfg["grid"] and cfg["stencil"]["diag"] > 0
        assert 0 < float(mix["params"]["rtol"]) < 1
        assert int(mix["warm_solves"]) >= 1
        assert 1 <= int(mix["check_solves"]) <= int(mix["check_from"])
    for m in b["per_layer"]:
        assert callable(registry.metric(ROOT, m["name"]).read), m["name"]


def test_kernel_files_name_their_wrapper():
    files = registry.kernel_files(ROOT)
    assert {"stencil3d_apply", "stencil3d_mv_cast", "stencil3d_residual_restrict",
            "stencil3d_prolong_jacobi", "stencil3d_df_residual", "chebyshev_coarse",
            "stencil2d_apply", "mdot", "maxpy"} <= set(files)
    import importlib
    for stem, kf in files.items():
        assert kf.FUNCTION == stem
        assert callable(getattr(importlib.import_module(kf.MODULE), kf.FUNCTION))
        assert kf.SYMBOLS and all(re.match(r"^\w+$", s) for s in kf.SYMBOLS)


def test_a_cell_added_by_new_files_and_one_entry(tmp_path):
    """A configuration, a traffic mix and a cell come in as two new files
    and new entries of BENCHMARK.json; nothing that was there changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((ROOT / "portbench/configs/poisson2d_4096.json").read_text())
    cfg.update(name="poisson2d_48", grid=[48, 48])
    (tmp_path / "portbench/configs/poisson2d_48.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "portbench/traffic/smsm_global.json").read_text())
    mix["params"]["s"] = 2
    (tmp_path / "portbench/traffic/smsm_s2.json").write_text(json.dumps(mix))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "poisson2d_48", "source": "test",
                         "file": "portbench/configs/poisson2d_48.json",
                         "reduced": ["grid"], "why": "test"})
    b["workloads"].append({"name": "p2d_48.smsm_s2", "config": "poisson2d_48",
                           "traffic": "smsm_s2", "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "p2d_4096.smsm_global" in m.get("workloads", []):
            m["workloads"].append("p2d_48.smsm_s2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    for p, data in before.items():
        assert p.read_bytes() == data
    out = harness.execute(tmp_path, "p2d_48.smsm_s2", 7, 0.5, False, "cpu", 0.0)
    line = out["line"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    # no card: no memory reading
    assert set(line["metrics"]) == {"solve_s.host_driven", "setup_s"}
    assert list(line)[-1] == "compared"


def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len(json.dumps(b)) <= 64 * 1024
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()

    def line(s):
        return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
            and "\t" not in s

    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
        names.add(("config", c["name"]))
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
    cells = {w["name"] for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["moves"] in e2e and line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for cell in cells:
        got = {m["name"] for m in registry.metrics_for(b, "end_to_end", cell)}
        assert "setup_s" in got and len(got) >= 2
        assert registry.metrics_for(b, "per_layer", cell)


def test_config_files_state_the_guarantee():
    b = bench()
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert "true residual" in cfg["guarantee"]
        assert len(cfg["grid"]) in (2, 3)


def test_run_without_a_card_gives_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from portbench import run

    rc = run.main(["--workload", "ns3d_512.stream", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
