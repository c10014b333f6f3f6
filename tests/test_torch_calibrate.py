"""The port's routing calibration (``utils/calibrate.py``) at a small size
on the CPU: the constants of ``core/calibration.SHIPPED`` come back
positive, and a saved calibration loads back through
``core/calibration``.  (On the card, ``chip_smoke.py calibration`` runs
it at the shipped table's sizes.)"""

import json

import pytest
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import calibration
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import calibrate

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

SMALL = dict(dia_grid=32, stored=1 << 15, block_sizes=(8, 16), width=2,
             aij_n=1024, ell_n=1024, dense_ns=(64, 128), reps=3, rounds=2,
             device="cpu")


@pytest.fixture(scope="module")
def measured():
    return calibrate.measure_calibration(log=lambda m: None, **SMALL)


def test_shipped_keys_positive(measured):
    for key in calibration.SHIPPED:
        assert key in measured
    assert set(measured["bsr_bs_penalty"]) == {"8", "16"}
    assert all(v > 0 for v in measured["bsr_bs_penalty"].values())
    for key in ("ell_relative_cost", "aij_relative_cost", "max_dense_n"):
        assert measured[key] > 0
    assert measured["max_dense_n"] <= calibration.SHIPPED["max_dense_n"]
    assert measured["platform"] == "cpu" and measured["dia_ms"] > 0


def test_save_and_load_back(measured, tmp_path, monkeypatch):
    path = tmp_path / "cal.json"
    monkeypatch.setenv("MEDANE_TORCH_CALIBRATION", str(path))
    assert calibration.save(measured, str(path)) == str(path)
    try:
        got = calibration.load()
        assert got["source"] == str(path)
        assert got["bsr_bs_penalty"] == {
            int(k): v for k, v in measured["bsr_bs_penalty"].items()}
        for key in ("ell_relative_cost", "aij_relative_cost", "max_dense_n"):
            assert got[key] == measured[key]
        assert calibration.bsr_bs_penalty()[16] == (
            measured["bsr_bs_penalty"]["16"])
    finally:
        calibration.reset_cache()


def test_main_dry_run_and_save(monkeypatch, tmp_path, capsys):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"device_kind": "cpu", "bsr_bs_penalty": {"8": 1.0},
                "ell_relative_cost": 2.0, "aij_relative_cost": 3.0,
                "max_dense_n": 64}

    monkeypatch.setattr(calibrate, "measure_calibration", fake)
    assert calibrate.main(["--device", "cpu", "--stored", "4096"]) == 0
    assert json.loads(capsys.readouterr().out)["max_dense_n"] == 64
    assert seen["device"] == "cpu" and seen["stored"] == 4096
    out = tmp_path / "c.json"
    try:
        assert calibrate.main(["--device", "cpu", "--out", str(out)]) == 0
        assert json.loads(out.read_text())["aij_relative_cost"] == 3.0
    finally:
        calibration.reset_cache()
