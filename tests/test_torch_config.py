"""The port's run configuration (``utils/config.py``) against the JAX
package's: the same fields, defaults, layering (defaults < JSON file <
overrides), per-block override maps and errors.  The port has one field
more, ``device`` (None: the current CUDA device, or an error without
one); every comparison leaves it out.  JAX's seven ``TestConfig`` cases
(``tests/test_cli.py``) run on both packages.
"""

import dataclasses
import json

import pytest
import torch

from medane_tchakorom_ufc_thesis_repository_tpu.models import (
    multisplitting as jms,
)
from medane_tchakorom_ufc_thesis_repository_tpu.utils import config as jcfg
from medane_tchakorom_ufc_thesis_repository_tpu_torch import utils as tutils
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    multisplitting as tms,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import config as tcfg

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

PKGS = {"jax": jcfg, "torch": tcfg}


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("device", None)
    return d


def _write(tmp_path, vals) -> str:
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(vals))
    return str(p)


# -- JAX's TestConfig, on both packages ---------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
class TestConfigBothPackages:
    def test_defaults_mirror_reference(self, pkg):
        cfg = PKGS[pkg].RunConfig()
        assert cfg.alg == "AM"
        assert cfg.m == cfg.n == 1024
        assert cfg.s == 4
        assert cfg.rtol == 1e-3
        assert cfg.min_convergence_count == 4
        assert cfg.inner_maxiter == 20
        assert cfg.inner_rtol == 1e-3

    def test_schedule_and_scope_derivation(self, pkg):
        dc = PKGS[pkg].default_config
        assert dc(alg="SM", m=8, n=8).schedule == "sync"
        assert dc(alg="AMAM_GLOBAL", m=8, n=8).schedule == "async"
        assert dc(alg="SMSM_LOCAL", m=8, n=8).minimization == "local"
        assert (dc(alg="SMSM_SEMI_LOCAL", m=8, n=8).minimization
                == "semi_local")
        assert dc(alg="AMAM_GLOBAL", m=8, n=8).minimization == "global"
        assert dc(alg="AM", m=8, n=8).minimization is None

    def test_unknown_algorithm_rejected(self, pkg):
        with pytest.raises(ValueError):
            PKGS[pkg].default_config(alg="NOPE")

    def test_file_layering(self, pkg, tmp_path):
        path = _write(tmp_path, {"alg": "SM", "m": 64, "n": 32})
        cfg = PKGS[pkg].load_config(path, n=16)   # the override wins
        assert cfg.alg == "SM" and cfg.m == 64 and cfg.n == 16

    def test_all_algorithms_enumerated(self, pkg):
        assert len(PKGS[pkg].ALGORITHMS) == 11

    def test_pc_fields_layer_through_config_file(self, pkg, tmp_path):
        path = _write(tmp_path, {
            "alg": "GMRES", "matrix": "dummy.npz",
            "pc_type": "bjacobi", "pc_block_size": 32,
            "inner_pc": "bjacobi", "inner_pc_block_size": 16,
        })
        cfg = PKGS[pkg].load_config(path, pc_block_size=8)
        assert cfg.pc_type == "bjacobi" and cfg.pc_block_size == 8
        assert cfg.inner_pc == "bjacobi" and cfg.inner_pc_block_size == 16
        assert cfg.inner_config().pc_block_size == 16

    def test_pc_type_validated(self, pkg):
        with pytest.raises(ValueError, match="pc_type"):
            PKGS[pkg].default_config(alg="GMRES", matrix="x.npz",
                                     pc_type="ilu")


# -- the two packages against each other ----------------------------------------

def test_algorithms_equal():
    assert tcfg.ALGORITHMS == jcfg.ALGORITHMS


def test_default_config_equal():
    assert _fields(tcfg.default_config()) == _fields(jcfg.default_config())
    assert _fields(tcfg.RunConfig()) == _fields(jcfg.RunConfig())


LAYERED = [
    ({"alg": "SMSM_GLOBAL", "m": 64, "n": 32, "dtype": "float64",
      "s": 8, "staleness": 3, "inner_ksp": "cg", "inner_pc": "mg",
      "outer_method": "lsqr"}, {"rtol": 1e-6, "n": 48}),
    ({"alg": "AMAM_LOCAL", "m": 32, "n": 32,
      "inner_overrides": [{"maxiter": 30}, {"ksp": "cg", "pc": "jacobi"}],
      "outer_overrides": [{}, {"method": "normal", "rtol": 1e-9}]}, {}),
    ({"alg": "SM", "backend": "tiled", "m": 32, "n": 16, "ir": 2,
      "ic": 4, "inner_basis": "bf16"}, {"maxiter": 7}),
    ({"alg": "MGPCG", "dim": 3, "m": 16, "n": 16, "nz": 16,
      "backend": "sharded", "intra": 4}, {"inner_rtol": 1e-5}),
]


@pytest.mark.parametrize("vals,overrides", LAYERED)
def test_load_config_equal(tmp_path, vals, overrides):
    path = _write(tmp_path, vals)
    tc = tcfg.load_config(path, **overrides)
    jc = jcfg.load_config(path, **overrides)
    assert _fields(tc) == _fields(jc)
    assert tc.schedule == jc.schedule and tc.minimization == jc.minimization
    # the InnerConfig / OuterConfig built from each are field for field
    # the same (a per-block tuple where overrides are given)
    for what in ("inner_config", "outer_config"):
        t, j = getattr(tc, what)(), getattr(jc, what)()
        ts = t if isinstance(t, tuple) else (t,)
        js = j if isinstance(j, tuple) else (j,)
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            assert type(a) in (tms.InnerConfig, tms.OuterConfig)
            assert type(b) in (jms.InnerConfig, jms.OuterConfig)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)


BAD = [
    dict(alg="NOPE"),
    dict(pc_type="ilu"),
    dict(alg="GMRES", pc_type="jacobi"),
    dict(alg="SM", matrix="a.npz", pc_type="jacobi"),
    dict(alg="GMRES", matrix="a.npz", pc_type="bjacobi", pc_block_size=0),
    dict(dim=4),
    dict(backend="tiled", m=30, ir=2),
    dict(backend="tiled", m=32, n=30, ic=4),
    dict(backend="sharded", m=36, intra=4),
    dict(m=33),
    dict(backend="sharded", inner_overrides=({}, {})),
    dict(inner_overrides=({},)),
    dict(inner_overrides=({"bogus": 1}, {})),
    dict(outer_overrides=({"ksp": "cg"}, {})),
]


@pytest.mark.parametrize("kw", BAD)
def test_errors_equal(kw):
    with pytest.raises(ValueError) as je:
        jcfg.default_config(**kw)
    with pytest.raises(ValueError) as te:
        tcfg.default_config(**kw)
    assert str(te.value) == str(je.value)


def test_device_field():
    cfg = tcfg.default_config()
    assert cfg.device is None
    assert tcfg.default_config(device="cpu").torch_device() == torch.device(
        "cpu")
    if torch.cuda.is_available():
        assert cfg.torch_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.torch_device()


def test_utils_exports():
    assert tutils.RunConfig is tcfg.RunConfig
    assert tutils.default_config is tcfg.default_config
    with tutils.PhaseTimer().phase("x"):
        pass
