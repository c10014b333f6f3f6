"""Nothing the benchmark loads imports JAX or the JAX package, and the
reference imports nothing of the port.  Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import json
import subprocess
import sys

import torch

from conftest import ROOT

torch.set_num_threads(1)

JAX_PKG = "medane_tchakorom_ufc_thesis_repository_tpu"
PORT = JAX_PKG + "_torch"


def loaded_tops(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter (JAX's platform variables cleared, so nothing preloads
    it)."""
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in "
            "list(sys.modules)})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT),
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Everything ``portbench/run.py`` loads, with a cell run to its end
    on the CPU at a tiny size through every entry, metric and count."""
    code = f"""
import torch; torch.set_num_threads(1)
from portbench import run, harness, registry, control
root = __import__('pathlib').Path({str(ROOT)!r})
for stem in registry.kernel_files(root): pass
for m in registry.load(root)['per_layer']: registry.metric(root, m['name'])
import json, shutil, tempfile, pathlib
tmp = pathlib.Path(tempfile.mkdtemp())
shutil.copy(root / 'BENCHMARK.json', tmp / 'BENCHMARK.json')
shutil.copytree(root / 'portbench', tmp / 'portbench')
b = json.loads((tmp / 'BENCHMARK.json').read_text())
for c in b['configs']:
    cfg = json.loads((tmp / c['file']).read_text())
    cfg['grid'] = [16] * len(cfg['grid'])
    (tmp / c['file']).write_text(json.dumps(cfg))
for w in b['workloads']:
    for tr in (False, True):
        assert harness.execute(tmp, w['name'], 3, 0.2, tr, 'cpu', 0.0)['ok']
assert harness.forbidden_modules() == []
"""
    tops = loaded_tops(code)
    assert PORT in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", JAX_PKG}


def test_the_reference_imports_nothing_of_the_port():
    tops = loaded_tops("import portbench.reference.stencil")
    assert not tops & {"jax", "jaxlib", "flax", JAX_PKG, PORT}


def test_the_check_names_what_it_finds(monkeypatch):
    from portbench import harness

    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, JAX_PKG + ".core", object())
    found = harness.forbidden_modules()
    assert "jax" in found and JAX_PKG in found and PORT not in found
