"""Routing-constant calibration store (the port's own copy of the JAX
package's ``core/calibration.py``).

The operator routing of ``core.operators`` weighs four measured
constants: the per-stored-value cost of the BSR kernel by block size,
the per-nonzero cost of the gather-ELL and of the CSR (AIJ) product,
each relative to the slice path (``DIA.mv``), and the largest ``n`` at
which a dense matvec still beats the CSR kernel.  They are properties of
the card, so the shipped table below was measured on it, and a file
measured on another card overrides it.

Lookup order:
  1. ``MEDANE_TORCH_CALIBRATION`` env var (explicit file path),
  2. ``$XDG_CACHE_HOME/medane_tchakorom_ufc_thesis_repository_tpu_torch/
     calibration-<device_kind>.json`` (the kind from
     ``torch.cuda.get_device_name``),
  3. the shipped constants.

``chip_smoke.py``'s calibration phase measures the four constants on the
card it runs on and writes them with ``save`` to
``build/torch_kernels/calibration.json``; naming that file in the env var,
or copying it to the cache path, makes the routing use it.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional

import torch

__all__ = [
    "SHIPPED",
    "bsr_bs_penalty",
    "calibration_path",
    "aij_relative_cost",
    "default_max_dense_n",
    "ell_relative_cost",
    "load",
    "reset_cache",
    "save",
]

# Measured on one NVIDIA H100 80GB HBM3 at its 700 W power limit by
# ``chip_smoke.py``'s calibration phase (CUDA events, the median of 3
# medians of 20, f32, per stored value; every cost is relative to
# ``DIA.mv`` on the 5-point 2D Poisson matrix of a 4096 x 4096 grid, the
# slice path: 0.833 ms for 83,886,080 stored values, 9.9 ps each):
#   * bsr_bs_penalty: kernel I (``ops.bsr.bsr_mv``) on block rows of 8
#     blocks holding 2^28 stored values in all, by block size (0.435 to
#     0.445 ms at 32, 64 and 128; 2.26 ms at 8);
#   * aij_relative_cost: kernel H (``ops.csr.csr_mv``) on a structureless
#     square pattern, n = 2^22, 10 draws a row (0.439 ms);
#   * ell_relative_cost: ``ELL.mv`` (gather and row sum in plain PyTorch)
#     on a structureless pattern, n = 2^20, 10 draws a row (0.580 ms);
#   * max_dense_n: the largest power of two at which ``DenseOp.mv`` was no
#     slower than kernel H on a structureless pattern of 10 draws a row
#     (0.049 against 0.059 ms at 4096; 0.110 against 0.036 ms at 8192).
# The three medians of a launch of 0.4 ms and more lay within 4% of each
# other.  Block sizes 32, 64 and 128 cost the same per stored value within
# that spread, so among them the fill decides, and at equal fill the
# choice changes nothing in cost.  Below n = 8192 both sides of the dense
# crossover are bound by the ~30-60 us of their wrappers, and the medians
# spread by 5-45%: 2048 was read as often as 4096.  Every BSR block size
# is cheaper per stored value than the slice path here, and the CSR
# product costs about what it does.
SHIPPED = {
    "bsr_bs_penalty": {8: 0.849, 16: 0.258, 32: 0.164, 64: 0.163, 128: 0.167},
    "ell_relative_cost": 5.566,
    "aij_relative_cost": 1.053,
    "max_dense_n": 4096,
}

_loaded = None


def _device_kind() -> str:
    if not torch.cuda.is_available():
        return "unknown"   # the shipped constants still apply
    return torch.cuda.get_device_name(torch.cuda.current_device()).replace(
        " ", "_").replace("/", "_")


def calibration_path(kind: Optional[str] = None) -> str:
    env = os.environ.get("MEDANE_TORCH_CALIBRATION")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(
        base, "medane_tchakorom_ufc_thesis_repository_tpu_torch",
        f"calibration-{kind or _device_kind()}.json")


def load() -> dict:
    """Constants for the current device: a saved calibration merged over
    the shipped table (cached after the first call; ``reset_cache`` after
    saving a new calibration in-process)."""
    global _loaded
    if _loaded is None:
        out = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in SHIPPED.items()}
        path = calibration_path()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                pen = {int(k): float(v)
                       for k, v in data.get("bsr_bs_penalty", {}).items()}
                if pen:
                    out["bsr_bs_penalty"] = pen
                for key in ("ell_relative_cost", "aij_relative_cost"):
                    if key in data:
                        out[key] = float(data[key])
                if "max_dense_n" in data:
                    out["max_dense_n"] = int(data["max_dense_n"])
                out["source"] = path
            except (OSError, ValueError) as e:
                warnings.warn(
                    f"ignoring unreadable calibration file {path!r}: {e}",
                    UserWarning)
        _loaded = out
    return _loaded


def reset_cache() -> None:
    global _loaded
    _loaded = None


def bsr_bs_penalty() -> dict:
    return load()["bsr_bs_penalty"]


def ell_relative_cost() -> float:
    return load()["ell_relative_cost"]


def aij_relative_cost() -> float:
    return load()["aij_relative_cost"]


def default_max_dense_n() -> int:
    return load()["max_dense_n"]


def save(cal: dict, path: Optional[str] = None) -> str:
    """Persist a measured calibration and reset the in-process cache so
    that routing picks it up at once."""
    path = path or calibration_path(cal.get("device_kind"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(cal, f, indent=2, sort_keys=True)
    reset_cache()
    return path
