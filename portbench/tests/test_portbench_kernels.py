"""Each kernel count file against a hand count at two shapes (meta
tensors: shapes and dtypes, no memory)."""

import inspect

import pytest
import torch

from conftest import ROOT
from portbench import registry

torch.set_num_threads(1)

F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64


def t(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def bound(stem, *args, **kwargs):
    """The count file's ``launch`` on the arguments bound as the wrapper
    binds them."""
    import importlib

    kf = registry.kernel_files(ROOT)[stem]
    fn = getattr(importlib.import_module(kf.MODULE), kf.FUNCTION)
    b = inspect.signature(fn).bind(*args, **kwargs)
    b.apply_defaults()
    p = dict(b.arguments)
    for name, q in inspect.signature(fn).parameters.items():
        if q.kind is inspect.Parameter.VAR_POSITIONAL:
            p["extras"] = p.pop(name)
    return kf.launch(p)


N512, N64 = 512**3, 64**3
CASES = [
    # (file, args, kwargs, label, bytes by hand)
    ("stencil3d_apply", (t(512, 512, 512),), dict(kind="mv", diag=6.0, off=-1.0),
     "stencil3d_apply[mv]", 8 * N512),
    ("stencil3d_apply", (t(64, 64, 64, dtype=BF16), t(64, 64, 64, dtype=BF16)),
     dict(kind="jacobi", diag=6.0, off=-1.0, omega=0.5),
     "stencil3d_apply[jacobi]", 6 * N64),
    ("stencil3d_apply", (t(512, 512, 512),), dict(kind="mv_dot", diag=6.0, off=-1.0),
     "stencil3d_apply[mv_dot]", 8 * N512 + 4),
    ("stencil3d_apply", (t(64, 64, 64, dtype=BF16), t(64, 64, 64, dtype=BF16)),
     dict(kind="jacobi_dot", diag=6.0, off=-1.0, omega=0.5, out_dtype=F32),
     "stencil3d_apply[jacobi_dot]", 2 * N64 + 2 * N64 + 4 * N64 + 4),
    ("stencil3d_apply", (t(512, 512, 512, dtype=BF16), t(512, 512, 512, dtype=BF16)),
     dict(kind="residual", diag=6.0, off=-1.0), "stencil3d_apply[residual]", 6 * N512),
    ("stencil3d_apply", (t(8, 32, 256, 256, dtype=F64),), dict(kind="mv", diag=6.0,
     off=-1.0), "stencil3d_apply[mv]", 16 * 8 * 32 * 256 * 256),
    ("stencil3d_mv_cast", (t(512, 512, 512),), dict(diag=6.0, off=-1.0, out_dtype=BF16),
     "stencil3d_mv_cast", 4 * N512 + 2 * 2 * N512),
    ("stencil3d_mv_cast", (t(64, 64, 64),), dict(diag=6.0, off=-1.0, out_dtype=F32),
     "stencil3d_mv_cast", 12 * N64),
    ("stencil3d_residual_restrict", (t(512, 512, 512, dtype=BF16),
     t(512, 512, 512, dtype=BF16)), dict(diag=6.0, off=-1.0),
     "stencil3d_residual_restrict", 2 * N512 + 2 * N512 + 2 * N512 // 8),
    ("stencil3d_residual_restrict", (t(64, 64, 64), t(64, 64, 64)),
     dict(diag=6.0, off=-1.0, scale=4.0), "stencil3d_residual_restrict",
     8 * N64 + 4 * N64 // 8),
    ("stencil3d_prolong_jacobi", (t(512, 512, 512, dtype=BF16), t(512, 512, 512, dtype=BF16),
     t(256, 256, 256, dtype=BF16)), dict(diag=6.0, off=-1.0, omega=0.5),
     "stencil3d_prolong_jacobi", 2 * N512 * 3 + 2 * N512 // 8),
    ("stencil3d_prolong_jacobi", (t(64, 64, 64), t(64, 64, 64), t(32, 32, 32)),
     dict(diag=6.0, off=-1.0, omega=0.5), "stencil3d_prolong_jacobi",
     12 * N64 + 4 * N64 // 8),
    ("stencil3d_df_residual", (t(512, 512, 512),) * 4, dict(diag=6.0, off=-1.0),
     "stencil3d_df_residual", 24 * N512),
    ("stencil3d_df_residual", (t(64, 64, 64),) * 4, dict(diag=6.0, off=-1.0),
     "stencil3d_df_residual", 24 * N64),
    ("chebyshev_coarse", (t(4, 4, 4, dtype=BF16),), dict(dims=(4, 4, 4), diag=6.0,
     off=-1.0, coefs=None), "chebyshev_coarse[3d]", 2 * 2 * 64),
    ("chebyshev_coarse", (t(2, 4, 8),), dict(dims=(4, 8), diag=4.0, off=-1.0,
     coefs=None), "chebyshev_coarse[2d]", 2 * 4 * 64),
    ("stencil2d_apply", (t(2, 2048, 4096),), dict(diag=4.0, off=-1.0),
     "stencil2d_apply[mv]", 2 * 4 * 2 * 2048 * 4096),
    ("stencil2d_apply", (t(4, 4096, 4096, dtype=BF16),), dict(diag=4.0, off=-1.0,
     panel=True), "stencil2d_apply[spmm]", 2 * 2 * 4 * 4096 * 4096),
    ("mdot", (t(2, 31, 2**23), t(2, 2**23), 21), {}, "mdot",
     4 * 2 * 21 * 2**23 + 4 * 2 * 2**23 + 4 * 2 * 31),
    ("mdot", (t(1, 5, 100, dtype=BF16), t(1, 100)), dict(k_active=3), "mdot",
     2 * 3 * 100 + 4 * 100 + 4 * 5),
    ("maxpy", (t(2, 31, 2**23), t(2, 31), t(2, 2**23), 21), {}, "maxpy",
     4 * 2 * 21 * 2**23 + 4 * 2 * 21 + 2 * 4 * 2 * 2**23),
    ("maxpy", (t(1, 4, 2**24), t(1, 4), t(1, 2**24)), dict(k_active=4), "maxpy",
     4 * 4 * 2**24 + 4 * 4 + 2 * 4 * 2**24),
]


@pytest.mark.parametrize("stem,args,kwargs,label,want", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_bytes_by_hand(stem, args, kwargs, label, want):
    assert bound(stem, *args, **kwargs) == (label, want)


def test_every_count_file_has_two_hand_counts():
    stems = [c[0] for c in CASES]
    for stem in registry.kernel_files(ROOT):
        assert stems.count(stem) >= 2, stem
