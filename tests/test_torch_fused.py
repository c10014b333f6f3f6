"""Port parity for GMRES's Gram-Schmidt pair (kernels F ``mdot`` and G
``maxpy``, ``ops/fused.py``).

The kernels' plain PyTorch versions, which the wrappers run for CPU
tensors, are held against the JAX package's Pallas kernels
``mdot_pallas``/``maxpy_pallas`` in interpret mode (tile_n 512, as
``tests/test_pallas.py`` runs them), system by system; with a bf16 basis
against the ``dot_general`` forms of the JAX GMRES (``solvers/krylov.py``
``vdot_mat``/``vtdot``: the vector rounded to bf16, products summed in
f32); and in f64 against numpy.  The CUDA kernels themselves are held
against the plain versions on the card by ``chip_smoke.py``.

Tolerances: f32 rtol 1e-6 with PR 1's absolute floor, 1e-6 * max|ref|
for ``maxpy`` and 1e-6 * ||V_k|| ||w|| for a dot (the two sum in
different orders and a dot can cancel); f64 rtol 1e-12 with the same
floors at 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from medane_tchakorom_ufc_thesis_repository_tpu.ops import fused_pallas as fp
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import fused as f

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)


@pytest.fixture()
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _np(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _assert_dots(h, ref, V, w, rtol):
    """``h[b, k]`` against ``ref[b, k]``, the floor scaled by the
    operands' norms."""
    h = h.to(torch.float64).numpy()
    ref = np.asarray(ref, np.float64)
    assert h.shape == ref.shape
    scale = (np.linalg.norm(np.asarray(V, np.float64), axis=-1)
             * np.linalg.norm(np.asarray(w, np.float64), axis=-1)[:, None])
    bound = rtol * np.abs(ref) + rtol * scale
    assert np.all(np.abs(h - ref) <= bound), np.max(np.abs(h - ref) - bound)


def _assert_close(t, ref, rtol):
    got = t.to(torch.float64).numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    bound = rtol * np.abs(ref) + rtol * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= bound), np.max(np.abs(got - ref) - bound)


@pytest.mark.usefixtures("_interpret")
class TestPlainVersusPallas:
    def test_mdot(self):
        B, K, N = 2, 7, 4096
        V, w = _np((B, K, N), 1), _np((B, N), 2)
        ref = np.stack([np.asarray(fp.mdot_pallas(jnp.asarray(V[b]),
                                                  jnp.asarray(w[b]),
                                                  tile_n=512))
                        for b in range(B)])
        h = f.mdot_plain(torch.from_numpy(V), torch.from_numpy(w), K)
        assert h.dtype == torch.float32 and tuple(h.shape) == (B, K)
        _assert_dots(h, ref, V, w, 1e-6)

    def test_maxpy(self):
        B, K, N = 2, 6, 2048
        V, a, y0 = _np((B, K, N), 3), _np((B, K), 4), _np((B, N), 5)
        ref = np.stack([np.asarray(fp.maxpy_pallas(
            jnp.asarray(V[b]), jnp.asarray(a[b]), jnp.asarray(y0[b]),
            tile_n=512)) for b in range(B)])
        y = f.maxpy_plain(torch.from_numpy(V), torch.from_numpy(a),
                          torch.from_numpy(y0), K)
        assert y.dtype == torch.float32
        _assert_close(y, ref, 1e-6)


def _vdot_mat(V, w, acc):
    """The JAX GMRES's ``h = V w`` (``krylov.py`` ``vdot_mat``)."""
    return jax.lax.dot_general(V, w.astype(V.dtype), (((1,), (0,)), ((), ())),
                               preferred_element_type=acc)


def _vtdot(V, h, acc):
    """The JAX GMRES's ``V^T h`` (``krylov.py`` ``vtdot``)."""
    return jax.lax.dot_general(V.T, h.astype(V.dtype), (((1,), (0,)), ((), ())),
                               preferred_element_type=acc)


class TestBasisTypes:
    """The plain versions against the JAX GMRES's own forms, per basis
    storage type: bf16 and f32 with f32 sums, f32 and f64 with f64 sums."""

    @pytest.mark.parametrize("vd,acc", [("bf16", "f32"), ("f32", "f32"),
                                        ("bf16", "f64"), ("f64", "f64")])
    def test_gram_schmidt_step(self, vd, acc):
        jd = {"bf16": jnp.bfloat16, "f32": jnp.float32, "f64": jnp.float64}
        td = {"bf16": torch.bfloat16, "f32": torch.float32,
              "f64": torch.float64}
        B, K, N = 2, 5, 1000
        V = _np((B, K, N), 6, np.float64)
        w = _np((B, N), 7, np.float64)
        Vj = jnp.asarray(V).astype(jd[vd])
        wj = jnp.asarray(w).astype(jd[acc])
        Vt = torch.from_numpy(V).to(td[vd])
        wt = torch.from_numpy(w).to(td[acc])
        hj = np.stack([np.asarray(_vdot_mat(Vj[b], wj[b], jd[acc]))
                       for b in range(B)])
        ht = f.mdot_plain(Vt, wt, K)
        assert ht.dtype == td[acc]
        rtol = 1e-12 if acc == "f64" else 1e-6
        _assert_dots(ht, hj, np.asarray(Vj.astype(jnp.float64)), w, rtol)
        # w - V^T h: maxpy with alphas = -h
        uj = np.stack([np.asarray(wj[b] - _vtdot(Vj[b], jnp.asarray(hj[b]).astype(jd[acc]), jd[acc]))
                       for b in range(B)])
        ut = f.maxpy_plain(Vt, -torch.from_numpy(hj).to(td[acc]), wt, K)
        assert ut.dtype == td[acc]
        _assert_close(ut, uj, rtol)

    def test_f64_against_numpy(self):
        V, w = _np((3, 4, 333), 8, np.float64), _np((3, 333), 9, np.float64)
        a = _np((3, 4), 10, np.float64)
        h = f.mdot_plain(torch.from_numpy(V), torch.from_numpy(w), 4)
        _assert_dots(h, np.einsum("bkn,bn->bk", V, w), V, w, 1e-12)
        y = f.maxpy_plain(torch.from_numpy(V), torch.from_numpy(a),
                          torch.from_numpy(w), 4)
        _assert_close(y, w + np.einsum("bk,bkn->bn", a, V), 1e-12)


class TestActiveRowsAndLayout:
    @pytest.mark.parametrize("k_active", [0, 1, 3, 5])
    def test_rows_past_k_active_are_not_read(self, k_active):
        V = _np((2, 5, 64), 11, np.float64)
        V[:, k_active:] = np.nan   # the GMRES basis leaves them unwritten
        w, a = _np((2, 64), 12, np.float64), _np((2, 5), 13, np.float64)
        h = f.mdot(torch.from_numpy(V), torch.from_numpy(w), k_active)
        assert np.all(h[:, k_active:].numpy() == 0.0)
        Va = V[:, :k_active]
        _assert_dots(h[:, :k_active], np.einsum("bkn,bn->bk", Va, w), Va, w,
                     1e-12)
        y = f.maxpy(torch.from_numpy(V), torch.from_numpy(a),
                    torch.from_numpy(w), k_active)
        _assert_close(y, w + np.einsum("bk,bkn->bn", a[:, :k_active], Va), 1e-12)

    def test_basis_stored_row_major_by_step(self):
        """GMRES stores its basis ``(K, batch, N)``; the wrappers read its
        ``(batch, K, N)`` view in place."""
        Vs = torch.from_numpy(_np((4, 3, 50), 14, np.float64))
        V = Vs.permute(1, 0, 2)
        w = torch.from_numpy(_np((3, 50), 15, np.float64))
        a = torch.from_numpy(_np((3, 4), 16, np.float64))
        torch.testing.assert_close(f.mdot(V, w, 4), f.mdot(V.contiguous(), w, 4),
                                   rtol=0, atol=0)
        torch.testing.assert_close(f.maxpy(V, a, w, 3),
                                   f.maxpy(V.contiguous(), a, w, 3), rtol=0,
                                   atol=0)


class TestWrappers:
    def test_cpu_takes_plain_and_counts_nothing(self):
        build.reset_launch_counts()
        V = torch.from_numpy(_np((2, 3, 10), 17))
        w = torch.from_numpy(_np((2, 10), 18))
        a = torch.from_numpy(_np((2, 3), 19))
        torch.testing.assert_close(f.mdot(V, w, 2), f.mdot_plain(V, w, 2),
                                   rtol=0, atol=0)
        torch.testing.assert_close(f.maxpy(V, a, w, 3),
                                   f.maxpy_plain(V, a, w, 3), rtol=0, atol=0)
        assert build.launch_counts() == {}

    @pytest.mark.parametrize("case", [
        "meta_device", "two_dims", "v_int", "acc_bf16", "f64_basis_f32_acc",
        "w_shape", "w_dtype", "k_active_high", "k_active_negative",
        "v_strided_n", "w_noncontiguous", "alphas_shape", "y0_dtype"])
    def test_rejects(self, case):
        V = torch.zeros(2, 3, 8)
        w = torch.zeros(2, 8)
        a = torch.zeros(2, 3)
        calls = {
            "meta_device": lambda: f.mdot(V.to("meta"), w.to("meta"), 3),
            "two_dims": lambda: f.mdot(V[0], w, 3),
            "v_int": lambda: f.mdot(V.int(), w, 3),
            "acc_bf16": lambda: f.mdot(V.bfloat16(), w.bfloat16(), 3),
            "f64_basis_f32_acc": lambda: f.mdot(V.double(), w, 3),
            "w_shape": lambda: f.mdot(V, torch.zeros(2, 9), 3),
            "w_dtype": lambda: f.maxpy(V, a, w.double(), 3),
            "k_active_high": lambda: f.mdot(V, w, 4),
            "k_active_negative": lambda: f.maxpy(V, a, w, -1),
            "v_strided_n": lambda: f.mdot(torch.zeros(2, 3, 16)[:, :, ::2], w, 3),
            "w_noncontiguous": lambda: f.mdot(V, torch.zeros(8, 2).t(), 3),
            "alphas_shape": lambda: f.maxpy(V, torch.zeros(2, 4), w, 3),
            "y0_dtype": lambda: f.maxpy(V, a.double(), w, 3),
        }
        with pytest.raises(ValueError):
            calls[case]()
