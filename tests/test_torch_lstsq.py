"""Port parity for ``lstsq_normal`` on a Gram matrix that is not positive
definite (``solvers/lstsq.py``), and for the multisplitting solve that
meets one.

JAX's ``cho_factor`` returns an all-NaN factor there, so the JAX
``lstsq_normal`` returns NaN and the multisplitting solve ends
unconverged with a NaN residual norm.  The port must do the same, batch
member by batch member, without raising.  Inputs are made with numpy from a seed and given to
both packages; the members that factor are held to JAX at the 1e-10 of
``tests/test_torch_krylov.py``'s direct cases (relative to the largest
entry).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops as jbo
from medane_tchakorom_ufc_thesis_repository_tpu.models import multisplitting as jms
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.lstsq import (
    lstsq_normal as jlstsq_normal,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops as tbo
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import multisplitting as tms
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
    lstsq_normal as tlstsq_normal,
)

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)

NP = {"f64": np.float64, "f32": np.float32}


def _panel(seed, dtype, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return (rng.standard_normal(lead + (200, 6)).astype(NP[dtype]),
            rng.standard_normal(lead + (200,)).astype(NP[dtype]))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_indefinite_gram_gives_nan_in_both(dtype):
    """A negative damping larger than the Gram's diagonal."""
    R, rhs = _panel(20, dtype)
    l2 = -10.0 * float((R * R).sum(0).max())
    aj = np.asarray(jlstsq_normal(jnp.asarray(R), jnp.asarray(rhs), l2=l2))
    at = tlstsq_normal(torch.from_numpy(R), torch.from_numpy(rhs), l2=l2)
    assert np.isnan(aj).all()
    assert at.shape == aj.shape and torch.isnan(at).all()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_nan_falls_on_the_indefinite_member_only(dtype):
    """A batch of 3 whose middle panel is scaled down by 100: a damping
    of -10 x its largest Gram diagonal breaks it alone."""
    R, rhs = _panel(21, dtype, batch=3)
    R[1] *= 0.01
    l2 = -10.0 * float((R[1] * R[1]).sum(0).max())
    aj = np.asarray(jax.vmap(lambda a, b: jlstsq_normal(a, b, l2=l2))(
        jnp.asarray(R), jnp.asarray(rhs)))
    at = tlstsq_normal(torch.from_numpy(R), torch.from_numpy(rhs), l2=l2)
    nan_t = torch.isnan(at).numpy()
    np.testing.assert_array_equal(nan_t, np.isnan(aj))
    assert nan_t[1].all() and not nan_t[[0, 2]].any()
    if dtype == "f64":
        # each member that factors is JAX's own answer for that member
        for i in (0, 2):
            ref = np.asarray(jlstsq_normal(jnp.asarray(R[i]),
                                           jnp.asarray(rhs[i]), l2=l2))
            err = np.abs(at[i].numpy() - ref).max() / np.abs(ref).max()
            assert err <= 1e-10, err


def test_members_that_factor_are_unchanged():
    """The factor of a positive definite Gram is ``cholesky``'s, to the
    bit: the NaN fill touches only the members that fail."""
    R, rhs = _panel(22, "f64", batch=3)
    Rt, rt = torch.from_numpy(R), torch.from_numpy(rhs)
    g = Rt.transpose(-2, -1) @ Rt
    g = g + (torch.finfo(g.dtype).eps * torch.diagonal(
        g, dim1=-2, dim2=-1).sum(-1) / 6)[..., None, None] * torch.eye(6)
    c = torch.linalg.cholesky(g)
    want = torch.cholesky_solve((Rt.transpose(-2, -1) @ rt[..., None]), c)[..., 0]
    assert torch.equal(tlstsq_normal(Rt, rt), want)


def test_multisplit_solve_ends_unconverged_with_nan_in_both():
    """SMSM_GLOBAL on the 3D strips with Chebyshev(20) inner solves, s=4,
    rtol 1e-5, f32 and normal equations (the JAX bench's 3D
    configuration, cut from 64^3 to 8^3): the f32 Gram of the basis stops
    being positive definite in the second cycle, and both packages run
    to ``maxiter`` with a NaN residual norm."""
    shape = (8, 8, 8)
    b = np.asarray(jbo.rhs_ones(jbo.block_poisson3d(*shape, 2), jnp.float32))
    kw = dict(scope="global", s=4, rtol=1e-5, maxiter=40)
    rj = jms.smsm(jbo.block_poisson3d(*shape, 2), jnp.asarray(b),
                  inner=jms.InnerConfig(method="chebyshev", maxiter=20),
                  outer=jms.OuterConfig(method="normal"), **kw)
    rt = tms.smsm(tbo.block_poisson3d(*shape, 2), torch.from_numpy(b.copy()),
                  inner=tms.InnerConfig(method="chebyshev", maxiter=20),
                  outer=tms.OuterConfig(method="normal"), **kw)
    for r in (rj, rt):
        assert not bool(r.converged)
        assert int(r.sweeps) == 40
        assert np.isnan(float(r.rnorm))
