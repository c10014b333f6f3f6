"""The reference's stencils against dense matrices built here."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench.reference.stencil import (
    poisson_apply,
    poisson_apply_np,
    relative_residual,
)

torch.set_num_threads(1)


def dense(dims, diag, off):
    """The Dirichlet Laplacian of a grid as a Kronecker sum of 1D paths."""
    eyes = [sp.identity(n) for n in dims]
    paths = [sp.diags([1.0, 1.0], [-1, 1], shape=(n, n)) for n in dims]
    a = diag * sp.identity(int(np.prod(dims)))
    for axis in range(len(dims)):
        factors = eyes[:axis] + [paths[axis]] + eyes[axis + 1:]
        term = factors[0]
        for f in factors[1:]:
            term = sp.kron(term, f)
        a = a + off * term
    return a.toarray()


@pytest.mark.parametrize("dims,diag", [((5, 7), 4.0), ((1, 6), 4.0),
                                       ((4, 5, 3), 6.0), ((2, 1, 3), 6.0)])
def test_stencil_matches_the_dense_matrix(dims, diag):
    rng = np.random.default_rng(1)
    u = rng.standard_normal(dims)
    want = (dense(dims, diag, -1.0) @ u.ravel()).reshape(dims)
    got = poisson_apply(torch.from_numpy(u), diag, -1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    np.testing.assert_allclose(poisson_apply_np(u, diag, -1.0), want, rtol=0,
                               atol=1e-13)


def test_relative_residual():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((6, 5, 4)))
    b = poisson_apply(x, 6.0, -1.0)
    assert relative_residual(b, x, 6.0, -1.0) < 1e-15
    y = x.clone()
    y[2, 2, 2] += 1.0
    e = np.zeros((6, 5, 4))
    e[2, 2, 2] = 1.0
    r = np.linalg.norm(poisson_apply_np(e, 6.0, -1.0))
    assert relative_residual(b, y, 6.0, -1.0) == pytest.approx(
        r / float(torch.linalg.vector_norm(b)), rel=1e-12)
    with pytest.raises(ValueError):
        relative_residual(b.float(), x.float(), 6.0, -1.0)
    with pytest.raises(ValueError):
        relative_residual(b, x.reshape(6, 20), 6.0, -1.0)
