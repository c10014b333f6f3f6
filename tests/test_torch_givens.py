"""Kernel O (``ops/givens.py``, ``csrc/givens.cu``): the small-state work
of one Arnoldi step of ``solvers.krylov.gmres``.

CPU tests: the plain step against a frozen copy of the lines GMRES ran
inline before the step became one call, bit for bit, over f32 and f64,
1, 2 and 5 systems, cycles of 1, 20 and 30 steps, and four kinds of
systems: free ones, frozen ones (converged, or out of iterations part way
through the cycle), a zero new column (no rotation to form) and a happy
breakdown.  Then the wrapper's routing and what it refuses.

Card tests (marker ``card``; they skip without a card, and run there with
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_givens.py``): the kernel against the plain step on the
card over the same grid, bit for bit, and a graphed AM 1024² solve that
launches the kernel once an Arnoldi step, 20 times a replay.  The card is
not held to the CPU's bits: PyTorch's vectorised CPU square root is not
always correctly rounded (one ulp low at some f32 and f64 inputs), the card's is,
as is the kernel's ``__fsqrt_rn``/``__dsqrt_rn``.
"""

import numpy as np
import pytest
import torch

import medane_tchakorom_ufc_thesis_repository_tpu_torch as port
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    multisplitting as ms,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build, givens
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import profiling

torch.set_num_threads(1)

CASES = ("free", "frozen", "zero_column", "happy")
DTYPES = (torch.float32, torch.float64)


def frozen_step(hcol, happy, tol, maxiter, j, H, cs, sn, g, iters, rnorm,
                converged):
    """GMRES's step as it ran inline: ``H``, ``cs`` and ``sn`` written in
    place, the rest returned as new tensors."""
    active = ~converged & (iters < maxiter)
    # the accumulated rotations; slots >= j are the identity
    for i in range(j):
        hi, hi1 = hcol[:, i], hcol[:, i + 1]
        t1 = cs[:, i] * hi + sn[:, i] * hi1
        t2 = -sn[:, i] * hi + cs[:, i] * hi1
        hcol[:, i] = t1
        hcol[:, i + 1] = t2
    # the new rotation, annihilating hcol[j+1]
    a_, b_ = hcol[:, j], hcol[:, j + 1]
    denom = torch.sqrt(a_ * a_ + b_ * b_)
    pos = denom > 0
    safe = torch.where(pos, denom, 1.0)
    c_new = torch.where(pos, a_ / safe, 1.0)
    s_new = torch.where(pos, b_ / safe, 0.0)
    hcol[:, j] = denom
    hcol[:, j + 1] = 0.0
    gj = g[:, j]
    g_new = g.clone()
    g_new[:, j] = c_new * gj
    g_new[:, j + 1] = -s_new * gj
    rnorm_new = g_new[:, j + 1].abs()
    H[:, :, j] = torch.where(active[:, None], hcol, 0.0)
    cs[:, j] = torch.where(active, c_new, 1.0)
    sn[:, j] = torch.where(active, s_new, 0.0)
    g = torch.where(active[:, None], g_new, g)
    iters = torch.where(active, iters + 1, iters)
    rnorm = torch.where(active, rnorm_new, rnorm)
    converged = converged | (active & ((rnorm_new <= tol) | happy))
    return active, g, iters, rnorm, converged


def start(case, nsys, m, dtype, device, seed):
    """``(state, maxiter, tol)``: a cycle's state as GMRES starts it."""
    rng = np.random.default_rng(seed)
    beta = torch.from_numpy(rng.uniform(0.5, 2.0, nsys)).to(dtype)
    # of three or more, the last converges on the Givens estimate part way
    # through
    tol = torch.full((nsys,), 1e-30, dtype=dtype)
    if nsys >= 3:
        tol[-1] = beta[-1] * 0.3
    iters = torch.from_numpy(rng.integers(0, 5, nsys).astype(np.int32))
    maxiter = 1000
    converged = beta <= tol
    if case == "frozen":
        converged[0] = True
        if nsys > 1:                    # out of iterations at step m // 2
            iters[1] = maxiter - m // 2
    g = torch.zeros((nsys, m + 1), dtype=dtype)
    g[:, 0] = beta
    state = dict(H=torch.zeros((nsys, m + 1, m), dtype=dtype),
                 cs=torch.ones((nsys, m), dtype=dtype),
                 sn=torch.zeros((nsys, m), dtype=dtype), g=g, iters=iters,
                 rnorm=beta.clone(), converged=converged)
    return ({k: v.to(device) for k, v in state.items()}, maxiter,
            tol.to(device))


def column(case, nsys, m, j, dtype, device, rng):
    """``(hcol, happy)`` of step ``j`` as GMRES hands them over: ``h`` with
    zeros past ``j + 1`` and the new direction's norm at ``j + 1``."""
    h = np.zeros((nsys, m + 1))
    h[:, :j + 1] = rng.standard_normal((nsys, j + 1))
    h[:, j + 1] = np.abs(rng.standard_normal(nsys)) + 0.1
    if case == "zero_column" and j % 2 == 0:
        h[0, :j + 2] = 0.0
    if case == "happy" and j == m // 2:
        h[0, j + 1] = 1e-300
    hcol = torch.from_numpy(h).to(dtype).to(device)
    eps = torch.finfo(dtype).eps
    happy = hcol[:, j + 1] <= eps * torch.linalg.vector_norm(hcol, dim=-1)
    return hcol, happy


def bits(t):
    """The tensor's bits: floats as integers, so -0.0 differs from 0.0."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def assert_same(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(bits(got), bits(want)), (what, got, want)


def run_cycle(step, case, nsys, m, dtype, device, seed=7):
    """Every step of one cycle through ``step(hcol, happy, tol, maxiter, j,
    state)``, which returns the step's ``active``; the states after each
    step."""
    state, maxiter, tol = start(case, nsys, m, dtype, device, seed)
    rng = np.random.default_rng(seed + 1)
    trail = []
    for j in range(m):
        hcol, happy = column(case, nsys, m, j, dtype, device, rng)
        active = step(hcol, happy, tol, maxiter, j, state)
        trail.append({k: v.clone() for k, v in
                      dict(state, active=active).items()})
    return trail


def step_frozen(hcol, happy, tol, maxiter, j, s):
    active, s["g"], s["iters"], s["rnorm"], s["converged"] = frozen_step(
        hcol, happy, tol, maxiter, j, s["H"], s["cs"], s["sn"], s["g"],
        s["iters"], s["rnorm"], s["converged"])
    return active


def stepper(fn):
    def step(hcol, happy, tol, maxiter, j, s):
        active = torch.empty(hcol.shape[0], dtype=torch.bool,
                             device=hcol.device)
        fn(hcol, happy, tol, maxiter, j, s["H"], s["cs"], s["sn"], s["g"],
           s["iters"], s["rnorm"], s["converged"], active)
        return active
    return step


def assert_trails_equal(got, want):
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            assert_same(g[k], w[k], f"step {j}: {k}")


# ---------------------------------------------------------------------------
# The plain step against the inline lines it replaced
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("m", [1, 20, 30])
@pytest.mark.parametrize("nsys", [1, 2, 5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_step_equals_the_inline_lines(dtype, nsys, m, case):
    want = run_cycle(step_frozen, case, nsys, m, dtype, "cpu")
    got = run_cycle(stepper(givens.givens_step_plain), case, nsys, m, dtype,
                    "cpu")
    assert_trails_equal(got, want)


def test_the_grid_reaches_every_case():
    """The cases do what they are named for: systems freeze, a rotation
    meets a zero column, a happy breakdown converges a system."""
    frozen = run_cycle(step_frozen, "frozen", 2, 20, torch.float64, "cpu")
    assert not frozen[0]["active"][0] and frozen[0]["active"][1]
    assert not frozen[-1]["active"][1]                 # out of iterations
    assert int(frozen[-1]["iters"][1]) == 1000
    zero = run_cycle(step_frozen, "zero_column", 2, 20, torch.float64, "cpu")
    assert zero[0]["cs"][0, 0] == 1.0 and zero[0]["sn"][0, 0] == 0.0
    happy = run_cycle(step_frozen, "happy", 2, 20, torch.float64, "cpu")
    assert not happy[9]["converged"][0] and happy[10]["converged"][0]
    assert not happy[11]["active"][0]
    # the loose tolerance converges the last system on its estimate
    free = run_cycle(step_frozen, "free", 5, 20, torch.float64, "cpu")
    assert free[-1]["converged"].tolist() == [False] * 4 + [True]
    assert not free[0]["converged"][4]


def test_wrapper_takes_plain_on_cpu():
    build.reset_launch_counts()
    want = run_cycle(step_frozen, "frozen", 5, 20, torch.float32, "cpu")
    got = run_cycle(stepper(givens.givens_step), "frozen", 5, 20,
                    torch.float32, "cpu")
    assert_trails_equal(got, want)
    assert build.launch_counts() == {}


def test_hcol_is_only_read():
    """The plain step rotates a copy of the column: the wrapper leaves the
    caller's ``hcol`` as the kernel does."""
    for j in (0, 3):
        a = _args(nsys=5, m=8, dtype=torch.float64)
        a["j"] = j
        a["hcol"], a["happy"] = column("free", 5, 8, j, torch.float64, "cpu",
                                       np.random.default_rng(j))
        before = a["hcol"].clone()
        givens.givens_step(**a)
        assert_same(a["hcol"], before)
        assert a["active"].all() and (a["iters"] > 0).all()


def _args(nsys=2, m=4, dtype=torch.float32):
    state, maxiter, tol = start("free", nsys, m, dtype, "cpu", 0)
    hcol, happy = column("free", nsys, m, 1, dtype, "cpu",
                         np.random.default_rng(0))
    return dict(hcol=hcol, happy=happy, tol=tol, maxiter=maxiter, j=1,
                **state, active=torch.empty(nsys, dtype=torch.bool))


@pytest.mark.parametrize("case", ["f16", "int_iters", "short_g", "strided_cs",
                                  "step_past_cycle", "negative_step",
                                  "f64_tol"])
def test_wrapper_refuses(case):
    a = _args()
    if case == "f16":
        a = {k: v.half() if torch.is_tensor(v) and v.is_floating_point()
             else v for k, v in _args().items()}
    elif case == "int_iters":
        a["iters"] = a["iters"].long()
    elif case == "short_g":
        a["g"] = a["g"][:, :-1].contiguous()
    elif case == "strided_cs":
        a["cs"] = torch.ones((2, 8))[:, ::2]
    elif case == "step_past_cycle":
        a["j"] = 4
    elif case == "negative_step":
        a["j"] = -1
    elif case == "f64_tol":
        a["tol"] = a["tol"].double()
    with pytest.raises(ValueError):
        givens.givens_step(**a)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    torch.cuda.set_device(0)
    ms._inner_graph.cache_clear()
    yield torch.device("cuda", 0)
    ms._inner_graph.cache_clear()


@pytest.mark.card
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("m", [1, 20, 30])
@pytest.mark.parametrize("nsys", [1, 2, 5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_kernel_equals_plain(card, dtype, nsys, m, case):
    build.reset_launch_counts()
    got = run_cycle(stepper(givens.givens_step), case, nsys, m, dtype, card)
    torch.cuda.synchronize()
    assert build.launch_counts() == {"givens_step": m}
    want = run_cycle(stepper(givens.givens_step_plain), case, nsys, m, dtype,
                     card)
    assert_trails_equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_hcol_is_only_read(card, dtype):
    state, maxiter, tol = start("free", 2, 20, dtype, card, 3)
    hcol, happy = column("free", 2, 20, 19, dtype, card,
                         np.random.default_rng(3))
    before = hcol.clone()
    active = torch.empty(2, dtype=torch.bool, device=card)
    givens.givens_step(hcol, happy, tol, maxiter, 19, **state, active=active)
    torch.cuda.synchronize()
    assert_same(hcol, before)


@pytest.mark.card
def test_card_many_systems(card):
    """More systems than a block's threads: every block's systems."""
    got = run_cycle(stepper(givens.givens_step), "frozen", 300, 20,
                    torch.float32, card)
    want = run_cycle(stepper(givens.givens_step_plain), "frozen", 300, 20,
                     torch.float32, card)
    assert_trails_equal(got, want)


@pytest.mark.card
def test_card_graphed_am_one_launch_a_step(card):
    """AM 1024², staleness 2, inner GMRES maxit 20: each replay of the inner
    sweep's graph launches kernel O 20 times, one an Arnoldi step."""
    op = port.block_poisson2d(1024, 1024, nblocks=2)
    b = op.full_mv(torch.ones((2, op.block_size), dtype=torch.float32,
                              device=card))
    solve = lambda: port.am(op, b, staleness=2, rtol=1e-3,  # noqa: E731
                            maxiter=4000)
    solve()                                  # warm-up and capture
    torch.cuda.synchronize()
    build.reset_launch_counts()
    profiling.reset()
    with profiling.recording():
        r = solve()
        torch.cuda.synchronize()
    replays = profiling.totals()["multisplit.replay"][0]
    profiling.reset()
    assert r.converged and replays >= r.sweeps
    assert build.launch_counts()["givens_step"] == 20 * replays
