"""The right-hand sides: a pool deterministic in (pool_seed, member),
ordered by the run's seed."""

import numpy as np
import torch

from portbench import harness, rhs
from portbench.reference.stencil import poisson_apply

torch.set_num_threads(1)

SPEC = {"modes": 8, "kmax": 64, "amplitude": 0.1, "noise": 0.01, "pool": 8,
        "pool_seed": 1}
S3 = {"diag": 6.0, "off": -1.0}


def test_same_pool_seed_and_member_same_b():
    for pool_seed in (0, 1, 2**31 + 5, 2**40 + 3, -3):
        spec = dict(SPEC, pool_seed=pool_seed)
        a = rhs.make((12, 10, 9), spec, S3, 4, "cpu")
        assert torch.equal(a, rhs.make((12, 10, 9), spec, S3, 4, "cpu"))


def test_other_member_or_pool_seed_other_b():
    base = rhs.make((12, 10, 9), SPEC, S3, 4, "cpu")
    for other in (rhs.make((12, 10, 9), SPEC, S3, 5, "cpu"),
                  rhs.make((12, 10, 9), dict(SPEC, pool_seed=2), S3, 4, "cpu")):
        assert not torch.allclose(base, other)


def test_each_pass_solves_the_whole_pool_in_a_seeded_order():
    for seed in (0, 2**31 + 11, 2**33 + 1):
        order = [rhs.member(seed, k, 8) for k in range(40)]
        assert order == [rhs.member(seed, k, 8) for k in range(40)]
        for p in range(5):
            assert sorted(order[8 * p:8 * p + 8]) == list(range(8))
        assert order[:8] != order[8:16] or order[8:16] != order[16:24]
    assert [rhs.member(1, k, 8) for k in range(8)] != \
        [rhs.member(2, k, 8) for k in range(8)]


def test_b_is_a_times_u_with_broadband_u():
    u = rhs.solution((64, 64), SPEC, 0, "cpu")
    b = rhs.make((64, 64), SPEC, {"diag": 4.0, "off": -1.0}, 0, "cpu")
    assert b.dtype == torch.float64
    assert torch.equal(b, poisson_apply(u, 4.0, -1.0))
    assert abs(float(u.mean()) - 1.0) < 0.1
    spectrum = np.abs(np.fft.rfft2(u.numpy() - 1.0))
    assert (spectrum[1:, 1:] > 1e-3).mean() > 0.9     # every frequency present


def test_modes_follow_the_drawn_wavenumbers():
    spec = dict(SPEC, noise=0.0, modes=1)
    u = rhs.solution((31, 17), spec, 2, "cpu")
    _, waves, amps = rhs._draws(1, 2, 2, spec)
    i = np.arange(1, 32)[:, None]
    j = np.arange(1, 18)[None, :]
    want = 1 + amps[0] * np.sin(np.pi * waves[0, 0] * i / 32) \
        * np.sin(np.pi * waves[0, 1] * j / 18)
    np.testing.assert_allclose(u.numpy(), want, rtol=0, atol=1e-14)


def test_sample_draws_from_the_seed_and_always_holds_the_first():
    a = harness.sample(2**31 + 9, 100, 3)
    assert a == harness.sample(2**31 + 9, 100, 3)
    assert len(a) == 3 and a[0] == 0 and max(a) < 100
    assert harness.sample(5, 2, 6) == [0, 1]
    assert {tuple(harness.sample(s, 100, 3)) for s in range(20)} != {tuple(a)}
