"""Kernel H's split of the CSR product (``ops/csr.py``, ``csrc/csr_mv.cu``).

The kernel gives each thread block a chunk of ``CHUNK`` nonzeros and the
rows that start in it; a row that runs on into later chunks leaves one
carry in each, and a second launch adds a row's carries in block order to
the value its owner wrote.  ``split_mv`` below is a plain emulation of
that: it takes the host pieces of ``ops/csr.py`` (``csr_blocks``,
``csr_partition``, ``csr_carry_size``) as the kernel does, sums each
chunk's share and adds the carries in the kernel's order.  It is held to
``csr_mv_plain`` in f64 (1e-12 relative to the largest entry) on the
patterns that stress the split, for 1, 4 and 5 vectors, and to the JAX
package's ``aij_mv_pallas`` (in interpret mode, as ``tests/test_aij.py``
runs it) in f32 on one pattern that carries all of them, at JAX's AIJ
tolerance (1e-4).  Every row must be written by exactly one owner.  The
CUDA kernel itself runs only on a card, where ``chip_smoke.py`` holds it
against the plain version on the same kinds of pattern.  The patterns are
cut at the kernel's ``CHUNK`` and, to cross many more chunk edges at a
small size (and to stay inside what the JAX pack takes), at a chunk of 64
set in ``ops/csr.py`` for the test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as jops
from medane_tchakorom_ufc_thesis_repository_tpu.ops import aij_pallas
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import operators as tops
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import csr as tcsr

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)

SMALL = 64


def split_mv(indptr, indices, data, x, nrows):
    """The kernel's arithmetic, chunk by chunk: ``x`` is ``(k, ncols)``;
    returns ``y`` ``(k, nrows)`` and how often each row was written by an
    owner."""
    C, nnz = tcsr.CHUNK, len(data)
    part = tcsr.csr_partition(torch.from_numpy(indptr), nnz).numpy()
    nblocks = tcsr.csr_blocks(nnz)
    assert len(part) == nblocks + 1 and part[-1] == nrows
    assert tcsr.csr_carry_size(nnz) == nblocks * tcsr.BATCH
    k = x.shape[0]
    prod = data * x[:, indices]
    y = np.full((k, nrows), np.nan, dtype=x.dtype)
    owned = np.zeros(nrows, np.int64)
    carry = np.zeros((nblocks, k), dtype=x.dtype)
    carry_row = np.full(nblocks, -1)
    for c in range(nblocks):
        nz0, nz1 = c * C, min((c + 1) * C, nnz)
        r0, r1 = int(part[c]), int(part[c + 1])
        # segment 0 is the head, segment s the in-chunk part of row r0+s-1
        ends = [nz0] + [min(int(indptr[r]), nz1) for r in range(r0, r1 + 1)]
        for s in range(r1 - r0 + 1):
            total = np.zeros(k, dtype=x.dtype)
            for p in range(ends[s], ends[s + 1]):
                total += prod[:, p]
            if s == 0:
                carry[c] = total
                carry_row[c] = r0 - 1 if ends[1] > nz0 else -1
            else:
                y[:, r0 + s - 1] = total
                owned[r0 + s - 1] += 1
    for c in range(nblocks):
        row = carry_row[c]
        if row < 0 or (c > 0 and carry_row[c - 1] == row):
            continue
        total = carry[c].copy()
        q = c + 1
        while q < nblocks and carry_row[q] == row:
            total += carry[q]
            q += 1
        y[:, row] += total
    return y, owned


def _csr(lengths, ncols, seed):
    """CSR arrays with the given row lengths, distinct sorted columns."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    indices = np.concatenate(
        [np.sort(rng.choice(ncols, size=n, replace=False)) for n in lengths]
        + [np.zeros(0, np.int64)]).astype(np.int32)
    return indptr, indices, rng.standard_normal(len(indices))


def _pattern(name, C):
    """(row lengths, ncols) of the patterns that stress the split, for a
    chunk of C nonzeros."""
    rng = np.random.default_rng(1)
    short = list(rng.integers(0, 40, 300))
    if name == "empty_runs":        # empty leading and trailing runs, and
        return [0] * 17 + short + [0] * 23, 500     # empty rows between
    if name == "three_chunk_row":   # a row over 3+ chunks among short ones
        return short[:100] + [3 * C + 7] + short[100:], 3 * C + 1000
    if name == "ends_on_boundary":  # every 4th row ends on a chunk edge,
        return [C // 4] * 12 + [C] * 2 + [0, 5], C + 900   # whole chunks
    if name == "rectangular":
        return short + [0] * 50, 90
    if name == "below_one_chunk":
        return [3, 0, 7, 1, 0, 2], 11
    if name == "one_nonempty_row":
        return [0] * 900 + [C + 300] + [0] * 700, C + 400
    if name == "no_entries":
        return [0] * 5, 4
    raise ValueError(name)


PATTERNS = ["empty_runs", "three_chunk_row", "ends_on_boundary",
            "rectangular", "below_one_chunk", "one_nonempty_row",
            "no_entries"]


@pytest.fixture(params=["kernel", "small"])
def chunk(request, monkeypatch):
    """The kernel's CHUNK, or SMALL set in ``ops/csr.py``."""
    if request.param == "small":
        monkeypatch.setattr(tcsr, "CHUNK", SMALL)
    return tcsr.CHUNK


class TestSplit:
    @pytest.mark.parametrize("k", [1, 4, 5])
    @pytest.mark.parametrize("name", PATTERNS)
    def test_split_matches_plain_f64(self, name, k, chunk):
        lengths, ncols = _pattern(name, chunk)
        indptr, indices, data = _csr(lengths, ncols, 2)
        nrows = len(lengths)
        x = np.random.default_rng(3).standard_normal((k, ncols))
        got, owned = split_mv(indptr, indices, data, x, nrows)
        assert (owned == 1).all()
        want = tcsr.csr_mv_plain(
            torch.from_numpy(indptr), torch.from_numpy(indices),
            torch.from_numpy(data), torch.from_numpy(x), nrows, ncols).numpy()
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(got - want).max() <= 1e-12 * scale

    def test_the_pattern_features_are_there(self, chunk):
        """Each pattern has what its name says, in chunks."""
        C = chunk

        def blocks(name):
            lengths, _ = _pattern(name, C)
            indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
            part = tcsr.csr_partition(torch.from_numpy(indptr),
                                      int(indptr[-1])).numpy()
            return indptr, part
        indptr, part = blocks("three_chunk_row")
        starts = np.arange(0, int(indptr[-1]), C)
        inside = (starts > indptr[100]) & (starts < indptr[101])
        assert inside.sum() >= 3 and (np.diff(part) == 0).sum() >= 2
        indptr, part = blocks("ends_on_boundary")
        assert set(range(0, int(indptr[-1]), C)) <= set(indptr.tolist())
        indptr, part = blocks("below_one_chunk")
        assert part.tolist() == [0, 6]
        indptr, part = blocks("no_entries")
        assert part.tolist() == [0, 5]

    def test_split_matches_pallas_f32(self, monkeypatch):
        """One rectangular f32 pattern with empty leading and trailing
        runs, a row over three chunks and rows ending on chunk edges:
        the emulation against JAX's AIJ product in interpret mode (whose
        pack takes no row of thousands of entries: SMALL chunks)."""
        monkeypatch.setattr(tcsr, "CHUNK", SMALL)
        C = SMALL
        lengths = ([0] * 9 + [C // 4] * 8 + [3 * C + 11] + [5, 0, 17] * 40
                   + [0] * 13)
        nrows, ncols = len(lengths), 900
        indptr, indices, data = _csr(lengths, ncols, 4)
        rows = np.repeat(np.arange(nrows), np.diff(indptr))
        jop = jops.AIJ.from_coo(rows, indices, data, (nrows, ncols),
                                with_rmv=False)
        x = np.random.default_rng(5).standard_normal(ncols).astype(np.float32)
        want = np.asarray(aij_pallas.aij_mv_pallas(
            jop.segments, jop.n_pad_cols, jop.nrows, jnp.asarray(x),
            interpret=True))
        got, owned = split_mv(indptr, indices, data.astype(np.float32),
                              x[None], nrows)
        assert (owned == 1).all()
        np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-4)


class TestAijKeepsItsPartitions:
    def test_built_with_the_matrix_and_moved(self):
        lengths, ncols = _pattern("three_chunk_row", tcsr.CHUNK)
        indptr, indices, data = _csr(lengths, ncols, 6)
        rows = np.repeat(np.arange(len(lengths)), np.diff(indptr))
        op = tops.AIJ.from_coo(rows, indices, data, (len(lengths), ncols),
                               dtype=torch.float64, device="cpu")
        assert op.t_data is not op.data
        for ptr, part in ((op.indptr, op.partition),
                          (op.t_indptr, op.t_partition)):
            assert torch.equal(part, tcsr.csr_partition(ptr, op.nnz))
        moved = op.to("cpu")
        assert torch.equal(moved.partition, op.partition)
        assert torch.equal(moved.t_partition, op.t_partition)
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(ncols))
        np.testing.assert_array_equal(moved.mv(x).numpy(), op.mv(x).numpy())

    def test_symmetric_shares_one_partition(self):
        rng = np.random.default_rng(8)
        r, c = rng.integers(0, 400, 3000), rng.integers(0, 400, 3000)
        v = rng.standard_normal(3000)
        op = tops.AIJ.from_coo(np.concatenate([r, c]), np.concatenate([c, r]),
                               np.concatenate([v, v]), (400, 400),
                               dtype=torch.float64, device="cpu")
        assert op.t_partition is op.partition
        assert torch.equal(op.partition,
                           tcsr.csr_partition(op.indptr, op.nnz))
        moved = op.to("cpu")
        assert moved.t_partition is moved.partition
        one_way = tops.AIJ.from_coo(r, c, v, (400, 400), with_rmv=False,
                                    device="cpu")
        assert one_way.t_partition is None and one_way.partition is not None
