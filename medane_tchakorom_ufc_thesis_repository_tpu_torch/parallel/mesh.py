"""Device meshes and their collectives (port of the JAX package's
``parallel/mesh.py``).

The reference derives its topology from ``nprocs`` and ``npb``: two Jacobi
blocks of ``npb`` ranks each (``computeDimensionRelatedVariables``,
reference ``src/utils/utils.c:652-666``).  JAX lays the same two levels
out as a ``Mesh`` with axes ``('block', 'intra')`` and runs one SPMD body
per device under ``shard_map``, with ``psum``, ``ppermute``,
``all_gather`` and ``axis_index`` over named axes.  Here the SPMD bodies
are written once against the same four collectives, methods of ``Mesh``,
and the mesh has two transports; the caller names one:

* ``'local'``: every shard of the mesh lives in this process on one
  device.  A sharded tensor carries the mesh as its leading axes,
  ``(nblocks, intra, ...)`` (``(nblocks, ir, ic, ...)`` for the tiled
  mesh), so a kernel that batches over a leading axis serves every shard
  in one launch.  ``psum`` sums over those axes and broadcasts back,
  ``ppermute`` shifts along one, zeros where no pair sends.
* ``'dist'``: ``torch.distributed``, one process per contiguous
  sub-mesh, taken in block-major order (JAX's host-major
  ``make_multihost_mesh``).  Each process keeps its own shards as the
  leading axes; a collective over an axis is the local operation over
  the local extent, then a process-group call over the processes along
  that axis (one ``new_group`` per axis line): ``all_reduce`` for
  ``psum``/``pmax``, ``all_gather`` for ``all_gather``, ``isend``/``irecv``
  for ``ppermute``.  The caller names the backend: ``'nccl'`` when every
  rank has a card of its own, ``'gloo'`` on the CPU or when ranks share a
  card.  Gloo moves CUDA tensors in ``all_reduce`` only; its
  point-to-point and all-gather calls take host tensors, so under gloo
  those two collectives, and nothing else, stage a CUDA tensor through a
  pinned host buffer (``_staged``).  The compute stays on the card.

Every reduction over several axes reduces the innermost named axis
first and the outermost last, one axis at a time (JAX's two-level
``psum``: over 'intra', then over 'block'), in both transports; so a
mesh whose cross-process axis holds two processes sums in the same order
under both, to the bit.

Collectives must stay in lockstep: every process runs the same sequence
of them (inner solves take fixed cycle counts and termination flags are
global reductions), or the group hangs.

``Mesh.count_collectives()`` tallies the collectives called on a mesh,
under JAX's HLO op names (``psum``/``pmax``/``pmean`` as ``all-reduce``,
``ppermute`` as ``collective-permute``, ``all_gather`` as
``all-gather``): calls, and bytes of one shard's result, as the compiled
SPMD program's per-device shapes count them (``utils/collstats.py``).  It
reads shapes only, and with no tally open costs one attribute test a
call.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve

TRANSPORTS = ("local", "dist")
# the collective kinds of a tally: the JAX package's HLO op names
# (utils/hlostats.py), so that records keep its keys
COLLECTIVES = ("collective-permute", "all-reduce", "all-gather",
               "reduce-scatter", "all-to-all")


def _as_axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _local_extents(shape: Tuple[int, ...], nproc: int) -> Tuple[int, ...]:
    """Each process's extent along each axis when ``nproc`` processes
    take contiguous sub-meshes in row-major (block-major) order: the
    processes split the leading axes first."""
    local = list(shape)
    left = nproc
    for i, n in enumerate(shape):
        g = math.gcd(n, left)
        local[i] = n // g
        left //= g
    if left != 1:
        raise ValueError(f"{nproc} processes do not tile the mesh {shape}")
    return tuple(local)


class Mesh:
    """A named-axis device mesh with a transport.  ``shape`` maps each
    axis to its global extent, ``local_shape`` gives this process's
    extents (the leading axes of every sharded tensor), and ``device`` is
    where this process's shards live."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], *,
                 transport: str = "local", device=None):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                             f"{transport!r}")
        self.axis_names = tuple(axis_names)
        self.global_shape = tuple(int(n) for n in shape)
        if len(self.axis_names) != len(self.global_shape):
            raise ValueError("one extent per axis name")
        if min(self.global_shape) < 1:
            raise ValueError(f"mesh extents must be positive, got {shape}")
        self.transport = transport
        self.device = resolve(device)
        if transport == "local":
            self.rank, self.nproc = 0, 1
        else:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise RuntimeError(
                    "the 'dist' transport needs torch.distributed "
                    "initialised first (init_multihost)")
            self.rank, self.nproc = dist.get_rank(), dist.get_world_size()
            self.backend = dist.get_backend()
        self.local_shape = _local_extents(self.global_shape, self.nproc)
        self.proc_shape = tuple(g // loc for g, loc in
                                zip(self.global_shape, self.local_shape))
        self.proc_coords = self._coords(self.rank)
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._tally: Optional[Dict[str, Dict[str, int]]] = None

    # -- layout ------------------------------------------------------------
    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.global_shape))

    @property
    def size(self) -> int:
        return math.prod(self.global_shape)

    @property
    def nlocal(self) -> int:
        """Shards held by this process."""
        return math.prod(self.local_shape)

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    def _dim(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"no mesh axis {axis!r} in {self.axis_names}")
        return self.axis_names.index(axis)

    def _coords(self, rank: int) -> Tuple[int, ...]:
        out = []
        for n in reversed(self.proc_shape):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def _rank_of(self, coords) -> int:
        r = 0
        for c, n in zip(coords, self.proc_shape):
            r = r * n + c
        return r

    def _remote(self, axes: Tuple[str, ...]) -> bool:
        return any(self.proc_shape[self._dim(a)] > 1 for a in axes)

    def _group(self, axes: Tuple[str, ...]):
        """The process group of this process's line along ``axes`` (the
        processes that differ only in those axes' coordinates).  Every
        line's group is created, in one order, by every process."""
        key = tuple(sorted(axes, key=self._dim))
        if key not in self._groups:
            import torch.distributed as dist

            dims = [self._dim(a) for a in key]
            others = [d for d in range(self.ndim) if d not in dims]
            mine = None
            for oc in itertools.product(*[range(self.proc_shape[d])
                                          for d in others]):
                ranks = []
                for ac in itertools.product(*[range(self.proc_shape[d])
                                              for d in dims]):
                    c = [0] * self.ndim
                    for d, v in zip(others, oc):
                        c[d] = v
                    for d, v in zip(dims, ac):
                        c[d] = v
                    ranks.append(self._rank_of(c))
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = (g, ranks)
            self._groups[key] = mine
        return self._groups[key]

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether a point-to-point or all-gather call moves ``t`` through a
        pinned host buffer: gloo takes host tensors in those calls."""
        return self.backend == "gloo" and t.is_cuda

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    # -- collective tally -----------------------------------------------------
    @contextlib.contextmanager
    def count_collectives(self):
        """Tally the collectives called on this mesh inside the block:
        yields ``{kind: {"count", "bytes"}}`` over ``COLLECTIVES``, filled
        as they run.  ``bytes`` is one shard's result (the data dims of a
        shard stack; an all-gather's whole gathered result), per call.  A
        ``ppermute`` whose pairs move nothing between shards is not
        counted, as XLA folds it away.  Tallies nest; the inner one
        takes the calls."""
        stats = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        outer, self._tally = self._tally, stats
        try:
            yield stats
        finally:
            self._tally = outer

    def _count(self, kind: str, x: torch.Tensor, shards: int = 1) -> None:
        if self._tally is not None:
            entry = self._tally[kind]
            entry["count"] += 1
            entry["bytes"] += (shards * math.prod(x.shape[self.ndim:])
                               * x.element_size())

    # -- collectives ---------------------------------------------------------
    def _reduce(self, x: torch.Tensor, axes, op: str) -> torch.Tensor:
        self._count("all-reduce", x)
        axes = _as_axes(axes)
        for a in sorted(axes, key=self._dim, reverse=True):
            d = self._dim(a)
            x = (x.sum(dim=d, keepdim=True) if op == "sum"
                 else x.amax(dim=d, keepdim=True))
            if self.transport == "dist" and self.proc_shape[d] > 1:
                import torch.distributed as dist

                x = x.contiguous()
                dist.all_reduce(x, op=(dist.ReduceOp.SUM if op == "sum"
                                       else dist.ReduceOp.MAX),
                                group=self._group((a,))[0])
        return x.expand(self.local_shape + tuple(x.shape[self.ndim:]))

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum of ``x`` over the mesh axes ``axes``, on every shard
        (``lax.psum``); innermost axis first."""
        return self._reduce(x, axes, "sum")

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Maximum of ``x`` over the mesh axes ``axes`` (``lax.pmax``)."""
        return self._reduce(x, axes, "max")

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = _as_axes(axes)
        n = math.prod(self.shape[a] for a in axes)
        return self.psum(x, axes) / n

    def ppermute(self, x: torch.Tensor, axis: str,
                 pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute`` along ``axis``: the shard at index ``dst``
        receives what the shard at ``src`` holds, for each ``(src, dst)``;
        a shard that no pair sends to receives zeros."""
        if any(src != dst for src, dst in pairs):
            self._count("collective-permute", x)
        d = self._dim(axis)
        nloc = self.local_shape[d]
        base = self.proc_coords[d] * nloc
        out = torch.zeros_like(x)
        sends, recvs = [], []
        for src, dst in pairs:
            s_here = base <= src < base + nloc
            d_here = base <= dst < base + nloc
            if s_here and d_here:
                out.select(d, dst - base).copy_(x.select(d, src - base))
            elif s_here:
                sends.append((src - base, dst // nloc))
            elif d_here:
                recvs.append((dst - base, src // nloc))
        if not (sends or recvs):
            return out
        import torch.distributed as dist

        def peer(pc):
            c = list(self.proc_coords)
            c[d] = pc
            return self._rank_of(c)

        ops, landing = [], []
        for li, pc in sends:
            t = x.select(d, li).contiguous()
            if self._staged(t):
                t = self._to_host(t)
            ops.append(dist.P2POp(dist.isend, t, peer(pc)))
        for li, pc in recvs:
            t = torch.empty_like(x.select(d, li)).contiguous()
            buf = self._to_host(t) if self._staged(t) else t
            ops.append(dist.P2POp(dist.irecv, buf, peer(pc)))
            landing.append((li, buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for li, buf in landing:
            out.select(d, li).copy_(buf)
        return out

    def _full_axes(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """``x`` with the mesh dims of ``axes`` widened from this process's
        extents to the global ones (the shards of every process along
        those axes, in mesh order); other mesh dims stay local."""
        if self.transport == "local" or not self._remote(axes):
            return x
        import torch.distributed as dist

        group, ranks = self._group(axes)
        src = x.contiguous()
        if self._staged(src):
            src = self._to_host(src)
        parts = [torch.empty_like(src) for _ in ranks]
        dist.all_gather(parts, src, group=group)
        parts = [p.to(x.device) for p in parts]
        dims = [self._dim(a) for a in sorted(axes, key=self._dim)]
        # place each process's block at its process coordinates
        full_shape = list(x.shape)
        for d in dims:
            full_shape[d] = self.global_shape[d]
        out = x.new_empty(full_shape)
        for r, p in zip(ranks, parts):
            c = self._coords(r)
            idx = [slice(None)] * x.dim()
            for d in dims:
                n = self.local_shape[d]
                idx[d] = slice(c[d] * n, (c[d] + 1) * n)
            out[tuple(idx)] = p
        return out

    def all_gather(self, x: torch.Tensor, axes, axis: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """``lax.all_gather`` over the mesh axes ``axes`` (mesh-axis-major
        order): every shard gets the stack of the shards' ``x`` (data axis
        ``axis`` of a shard's own tensor) as a new axis at ``axis``, or
        concatenated along it when ``tiled``."""
        axes = tuple(sorted(_as_axes(axes), key=self._dim))
        gd = [self._dim(a) for a in axes]
        self._count("all-gather", x,
                    math.prod(self.global_shape[d] for d in gd))
        full = self._full_axes(x, axes)
        k = self.ndim
        keep = [d for d in range(k) if d not in gd]
        y = full.permute(keep + gd + list(range(k, full.dim())))
        g = math.prod(self.global_shape[d] for d in gd)
        nk = len(keep)
        y = y.reshape([full.shape[d] for d in keep] + [g]
                      + list(full.shape[k:]))
        y = y.movedim(nk, nk + axis)
        if tiled:
            shp = list(y.shape)
            y = y.reshape(shp[:nk + axis] + [shp[nk + axis] * shp[nk + axis + 1]]
                          + shp[nk + axis + 2:])
        for d in gd:
            y = y.unsqueeze(d)
        return y.expand(self.local_shape + tuple(y.shape[k:]))

    def axis_index(self, axis: str) -> torch.Tensor:
        """Each shard's global index along ``axis`` (int64, broadcast over
        the local mesh dims; ``lax.axis_index``)."""
        d = self._dim(axis)
        n = self.local_shape[d]
        idx = torch.arange(n, device=self.device) + self.proc_coords[d] * n
        shape = [1] * self.ndim
        shape[d] = n
        return idx.reshape(shape).expand(self.local_shape)

    def shard_index(self) -> torch.Tensor:
        """Each shard's global row-major index over the whole mesh."""
        idx = torch.zeros(self.local_shape, dtype=torch.int64,
                          device=self.device)
        for a, n in zip(self.axis_names, self.global_shape):
            idx = idx * n + self.axis_index(a)
        return idx

    def reducer(self, axes):
        """``f(p) -> psum(p, axes)`` for partials ``p`` whose leading axis
        runs over the local shards in row-major order (a flattened
        sharded tensor): the form the solvers' ``axis_name`` hooks take."""
        axes = _as_axes(axes)

        def f(p: torch.Tensor) -> torch.Tensor:
            s = self.psum(p.reshape(self.local_shape + tuple(p.shape[1:])),
                          axes)
            return s.contiguous().reshape(p.shape)

        return f

    # -- layout conversions ------------------------------------------------
    def shard(self, g: torch.Tensor, spec) -> torch.Tensor:
        """Global tensor -> this process's shard stack.  ``spec`` names,
        per leading axis of ``g``, the mesh axes that split it (a name, a
        tuple of names, or None), as a ``PartitionSpec``; mesh axes named
        nowhere replicate.  Returns ``(*local_shape, *tile)``."""
        g = g.to(self.device)
        k = self.ndim
        spec = tuple(spec) + (None,) * (g.dim() - len(spec))
        split_shape, order = [], []
        pos = 0
        for n, names in zip(g.shape, spec):
            names = () if names is None else _as_axes(names)
            parts = [self.shape[a] for a in names]
            f = math.prod(parts)
            if n % f:
                raise ValueError(f"extent {n} not divisible by {f} shards")
            split_shape += parts + [n // f]
            for a in names:
                order.append((self._dim(a), pos))
                pos += 1
            pos += 1
        y = g.reshape(split_shape)
        mesh_pos = {d: p for d, p in order}
        data_pos = [p for p in range(len(split_shape))
                    if p not in mesh_pos.values()]
        # mesh dims in mesh order; unnamed mesh axes broadcast
        perm = [mesh_pos[d] for d in range(k) if d in mesh_pos] + data_pos
        y = y.permute(perm)
        for d in range(k):
            if d not in mesh_pos:
                y = y.unsqueeze(d)
        idx = []
        for d in range(k):
            if d in mesh_pos:
                n = self.local_shape[d]
                c = self.proc_coords[d]
                idx.append(slice(c * n, (c + 1) * n))
            else:
                idx.append(slice(None))
        y = y[tuple(idx)]
        return y.expand(self.local_shape + tuple(y.shape[k:])).contiguous()

    def unshard(self, xs: torch.Tensor, spec, shape) -> torch.Tensor:
        """Shard stack -> the global tensor of shape ``shape``, on every
        process (the inverse of ``shard``)."""
        k = self.ndim
        named = [a for names in spec if names is not None
                 for a in _as_axes(names)]
        full = self._full_axes(xs, tuple(named))
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        # drop replicated mesh dims
        idx = tuple(slice(None) if a in named else 0 for a in self.axis_names)
        full = full[idx]
        kept = [a for a in self.axis_names if a in named]
        # tile dims interleaved after their mesh factors
        perm, pos = [], len(kept)
        for names in spec:
            names = () if names is None else _as_axes(names)
            perm += [kept.index(a) for a in names] + [pos]
            pos += 1
        return full.permute(perm).reshape(tuple(shape))

    def local(self, shards: torch.Tensor) -> torch.Tensor:
        """The first local shard of a replicated sharded tensor (the copy a
        process computes on when every shard holds the same value)."""
        return shards[(0,) * self.ndim]


def make_mesh(nblocks: int = 2, intra: Optional[int] = None, *,
              transport: str = "local", device=None) -> Mesh:
    """A ``('block', 'intra')`` mesh.  ``'local'``: ``intra`` shards a
    block (default 1), all in this process on ``device`` (None: the
    current CUDA device).  ``'dist'``: ``intra`` defaults to the world
    size over ``nblocks`` (one shard a process), the analog of
    ``npb = nprocs / njacobi_blocks``."""
    if intra is None:
        if transport == "dist":
            import torch.distributed as dist

            world = dist.get_world_size()
            if world % nblocks:
                raise ValueError(f"{world} processes not divisible by "
                                 f"nblocks={nblocks}")
            intra = world // nblocks
        else:
            intra = 1
    return Mesh(("block", "intra"), (nblocks, intra), transport=transport,
                device=device)


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, *, backend: str) -> None:
    """``torch.distributed.init_process_group`` over TCP (the analog of the
    reference's ``mpiexec`` fan-out, ``iSolve:347-401``): the caller gives
    the coordinator's ``host:port``, the world size, this rank and the
    backend ('nccl' with a card a rank, 'gloo' on the CPU or on a shared
    card)."""
    import torch.distributed as dist

    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_multihost_mesh(nblocks: int = 2, intra: Optional[int] = None, *,
                        device=None) -> Mesh:
    """The ``'dist'`` mesh over every process: blocks across processes
    first, as JAX's host-major device order places them."""
    return make_mesh(nblocks, intra, transport="dist", device=device)
