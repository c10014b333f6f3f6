"""Collective-traffic accounting on the port's mesh (the port's stand-in
for the JAX package's ``utils/hlostats.py``, which parses compiled XLA
HLO: PyTorch has no such program text).

``Mesh.count_collectives()`` (``parallel/mesh.py``) tallies each
collective as it is called, under JAX's HLO op names: ``psum``, ``pmax``
and ``pmean`` as ``all-reduce``, ``ppermute`` as ``collective-permute``,
``all_gather`` as ``all-gather``; ``bytes`` is one shard's result per
call, as the per-device shapes of an SPMD module give it.  One semantic
difference: JAX counts each collective once per compiled program (a loop
body appears once in the HLO), the tally counts calls as they run.  So a
structural comparison across meshes (``utils/scaling.run_structural``)
runs a fixed amount of work at every mesh size.
"""

from __future__ import annotations

from typing import Dict


def total_collective_bytes(stats: Dict[str, Dict[str, int]]) -> int:
    return sum(v["bytes"] for v in stats.values())


def total_collective_count(stats: Dict[str, Dict[str, int]]) -> int:
    return sum(v["count"] for v in stats.values())
