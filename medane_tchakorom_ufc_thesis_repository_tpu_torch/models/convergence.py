"""Decentralized convergence detection — "Algorithm 5.15" protocol.

(The PyTorch port's copy of the JAX package's ``models/convergence.py``:
plain Python, the same classes, the same messages in the same order.)

Host-side rebuild of the reference's L4 layer
(``src/utils/conv_detection_prime.c``, SURVEY.md §2.3): the *practical
version of convergence detection* for totally-asynchronous iterations
(Bahi, Contassot-Vivier, Couturier — "Parallel Iterative Algorithms: from
Sequential to Grid Computing", the book the reference cites at
``conv_detection_prime.c:5-9``).  Re-derived from the protocol's
published description; no reference code was copied.

Protocol summary (per node = block root):

* **pseudo-period** — a window in which fresh data from *every*
  dependency has arrived.  ``local_cv`` requires the residual to stay
  under threshold across one full pseudo-period (stale-data guard).
* **partial CV** — on ``local_cv``, broadcast PartialCV(iteration) to
  neighbors; if the residual rebounds, send CancelCV retracting it
  (neighbors match on iteration numbers to drop stale claims).
* **verification phase** — when a node holds ``local_cv`` and has
  unretracted PartialCVs from all neighbors, the *leader* (max rank, as
  in the reference's ``choose_leader``) increments ``phase_tag`` and
  sends Verification to everyone; each replies positive/negative
  depending on whether its ``local_cv`` still holds for that phase.
* **verdict** — all-positive responses: leader broadcasts
  Verdict(POSITIVE), every node moves to FINISHED; any negative:
  Verdict(NEGATIVE) resets the protocol (``initialize_state``).
* **staleness filtering** — every message carries ``phase_tag`` and the
  sender's iteration; receivers drop anything older than what they have
  (the reference's ``receive_data_dependency`` guard).

The transport is abstract (``send(dst, msg)``); ``LocalTransport`` wires
nodes through in-process queues for the threaded host-async driver and
for deterministic protocol tests with injected delay/reorder.
"""

from __future__ import annotations

import dataclasses
import enum
import queue
from typing import Dict, List, Optional


class State(enum.Enum):
    NORMAL = "normal"
    WAIT4VERIFICATION = "wait4verification"  # sent responses, awaiting verdict
    VERIFICATION = "verification"            # leader collecting responses
    FINISHED = "finished"


class MsgKind(enum.Enum):
    PARTIAL_CV = "partial_cv"
    CANCEL_CV = "cancel_cv"
    VERIFICATION = "verification"
    RESPONSE = "response"
    VERDICT = "verdict"
    # post-verdict lockstep certification tail (models.net_async): acks
    # a certification-round DATA frame so latest-wins mailboxes can never
    # skip a round.  Not part of Alg-5.15; `_handle` ignores it.
    TAIL_ACK = "tail_ack"
    # SLCV legacy protocol (``SlcvNode``) — appended so existing wire
    # indices (TcpTransport maps kinds by enum position) stay stable
    S_PARTIAL_CV = "s_partial_cv"    # TAG_SEND_CV=123 analog
    S_CANCEL_CV = "s_cancel_cv"      # TAG_CANCEL_CV=1024 analog
    GLOBAL_CV = "global_cv"          # TAG_SEND_RCV_GLOBAL_CV=888 analog


@dataclasses.dataclass(frozen=True)
class Msg:
    kind: MsgKind
    src: int
    phase_tag: int
    iteration: int
    positive: bool = True


class Transport:
    """Abstract message transport between protocol nodes."""

    def send(self, dst: int, msg: Msg) -> None:
        raise NotImplementedError

    def drain(self, rank: int) -> List[Msg]:
        raise NotImplementedError


class LocalTransport(Transport):
    """In-process queues; thread-safe; optional reorder hook for tests."""

    def __init__(self, nranks: int):
        self.queues = [queue.SimpleQueue() for _ in range(nranks)]

    def send(self, dst: int, msg: Msg) -> None:
        self.queues[dst].put(msg)

    def drain(self, rank: int) -> List[Msg]:
        out = []
        q = self.queues[rank]
        while True:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                return out


class Alg515Node:
    """One protocol participant (a block root).

    Drive it from the solver loop:

    >>> node = Alg515Node(rank, neighbors, transport, persistence=4)
    >>> node.step(under_threshold=..., fresh_from=[...])  # each iteration
    >>> node.state is State.FINISHED  # global convergence detected
    """

    def __init__(
        self,
        rank: int,
        neighbors: List[int],
        transport: Transport,
        persistence: int = 1,
    ):
        self.rank = rank
        self.neighbors = list(neighbors)
        self.transport = transport
        self.persistence = max(1, persistence)
        self.leader = max([rank] + self.neighbors)
        self.iteration = 0
        self._init_state()

    # -- state management (the reference's initialize_state) ------------
    def _init_state(self) -> None:
        self.state = State.NORMAL
        # phase_tag survives resets (monotone) so stale verification
        # rounds can never be confused with the current one
        if not hasattr(self, "phase_tag"):
            self.phase_tag = 0
        self.local_cv = False
        self.under_count = 0
        self.fresh = {n: False for n in self.neighbors}  # pseudo-period bookkeeping
        self.partial_cv: Dict[int, Optional[int]] = {n: None for n in self.neighbors}
        self.sent_partial: Optional[int] = None
        self.responses: Dict[int, Optional[bool]] = {}

    def _reset_after_negative(self) -> None:
        # verdict NEGATIVE: full restart of the detection state, keep iterating
        self._init_state()

    # -- pseudo-period ---------------------------------------------------
    def _pseudo_period_complete(self) -> bool:
        return all(self.fresh.values()) if self.fresh else True

    def _reset_pseudo_period(self) -> None:
        for k in self.fresh:
            self.fresh[k] = False

    # -- main per-iteration hook ----------------------------------------
    def step(self, under_threshold: bool, fresh_from: List[int]) -> State:
        """Advance one solver iteration.

        ``under_threshold``: this block's residual test this iteration.
        ``fresh_from``: neighbor ranks whose data arrived since last step.
        """
        if self.state is State.FINISHED:
            return self.state
        self.iteration += 1
        for n in fresh_from:
            if n in self.fresh:
                self.fresh[n] = True

        # local CV: under threshold persistently across a full pseudo-period
        if under_threshold:
            self.under_count += 1
            if (
                not self.local_cv
                and self.under_count >= self.persistence
                and self._pseudo_period_complete()
            ):
                self.local_cv = True
                self.sent_partial = self.iteration
                self._broadcast(MsgKind.PARTIAL_CV)
                self._reset_pseudo_period()
        else:
            self.under_count = 0
            if self.local_cv:
                # residual rebound: retract our claim
                self.local_cv = False
                self._broadcast(MsgKind.CANCEL_CV)
                self.sent_partial = None
            self._reset_pseudo_period()

        self._process_messages()
        self._maybe_start_verification()
        return self.state

    # -- messaging -------------------------------------------------------
    def _broadcast(self, kind: MsgKind, positive: bool = True) -> None:
        for n in self.neighbors:
            self.transport.send(
                n,
                Msg(kind=kind, src=self.rank, phase_tag=self.phase_tag,
                    iteration=self.iteration, positive=positive),
            )

    def _process_messages(self) -> None:
        for msg in self.transport.drain(self.rank):
            self._handle(msg)

    def _handle(self, msg: Msg) -> None:
        if self.state is State.FINISHED:
            return
        if msg.kind is MsgKind.PARTIAL_CV:
            prev = self.partial_cv.get(msg.src)
            if prev is None or msg.iteration >= prev:
                self.partial_cv[msg.src] = msg.iteration
        elif msg.kind is MsgKind.CANCEL_CV:
            prev = self.partial_cv.get(msg.src)
            # cancellation retracts only same-or-older claims (stale-msg guard)
            if prev is not None and msg.iteration >= prev:
                self.partial_cv[msg.src] = None
        elif msg.kind is MsgKind.VERIFICATION:
            if msg.phase_tag <= self.phase_tag:
                return  # stale verification round (phase tags are monotone
                        # across resets, so a delayed message from an
                        # aborted round can never regress our tag)
            self.phase_tag = msg.phase_tag
            self.state = State.WAIT4VERIFICATION
            self.transport.send(
                msg.src,
                Msg(kind=MsgKind.RESPONSE, src=self.rank,
                    phase_tag=msg.phase_tag, iteration=self.iteration,
                    positive=self.local_cv),
            )
        elif msg.kind is MsgKind.RESPONSE:
            if self.state is State.VERIFICATION and msg.phase_tag == self.phase_tag:
                self.responses[msg.src] = msg.positive
                self._maybe_conclude()
        elif msg.kind is MsgKind.VERDICT:
            if msg.positive:
                self.state = State.FINISHED
            else:
                self._reset_after_negative()

    # -- verification round (leader) ------------------------------------
    def _maybe_start_verification(self) -> None:
        if self.state is not State.NORMAL:
            return
        if not self.local_cv:
            return
        if any(v is None for v in self.partial_cv.values()):
            return
        if self.rank != self.leader:
            return  # non-leaders wait for the leader's Verification
        self.phase_tag += 1
        self.state = State.VERIFICATION
        self.responses = {n: None for n in self.neighbors}
        self._broadcast(MsgKind.VERIFICATION)
        self._maybe_conclude()

    def _maybe_conclude(self) -> None:
        if self.state is not State.VERIFICATION:
            return
        if any(v is None for v in self.responses.values()):
            return
        positive = all(self.responses.values()) and self.local_cv
        self._broadcast(MsgKind.VERDICT, positive=positive)
        if positive:
            self.state = State.FINISHED
        else:
            self._reset_after_negative()

    def pump(self) -> State:
        """Process pending messages outside a solver iteration (used while
        blocked or after local termination)."""
        if self.state is not State.FINISHED:
            self._process_messages()
            self._maybe_start_verification()
        return self.state


def slcv_tree(rank: int, nblocks: int):
    """Spanning tree over block roots for the SLCV protocol: binary
    heap shape (parent ``(i-1)//2``).  The reference hardcodes the
    2-node tree block-0-root <-> block-npb-root
    (``build_spanning_tree``, ``conv_detection.c:180-196``, with the
    comment that >2 blocks would need a real tree) — this is that
    generalization; for ``nblocks=2`` it reduces to the reference's
    pair.  Returns ``(parent | None, children)``."""
    parent = None if rank == 0 else (rank - 1) // 2
    children = [c for c in (2 * rank + 1, 2 * rank + 2) if c < nblocks]
    return parent, children


class SlcvNode:
    """The legacy "SLCV" counter protocol — the reference's FIRST
    decentralized termination scheme (``src/utils/conv_detection.c:
    6-196``; tags ``include/constants.h:24-39``), superseded there by
    Algorithm 5.15 but kept as an independently interesting mechanism.
    Re-derived from the protocol's behavior; no reference code copied.

    Mechanics (per node = block root, on a spanning tree):

    * ``preLocalCV`` — the residual is under threshold this iteration;
      held for ``threshold_slcv`` CONSECUTIVE iterations ⇒ ``sLocalCV``
      (the counter that names the protocol).
    * subtree convergence flows UP the tree: a node whose ``sLocalCV``
      holds and whose children's sPartialCVs are all present sends
      ``sPartialCV(iteration)`` to its parent; a residual rebound (or a
      child's cancellation) RETRACTS it with ``CancelCV(iteration)``.
    * stale-message filtering by per-neighbor iteration counters (the
      reference's ``prevIterNumS``/``prevIterNumC``): a PartialCV is
      accepted only if at least as new as the last Cancel seen from
      that child, and vice versa — out-of-order claims can never
      resurrect a retracted subtree.
    * the ROOT reaching full-subtree convergence sets ``globalCV`` and
      gossips it DOWN the tree (``GLOBAL_CV`` positive); any
      retraction reaching the root gossips the negative.
    * termination is the caller's: iterate until ``global_cv`` has held
      CONTINUOUSLY longer than the measured message traversal time
      (``held_for()`` vs the startup RTT probe — the reference's
      ``MAX_TRAVERSAL_TIME`` guard,
      ``asynchronous-multisplitting.c.save:307-329``).

    Unlike Alg-5.15 there is no verification round and no leader: the
    guard window is the only defense against a claim retracted in
    flight — which is exactly why the reference replaced it.
    """

    def __init__(self, rank: int, nblocks: int, transport: Transport,
                 threshold_slcv: int = 4):
        import time as _time

        self._now = _time.monotonic
        self.rank = rank
        self.nblocks = nblocks
        self.transport = transport
        self.threshold_slcv = max(1, threshold_slcv)
        self.parent, self.children = slcv_tree(rank, nblocks)
        self.iteration = 0
        self.under_count = 0
        self.s_local_cv = False
        self.sent_partial: Optional[int] = None
        self.child_partial: Dict[int, Optional[int]] = {
            c: None for c in self.children}
        self._last_s: Dict[int, int] = {c: -1 for c in self.children}
        self._last_c: Dict[int, int] = {c: -1 for c in self.children}
        self.global_cv = False
        self._global_since = 0.0

    # -- queries ---------------------------------------------------------
    def _subtree_cv(self) -> bool:
        return self.s_local_cv and all(
            v is not None for v in self.child_partial.values())

    def held_for(self) -> float:
        """Seconds ``global_cv`` has held continuously (0 when unset)."""
        if not self.global_cv:
            return 0.0
        return self._now() - self._global_since

    # -- messaging -------------------------------------------------------
    def _send(self, dst: int, kind: MsgKind, positive: bool = True,
              iteration: Optional[int] = None) -> None:
        self.transport.send(dst, Msg(
            kind=kind, src=self.rank, phase_tag=0,
            iteration=self.iteration if iteration is None else iteration,
            positive=positive,
        ))

    def _set_global(self, value: bool) -> None:
        if value and not self.global_cv:
            self._global_since = self._now()
        self.global_cv = value
        for c in self.children:
            self._send(c, MsgKind.GLOBAL_CV, positive=value)

    def _retract_up(self) -> None:
        """Our subtree is no longer converged: cancel the claim we sent
        (or clear globalCV at the root)."""
        if self.parent is not None:
            if self.sent_partial is not None:
                self._send(self.parent, MsgKind.S_CANCEL_CV)
                self.sent_partial = None
        elif self.global_cv:
            self._set_global(False)

    def _maybe_claim_up(self) -> None:
        if not self._subtree_cv():
            return
        if self.parent is not None:
            if self.sent_partial is None:
                self.sent_partial = self.iteration
                self._send(self.parent, MsgKind.S_PARTIAL_CV)
        elif not self.global_cv:
            self._set_global(True)

    def _handle(self, msg: Msg) -> None:
        if msg.kind is MsgKind.S_PARTIAL_CV:
            if msg.src not in self.child_partial:
                return
            # accept only if not retracted by an as-new-or-newer cancel
            if msg.iteration >= self._last_c[msg.src]:
                self.child_partial[msg.src] = msg.iteration
                self._last_s[msg.src] = msg.iteration
                self._maybe_claim_up()
        elif msg.kind is MsgKind.S_CANCEL_CV:
            if msg.src not in self.child_partial:
                return
            if msg.iteration >= self._last_s[msg.src]:
                self._last_c[msg.src] = msg.iteration
                if self.child_partial[msg.src] is not None:
                    self.child_partial[msg.src] = None
                    self._retract_up()
        elif msg.kind is MsgKind.GLOBAL_CV:
            # gossip from the parent; forward down
            if msg.positive and not self.global_cv:
                self._global_since = self._now()
            self.global_cv = msg.positive
            for c in self.children:
                self._send(c, MsgKind.GLOBAL_CV, positive=msg.positive)

    def pump(self) -> None:
        for msg in self.transport.drain(self.rank):
            self._handle(msg)

    # -- per-iteration hook ----------------------------------------------
    def step(self, under_threshold: bool) -> None:
        self.iteration += 1
        if under_threshold:
            self.under_count += 1
            if (not self.s_local_cv
                    and self.under_count >= self.threshold_slcv):
                self.s_local_cv = True
                self._maybe_claim_up()
        else:
            self.under_count = 0
            if self.s_local_cv:
                self.s_local_cv = False
                self._retract_up()
        self.pump()
