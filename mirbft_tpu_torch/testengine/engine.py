"""The discrete-event simulation engine.

Rebuild of the reference's recorder/player (reference:
testengine/recorder.go:41-685, testengine/player.go).  One time-ordered
event queue drives N bare StateMachines; the environment around them — WAL,
request store, app log, hashing, the network — is modeled with configurable
latencies.  All randomness comes from a seed; the wall clock is never read.

Consequence scheduling per executed Actions (mirroring the runtime's
processor contract, docs/Processor.md):
- persists apply to the node's model WAL immediately (durability modeled as
  ``persist_latency`` added before dependent sends);
- sends become Step events at ``+persist_latency+link_latency`` (self
  deliveries too: the executor loops self-sends back through Step);
- hashes go to the hash plane (by default the SHA-256 kernel on the card)
  and return as one ActionResults event at ``+ready_latency``;
- commits apply to a per-node SHA-256 hash chain; checkpoint requests
  compute the chain value and return with the same ActionResults event;
- forward-requests read the node's request store and send ForwardRequest
  messages;
- state transfer is served from any node's checkpoint store at
  ``+state_transfer_latency``.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import heapq
import random
from dataclasses import dataclass, field


@contextlib.contextmanager
def _gc_paused():
    """Pause the cyclic collector for the duration of a drain loop.

    The engine allocates millions of (almost entirely acyclic) events,
    actions, and tracker records per run; generational GC repeatedly scans
    the large live graph and costs ~40% of drain wall clock at ladder
    scale.  The few real cycles (Recorder back-references) persist until
    the resumed collector's next threshold-triggered pass."""
    was_enabled = gc.isenabled()
    if was_enabled:
        gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()

from .. import pb
from ..core import actions as act
from ..core.state_machine import StateMachine
from ..obsv import hooks
from .crypto_plane import AsyncKernelHashPlane


@dataclass
class RuntimeParameters:
    """Latency model, in simulated milliseconds (reference defaults:
    testengine/recorder.go:649-656)."""

    tick_interval: int = 500
    link_latency: int = 100
    ready_latency: int = 50
    process_latency: int = 10
    persist_latency: int = 10
    state_transfer_latency: int = 800
    # WAN delay variance, applied per delivered frame (uniform in
    # [0, link_jitter], drawn from the engine's seeded rng).  Frame-level
    # because a frame models one transport segment: per-msg jitter (the
    # manglers' fault-injection semantics) would tear every coalesced
    # delivery into individual events, which is neither how packet delay
    # variation behaves nor affordable at pod scale.
    link_jitter: int = 0


def standard_initial_network_state(
    node_count: int, client_ids: list
) -> pb.NetworkState:
    """Default protocol constants (reference: mirbft.go:125-154):
    buckets = nodes, ci = 5*buckets, max epoch length = 10*ci, width 100."""
    buckets = node_count
    ci = 5 * buckets
    return pb.NetworkState(
        config=pb.NetworkConfig(
            nodes=list(range(node_count)),
            f=(node_count - 1) // 3,
            number_of_buckets=buckets,
            checkpoint_interval=ci,
            max_epoch_length=10 * ci,
        ),
        clients=[
            pb.NetworkClient(id=cid, width=100, low_watermark=0)
            for cid in client_ids
        ],
    )


@dataclass
class NodeState:
    """Environment model for one node."""

    wal: list = field(default_factory=list)  # [(index, pb.Persistent)]
    wal_truncated_to: int = 0
    reqstore: dict = field(default_factory=dict)  # digest -> (ack, data)
    app_chain: bytes = b""  # rolling SHA-256 hash chain of applied batches
    last_committed: int = 0
    checkpoints: dict = field(default_factory=dict)  # seq -> (value, state)
    committed_reqs: list = field(default_factory=list)  # [(client, req_no, seq)]
    crashed: bool = False
    # Reconfigurations the app observed committed in the current checkpoint
    # window (reported with the next CheckpointResult, reference:
    # actions.go:234-261).
    pending_reconfigs: list = field(default_factory=list)
    # Actions accumulated since the last executor pass.  The executor runs
    # once per ``process_latency`` window over everything accumulated —
    # the reference serializer's Actions accumulation between Ready()
    # reads (reference: serializer.go:216-223) — which is what lets sends
    # coalesce per target and hashes batch per launch.
    pending: act.Actions = field(default_factory=act.Actions)
    process_scheduled: bool = False


class _ClientState:
    def __init__(self, client_id: int, total_reqs: int = 0, owner=None):
        self.client_id = client_id
        self.next_req_no = 0
        self._owner = owner  # Recorder, for total-reqs cache invalidation
        self._total_reqs = total_reqs
        # node -> set of this client's req_nos seen committed there
        self.committed_by_node: dict = {}
        # req_nos committed anywhere (drives window refill exactly once)
        self.committed_anywhere: set = set()

    @property
    def total_reqs(self) -> int:
        return self._total_reqs

    @total_reqs.setter
    def total_reqs(self, value: int) -> None:
        # Direct assignment must invalidate the Recorder's cached total —
        # tests legitimately shorten a removed client's stream this way.
        self._total_reqs = value
        if self._owner is not None:
            self._owner._total_reqs_cache = None
            self._owner._progress = True

    def request(self, req_no: int) -> pb.Request:
        # Deterministic payload, distinct per (client, req_no).
        data = b"%d:%d" % (self.client_id, req_no)
        if self._owner is not None and self._owner.signer is not None:
            data = self._owner.signer(self.client_id, req_no, data)
        return pb.Request(client_id=self.client_id, req_no=req_no, data=data)


class Recorder:
    """Drives a simulated network to full commitment, recording every event."""

    def __init__(
        self,
        node_count: int,
        client_count: int,
        reqs_per_client: int,
        params: RuntimeParameters | None = None,
        seed: int = 0,
        batch_size: int = 1,
        interceptor=None,
        manglers=(),
        hash_executor=None,
        hash_plane=None,
        signer=None,
        signature_plane=None,
        mac_plane=None,
        network_state=None,
        checkpoint_certs=None,
        record=True,
        deferred_nodes=(),
        ack_plane=None,
        ack_device="cuda",
    ):
        self.params = params or RuntimeParameters()
        # The ack plane of every node's state machine: ack_plane "host" or
        # "device" (None defers to the MIRBFT_ACK_PLANE knob, as in the
        # JAX package), and the device plane's card, "cuda" (the kernels;
        # raises without a card) or "cpu" (their plain versions).
        self.ack_plane = ack_plane
        self.ack_device = ack_device
        self.rng = random.Random(seed)
        self.node_count = node_count
        self.reqs_per_client = reqs_per_client
        self.batch_size = batch_size
        self.interceptor = interceptor
        self.manglers = list(manglers)
        # Every digest goes through a hash plane (crypto_plane.py): digests
        # are computed lazily at result-delivery time, coalescing everything
        # pending across all nodes into few kernel launches.  The default is
        # the kernel plane on the card, which raises when no card is
        # present; pass AsyncKernelHashPlane(device="cpu") for the kernel's
        # plain version, or CoalescingHashPlane() for the hashlib oracle.
        # Values (and thus logs) are identical on every plane.
        if hash_executor is not None:
            raise ValueError(
                "hash_executor is not supported: digests go through "
                "hash_plane"
            )
        self.hash_plane = (
            hash_plane if hash_plane is not None else AsyncKernelHashPlane()
        )
        # Signed-request mode (signing.py): clients sign, and replicas
        # authenticate each Propose at ingress — the consumer-side auth the
        # reference mandates (mirbft.go:297-301) — via a deferred batched
        # SignaturePlane.  Invalid requests are dropped before the state
        # machine sees them.
        self.signer = signer
        self.signature_plane = signature_plane
        # MAC-authenticated replica channels (signing.MacSealPlane): every
        # legitimately sent node-to-node message is sealed at emission and
        # checked at delivery; mangler-forged rewrites are unsealed and
        # dropped at ingress, mirroring the live transport's per-link MAC
        # rejection (docs/CRYPTO.md).  Opt-in per scenario: the default
        # None keeps digest-layer corruption scenarios observing their
        # evidence where they always did.
        self.mac_plane = mac_plane
        # Checkpoint quorum certificates (certs.py): every Checkpoint
        # broadcast doubles as a BLS vote; 2f+1 matching votes aggregate
        # into one constant-size certificate.
        self.checkpoint_certs = checkpoint_certs

        # Default protocol constants scale buckets/ci with the node count
        # (reference: mirbft.go:125-154); very large networks pass an
        # explicit network_state to tame the O(buckets * n^2) heartbeat
        # traffic (fewer leaders, smaller checkpoint interval).  Client ids
        # always come from the replicated state so the simulated clients
        # and the protocol config agree by construction.
        if network_state is not None:
            self.initial_state = network_state
            client_ids = [c.id for c in network_state.clients]
            assert len(client_ids) == client_count, (
                f"network_state declares {len(client_ids)} clients, "
                f"client_count={client_count}"
            )
            # The simulated universe may be a superset of the configured
            # member set, but only by the explicitly deferred nodes
            # (replicas that join later via a node-set reconfiguration,
            # see provision_node) — a live non-member would hang at drain
            # instead of failing fast.
            members = set(network_state.config.nodes)
            assert members <= set(range(node_count)), (
                f"network_state declares nodes "
                f"{network_state.config.nodes}, engine simulates "
                f"0..{node_count - 1}"
            )
            assert set(range(node_count)) - members <= set(
                deferred_nodes
            ), (
                f"nodes {sorted(set(range(node_count)) - members)} are "
                f"simulated but neither configured members nor deferred"
            )
        else:
            client_ids = [node_count + i for i in range(client_count)]
            self.initial_state = standard_initial_network_state(
                node_count, client_ids
            )
        self.initial_checkpoint_value = b""

        self.clients = {}
        # Requests submitted at the current instant, awaiting the batched
        # per-node propose flush (_flush_proposes).
        self._pending_proposes: list = []
        # (client_id, req_no) -> [pb.Reconfiguration]: the deterministic
        # app-level reconfig model — when that request commits at a node,
        # the node's app reports the reconfigurations with its next
        # checkpoint (every correct node commits the same batches, so all
        # report identically).
        self.reconfig_on_commit: dict = {}

        self.event_count = 0
        # Proposal deliveries the signature plane refused at ingress —
        # in-flight corruptions/forgeries.  The chaos corruption invariant
        # asserts this equals the adversary's rewrite count (signed mode
        # rejects 100%); mirrored to mirbft_byzantine_rejections_total
        # when hooks are enabled.
        self.byzantine_rejections = 0
        # Incremental mirror of per-node distinct-committed counts (the
        # drain predicates run every step; recounting the per-client sets
        # each time dominated large-run profiles).
        self._committed_counts: dict[int, int] = dict.fromkeys(
            range(node_count), 0
        )
        # Set whenever commitment state could have changed; drain_clients
        # only re-evaluates fully_committed() when it is — the predicate is
        # O(nodes) and running it every step dominated large-run profiles.
        self._progress = True
        self._total_reqs_cache: int | None = None
        # record=False skips the in-memory recorded_events list (an
        # interceptor still sees every event) — pod-scale runs are tens of
        # millions of events and the list dominates memory.
        self.record = record
        self.recorded_events: list = []  # [(time, node, pb.StateEvent)]
        self._queue: list = []  # heap of (time, seq, node, StateEvent)
        self._seq = 0
        self.now = 0

        self.machines: dict[int, StateMachine] = {}
        self.node_states: dict[int, NodeState] = {}
        # Deferred nodes are part of the simulated universe but not yet
        # provisioned (they join later via a node-set reconfiguration +
        # provision_node); until then they behave like crashed nodes.
        self.deferred_nodes = set(deferred_nodes)
        for node in range(node_count):
            if node in self.deferred_nodes:
                state = NodeState()
                state.crashed = True
                self.node_states[node] = state
                self.machines[node] = self._new_machine()
                continue
            self._start_node(node, at_time=0)
            self._schedule(self.params.tick_interval, node, _tick_event())

        # Clients submit their initial window of requests to every node —
        # one batched delivery per node for the whole initial wave.
        for cid in client_ids:
            self.add_client(cid, reqs_per_client)
        self._flush_proposes()

    # -- bootstrap -----------------------------------------------------------

    def _new_machine(self) -> StateMachine:
        return StateMachine(
            ack_plane=self.ack_plane, ack_device=self.ack_device
        )

    def _start_node(self, node: int, at_time: int) -> None:
        """(Re)start a node: Initialize, replay its WAL model (or synthesize
        the bootstrap log, reference: mirbft.go:162-190), replay uncommitted
        requests, CompleteInitialization."""
        self.machines[node] = self._new_machine()
        state = self.node_states.get(node)
        if state is None:
            state = NodeState()
            self.node_states[node] = state
        state.crashed = False
        state.pending = act.Actions()
        state.process_scheduled = False

        my_params = pb.InitialParameters(
            id=node,
            batch_size=self.batch_size,
            heartbeat_ticks=2,
            suspect_ticks=4,
            new_epoch_timeout_ticks=8,
            buffer_size=5 * 1024 * 1024,
        )

        events = [pb.StateEvent(type=pb.EventInitialize(initial_parms=my_params))]
        if not state.wal:
            state.wal = [
                (
                    1,
                    pb.Persistent(
                        type=pb.CEntry(
                            seq_no=0,
                            checkpoint_value=self.initial_checkpoint_value,
                            network_state=self.initial_state,
                        )
                    ),
                ),
                (
                    2,
                    pb.Persistent(
                        type=pb.FEntry(
                            ends_epoch_config=pb.EpochConfig(
                                number=0,
                                leaders=self.initial_state.config.nodes,
                            )
                        )
                    ),
                ),
            ]
        for index, entry in state.wal:
            events.append(
                pb.StateEvent(type=pb.EventLoadEntry(index=index, data=entry))
            )
        for digest, (ack, _data) in sorted(state.reqstore.items()):
            events.append(
                pb.StateEvent(type=pb.EventLoadRequest(request_ack=ack))
            )
        events.append(pb.StateEvent(type=pb.EventCompleteInitialization()))

        for event in events:
            # Boot lifecycle events bypass manglers (and the crashed-node
            # filter): they are harness machinery, not network traffic — a
            # node-scoped drop/jitter mangler must not break the strict
            # Initialize→Load→Complete sequence.
            heapq.heappush(self._queue, (at_time, self._seq, node, event))
            self._seq += 1

    # -- scheduling ----------------------------------------------------------

    def _schedule(self, delay: int, node: int, event: pb.StateEvent) -> None:
        state = self.node_states.get(node)
        if state is not None and state.crashed:
            return  # a down node loses its inbound traffic
        when = self.now + delay
        if not self.manglers:  # hot path: most runs are fault-free
            heapq.heappush(self._queue, (when, self._seq, node, event))
            self._seq += 1
            return
        # Mangler protocol: each mangler maps one candidate to None (drop),
        # a (when, node, event) tuple, or a list of tuples (duplication);
        # manglers fold left over the candidate set.
        for w, n, e in self._mangle([(when, node, event)]):
            heapq.heappush(self._queue, (w, self._seq, n, e))
            self._seq += 1

    def _schedule_frame_mangled(
        self, delay: int, source: int, target: int, msgs: list
    ) -> None:
        """Fold each msg of a frame through the manglers as its own
        EventStep candidate (per-msg fault-injection semantics), then
        re-coalesce survivors that share a delivery instant into batch
        events."""
        state = self.node_states.get(target)
        if state is not None and state.crashed:
            return  # a down node loses its inbound traffic
        when = self.now + delay
        if self.params.link_jitter:
            when += self.rng.randint(0, self.params.link_jitter)
        survivors: list = []
        for msg in msgs:
            survivors.extend(
                self._mangle(
                    [
                        (
                            when,
                            target,
                            pb.StateEvent(
                                type=pb.EventStep(source=source, msg=msg)
                            ),
                        )
                    ]
                )
            )
        merged: dict = {}
        for w, n, e in survivors:
            merged.setdefault((w, n), []).append(e)
        for (w, n), events in merged.items():
            if len(events) == 1:
                event = events[0]
            else:
                event = pb.StateEvent(
                    type=pb.EventStepBatch(
                        source=source,
                        msgs=[e.type.msg for e in events],
                    )
                )
            heapq.heappush(self._queue, (w, self._seq, n, event))
            self._seq += 1

    def provision_node(
        self, node: int, from_node: int, seq_no: int, delay: int
    ) -> None:
        """Provision a (deferred or crashed) node from another node's
        stable checkpoint and schedule its boot — the operator-side half of
        a node-set reconfiguration: the new replica starts from a snapshot
        whose network state already includes it (reference seam:
        commitstate.go:192-226; the reference admits this path 'does not
        entirely work', README.md:35 — here it is driven end to end).

        The synthesized WAL is the bootstrap pair (CEntry at the snapshot +
        FEntry for the snapshot's epoch); the app state (hash chain +
        per-client commit sets) is adopted exactly as a completed state
        transfer would."""
        source_state = self.node_states[from_node]
        stored = source_state.checkpoints.get(seq_no)
        assert stored is not None, (
            f"node {from_node} has no checkpoint at {seq_no}"
        )
        value, network_state, snapshot = stored
        assert node in network_state.config.nodes, (
            f"checkpoint at {seq_no} does not configure node {node}"
        )
        # The epoch active at the source: the new node's FEntry ends the
        # previous epoch, so its reinitialize runs the normal after-epoch-
        # change path and it integrates at the next epoch rollover.
        current = self.machines[from_node].epoch_tracker.current_epoch
        epoch_config = pb.EpochConfig(
            number=current.number,
            leaders=list(network_state.config.nodes),
            planned_expiration=0,
        )

        state = self.node_states[node]
        state.wal = [
            (
                1,
                pb.Persistent(
                    type=pb.CEntry(
                        seq_no=seq_no,
                        checkpoint_value=value,
                        network_state=network_state,
                    )
                ),
            ),
            (2, pb.Persistent(type=pb.FEntry(ends_epoch_config=epoch_config))),
        ]
        state.reqstore = {}
        state.app_chain = value
        state.last_committed = seq_no
        for cid, req_nos in snapshot.items():
            mine = self.clients[cid].committed_by_node.setdefault(node, set())
            self._committed_counts[node] += len(req_nos - mine)
            mine |= req_nos
        self._progress = True
        self.deferred_nodes.discard(node)
        self.schedule_restart(node, delay)

    def _mangle(self, candidates: list) -> list:
        """Fold candidate (when, node, event) tuples through every mangler
        (None = drop, tuple = reschedule, list = duplicate)."""
        for mangler in self.manglers:
            folded = []
            for w, n, e in candidates:
                verdict = mangler(self, w, n, e)
                if verdict is None:
                    continue
                if isinstance(verdict, list):
                    folded.extend(verdict)
                else:
                    folded.append(verdict)
            candidates = folded
        return candidates

    def schedule_restart(self, node: int, delay: int) -> None:
        """Schedule a node (possibly crashed) to boot from its durable state
        at now+delay.  Bypasses manglers and crash filtering: the restart is
        harness machinery, not network traffic."""
        heapq.heappush(
            self._queue, (self.now + delay, self._seq, node, _RESTART)
        )
        self._seq += 1

    def _submit_next_request(self, client: _ClientState) -> None:
        if client.next_req_no >= client.total_reqs:
            return
        request = client.request(client.next_req_no)
        client.next_req_no += 1
        if self.signature_plane is not None:
            self.signature_plane.submit(
                request.client_id, request.req_no, request.data
            )
        # Proposals buffer and flush as one batched delivery per node per
        # instant (see _flush_proposes) — the per-request propose fan-out
        # (reqs x nodes single events) otherwise dominates event counts.
        self._pending_proposes.append(request)

    def _flush_proposes(self) -> None:
        """Schedule everything _submit_next_request buffered at this
        instant: one EventPropose(Batch) per node at +link_latency.  Called
        at the end of __init__ (the initial client windows) and of every
        step() (window refills triggered by commits); external callers that
        submit between steps (tests) are flushed by the next step."""
        pending = self._pending_proposes
        if not pending:
            return
        self._pending_proposes = []
        delay = self.params.link_latency
        if self.manglers:
            # Per-request fault-injection semantics: each request folds
            # through the manglers as its own EventPropose candidate;
            # survivors sharing a delivery instant re-coalesce.
            for node in range(self.node_count):
                state = self.node_states.get(node)
                if state is not None and state.crashed:
                    continue
                when = self.now + delay
                survivors: list = []
                for request in pending:
                    survivors.extend(
                        self._mangle(
                            [
                                (
                                    when,
                                    node,
                                    pb.StateEvent(
                                        type=pb.EventPropose(request=request)
                                    ),
                                )
                            ]
                        )
                    )
                merged: dict = {}
                for w, n, e in survivors:
                    merged.setdefault((w, n), []).append(e)
                for (w, n), events in merged.items():
                    if len(events) == 1:
                        event = events[0]
                    else:
                        event = pb.StateEvent(
                            type=pb.EventProposeBatch(
                                requests=[e.type.request for e in events]
                            )
                        )
                    heapq.heappush(self._queue, (w, self._seq, n, event))
                    self._seq += 1
            return
        if len(pending) == 1:
            event = pb.StateEvent(type=pb.EventPropose(request=pending[0]))
        else:
            event = pb.StateEvent(type=pb.EventProposeBatch(requests=pending))
        # One shared event object for every node, like delivery frames:
        # propose events are never mutated (signature filtering builds a
        # fresh event).
        for node in range(self.node_count):
            self._schedule(delay, node, event)

    def _count_rejection(self, n: int) -> None:
        """Account n signature-plane ingress rejections (corrupted or forged
        proposal deliveries)."""
        self.byzantine_rejections += n
        if hooks.enabled:
            hooks.metrics.counter(
                "mirbft_byzantine_rejections_total", kind="corrupt"
            ).inc(n)

    # -- the loop ------------------------------------------------------------

    def step(self) -> bool:
        """Process one event; returns False when the queue is empty."""
        if not self._queue:
            return False
        when, _seq, node, event = heapq.heappop(self._queue)
        if when > self.now:
            self.now = when
            if hooks.enabled:
                # Publish the simulated clock so milestone instants carry
                # deterministic simulated time alongside wall timestamps.
                hooks.sim_now = when
            # Simulated time advanced: every hash submitted at earlier
            # instants is a complete wave the plane may launch now,
            # overlapping device work with the events between here and the
            # results delivery.
            self.hash_plane.on_time(when)
            if self.signature_plane is not None:
                # Same wave boundary for ingress authentication: requests
                # submitted at earlier instants may launch their verify
                # kernels now, ahead of the first delivery's valid() check.
                self.signature_plane.on_time(when)
        if event is _RESTART:
            self.restart(node)
            return True
        machine = self.machines[node]
        state = self.node_states[node]
        if state.crashed:
            return True
        if event is _PROCESS:
            # The executor pass: run everything this node accumulated since
            # the pass was scheduled.
            state.process_scheduled = False
            pending = state.pending
            state.pending = act.Actions()
            self._execute(node, state, pending)
            if self._pending_proposes:
                # Commits in this pass refilled client windows; batch the
                # new submissions into one delivery per node.
                self._flush_proposes()
            return True
        if self.signature_plane is not None:
            inner = event.type
            if isinstance(inner, pb.EventPropose):
                req = inner.request
                if not self.signature_plane.valid(
                    req.client_id, req.req_no, req.data
                ):
                    # Ingress authentication failed: the replica never
                    # steps the state machine (unrecorded, like any
                    # dropped packet).
                    self._count_rejection(1)
                    return True
            elif isinstance(inner, pb.EventProposeBatch):
                valid = self.signature_plane.valid
                reqs = [
                    r
                    for r in inner.requests
                    if valid(r.client_id, r.req_no, r.data)
                ]
                if len(reqs) != len(inner.requests):
                    self._count_rejection(len(inner.requests) - len(reqs))
                if not reqs:
                    return True
                if len(reqs) != len(inner.requests):
                    # Never mutate the shared event object; the filtered
                    # batch is what this replica (and the record) sees.
                    # Verdicts are pure functions of the bytes, so every
                    # replica filters identically.
                    event = pb.StateEvent(
                        type=pb.EventProposeBatch(requests=reqs)
                    )
        if self.mac_plane is not None:
            inner = event.type
            if isinstance(inner, pb.EventStep):
                if not self.mac_plane.admit(inner.msg):
                    # Replica-channel MAC failed: dropped at ingress,
                    # unrecorded — the live transport never delivers a
                    # bad-MAC frame to the node either.
                    return True
            elif isinstance(inner, pb.EventStepBatch):
                admit = self.mac_plane.admit
                msgs = [m for m in inner.msgs if admit(m)]
                if len(msgs) != len(inner.msgs):
                    if not msgs:
                        return True
                    # Never mutate the shared event object (other targets
                    # and the record see the original).
                    event = pb.StateEvent(
                        type=pb.EventStepBatch(
                            source=inner.source, msgs=msgs
                        )
                    )

        self.event_count += 1
        # Materialize lazy digests before the event is recorded or applied
        # so logs match inline execution bit-for-bit.
        self.hash_plane.resolve_event(event)
        if self.interceptor is not None:
            self.interceptor(node, self.now, event)
        if self.record:
            self.recorded_events.append((self.now, node, event))

        if isinstance(event.type, pb.EventTick):
            self._schedule(self.params.tick_interval, node, _tick_event())
        elif (
            isinstance(event.type, pb.EventTransfer)
            and event.type.c_entry.network_state is not None
        ):
            # The transferred app state is adopted when the transfer event
            # is *delivered* (not when it was scheduled — the node may have
            # crashed in between).
            self._adopt_transferred_state(node, event.type.c_entry)

        actions = machine.apply_event(event)
        if not actions.is_empty():
            state.pending.concat(actions)
            if not state.process_scheduled:
                state.process_scheduled = True
                heapq.heappush(
                    self._queue,
                    (
                        self.now + self.params.process_latency,
                        self._seq,
                        node,
                        _PROCESS,
                    ),
                )
                self._seq += 1
        if self._pending_proposes:
            # Commits in this event refilled client windows; batch the new
            # submissions into one delivery per node at this instant.
            self._flush_proposes()
        return True

    def _adopt_transferred_state(self, node: int, c_entry: pb.CEntry) -> None:
        state = self.node_states[node]
        state.app_chain = c_entry.checkpoint_value
        state.last_committed = c_entry.seq_no
        for other in range(self.node_count):
            stored = self.node_states[other].checkpoints.get(c_entry.seq_no)
            if stored is None or stored[0] != c_entry.checkpoint_value:
                continue
            snapshot = stored[2]
            for cid, req_nos in snapshot.items():
                mine = self.clients[cid].committed_by_node.setdefault(
                    node, set()
                )
                self._committed_counts[node] += len(req_nos - mine)
                mine |= req_nos
            self._progress = True
            return

    def _execute(self, node: int, state: NodeState, actions: act.Actions) -> None:
        """Model the executor: apply durable effects, schedule consequences."""
        persist_delay = 0

        for write in actions.write_ahead:
            persist_delay = self.params.persist_latency
            if write.append is not None:
                state.wal.append((write.append.index, write.append.data))
            else:
                state.wal = [
                    (i, e) for i, e in state.wal if i >= write.truncate
                ]

        for fr in actions.store_requests:
            state.reqstore[fr.request_ack.digest] = (
                fr.request_ack,
                fr.request_data,
            )

        send_delay = persist_delay + self.params.link_latency
        # Coalesce this pass's sends into one frame per distinct target
        # set — the transport-level batching that collapses the n^2
        # per-request ack fan-out into per-(source,target) deliveries.
        # All targets of a group share one event object.  A target
        # appearing in several groups receives the groups as separate
        # frames in emission order; relative reordering of msgs across
        # groups is fine (the network is unordered by assumption) and
        # deterministic (insertion-ordered dicts).
        groups: dict[tuple, list] = {}
        observe = (
            self.checkpoint_certs.observe
            if self.checkpoint_certs is not None
            else None
        )
        seal = self.mac_plane.seal if self.mac_plane is not None else None
        last_targets = None  # sends overwhelmingly share one list object
        last_key = None
        for send in actions.sends:
            if observe is not None:
                observe(node, send.msg)
            if seal is not None:
                seal(send.msg)
            targets = send.targets
            if targets is last_targets:
                key = last_key
            else:
                key = tuple(targets)
                last_targets, last_key = targets, key
            frame = groups.get(key)
            if frame is None:
                groups[key] = [send.msg]
            else:
                frame.append(send.msg)
        for fwd in actions.forward_requests:
            stored = state.reqstore.get(fwd.request_ack.digest)
            if stored is None:
                continue
            _ack, data = stored
            msg = pb.Msg(
                type=pb.ForwardRequest(
                    request_ack=fwd.request_ack, request_data=data
                )
            )
            if seal is not None:
                seal(msg)
            key = tuple(fwd.targets)
            frame = groups.get(key)
            if frame is None:
                groups[key] = [msg]
            else:
                frame.append(msg)
        if self.manglers:
            # Manglers keep their per-msg semantics: each inner msg folds
            # through the rules as its own EventStep candidate (so
            # msg-type/percent matchers behave exactly as before), and the
            # survivors that still share a delivery instant re-coalesce
            # into frames.
            for targets, msgs in groups.items():
                for target in targets:
                    self._schedule_frame_mangled(
                        send_delay, node, target, msgs
                    )
        else:
            jitter = self.params.link_jitter
            rand = self.rng.randint
            for targets, msgs in groups.items():
                if len(msgs) == 1:
                    event = pb.StateEvent(
                        type=pb.EventStep(source=node, msg=msgs[0])
                    )
                else:
                    event = pb.StateEvent(
                        type=pb.EventStepBatch(source=node, msgs=msgs)
                    )
                if jitter:
                    for target in targets:
                        self._schedule(
                            send_delay + rand(0, jitter), target, event
                        )
                else:
                    for target in targets:
                        self._schedule(send_delay, target, event)

        results = act.ActionResults()
        if actions.hashes:
            digests = self.hash_plane.submit([hr.data for hr in actions.hashes])
            for hr, digest in zip(actions.hashes, digests, strict=True):
                results.digests.append(act.HashResult(digest=digest, request=hr))

        for commit in actions.commits:
            if commit.batch is not None:
                self._apply_batch(node, state, commit.batch)
            else:
                cp = commit.checkpoint
                value = state.app_chain
                reconfigs = state.pending_reconfigs
                state.pending_reconfigs = []
                # Snapshot the app state (chain + per-client commits) so a
                # lagging node can adopt it wholesale via state transfer.
                snapshot = {
                    cid: set(c.committed_by_node.get(node, ()))
                    for cid, c in self.clients.items()
                }
                state.checkpoints[cp.seq_no] = (
                    value,
                    pb.NetworkState(
                        config=cp.network_config,
                        clients=cp.clients_state,
                    ),
                    snapshot,
                )
                results.checkpoints.append(
                    act.CheckpointResult(
                        checkpoint=cp,
                        value=value,
                        reconfigurations=reconfigs,
                    )
                )

        if results.digests or results.checkpoints:
            self._schedule(
                self.params.ready_latency,
                node,
                pb.StateEvent(type=act.results_to_event(results)),
            )

        if actions.state_transfer is not None:
            self._serve_state_transfer(node, actions.state_transfer)

    def add_client(self, client_id: int, total_reqs: int) -> None:
        """Register a (reconfiguration-added) client and submit its initial
        request window to every node."""
        client = _ClientState(client_id, total_reqs=total_reqs, owner=self)
        self.clients[client_id] = client
        self._total_reqs_cache = None
        self._progress = True
        for _ in range(min(total_reqs, 100)):
            self._submit_next_request(client)

    def _apply_batch(self, node: int, state: NodeState, batch: pb.QEntry) -> None:
        if batch.seq_no <= state.last_committed:
            # A restarted state machine replays from its last stable
            # checkpoint and re-emits commits the durable app already
            # applied before the crash (reference contract: the app owns
            # commit idempotency, processor.go's persisted last-applied).
            # Re-applying would double-hash the app chain and fork the
            # node's next checkpoint off the network.
            return
        state.last_committed = batch.seq_no
        if hooks.enabled:
            hooks.milestone("seq.committed", node, batch.seq_no)
        for ack in batch.requests:
            triggered = self.reconfig_on_commit.get((ack.client_id, ack.req_no))
            if triggered:
                state.pending_reconfigs.extend(triggered)
            h = hashlib.sha256()
            h.update(state.app_chain)
            h.update(ack.digest)
            state.app_chain = h.digest()
            state.committed_reqs.append((ack.client_id, ack.req_no, batch.seq_no))
            client = self.clients.get(ack.client_id)
            if client is not None:
                seen = client.committed_by_node.setdefault(node, set())
                if ack.req_no not in seen:
                    seen.add(ack.req_no)
                    self._committed_counts[node] += 1
                    self._progress = True
                if ack.req_no not in client.committed_anywhere:
                    # First commit anywhere slides the client's submission
                    # window (a deterministic stand-in for client waiters).
                    client.committed_anywhere.add(ack.req_no)
                    self._submit_next_request(client)

    def _serve_state_transfer(self, node: int, target: act.StateTarget) -> None:
        for other in range(self.node_count):
            stored = self.node_states[other].checkpoints.get(target.seq_no)
            if stored is None:
                continue
            value, network_state, _snapshot = stored
            if value != target.value:
                continue
            # State adoption happens at delivery time (step()); here we only
            # schedule the transfer's arrival.
            self._schedule(
                self.params.state_transfer_latency,
                node,
                pb.StateEvent(
                    type=pb.EventTransfer(
                        c_entry=pb.CEntry(
                            seq_no=target.seq_no,
                            checkpoint_value=value,
                            network_state=network_state,
                        )
                    )
                ),
            )
            return
        # Nobody has it yet; retry after a delay by re-scheduling the check.
        self._schedule(
            self.params.state_transfer_latency,
            node,
            pb.StateEvent(
                type=pb.EventTransfer(
                    c_entry=pb.CEntry(
                        seq_no=target.seq_no,
                        checkpoint_value=target.value,
                        network_state=None,  # signals failure → retry
                    )
                )
            ),
        )

    # -- crash / restart (used by manglers) ----------------------------------

    def crash(self, node: int) -> None:
        self.node_states[node].crashed = True
        self._progress = True  # a crashed node leaves the commitment quorum
        self._queue = [
            entry
            for entry in self._queue
            if entry[2] != node or entry[3] is _RESTART
        ]
        heapq.heapify(self._queue)

    def restart(self, node: int) -> None:
        self._start_node(node, at_time=self.now)
        self._schedule(self.params.tick_interval, node, _tick_event())

    # -- assertions ----------------------------------------------------------

    @property
    def _total_reqs(self) -> int:
        if self._total_reqs_cache is None:
            self._total_reqs_cache = sum(
                c.total_reqs for c in self.clients.values()
            )
        return self._total_reqs_cache

    def set_client_total(self, client_id: int, total_reqs: int) -> None:
        """Adjust how many requests a client will submit (e.g. a test
        shortening a removed client's stream).  Equivalent to assigning
        ``clients[cid].total_reqs`` — the setter invalidates the cache."""
        self.clients[client_id].total_reqs = total_reqs

    def fully_committed(self) -> bool:
        total = self._total_reqs
        if total == 0:
            return True
        return all(
            self._committed_counts[n] >= total
            for n in range(self.node_count)
            if not self.node_states[n].crashed
        )

    def drain_until(self, predicate, max_steps: int = 100_000) -> int:
        """Run until predicate(self) holds; returns events processed."""
        with _gc_paused():
            for _ in range(max_steps):
                if predicate(self):
                    return self.event_count
                if not self.step():
                    raise AssertionError(
                        f"event queue drained before condition "
                        f"({self.event_count} events)"
                    )
        raise AssertionError(
            f"condition not reached after {max_steps} steps "
            f"({self.event_count} events)"
        )

    def committed_at(self, node: int) -> int:
        """Distinct requests committed (or adopted via transfer) at node."""
        return self._committed_counts[node]

    def drain_clients(self, max_steps: int = 100_000) -> int:
        """Run until every client's requests commit at every live node;
        returns the number of events processed (the determinism anchor)."""
        check = True  # always evaluate on entry (drain may be a no-op)
        with _gc_paused():
            for _ in range(max_steps):
                if check or self._progress:
                    check = False
                    self._progress = False
                    if self.fully_committed():
                        return self.event_count
                if not self.step():
                    raise AssertionError(
                        f"event queue drained before full commitment "
                        f"({self.event_count} events)"
                    )
        raise AssertionError(
            f"no full commitment after {max_steps} steps "
            f"({self.event_count} events)"
        )


class _RestartSentinel:
    """Queue marker: boot this node when popped (sorts after real events at
    the same (when, seq) because it is never compared — seq breaks ties)."""

    def __repr__(self):
        return "<restart>"


_RESTART = _RestartSentinel()


class _ProcessSentinel:
    """Queue marker: run the node's executor pass over its accumulated
    Actions.  Harness machinery like _RESTART: not a StateEvent, never
    recorded, never counted, never mangled."""

    def __repr__(self):
        return "<process>"


_PROCESS = _ProcessSentinel()


def _tick_event() -> pb.StateEvent:
    return pb.StateEvent(type=pb.EventTick())


def BasicRecorder(
    node_count: int, client_count: int, reqs_per_client: int, **kwargs
) -> Recorder:
    """The standard fixture (reference: testengine/recorder.go:637-685)."""
    return Recorder(node_count, client_count, reqs_per_client, **kwargs)
