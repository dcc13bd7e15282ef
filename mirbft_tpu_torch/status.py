"""Read-only status snapshots and the ASCII dashboard.

Rebuild of the reference's status package (reference: status/status.go:
73-296): a JSON-able deep snapshot of every tracker, taken on demand via
the serializer, plus a pretty renderer showing buckets, sequences,
checkpoints, and client windows.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

from .core.epoch_target import TargetState
from .core.sequence import SeqState


@dataclass
class BucketStatus:
    id: int
    leader: bool
    sequences: list = field(default_factory=list)  # [str: sequence states]


@dataclass
class CheckpointStatus:
    seq_no: int
    max_agreements: int
    net_quorum: bool
    local_decision: bool
    stable: bool


@dataclass
class ClientStatus:
    client_id: int
    low_watermark: int
    high_watermark: int
    next_ready_mark: int
    # per req_no in window: "" (empty), A (acked), W (weak), S (strong),
    # R (ready/local), C (committed)
    allocated: list = field(default_factory=list)


@dataclass
class EpochChangeStatus:
    source: int
    msgs: list = field(default_factory=list)  # [(digest_hex, [ackers])]


@dataclass
class EpochTargetStatus:
    number: int
    state: str
    epoch_changes: list = field(default_factory=list)
    echos: list = field(default_factory=list)
    readies: list = field(default_factory=list)
    suspicions: list = field(default_factory=list)


@dataclass
class NetworkConfigStatus:
    """The active consensus configuration and the reconfiguration
    pipeline's position: which config this node runs under (epoch it is
    serving, the checkpoint it was re-anchored at), plus how many
    committed reconfigurations are pending adoption and how many have
    been adopted over this process's lifetime."""

    epoch: int
    first_seq: int  # checkpoint seq_no the active config anchors at
    nodes: list = field(default_factory=list)
    f: int = 0
    number_of_buckets: int = 0
    checkpoint_interval: int = 0
    max_epoch_length: int = 0
    pending_reconfigurations: int = 0
    reconfigs_adopted: int = 0
    retired: bool = False


@dataclass
class StateMachineStatus:
    node_id: int
    low_watermark: int
    high_watermark: int
    epoch_tracker: EpochTargetStatus | None
    client_windows: list = field(default_factory=list)
    buckets: list = field(default_factory=list)
    checkpoints: list = field(default_factory=list)
    # Skew signal: in-flight (allocated-but-uncommitted) sequences per
    # bucket, and max/median of that vector — 1.0 means balanced load,
    # large means one leader's bucket is absorbing the hot clients.
    bucket_backlog: list = field(default_factory=list)
    bucket_imbalance: float = 0.0
    network_config: NetworkConfigStatus | None = None

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, default=str)

    def pretty(self) -> str:
        return pretty(self)


_SEQ_CHARS = {
    SeqState.UNINITIALIZED: ".",
    SeqState.ALLOCATED: "a",
    SeqState.PENDING_REQUESTS: "q",
    SeqState.READY: "r",
    SeqState.PREPREPARED: "Q",
    SeqState.PREPARED: "P",
    SeqState.COMMITTED: "C",
}


def _imbalance_ratio(backlog: list) -> float:
    """max/median of the per-bucket backlog vector (median floored at 1
    so an idle cluster reads as ratio == max, not a division blowup).
    1.0 when perfectly balanced or empty."""
    if not backlog:
        return 0.0
    ordered = sorted(backlog)
    n = len(ordered)
    mid = ordered[n // 2] if n % 2 else (ordered[n // 2 - 1] + ordered[n // 2]) / 2.0
    return max(ordered) / max(float(mid), 1.0)


def _client_status(client) -> ClientStatus:
    allocated = []
    for crn in client.req_nos():
        if crn.committed is not None:
            allocated.append("C")
        elif any(d in crn.my_requests for d in crn.strong_requests):
            allocated.append("R")
        elif crn.strong_requests:
            allocated.append("S")
        elif crn.weak_requests:
            allocated.append("W")
        elif crn.requests:
            allocated.append("A")
        else:
            allocated.append("")
    while allocated and allocated[-1] == "":
        allocated.pop()
    return ClientStatus(
        client_id=client.client_state.id,
        low_watermark=client.low_watermark,
        high_watermark=client.high_watermark,
        next_ready_mark=client.next_ready_mark,
        allocated=allocated,
    )


def state_machine_status(machine) -> StateMachineStatus:
    """Snapshot a core.state_machine.StateMachine.  Must be called from the
    thread that owns the machine (the serializer does this)."""
    if machine.my_config is None or machine.epoch_tracker is None or \
            machine.epoch_tracker.current_epoch is None:
        return StateMachineStatus(
            node_id=machine.my_config.id if machine.my_config else -1,
            low_watermark=0,
            high_watermark=0,
            epoch_tracker=None,
        )

    target = machine.epoch_tracker.current_epoch

    epoch_changes = []
    for origin in sorted(target.changes):
        cert = target.changes[origin]
        msgs = [
            (digest.hex()[:16], sorted(parsed.acks))
            for digest, parsed in sorted(cert.parsed_by_digest.items())
        ]
        epoch_changes.append(EpochChangeStatus(source=origin, msgs=msgs))

    def voters(table):
        out = []
        for _cfg, votes in table.values():
            out.extend(votes)
        return sorted(set(out))

    tracker_status = EpochTargetStatus(
        number=target.number,
        state=TargetState(target.state).name,
        epoch_changes=epoch_changes,
        echos=voters(target.echos),
        readies=voters(target.readies),
        suspicions=sorted(target.suspicions),
    )

    low = high = 0
    buckets = []
    active = target.active_epoch
    if active is not None and active.sequences:
        low = active.low_watermark()
        high = active.high_watermark()
        per_bucket: dict[int, list] = {b: [] for b in active.buckets}
        for seq_no in range(low, high + 1):
            seq = active.sequence(seq_no)
            per_bucket[active.seq_bucket(seq_no)].append(
                _SEQ_CHARS[seq.state]
            )
        buckets = [
            BucketStatus(
                id=b,
                leader=active.buckets[b] == machine.my_config.id,
                sequences=per_bucket[b],
            )
            for b in sorted(per_bucket)
        ]
        backlog = [
            sum(1 for c in per_bucket[b] if c not in (".", "C"))
            for b in sorted(per_bucket)
        ]
        imbalance = _imbalance_ratio(backlog)
    else:
        backlog = []
        imbalance = 0.0

    checkpoints = [
        CheckpointStatus(
            seq_no=cp.seq_no,
            max_agreements=max(
                (len(nodes) for nodes in cp.votes.values()), default=0
            ),
            net_quorum=cp.committed_value is not None,
            local_decision=cp.my_value is not None,
            stable=cp.stable,
        )
        for cp in sorted(
            machine.checkpoint_tracker.checkpoint_map.values(),
            key=lambda c: c.seq_no,
        )
    ]

    clients = [
        _client_status(machine.client_tracker.clients[cs.id])
        for cs in machine.client_tracker.client_states
    ]

    config_status = None
    commit_state = machine.commit_state
    if commit_state is not None and commit_state.active_state is not None:
        active = commit_state.active_state
        config_status = NetworkConfigStatus(
            epoch=target.number,
            first_seq=commit_state.low_watermark,
            nodes=list(active.config.nodes),
            f=active.config.f,
            number_of_buckets=active.config.number_of_buckets,
            checkpoint_interval=active.config.checkpoint_interval,
            max_epoch_length=active.config.max_epoch_length,
            pending_reconfigurations=len(active.pending_reconfigurations),
            reconfigs_adopted=machine.reconfigs_adopted,
            retired=machine.retired,
        )

    return StateMachineStatus(
        node_id=machine.my_config.id,
        low_watermark=low,
        high_watermark=high,
        epoch_tracker=tracker_status,
        client_windows=clients,
        buckets=buckets,
        checkpoints=checkpoints,
        bucket_backlog=backlog,
        bucket_imbalance=imbalance,
        network_config=config_status,
    )


@dataclass
class PeerLinkStatus:
    """One peer's outbound channel (runtime/transport.py counters)."""

    peer_id: int
    enqueued: int
    sent: int
    dropped_overflow: int
    dropped_closed: int
    send_failures: int
    connect_failures: int
    connects: int
    queue_depth: int


@dataclass
class TransportStatus:
    """Snapshot of a TcpTransport's drop/retry accounting."""

    node_id: int
    dropped_unknown: int
    peers: list = field(default_factory=list)  # [PeerLinkStatus]

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, default=str)

    def pretty(self) -> str:
        lines = [f"=== Transport (node {self.node_id}) ==="]
        if self.dropped_unknown:
            lines.append(f"  dropped (unknown peer): {self.dropped_unknown}")
        for peer in self.peers:
            drops = peer.dropped_overflow + peer.dropped_closed
            lines.append(
                f"  peer {peer.peer_id}: sent={peer.sent}/{peer.enqueued} "
                f"queued={peer.queue_depth} dropped={drops} "
                f"send_failures={peer.send_failures} "
                f"connects={peer.connects} "
                f"(failed {peer.connect_failures})"
            )
        return "\n".join(lines)


def transport_status(transport) -> TransportStatus:
    """Snapshot a runtime.transport.TcpTransport."""
    counters = transport.counters()
    return TransportStatus(
        node_id=transport.node_id,
        dropped_unknown=counters["dropped_unknown"],
        peers=[
            PeerLinkStatus(peer_id=peer_id, **stats)
            for peer_id, stats in sorted(counters["peers"].items())
        ],
    )


@dataclass
class TransferStatus:
    """Snapshot of a runtime.transfer.TransferEngine: fetch progress on
    the fetcher side, cached anchors on the donor side, and the evidence
    counters the chaos audits read."""

    node_id: int
    phase: str
    target_seq_no: int | None
    donor: int | None
    chunks_received: int
    total_chunks: int | None
    cached_snapshots: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, default=str)

    def pretty(self) -> str:
        lines = [f"=== State transfer (node {self.node_id}) ==="]
        if self.phase == "idle":
            lines.append("  idle")
        else:
            total = self.total_chunks if self.total_chunks is not None else "?"
            lines.append(
                f"  {self.phase} target=seq {self.target_seq_no} "
                f"donor={self.donor} chunks={self.chunks_received}/{total}"
            )
        if self.cached_snapshots:
            lines.append(
                "  servable anchors: "
                + ", ".join(str(s) for s in self.cached_snapshots)
            )
        interesting = {k: v for k, v in sorted(self.counters.items()) if v}
        if interesting:
            lines.append(
                "  "
                + " ".join(f"{k}={v}" for k, v in interesting.items())
            )
        return "\n".join(lines)


def transfer_status(engine) -> TransferStatus:
    """Snapshot a runtime.transfer.TransferEngine."""
    snap = engine.status()
    return TransferStatus(
        node_id=engine.node_id,
        phase=snap["phase"],
        target_seq_no=snap["target_seq_no"],
        donor=snap["donor"],
        chunks_received=snap["chunks_received"],
        total_chunks=snap["total_chunks"],
        cached_snapshots=snap["cached_snapshots"],
        counters=snap["counters"],
    )


@dataclass
class AppStatus:
    """Snapshot of the app commit stream (app/stream.py): the applied
    and enqueued frontiers, queue pressure, and read-barrier traffic —
    the user-visible side of the node.  Also published as ``app.json``
    by the cluster worker."""

    node_id: int
    applied_seq: int
    applied_index: int
    enqueued_seq: int
    enqueued_index: int
    queue_len: int
    queue_depth: int
    waiters: int
    installs: int
    snapshots: int

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, default=str)

    def pretty(self) -> str:
        lines = [f"=== App (node {self.node_id}) ==="]
        lines.append(
            f"  applied: index {self.applied_index} @ seq "
            f"{self.applied_seq} (enqueued: index {self.enqueued_index} "
            f"@ seq {self.enqueued_seq})"
        )
        lines.append(
            f"  queue: {self.queue_len}/{self.queue_depth} "
            f"waiters={self.waiters} installs={self.installs} "
            f"snapshots_retained={self.snapshots}"
        )
        return "\n".join(lines)


def app_status(stream, node_id: int | None = None) -> AppStatus:
    """Snapshot an app.stream.CommitStream."""
    snap = stream.status()
    return AppStatus(
        node_id=node_id if node_id is not None else stream.node_id,
        applied_seq=snap["applied_seq"],
        applied_index=snap["applied_index"],
        enqueued_seq=snap["enqueued_seq"],
        enqueued_index=snap["enqueued_index"],
        queue_len=snap["queue_len"],
        queue_depth=snap["queue_depth"],
        waiters=snap["waiters"],
        installs=snap["installs"],
        snapshots=snap["snapshots"],
    )


@dataclass
class BreakerStatus:
    state: str
    consecutive_failures: int
    failures: int
    successes: int
    trips: int
    probes: int


@dataclass
class CryptoPlaneStatus:
    """Device-health snapshot of a digest or signature plane: how much
    work the device did vs. was rescued/fallen back to the host, and what
    the circuit breaker thinks of the device right now."""

    plane: str
    flushes: int
    device_errors: int
    fallback_work: int
    device_timeouts: int = 0
    rescued_digests: int = 0
    # Speculative admission (SpeculativeSignaturePlane / ingress): how
    # many verdicts are still outstanding and how many admitted requests
    # were evicted on a false verdict.  Zero for non-speculative planes.
    speculative_depth: int = 0
    speculative_evictions: int = 0
    breaker: BreakerStatus | None = None

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, default=str)

    def pretty(self) -> str:
        lines = [f"=== Crypto plane ({self.plane}) ==="]
        lines.append(
            f"  flushes={self.flushes} device_errors={self.device_errors} "
            f"timeouts={self.device_timeouts} "
            f"fallback={self.fallback_work} rescued={self.rescued_digests}"
        )
        if self.speculative_depth or self.speculative_evictions:
            lines.append(
                f"  speculative: depth={self.speculative_depth} "
                f"evictions={self.speculative_evictions}"
            )
        if self.breaker is not None:
            b = self.breaker
            lines.append(
                f"  breaker: {b.state} "
                f"(consecutive_failures={b.consecutive_failures}, "
                f"trips={b.trips}, probes={b.probes}, "
                f"{b.successes} ok / {b.failures} failed)"
            )
        return "\n".join(lines)


def crypto_plane_status(plane) -> CryptoPlaneStatus:
    """Snapshot a testengine crypto plane (CoalescingHashPlane,
    AsyncKernelHashPlane, SignaturePlane, AsyncSignaturePlane, or
    SpeculativeSignaturePlane)."""
    breaker = getattr(plane, "breaker", None)
    breaker_status = None
    if breaker is not None:
        breaker_status = BreakerStatus(
            state=breaker.state,
            consecutive_failures=breaker.consecutive_failures,
            failures=breaker.failures,
            successes=breaker.successes,
            trips=breaker.trips,
            probes=breaker.probes,
        )
    return CryptoPlaneStatus(
        plane=type(plane).__name__,
        flushes=len(plane.flush_sizes),
        device_errors=getattr(plane, "device_errors", 0),
        device_timeouts=getattr(plane, "device_timeouts", 0),
        fallback_work=getattr(plane, "fallback_digests", 0)
        or getattr(plane, "fallback_verifies", 0),
        rescued_digests=getattr(plane, "rescued_digests", 0),
        speculative_depth=getattr(plane, "speculative_depth", 0),
        speculative_evictions=getattr(plane, "speculative_evictions", 0),
        breaker=breaker_status,
    )


@dataclass
class MetricsStatus:
    """Snapshot of the obsv metrics registry, folded into the same
    to_json()/pretty() idiom as the tracker snapshots.  ``families`` is
    the registry's snapshot(): name -> {kind, help, series}."""

    enabled: bool
    families: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, default=str)

    def pretty(self) -> str:
        lines = ["=== Metrics ==="]
        if not self.enabled:
            lines.append("  (observability disabled)")
            return "\n".join(lines)
        if not self.families:
            lines.append("  (no metrics recorded)")
        for name, family in self.families.items():
            for entry in family["series"]:
                labels = entry["labels"]
                label_str = (
                    "{"
                    + ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                    + "}"
                    if labels
                    else ""
                )
                if family["kind"] == "histogram":
                    count = entry["count"]
                    mean = entry["sum"] / count if count else 0.0
                    lines.append(
                        f"  {name}{label_str}: count={count} mean={mean:.6f}"
                    )
                else:
                    lines.append(f"  {name}{label_str}: {entry['value']}")
        return "\n".join(lines)


def metrics_status(registry=None) -> MetricsStatus:
    """Snapshot an obsv Registry (default: the hooks-installed one)."""
    from .obsv import hooks

    if registry is None:
        registry = hooks.metrics
    if registry is None:
        return MetricsStatus(enabled=False)
    return MetricsStatus(enabled=True, families=registry.snapshot())


def pretty(status: StateMachineStatus) -> str:
    """ASCII dashboard (reference: status/status.go:141-296)."""
    lines = [
        "===========================================",
        f"NodeID={status.node_id}, "
        f"LowWatermark={status.low_watermark}, "
        f"HighWatermark={status.high_watermark}, "
        f"Epoch={status.epoch_tracker.number if status.epoch_tracker else '?'} "
        f"({status.epoch_tracker.state if status.epoch_tracker else '?'})",
        "===========================================",
        "",
    ]
    if status.network_config is not None:
        nc = status.network_config
        retired = " RETIRED" if nc.retired else ""
        lines.append("=== Network Config ===")
        lines.append(
            f"  epoch {nc.epoch} @seq {nc.first_seq}: nodes={nc.nodes} "
            f"f={nc.f} buckets={nc.number_of_buckets} "
            f"ci={nc.checkpoint_interval}{retired}"
        )
        lines.append(
            f"  reconfigs: pending={nc.pending_reconfigurations} "
            f"adopted={nc.reconfigs_adopted}"
        )
        lines.append("")
    if status.buckets:
        lines.append("=== Buckets ===")
        lines.append("  (.=unalloc a=alloc q=pending r=ready "
                     "Q=preprepared P=prepared C=committed)")
        for bucket in status.buckets:
            marker = "*" if bucket.leader else " "
            lines.append(
                f"  {marker}bucket {bucket.id}: {''.join(bucket.sequences)}"
            )
        if status.bucket_backlog:
            lines.append(
                "  backlog: "
                + " ".join(str(n) for n in status.bucket_backlog)
                + f"  (imbalance max/median {status.bucket_imbalance:.2f})"
            )
        lines.append("")
    if status.checkpoints:
        lines.append("=== Checkpoints ===")
        for cp in status.checkpoints:
            flags = "".join(
                c
                for c, on in (
                    ("N", cp.net_quorum),
                    ("L", cp.local_decision),
                    ("S", cp.stable),
                )
                if on
            )
            lines.append(
                f"  seq {cp.seq_no}: agreements={cp.max_agreements} [{flags}]"
            )
        lines.append("")
    if status.client_windows:
        lines.append("=== Clients ===")
        lines.append("  (A=acked W=weak S=strong R=ready C=committed)")
        for client in status.client_windows:
            window = "".join(c or "_" for c in client.allocated)
            lines.append(
                f"  client {client.client_id} "
                f"[{client.low_watermark}..{client.high_watermark}] "
                f"ready@{client.next_ready_mark}: {window}"
            )
        lines.append("")
    if status.epoch_tracker:
        et = status.epoch_tracker
        if et.epoch_changes or et.echos or et.readies or et.suspicions:
            lines.append("=== Epoch Transition ===")
            for ec in et.epoch_changes:
                lines.append(f"  change from {ec.source}: {ec.msgs}")
            if et.echos:
                lines.append(f"  echos: {et.echos}")
            if et.readies:
                lines.append(f"  readies: {et.readies}")
            if et.suspicions:
                lines.append(f"  suspicions: {et.suspicions}")
    return "\n".join(lines)
