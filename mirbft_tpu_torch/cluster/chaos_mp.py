"""Chaos scenarios against a real multi-process cluster.

``run_mp_scenario`` is the ``--cluster mp`` lowering of
``chaos.live.run_live_scenario``: the same ``Scenario`` schema, the same
invariant checkers, but each node is a separate OS process under
``ClusterSupervisor``.  Crash points become SIGKILL (true kill -9, not
the in-process approximation), restarts respawn the worker from its
on-disk WAL/reqstore on the same port, and partition windows cut the
supervisor's socket proxies.

Evidence is read from the outside only — the supervisor tails each
node's fsynced app.log — so the audit holds exactly what a crashed
process left on disk, with no in-process shortcuts.

The client load doubles as a retry storm: every request is submitted to
*every* live node, and uncommitted requests are re-submitted on a short
period until convergence.  Request dedup (the client-window watermarks)
must absorb all of it; ``check_no_fork`` fails any scenario in which a
``(client_id, req_no)`` pair commits twice on any node, and the
dedicated ``retry-storm-dedup`` scenario additionally asserts the
exactly-once count while reporting how many duplicate submissions the
cluster absorbed.

Not every live-scenario feature lowers to processes: storage-fault
injection and signed mode need in-process seams, and ``drop_pct``'s
``TransportFault`` lives inside each worker — scenarios using those are
rejected rather than silently weakened.

Every worker runs ``processor`` (``cuda`` by default: each Actions
batch's digests in one launch of the SHA-256 kernel) on ``device``
(``cuda`` unless the caller asks for ``cpu``, the kernel's plain
version).  Each result reports every worker's kernel evidence, read from
its node directory at teardown: ``digest_launches`` (the processor's
launches, summed over the node's incarnations), ``hash_flushes``
(``mirbft_crypto_flush_total{plane="hash",path="device"}`` of its last
graceful stop's ``metrics.json``), ``host_digests`` and
``launches_sha256`` (the kernel wrapper's count in the workers, each
summed over every node), ``log_faults`` (the lines of a traceback or of
a worker's "died"/"failed" report in the workers' logs), ``exit_codes``
and ``worker_faults`` (each exit the supervisor did not cause: not 0
after a SIGTERM, not -9 after a crash's SIGKILL).  A worker fault, a
log fault or a host digest fails the scenario whatever the invariants
found.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from types import SimpleNamespace

from .. import pb
from ..app.service import KvClient
from ..chaos.invariants import (
    CrashSnapshot,
    InvariantViolation,
    check_bounded_catchup,
    check_bounded_recovery,
    check_commit_resumption,
    check_config_agreement,
    check_durable_prefix,
    check_linearizable_reads,
    check_no_fork,
)
from ..ops.batching import resolve_device
from ..runtime.reconfig import encode_reconfig_request
from ..chaos.live import MIN_RECOVERY_BOUND_MS, SIM_TICK_MS
from ..chaos.runner import CampaignResult, ScenarioResult
from ..chaos.scenarios import (
    NodeJoin,
    NodeRemoval,
    PartitionWindow,
    Scenario,
    live_smoke_matrix,
)
from .supervisor import ClusterSupervisor
from .worker import read_json

DEFAULT_PROCESSOR = "cuda"

# The mp acceptance pair: a true kill -9 + restart-from-disk, and a
# proxied minority partition with heal — plus the dedup storm.
MP_SMOKE_NAMES = ("crash-restart", "partition-minority")

# The KV-app chaos pair: the same two disruption families with the
# replicated KV state machine installed and live client sessions
# recording an op history that check_linearizable_reads audits.
KV_MP_SMOKE_NAMES = ("kv-crash-restart", "kv-partition-minority")


def kv_mp_matrix() -> list:
    """Crash-restart and partition-minority with the KV app installed:
    ``notes={"app": "kv"}`` makes the driver spawn KV client sessions
    whose recorded read/write history is audited for linearizable
    reads after convergence (docs/APP.md)."""
    base = {s.name: s for s in live_smoke_matrix()}
    out = []
    for name in MP_SMOKE_NAMES:
        src = base[name]
        out.append(
            Scenario(
                name=f"kv-{name}",
                description=f"{src.description} — with the replicated KV "
                "app and linearizable-read audit",
                partitions=src.partitions,
                crashes=src.crashes,
                notes={"app": "kv", "kv_sessions": 2, "kv_ops": 24},
                tags=("kv",) + tuple(src.tags),
            )
        )
    return out


def retry_storm_scenario() -> Scenario:
    """No faults, maximum client hostility: every request submitted to
    every node and re-submitted aggressively until the cluster converges.
    The pass condition is exactly-once commitment everywhere."""
    return Scenario(
        name="retry-storm-dedup",
        description=(
            "duplicate-heavy open retry storm; dedup must absorb every "
            "resubmission"
        ),
        node_count=4,
        client_count=2,
        reqs_per_client=6,
    )


def join_under_partition_scenario() -> Scenario:
    """Reconfiguration under fire, the add-node half: a 5th provisioned
    member is spawned against the running 4-node cluster mid-run, and a
    partition then strands it with only part of the mesh while it is
    still catching up.  The joiner holds no log — the only way it can
    reach the commit frontier is a real snapshot fetch over the
    transport's transfer lane, verified against a 2f+1 checkpoint
    certificate.  The audit demands exactly that: bounded catch-up AND
    ``snapshots_installed >= 1`` in the joiner's published engine
    counters, so live replay can never quietly stand in for transfer."""
    return Scenario(
        name="join-under-partition",
        description=(
            "5th member joins a running cluster mid-traffic, then a "
            "partition strands it with a minority; it must fetch a "
            "certified snapshot over the real transport and reach the "
            "frontier within the catch-up bound"
        ),
        node_count=5,
        client_count=2,
        reqs_per_client=6,
        joins=(NodeJoin(at_ms=4000, node=4, catchup_bound_ms=150_000),),
        # Sim-ms scale to wall: x * tick/500.  The cut lands well after
        # the (blocking, process-spawn) join returns, mid catch-up; the
        # heal leaves the survivors a full traffic tail to converge on.
        partitions=(
            PartitionWindow(
                groups=((0, 1, 4), (2, 3)),
                from_ms=31_250,
                until_ms=68_750,
            ),
        ),
        # Shrink the checkpoint window so the joiner falls a certified
        # checkpoint behind quickly (identical in every worker spec, so
        # fresh boots stay deterministic).
        notes={"checkpoint_interval": 5},
        tags=("mp", "reconfig"),
    )


def remove_under_partition_scenario() -> Scenario:
    """The remove-node half: node 3 is first partitioned away, then
    permanently removed (true kill -9, never restarted) while the
    majority side keeps committing.  The survivors must converge, and
    the corpse's durable log must remain a clean prefix of theirs."""
    return Scenario(
        name="remove-under-partition",
        description=(
            "node 3 is isolated, then permanently removed mid-window; "
            "the 3-node majority keeps committing and the removed "
            "node's durable log stays a clean prefix"
        ),
        node_count=4,
        client_count=2,
        reqs_per_client=6,
        partitions=(
            PartitionWindow(
                groups=((0, 1, 2), (3,)), from_ms=12_500, until_ms=50_000
            ),
        ),
        removes=(NodeRemoval(at_ms=25_000, node=3),),
        tags=("mp", "reconfig"),
    )


def reconfig_add_under_partition_scenario() -> Scenario:
    """Dynamic membership, the add half: the 4 incumbents boot with a
    genesis config that does NOT include node 4.  An admin client then
    submits a ``pb.Reconfiguration`` carrying the grown 5-node config
    through the ordered broadcast; only once an incumbent's published
    reconfig counters show the config *adopted* (stable reconfigured
    checkpoint) does the driver spawn node 4 — booted with the exact
    target config the committed op carried, never a static roster.  A
    2-2 incumbent partition spans the config flip: while it holds no
    quorum exists, so adoption itself must ride out the cut.  The
    joiner still owes the usual evidence: bounded catch-up plus
    ``snapshots_installed >= 1``, and ``check_config_agreement`` audits
    every certified checkpoint config byte-for-byte across nodes."""
    return Scenario(
        name="reconfig-add-under-partition",
        description=(
            "a committed Reconfiguration grows the cluster 4 -> 5 while "
            "a 2-2 incumbent partition spans the config flip; node 4 "
            "joins only after adoption, catches up via certified "
            "snapshot, and no two nodes ever certify divergent configs"
        ),
        node_count=5,
        client_count=2,
        reqs_per_client=6,
        joins=(
            NodeJoin(
                at_ms=2000,
                node=4,
                catchup_bound_ms=150_000,
                via_reconfig=True,
            ),
        ),
        partitions=(
            PartitionWindow(
                groups=((0, 1), (2, 3, 4)),
                from_ms=12_500,
                until_ms=37_500,
            ),
        ),
        notes={"checkpoint_interval": 5},
        recovery_bound_ms=300_000,
        tags=("mp", "reconfig"),
    )


def reconfig_remove_leader_crash_scenario() -> Scenario:
    """Dynamic membership, the remove half: leader 3 is killed (true
    kill -9, never restarted) and the survivors commit a
    ``pb.Reconfiguration`` shrinking the config to exclude it.  The
    3-node quorum must first ride the leader crash (epoch change to
    strip the dead leader's buckets), then adopt the shrunk config at a
    stable checkpoint and keep committing under it — the departure is a
    membership change the protocol agrees on, not just a silent hole in
    the mesh.  The corpse's durable log must stay a clean prefix, and
    ``check_config_agreement`` holds every shared checkpoint config
    byte-identical across survivors and corpse alike."""
    return Scenario(
        name="reconfig-remove-leader-crash",
        description=(
            "leader 3 crashes for good and the survivors commit a "
            "Reconfiguration removing it; commits resume under the "
            "adopted 3-node config within the liveness bound"
        ),
        node_count=4,
        client_count=2,
        reqs_per_client=6,
        removes=(NodeRemoval(at_ms=12_500, node=3, via_reconfig=True),),
        notes={"checkpoint_interval": 5},
        recovery_bound_ms=300_000,
        tags=("mp", "reconfig"),
    )


MP_RECONFIG_NAMES = (
    "join-under-partition",
    "remove-under-partition",
    "reconfig-add-under-partition",
    "reconfig-remove-leader-crash",
)


def mp_reconfig_matrix() -> list:
    """The reconfiguration-under-fire set (mp-only: joining means
    spawning a real OS process against a live mesh): the static-roster
    pair, then the committed-Reconfiguration pair."""
    return [
        join_under_partition_scenario(),
        remove_under_partition_scenario(),
        reconfig_add_under_partition_scenario(),
        reconfig_remove_leader_crash_scenario(),
    ]


def _reconfig_target(scenario: Scenario) -> tuple:
    """The (incumbent, target) config dicts for a via_reconfig scenario.

    The incumbent config is the genesis every booted member starts
    from: the provisioned node set minus deferred joiners.  The target
    is what the committed ``pb.Reconfiguration`` carries: plus the
    joiners, minus the removed.  Bucket count is pinned to the
    incumbent width so the request->bucket mapping survives the flip."""
    nodes = list(range(scenario.node_count))
    joining = {j.node for j in scenario.joins if j.via_reconfig}
    removing = {r.node for r in scenario.removes if r.via_reconfig}
    incumbents = [n for n in nodes if n not in joining]
    target = [n for n in nodes if n not in removing]
    buckets = len(incumbents)
    ci = int(scenario.notes.get("checkpoint_interval") or 5 * buckets)
    mel = 10 * ci

    def cfg(members: list) -> dict:
        return {
            "nodes": list(members),
            "f": (len(members) - 1) // 3,
            "number_of_buckets": buckets,
            "checkpoint_interval": ci,
            "max_epoch_length": mel,
        }

    return cfg(incumbents), cfg(target)


def mp_matrix() -> list:
    """Scenarios run under ``chaos --live --cluster mp``."""
    by_name = {s.name: s for s in live_smoke_matrix()}
    return (
        [by_name[name] for name in MP_SMOKE_NAMES]
        + [retry_storm_scenario()]
        + mp_reconfig_matrix()
    )


def mp_adversary_matrix() -> list:
    """The mp lowering of the adversary campaign: attacks driven at the
    client seam (duplication floods through real submission sockets).
    Wire-level adversaries need the threads cluster's frame-rewriting
    proxies and are rejected here."""
    from ..chaos.scenarios import live_adversary_matrix

    return [
        scenario
        for scenario in live_adversary_matrix()
        if _mp_supported_adversaries(scenario)
        and not scenario.signed
        and scenario.network_state is None
    ]


def _mp_supported_adversaries(scenario: Scenario) -> bool:
    return bool(scenario.adversaries) and all(
        spec.kind == "flood" and spec.msg_kinds == ("Propose",)
        for spec in scenario.adversaries
    )


def _reject_unsupported(scenario: Scenario) -> None:
    unsupported = []
    if scenario.storage_faults:
        unsupported.append("storage_faults")
    if scenario.signed:
        unsupported.append("signed")
    if scenario.drop_pct:
        unsupported.append("drop_pct")
    if scenario.adversaries and not _mp_supported_adversaries(scenario):
        unsupported.append("non-flood adversaries")
    if unsupported:
        raise ValueError(
            f"scenario {scenario.name!r} uses {', '.join(unsupported)}, "
            "which need in-process seams; run it under --cluster threads"
        )


class _MpDriver:
    """One scenario against one multi-process cluster."""

    def __init__(
        self,
        scenario: Scenario,
        tick_seconds: float,
        budget_s: float,
        max_reqs_per_client: int,
        processor: str,
        retry_period_s: float = 0.3,
        seed: int = 0,
        device: str = "cuda",
    ):
        self.scenario = scenario
        # Propose-flood adversaries lower to multiplied submissions
        # through the real client sockets (seeded, windowed); everything
        # else was rejected by _reject_unsupported.
        self.flood_specs = list(scenario.adversaries)
        self.flooded = 0
        self._rng = random.Random(seed)
        self.tick_seconds = tick_seconds
        self.budget_s = budget_s
        self.reqs_per_client = min(
            scenario.reqs_per_client, max_reqs_per_client
        )
        self.clients = list(range(1, scenario.client_count + 1))
        self.retry_period_s = retry_period_s
        # KV-app mode (notes={"app": "kv"}): live client sessions drive
        # the replicated KV service alongside the raw proposer load and
        # record the op history check_linearizable_reads audits.  KV
        # sessions get consensus client ids above the raw clients'.
        self.app = scenario.notes.get("app")
        self.kv_ops = int(scenario.notes.get("kv_ops", 24))
        kv_sessions = (
            int(scenario.notes.get("kv_sessions", 2))
            if self.app == "kv"
            else 0
        )
        kv_base = max(self.clients, default=0) + 1
        self.kv_client_ids = list(range(kv_base, kv_base + kv_sessions))
        # Dynamic membership (via_reconfig joins/removes): the admin
        # client submits the target config through the ordered
        # broadcast; incumbents boot with a genesis that excludes the
        # joiners, so the only way the member set can change is the
        # committed pb.Reconfiguration.
        self.reconfig_incumbent = None
        self.reconfig_target = None
        self.reconfig_payload = None
        self.admin_client_id = None
        admin_ids: list = []
        if any(j.via_reconfig for j in scenario.joins) or any(
            r.via_reconfig for r in scenario.removes
        ):
            self.reconfig_incumbent, self.reconfig_target = _reconfig_target(
                scenario
            )
            self.reconfig_payload = encode_reconfig_request(
                [
                    pb.Reconfiguration(
                        type=pb.NetworkConfig(
                            nodes=list(self.reconfig_target["nodes"]),
                            f=self.reconfig_target["f"],
                            number_of_buckets=self.reconfig_target[
                                "number_of_buckets"
                            ],
                            checkpoint_interval=self.reconfig_target[
                                "checkpoint_interval"
                            ],
                            max_epoch_length=self.reconfig_target[
                                "max_epoch_length"
                            ],
                        )
                    )
                ]
            )
            self.admin_client_id = (
                max(self.clients + self.kv_client_ids, default=0) + 1
            )
            admin_ids = [self.admin_client_id]
        self.reconfig_submitted = False
        self._last_reconfig_submit = 0.0
        self._adopted_nodes: set = set()  # cached adoption observations
        self.pending_reconfig_joins: dict = {}  # node -> NodeJoin
        self.supervisor = ClusterSupervisor(
            node_count=scenario.node_count,
            client_ids=self.clients + self.kv_client_ids + admin_ids,
            batch_size=scenario.batch_size,
            processor=processor,
            tick_seconds=tick_seconds,
            proxied=bool(scenario.partitions),
            deferred_nodes=tuple(j.node for j in scenario.joins),
            checkpoint_interval=scenario.notes.get("checkpoint_interval"),
            network_config=self.reconfig_incumbent,
            app=self.app,
            device=device,
        )
        self.expected = {
            (client_id, req_no)
            for client_id in self.clients
            for req_no in range(self.reqs_per_client)
        }
        # The dedup scenario must not depend on racing the commit path:
        # every first-pass submission is itself repeated, so duplicates
        # reach the cluster even when it converges before a retry fires.
        self.storm_repeat = 3 if scenario.name == "retry-storm-dedup" else 1
        self._start = None
        # Clear while a worker boots (``_booting``): the fault clock is
        # stopped and the proposer's first pass waits.
        self._clock_running = threading.Event()
        self._clock_running.set()
        self.down: set = set()  # crashed, restart still pending
        self.removed: set = set()  # permanently removed, never restarted
        self.pending_joins: set = {j.node for j in scenario.joins}
        self.join_times_ms: dict = {}  # node -> wall ms the join fired
        self.catchup_times_ms: dict = {}  # node -> first frontier evidence
        self.snapshots: list = []
        self.commit_times_ms: list = []
        self.heal_times_ms: list = []
        self.events_fired = 0
        self.resubmissions = 0
        self._proposer_stop = threading.Event()
        self._proposer = None
        self.kv_history: list = []
        self._kv_stop = threading.Event()
        self._kv_done = threading.Event()
        self._kv_thread = None

    # -- time ----------------------------------------------------------------

    def scale_s(self, sim_ms: int) -> float:
        return sim_ms / SIM_TICK_MS * self.tick_seconds

    def now_ms(self) -> int:
        return int((time.monotonic() - self._start) * 1000)

    def _booting(self, boot, *args, **kwargs):
        """Run ``boot`` (a join or restart: it blocks until the worker
        process is ready) with the fault clock and the proposer's first
        pass stopped.  A port worker opens a CUDA context before it is
        ready (~10 s on an H100's host, ~3 s without a card); with the clock
        running, the JAX driver's blocking join would push the scenario's
        later faults past the end of its traffic (``join-under-partition``
        healed after its last commit and failed "no commits at all after
        the heal", ROADMAP queue 3).  The budget stays wall clock."""
        self._clock_running.clear()
        began = time.monotonic()
        try:
            return boot(*args, **kwargs)
        finally:
            self._start += time.monotonic() - began
            self._clock_running.set()

    # -- client load ---------------------------------------------------------

    def _flood_copies(self) -> int:
        """Extra duplicate submissions the flood adversaries inject for
        one delivery right now (0 when no window is open)."""
        if self._start is None:
            return 0
        now_s = time.monotonic() - self._start
        copies = 0
        for spec in self.flood_specs:
            if now_s < self.scale_s(spec.from_ms):
                continue
            if spec.until_ms is not None and now_s >= self.scale_s(
                spec.until_ms
            ):
                continue
            if (
                spec.rate_pct < 100
                and self._rng.random() * 100.0 >= spec.rate_pct
            ):
                continue
            copies += spec.copies
        return copies

    def _submit(self, client_id: int, req_no: int, first: bool) -> None:
        request = pb.Request(
            client_id=client_id, req_no=req_no, data=b"%d" % req_no
        )
        repeat = self.storm_repeat if first else 1
        for round_no in range(repeat):
            for node_id in self.supervisor.alive_nodes():
                self.supervisor.submit(node_id, request)
                if not first or round_no > 0:
                    self.resubmissions += 1
                copies = self._flood_copies() if self.flood_specs else 0
                for _ in range(copies):
                    self.supervisor.submit(node_id, request)
                self.flooded += copies

    def _propose_all(self, last_event_s: float) -> None:
        ordered = sorted(self.expected)
        # Pace the first pass past the final fault instant so every
        # disruption lands mid-traffic (see LiveCluster._propose_all).
        span_s = max(last_event_s * 1.25, 0.4)
        gap = span_s / max(len(ordered), 1)
        for index, (client_id, req_no) in enumerate(ordered):
            # On the fault clock: the pass stops while a worker boots.
            while self.now_ms() < (index + 1) * gap * 1000:
                if self._proposer_stop.wait(0.005):
                    return
                self._clock_running.wait()
            self._submit(client_id, req_no, first=True)
        # The retry storm: keep re-submitting whatever a node has not yet
        # committed; watermark dedup must absorb all of it.
        while not self._proposer_stop.wait(self.retry_period_s):
            committed = set()
            for handle in self.supervisor.nodes:
                committed |= {(c, q) for c, q, _s in handle.commits}
            for client_id, req_no in ordered:
                if (client_id, req_no) not in committed:
                    self._submit(client_id, req_no, first=False)

    # -- KV app sessions -----------------------------------------------------

    def _drive_kv(self) -> None:
        """Drive the KV service with live sessions through the whole run:
        per-session threads alternate puts and committed-mode gets over a
        small shared key space (so read/write intervals overlap — the
        checker's vacuity guard), refreshing service addresses every op
        round so restarted workers' re-bound ports are picked up."""
        addresses: dict = {}
        while not self._kv_stop.is_set():
            addresses = self.supervisor.app_addresses()
            if addresses:
                break
            time.sleep(0.05)
        if not addresses:
            self._kv_done.set()
            return
        homes = sorted(addresses)
        lock = threading.Lock()
        # Lockstep rounds: a disruption can stall one session for whole
        # seconds while its peer races ahead, desyncing the parities
        # below until no read interval overlaps any write.  The barrier
        # keeps every round's read and write concurrent by construction.
        barrier = threading.Barrier(len(self.kv_client_ids))

        def drive(index: int, client_id: int) -> None:
            session = KvClient(
                addresses, client_id, home=homes[index % len(homes)]
            )
            synced = True
            try:
                for op_no in range(self.kv_ops):
                    if synced:
                        try:
                            barrier.wait(timeout=20.0)
                        except threading.BrokenBarrierError:
                            synced = False  # a peer exited; run free
                    if self._kv_stop.is_set():
                        return
                    session.set_addresses(self.supervisor.app_addresses())
                    key = f"k{op_no % 4}"
                    # Opposite parities per session: at each op round one
                    # session writes the key the other is reading.
                    is_read = (op_no + index) % 2 == 1
                    value = b"%d:%d" % (client_id, op_no)
                    t0 = time.monotonic_ns()
                    try:
                        if is_read:
                            resp = session.get(key, timeout=3.0)
                        else:
                            resp = session.put(key, value, timeout=5.0)
                    except OSError:
                        resp = {"status": "error"}
                    t1 = time.monotonic_ns()
                    entry = {
                        "client_id": client_id,
                        "op": "get" if is_read else "put",
                        "key": key,
                        "invoke_ns": t0,
                        "return_ns": t1,
                        "outcome": resp.get("status", "error"),
                        "version": resp.get("version", 0),
                    }
                    if is_read:
                        if resp.get("status") == "ok":
                            entry["value"] = resp.get("value")
                    else:
                        entry["value"] = value.hex()
                    with lock:
                        self.kv_history.append(entry)
            finally:
                barrier.abort()  # never strand a peer at the barrier
                session.close()

        threads = [
            threading.Thread(
                target=drive,
                args=(index, client_id),
                name=f"chaos-kv-{client_id}",
                daemon=True,
            )
            for index, client_id in enumerate(self.kv_client_ids)
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        self._kv_done.set()

    # -- fault schedule ------------------------------------------------------

    def schedule(self) -> list:
        events = []
        for window in self.scenario.partitions:
            events.append(
                (self.scale_s(window.from_ms), 0, "cut", window.groups)
            )
            events.append(
                (self.scale_s(window.until_ms), 1, "heal", window.groups)
            )
        for point in self.scenario.crashes:
            events.append((self.scale_s(point.at_ms), 2, "crash", point.node))
            events.append(
                (
                    self.scale_s(point.at_ms + point.restart_delay_ms),
                    3,
                    "restart",
                    point.node,
                )
            )
        for join in self.scenario.joins:
            events.append((self.scale_s(join.at_ms), 4, "join", join.node))
        for removal in self.scenario.removes:
            events.append(
                (self.scale_s(removal.at_ms), 5, "remove", removal.node)
            )
        events.sort(key=lambda e: (e[0], e[1]))
        return events

    def _fire(self, kind: str, payload) -> None:
        if kind == "cut":
            self.supervisor.set_partition(payload, True)
        elif kind == "heal":
            self.supervisor.set_partition(payload, False)
            self.heal_times_ms.append(self.now_ms())
        elif kind == "crash":
            self.supervisor.poll_commits()
            self.snapshots.append(
                CrashSnapshot(
                    node=payload,
                    at_ms=self.now_ms(),
                    committed=list(self.supervisor.nodes[payload].commits),
                )
            )
            self.down.add(payload)
            self.supervisor.kill(payload, graceful=False)
        elif kind == "restart":
            self._booting(self.supervisor.restart, payload)
            self.down.discard(payload)
            self.heal_times_ms.append(self.now_ms())
        elif kind == "join":
            join = next(
                j for j in self.scenario.joins if j.node == payload
            )
            if join.via_reconfig:
                # Membership authority is the committed op: submit the
                # grown config now, spawn the node only once an
                # incumbent has *adopted* it (_service_reconfig).
                self.pending_reconfig_joins[payload] = join
                self._submit_reconfig()
            else:
                self._booting(self.supervisor.join_node, payload)
                self.join_times_ms[payload] = self.now_ms()
                # Joining is a disruption end: catch-up traffic starts
                # here.
                self.heal_times_ms.append(self.now_ms())
        elif kind == "remove":
            self.supervisor.poll_commits()
            self.snapshots.append(
                CrashSnapshot(
                    node=payload,
                    at_ms=self.now_ms(),
                    committed=list(self.supervisor.nodes[payload].commits),
                )
            )
            self.removed.add(payload)
            self.supervisor.kill(payload, graceful=False)
            # Removal is permanent; the survivors' recovery clock starts
            # at the removal instant.
            self.heal_times_ms.append(self.now_ms())
            removal = next(
                r for r in self.scenario.removes if r.node == payload
            )
            if removal.via_reconfig:
                # The survivors now agree the departure is a membership
                # change: commit the shrunk config through the normal
                # broadcast path.
                self._submit_reconfig()

    def _observe_catchup(self) -> None:
        """First non-empty app-chain on a joined node = it adopted the
        certified snapshot (or applied its first live batch) — the
        bounded-catchup clock's stop instant."""
        for node, _joined in self.join_times_ms.items():
            if node in self.catchup_times_ms:
                continue
            if self.supervisor.nodes[node].chain:
                self.catchup_times_ms[node] = self.now_ms()

    # -- dynamic membership --------------------------------------------------

    def _submit_reconfig(self) -> None:
        """Fire (or re-fire) the admin client's reconfiguration request
        at every live node.  Resubmission until adoption is deliberate:
        a partition or leader crash can eat the first copy, and the
        client-window dedup absorbs the duplicates."""
        if self.reconfig_payload is None:
            return
        request = pb.Request(
            client_id=self.admin_client_id,
            req_no=0,
            data=self.reconfig_payload,
        )
        for node_id in self.supervisor.alive_nodes():
            self.supervisor.submit(node_id, request)
        self.reconfig_submitted = True
        self._last_reconfig_submit = time.monotonic()

    def _reconfig_counters(self, node: int) -> dict:
        doc = read_json(
            os.path.join(self.supervisor.nodes[node].dir, "reconfig.json")
        )
        return doc if isinstance(doc, dict) else {}

    def _incumbent_nodes(self) -> list:
        """Members booted at cluster start (deferred joiners excluded)
        that are still supposed to be up."""
        return [
            n
            for n in range(self.scenario.node_count)
            if n not in self.pending_joins
            and n not in self.removed
            and n not in self.down
        ]

    def _poll_adoptions(self) -> None:
        for node in self._incumbent_nodes():
            if node in self._adopted_nodes:
                continue
            if int(self._reconfig_counters(node).get("adopted", 0)) >= 1:
                self._adopted_nodes.add(node)

    def _adoption_complete(self) -> bool:
        """Every live incumbent has activated the committed config (the
        convergence gate for via_reconfig scenarios — exiting before
        adoption would make check_config_agreement vacuous)."""
        incumbents = self._incumbent_nodes()
        return bool(incumbents) and all(
            n in self._adopted_nodes for n in incumbents
        )

    def _service_reconfig(self) -> None:
        """Drive the committed-membership-change lifecycle each loop
        turn: resubmit the admin request until some incumbent adopts,
        then spawn pending joiners with the exact target config the
        committed op carried."""
        if not self.reconfig_submitted:
            return
        self._poll_adoptions()
        if not self._adopted_nodes:
            if (
                time.monotonic() - self._last_reconfig_submit
                > self.retry_period_s
            ):
                self._submit_reconfig()
            return
        for node in sorted(self.pending_reconfig_joins):
            self._booting(
                self.supervisor.join_node,
                node,
                network_config=self.reconfig_target,
            )
            del self.pending_reconfig_joins[node]
            self.join_times_ms[node] = self.now_ms()
            # Joining is a disruption end: catch-up starts here.
            self.heal_times_ms.append(self.now_ms())

    def _read_checkpoints(self, node: int) -> list:
        """Every (seq_no, pb.NetworkState) the node certified into its
        checkpoints.jsonl, torn tail lines tolerated (the process may
        have been killed mid-write)."""
        path = os.path.join(
            self.supervisor.nodes[node].dir, "checkpoints.jsonl"
        )
        out = []
        try:
            with open(path, encoding="utf-8") as handle:
                for line in handle:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        record = json.loads(line)
                        state = pb.decode(
                            pb.NetworkState,
                            bytes.fromhex(record["state"]),
                        )
                        out.append((int(record["seq"]), state))
                    except (ValueError, KeyError, TypeError):
                        continue
        except OSError:
            return []
        return out

    def config_evidence(self, timeout_s: float = 15.0) -> tuple:
        """The ``check_config_agreement`` inputs, read from the outside:
        per-node certified checkpoint configs (checkpoints.jsonl), each
        survivor's newest certified config, and the total adoption count
        (reconfig.json).  Waits briefly for every survivor's newest
        checkpoint to carry the target member set — the post-adoption
        checkpoint trails the adoption boundary by one window, and the
        heartbeat keeps sequences trickling, so it lands shortly after
        convergence; a survivor that never gets there surfaces as a
        final-config divergence, which is exactly the violation."""
        target = sorted(self.reconfig_target["nodes"])
        survivors = [
            n
            for n in range(self.scenario.node_count)
            if n not in self.removed
            and n not in self.down
            and (n not in self.pending_joins or n in self.join_times_ms)
        ]
        deadline = time.monotonic() + timeout_s
        final_configs: dict = {}
        while time.monotonic() < deadline:
            final_configs = {}
            for node in survivors:
                entries = self._read_checkpoints(node)
                if not entries:
                    continue
                config = entries[-1][1].config
                if config is not None and sorted(config.nodes) == target:
                    final_configs[node] = pb.encode(config)
            if len(final_configs) == len(survivors):
                break
            time.sleep(0.2)
        # A survivor whose newest certified config never reached the
        # target set goes in as-is: divergence is the finding.
        for node in survivors:
            if node in final_configs:
                continue
            entries = self._read_checkpoints(node)
            if entries and entries[-1][1].config is not None:
                final_configs[node] = pb.encode(entries[-1][1].config)
        checkpoint_configs: dict = {}
        for node in range(self.scenario.node_count):
            if node in self.pending_joins and node not in self.join_times_ms:
                continue  # never booted
            checkpoint_configs[node] = {
                seq: pb.encode(state.config)
                for seq, state in self._read_checkpoints(node)
                if state.config is not None
            }
        adoptions = sum(
            int(self._reconfig_counters(node).get("adopted", 0))
            for node in survivors
        )
        return checkpoint_configs, final_configs, adoptions

    def _reap(self) -> None:
        for handle in self.supervisor.nodes:
            if handle.node_id in self.down or handle.node_id in self.removed:
                continue
            if handle.node_id in self.pending_joins and (
                handle.node_id not in self.join_times_ms
            ):
                continue  # deferred member not spawned yet
            if handle.process is not None and not handle.alive:
                raise InvariantViolation(
                    f"node {handle.node_id} process died without an "
                    f"injected crash (rc={handle.process.returncode}):\n"
                    f"{handle.log_tail()}"
                )

    def _converged(self) -> bool:
        if self.down:
            return False
        full = False
        chains = set()
        for handle in self.supervisor.nodes:
            if handle.node_id in self.removed:
                continue  # permanently gone; survivors carry the audit
            if not handle.alive:
                return False
            pairs = {(c, q) for c, q, _s in handle.commits}
            if self.expected <= pairs:
                full = True
            chains.add(handle.chain)
        return full and len(chains) == 1 and "" not in chains

    # -- the drive loop ------------------------------------------------------

    def run(self) -> int:
        self.supervisor.start()
        self._start = time.monotonic()
        events = self.schedule()
        last_event_s = events[-1][0] if events else 0.0
        self._proposer = threading.Thread(
            target=self._propose_all,
            args=(last_event_s,),
            name="chaos-mp-proposer",
            daemon=True,
        )
        self._proposer.start()
        if self.kv_client_ids:
            self._kv_thread = threading.Thread(
                target=self._drive_kv, name="chaos-mp-kv", daemon=True
            )
            self._kv_thread.start()
        deadline = self._start + self.budget_s
        while time.monotonic() < deadline:
            now_s = time.monotonic() - self._start
            while events and events[0][0] <= now_s:
                _at, _order, kind, payload = events.pop(0)
                self.events_fired += 1
                self._fire(kind, payload)
            if self.supervisor.poll_commits():
                self.commit_times_ms.append(self.now_ms())
            if self.join_times_ms:
                self._observe_catchup()
            if self.reconfig_submitted and (
                self.pending_reconfig_joins or not self._adoption_complete()
            ):
                self._service_reconfig()
            self._reap()
            if (
                not events
                and not self.pending_reconfig_joins
                and (
                    self.reconfig_payload is None
                    or self._adoption_complete()
                )
                and self._converged()
            ):
                return self.now_ms()
            time.sleep(0.02)
        commits = [len(h.commits) for h in self.supervisor.nodes]
        raise InvariantViolation(
            f"no convergence within the {self.budget_s:.0f}s budget "
            f"(per-node commits: {commits}, nodes down: {sorted(self.down)}, "
            f"events unfired: {len(events)})"
        )

    def evidence(self) -> SimpleNamespace:
        self.supervisor.poll_commits()
        return SimpleNamespace(
            node_count=self.scenario.node_count,
            node_states=[
                SimpleNamespace(
                    committed_reqs=list(handle.commits),
                    app_chain=handle.chain,
                    crashed=handle.node_id in self.removed,
                )
                for handle in self.supervisor.nodes
            ],
        )

    def transfer_counters(self, node: int) -> dict:
        """The engine evidence a worker last published to its
        transfer.json (empty when the file never appeared)."""
        doc = read_json(
            os.path.join(self.supervisor.nodes[node].dir, "transfer.json")
        )
        if not doc:
            return {}
        counters = doc.get("counters", {})
        return counters if isinstance(counters, dict) else {}

    def wait_transfer_evidence(self, node: int, timeout_s: float = 3.0) -> dict:
        """Counters once they show an installed/resumed snapshot, or the
        last observation after ``timeout_s``.  Workers publish on a 0.5s
        cadence, so convergence (detected from the fsynced app.log) can
        race a hair ahead of the final counter publish."""
        deadline = time.monotonic() + timeout_s
        counters = self.transfer_counters(node)
        while time.monotonic() < deadline:
            installed = int(counters.get("snapshots_installed", 0)) + int(
                counters.get("snapshots_resumed_staged", 0)
            )
            if installed >= 1:
                break
            time.sleep(0.05)
            counters = self.transfer_counters(node)
        return counters

    def teardown(self) -> None:
        self._proposer_stop.set()
        self._kv_stop.set()
        if self._proposer is not None and self._proposer.ident is not None:
            self._proposer.join(timeout=10)
        if self._kv_thread is not None and self._kv_thread.ident is not None:
            self._kv_thread.join(timeout=15)
        self.supervisor.teardown()


def _record_kernel_evidence(result: ScenarioResult, supervisor) -> None:
    """Every worker's kernel evidence, gathered by the supervisor's
    teardown, into the result's counters (one entry a node)."""
    evidence = [
        supervisor.evidence.get(handle.node_id, {})
        for handle in supervisor.nodes
    ]
    result.counters["digest_launches"] = [
        e.get("launches", 0) for e in evidence
    ]
    result.counters["hash_flushes"] = [
        e.get("flushes", {}).get("hash/device", 0) for e in evidence
    ]
    result.counters["host_digests"] = sum(
        e.get("host_digests", 0) for e in evidence
    )
    result.counters["launches_sha256"] = sum(
        e.get("launches_sha256", 0) for e in evidence
    )
    result.counters["log_faults"] = [
        f"node {node}: {line}"
        for node, e in enumerate(evidence)
        for line in e.get("log_faults", [])
    ]
    result.counters["exit_codes"] = [
        codes for _node, codes in sorted(supervisor.exit_codes().items())
    ]
    result.counters["worker_faults"] = supervisor.worker_faults()


def _worker_violations(counters: dict) -> list:
    """What the workers did wrong whatever the invariants say: an exit
    the supervisor did not cause, a fault in a worker's log, a digest
    made on the host."""
    faults = counters["worker_faults"] + counters["log_faults"]
    if counters["host_digests"]:
        faults.append(f"{counters['host_digests']} digests made on the host")
    return faults


def run_mp_scenario(
    scenario: Scenario,
    seed: int = 0,
    tick_seconds: float = 0.04,
    budget_s: float = 180.0,
    max_reqs_per_client: int = 8,
    processor: str = DEFAULT_PROCESSOR,
    device: str = "cuda",
) -> ScenarioResult:
    """Execute one scenario against a real multi-process cluster and
    audit every invariant; violations are reported in the result, never
    raised (harness bugs still propagate)."""
    _reject_unsupported(scenario)
    resolve_device(device)  # without a card, raise before any spawn
    result = ScenarioResult(name=scenario.name, seed=seed, passed=False)
    driver = _MpDriver(
        scenario,
        tick_seconds,
        budget_s,
        max_reqs_per_client,
        processor,
        seed=seed,
        device=device,
    )
    try:
        try:
            converged_ms = driver.run()
            heals = driver.heal_times_ms
            last_heal = max(heals) if heals else 0
            bound_ms = max(
                int(driver.scale_s(scenario.recovery_bound_ms) * 1000),
                MIN_RECOVERY_BOUND_MS,
            )
            result.counters["recovery_ms"] = converged_ms - last_heal
            check_bounded_recovery(converged_ms, last_heal, bound_ms)
            if heals:
                check_commit_resumption(
                    driver.commit_times_ms, last_heal, bound_ms
                )
            evidence = driver.evidence()
            check_no_fork(evidence)
            check_durable_prefix(evidence, driver.snapshots)
            for join in scenario.joins:
                joined_ms = driver.join_times_ms.get(join.node)
                if joined_ms is None:
                    raise InvariantViolation(
                        f"join of node {join.node} never fired inside "
                        "the run window"
                    )
                caught_ms = driver.catchup_times_ms.get(join.node)
                catchup_bound = max(
                    int(driver.scale_s(join.catchup_bound_ms) * 1000),
                    MIN_RECOVERY_BOUND_MS,
                )
                if caught_ms is not None:
                    result.counters["catchup_ms"] = caught_ms - joined_ms
                check_bounded_catchup(joined_ms, caught_ms, catchup_bound)
                # The joiner must have reached the frontier by *state
                # transfer*, not by quietly replaying live traffic — a
                # fresh process that joined mid-run has no log to replay,
                # so zero installed snapshots means the scenario proved
                # nothing about the transfer path.
                counters = driver.wait_transfer_evidence(join.node)
                installed = int(
                    counters.get("snapshots_installed", 0)
                ) + int(counters.get("snapshots_resumed_staged", 0))
                result.counters["snapshots_installed"] = installed
                if installed <= 0:
                    raise InvariantViolation(
                        f"joined node {join.node} reached the frontier "
                        "without installing a snapshot (vacuous join "
                        f"scenario; engine counters: {counters})"
                    )
            if driver.reconfig_payload is not None:
                # Dynamic membership audit: adoption actually happened
                # (vacuity guard), no two nodes ever certified divergent
                # configs at the same checkpoint, and every survivor
                # converged to the committed target config.
                (
                    checkpoint_configs,
                    final_configs,
                    adoptions,
                ) = driver.config_evidence()
                agreement = check_config_agreement(
                    checkpoint_configs, final_configs, adoptions
                )
                result.counters["reconfig_adoptions"] = adoptions
                result.counters["config_checkpoints"] = agreement[
                    "checkpoints_compared"
                ]
            if scenario.notes.get("app") == "kv":
                # The user-visible claim: reads through the KV service
                # never go backwards or observe forks, even across the
                # injected crash/partition (vacuity-guarded inside).
                # KV op budgets are deliberately NOT part of convergence
                # (they would inflate the recovery clock); the cluster is
                # still up here, so let the sessions finish first.
                if not driver._kv_done.wait(timeout=60.0):
                    raise InvariantViolation(
                        "KV sessions failed to finish their op budget "
                        "within 60s of consensus convergence"
                    )
                tally = check_linearizable_reads(driver.kv_history)
                result.counters["kv_reads"] = tally["reads"]
                result.counters["kv_writes"] = tally["writes"]
                result.counters["kv_overlaps"] = tally["overlaps"]
            if scenario.removes:
                result.counters["removed"] = len(scenario.removes)
            if driver.flood_specs:
                result.counters["flooded"] = driver.flooded
                if driver.flooded <= 0:
                    raise InvariantViolation(
                        "flood scenario injected no duplicate submissions "
                        "(vacuous)"
                    )
            if scenario.name == "retry-storm-dedup" or driver.flood_specs:
                if (
                    scenario.name == "retry-storm-dedup"
                    and driver.resubmissions == 0
                ):
                    raise InvariantViolation(
                        "the retry storm never submitted a duplicate — "
                        "the scenario proved nothing"
                    )
                # Exactly-once, strictly: neither the storm nor the flood
                # may inflate any node's log past one commit per unique
                # request.
                for state in evidence.node_states:
                    pairs = [(c, q) for c, q, _s in state.committed_reqs]
                    extra = len(pairs) - len(driver.expected)
                    if extra > 0:
                        raise InvariantViolation(
                            f"duplicate storm leaked {extra} duplicate "
                            "commits into a node's log"
                        )
                if scenario.name == "retry-storm-dedup":
                    result.counters["resubmissions"] = driver.resubmissions
            result.passed = True
        except InvariantViolation as violation:
            result.violation = str(violation)
        result.events = driver.events_fired
        result.sim_ms = driver.now_ms() if driver._start is not None else 0
        result.commits = sum(
            len(handle.commits) for handle in driver.supervisor.nodes
        )
        if driver.snapshots:
            result.counters["crashes"] = len(driver.snapshots)
    finally:
        driver.teardown()
    _record_kernel_evidence(result, driver.supervisor)
    faults = _worker_violations(result.counters)
    if faults:
        result.passed = False
        prior = [result.violation] if result.violation else []
        result.violation = "; ".join(prior + faults)
    return result


def run_mp_campaign(
    scenarios: list | None = None,
    seed: int = 0,
    tick_seconds: float = 0.04,
    budget_s: float = 180.0,
    processor: str = DEFAULT_PROCESSOR,
    device: str = "cuda",
) -> CampaignResult:
    """Run a scenario list (default: the mp matrix) against real
    multi-process clusters, one at a time."""
    if scenarios is None:
        scenarios = mp_matrix()
    campaign = CampaignResult(seed=seed)
    for index, scenario in enumerate(scenarios):
        campaign.results.append(
            run_mp_scenario(
                scenario,
                seed=seed + index,
                tick_seconds=tick_seconds,
                budget_s=budget_s,
                processor=processor,
                device=device,
            )
        )
    return campaign
