"""Campaign runner: executes scenarios on the testengine and audits them.

The runner drives a custom drain loop (instead of ``drain_clients``) so it
can fire runner-driven crash points at simulated instants — snapshotting
each victim's durable commit log first, which is what gives the durability
invariant its ground truth — and record when commitment progress happens,
which is what gives bounded-recovery its evidence.

Every digest of a run comes off the SHA-256 kernel through the engine's
``AsyncKernelHashPlane``, every signature verdict in signed mode off the
Ed25519 kernels, and every checkpoint certificate of a ``cert_audit``
scenario off the BLS G1 kernel: on ``device="cuda"`` (the default; raises
without a card), or on the kernels' plain versions with ``device="cpu"``.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field

from .. import pb
from ..obsv import hooks
from ..ops import kernel_launches
from ..ops.batching import resolve_device
from ..resilience import CircuitBreaker
from ..obsv.metrics import Registry
from ..obsv.recorder import FlightRecorder
from ..testengine.crypto_plane import AsyncKernelHashPlane
from ..testengine.engine import BasicRecorder
from .invariants import (
    CrashSnapshot,
    InvariantViolation,
    audit_aggregate_certs,
    check_aggregate_cert_rejected,
    check_bounded_recovery,
    check_censorship_liveness,
    check_commit_resumption,
    check_config_agreement,
    check_corruption_rejected,
    check_durable_prefix,
    check_flood_bounded,
    check_full_convergence,
    check_mac_rejected,
    check_no_fork,
    check_no_fork_under_equivocation,
    check_no_vector_divergence,
)
from .scenarios import Scenario, matrix

# The boot WAL's FEntry gracefully ends epoch 0, so every run negotiates
# epoch 1 at startup — epoch 1 *is* the quiescent baseline, and only an
# epoch beyond it is evidence of a forced change / bucket rotation.
FIRST_WORKING_EPOCH = 1

# Rotations-to-commit scale for the censorship histogram (the default
# obsv buckets are seconds — wrong scale for epoch counts).
ROTATION_BUCKETS = (0, 1, 2, 3, 4, 6, 8)


@dataclass
class ScenarioResult:
    name: str
    seed: int
    passed: bool
    events: int = 0
    sim_ms: int = 0
    commits: int = 0
    violation: str = ""
    dump: str = ""  # flight-recorder segment path on invariant failure
    counters: dict = field(default_factory=dict)

    def line(self) -> str:
        status = "ok  " if self.passed else "FAIL"
        extra = "".join(
            f" {key}={value}" for key, value in sorted(self.counters.items())
        )
        tail = f" [{self.violation}]" if self.violation else ""
        dump = f" dump={self.dump}" if self.dump else ""
        return (
            f"{status} {self.name:<28} seed={self.seed} "
            f"events={self.events} sim={self.sim_ms}ms "
            f"commits={self.commits}{extra}{tail}{dump}"
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "passed": self.passed,
            "events": self.events,
            "sim_ms": self.sim_ms,
            "commits": self.commits,
            "violation": self.violation,
            "dump": self.dump,
            "counters": dict(self.counters),
        }


@dataclass
class CampaignResult:
    seed: int
    results: list = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return all(r.passed for r in self.results)

    def report(self) -> str:
        lines = [r.line() for r in self.results]
        good = sum(r.passed for r in self.results)
        lines.append(
            f"campaign seed={self.seed}: {good}/{len(self.results)} "
            f"scenarios passed"
        )
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """Machine-readable campaign summary (``chaos --json``); each
        failed scenario's ``dump`` points at its postmortem segment."""
        return {
            "seed": self.seed,
            "passed": self.passed,
            "scenarios": [r.to_dict() for r in self.results],
        }


def _dump_dir() -> str:
    """Where invariant-failure flight dumps land:
    ``$MIRBFT_CHAOS_DUMP_DIR`` when set, else a per-process tempdir."""
    configured = os.environ.get("MIRBFT_CHAOS_DUMP_DIR")
    if configured:
        os.makedirs(configured, exist_ok=True)
        return configured
    root = os.path.join(
        tempfile.gettempdir(), f"mirbft-chaos-dumps-{os.getpid()}"
    )
    os.makedirs(root, exist_ok=True)
    return root


def dump_on_violation(recorder, scenario_name, seed, violation) -> str:
    """Record the failure note and flush the ring to a segment; returns
    the segment path ('' when the flush could not land)."""
    recorder.record_note(
        "invariant.violation",
        args={
            "scenario": scenario_name,
            "seed": seed,
            "violation": str(violation),
        },
    )
    if not recorder.dump_dir:
        recorder.dump_dir = os.path.join(
            _dump_dir(), f"{scenario_name}-seed{seed}"
        )
        os.makedirs(recorder.dump_dir, exist_ok=True)
    try:
        return recorder.flush("invariant-failure") or ""
    except OSError:
        return ""


def _active_config(rec, node):
    """The node's currently-active NetworkConfig, or None before its
    commit state initializes (deferred/booting nodes)."""
    machine = rec.machines.get(node)
    commit_state = getattr(machine, "commit_state", None)
    if commit_state is None or commit_state.active_state is None:
        return None
    return commit_state.active_state.config


def run_scenario(
    scenario: Scenario,
    seed: int = 0,
    registry: Registry | None = None,
    device="cuda",
) -> ScenarioResult:
    """Execute one scenario under one seed and audit every invariant.
    Never raises for an invariant violation — it is reported in the
    result — but scenario-construction bugs do propagate, and so does a
    ``DevicePlaneError`` (a kernel launch the breaker would not retry).

    The kernels run on ``device``: ``cuda`` unless the caller asks for
    ``cpu`` (their plain versions).

    Recovery time and drop/duplicate casualties are recorded through the
    metrics registry: the one passed in, else the globally-enabled obsv
    registry, else a throwaway local one."""
    device = resolve_device(device)
    launches_before = kernel_launches()
    if registry is None:
        registry = hooks.metrics if hooks.enabled else Registry()
    manglers = scenario.build_manglers()
    hash_plane = (
        scenario.hash_plane(device)
        if scenario.hash_plane
        else AsyncKernelHashPlane(device=device)
    )
    signer = None
    signature_plane = None
    if scenario.signed:
        from ..testengine.signing import (
            SignaturePlane,
            batch_verifier,
            make_signer,
        )

        signer = make_signer()
        signature_plane = (
            scenario.signature_plane(device)
            if scenario.signature_plane
            else SignaturePlane(batch_verifier(device),
                                breaker=CircuitBreaker())
        )
    mac_plane = None
    if scenario.link_auth:
        from ..testengine.signing import MacSealPlane

        mac_plane = MacSealPlane()
    cert_plane = None
    if scenario.cert_audit:
        from ..testengine.certs import CheckpointCertPlane

        # 2f+1 votes make a certificate, aggregated on the BLS G1
        # kernel.
        f = (scenario.node_count - 1) // 3
        cert_plane = CheckpointCertPlane(
            quorum=2 * f + 1, use_device=True, device=device
        )
    rec = BasicRecorder(
        node_count=scenario.node_count,
        client_count=scenario.client_count,
        reqs_per_client=scenario.reqs_per_client,
        batch_size=scenario.batch_size,
        seed=seed,
        manglers=manglers,
        hash_plane=hash_plane,
        signer=signer,
        signature_plane=signature_plane,
        mac_plane=mac_plane,
        checkpoint_certs=cert_plane,
        network_state=(
            scenario.network_state() if scenario.network_state else None
        ),
        record=False,
        deferred_nodes=scenario.deferred_nodes,
    )

    # Committed-reconfiguration triggers: the app model reports the
    # payloads when the trigger request commits; the runner then owns the
    # operator-side half — provisioning joined nodes from a reconfigured
    # checkpoint and registering reconfiguration-added clients once the
    # new config is active somewhere.
    for point in scenario.reconfigs:
        rec.reconfig_on_commit[(point.client_id, point.req_no)] = point.build()
    joins_pending = [
        (node, point) for point in scenario.reconfigs for node in point.joins
    ]
    clients_pending = [
        (cid, total)
        for point in scenario.reconfigs
        for cid, total in point.add_clients
    ]

    def service_reconfigs() -> None:
        for node, point in list(joins_pending):
            if rec.node_states[point.provision_from].crashed:
                continue
            config = _active_config(rec, point.provision_from)
            if config is None or node not in config.nodes:
                continue
            seq = None
            checkpoints = rec.node_states[point.provision_from].checkpoints
            for cp_seq, (_v, state, _snap) in checkpoints.items():
                if node in state.config.nodes and (
                    seq is None or cp_seq > seq
                ):
                    seq = cp_seq
            if seq is None:
                continue
            rec.provision_node(
                node, point.provision_from, seq, point.provision_delay_ms
            )
            joins_pending.remove((node, point))
        for cid, total in list(clients_pending):
            for member in range(rec.node_count):
                if rec.node_states[member].crashed:
                    continue
                config_state = _active_config(rec, member)
                if config_state is None:
                    continue
                clients = rec.machines[member].commit_state.active_state.clients
                if any(c.id == cid for c in clients):
                    rec.add_client(cid, total)
                    clients_pending.remove((cid, total))
                    break

    pending = sorted(scenario.crashes, key=lambda c: c.at_ms)
    snapshots: list = []
    commit_times: list = []
    last_total = sum(rec._committed_counts.values())
    result = ScenarioResult(name=scenario.name, seed=seed, passed=False)

    # Flight recorder: reuse the globally-wired one so the dump carries
    # the engine's milestones; otherwise run a scenario-local ring (and,
    # when hooks are live, lend it to them for the scenario's duration)
    # so a violation still leaves black-box evidence behind.
    recorder = hooks.recorder if hooks.enabled else None
    own_recorder = recorder is None
    if own_recorder:
        recorder = FlightRecorder(f"chaos-{scenario.name}")
        if hooks.enabled:
            hooks.recorder = recorder
    recorder.record_note(
        "scenario.start", args={"scenario": scenario.name, "seed": seed}
    )

    censor_manglers = [m for m in manglers if hasattr(m, "censored_pairs")]
    # (client_id, req_no) -> epoch rotations (relative to the first
    # working epoch) observed when the censored request first committed
    # anywhere; the censorship-liveness invariant's evidence.
    commit_rotations: dict = {}

    def current_rotation() -> int:
        epochs = [
            rec.machines[n].epoch_tracker.current_epoch.number
            for n in range(rec.node_count)
            if not rec.node_states[n].crashed
            and rec.machines[n].epoch_tracker.current_epoch is not None
        ]
        return max(0, max(epochs, default=0) - FIRST_WORKING_EPOCH)

    def track_censored_commits() -> None:
        rotation = None
        for mangler in censor_manglers:
            for pair in mangler.censored_pairs:
                if pair in commit_rotations:
                    continue
                client = rec.clients.get(pair[0])
                if client is None or pair[1] not in client.committed_anywhere:
                    continue
                if rotation is None:
                    rotation = current_rotation()
                commit_rotations[pair] = rotation

    def fire_due_crashes() -> None:
        while pending and rec.now >= pending[0].at_ms:
            point = pending.pop(0)
            state = rec.node_states[point.node]
            snapshots.append(
                CrashSnapshot(
                    node=point.node,
                    at_ms=rec.now,
                    committed=list(state.committed_reqs),
                )
            )
            rec.crash(point.node)
            rec.schedule_restart(point.node, point.restart_delay_ms)

    try:
        check = True
        for _ in range(scenario.max_steps):
            fire_due_crashes()
            if joins_pending or clients_pending:
                service_reconfigs()
            if check or rec._progress:
                check = False
                # fully_committed ignores crashed nodes; a scenario only
                # completes once every scheduled crash has fired, every
                # reconfiguration-joined node is provisioned and every
                # node is back up and caught up.
                if (
                    not pending
                    and not joins_pending
                    and not clients_pending
                    and rec.fully_committed()
                    and not any(
                        rec.node_states[n].crashed
                        for n in range(rec.node_count)
                    )
                ):
                    break
            if not rec.step():
                raise InvariantViolation(
                    f"event queue drained before convergence "
                    f"({rec.event_count} events)"
                )
            total = sum(rec._committed_counts.values())
            if total > last_total:
                last_total = total
                commit_times.append(rec.now)
                if censor_manglers:
                    track_censored_commits()
        else:
            raise InvariantViolation(
                f"no convergence after {scenario.max_steps} steps "
                f"({rec.event_count} events, t={rec.now}ms)"
            )

        check_no_fork(rec)
        check_durable_prefix(rec, snapshots)
        check_full_convergence(rec)
        check_no_vector_divergence(rec)
        ends = scenario.disruption_ends()
        # Recovery time flows through the metrics registry so the same
        # number shows up in chaos reports, status snapshots, and tests:
        # the gauge IS the value the bounded-recovery invariant audits.
        gauge = registry.gauge(
            "mirbft_chaos_recovery_ms", scenario=scenario.name
        )
        gauge.set(rec.now - (max(ends) if ends else 0))
        result.counters["recovery_ms"] = gauge.value
        check_bounded_recovery(
            completion_ms=(max(ends) if ends else 0) + gauge.value,
            last_disruption_end_ms=max(ends) if ends else 0,
            bound_ms=scenario.recovery_bound_ms,
        )
        if ends:
            check_commit_resumption(
                commit_times, max(ends), scenario.recovery_bound_ms
            )
        if scenario.expect_epoch_change:
            epochs = [
                rec.machines[n].epoch_tracker.current_epoch.number
                for n in range(rec.node_count)
            ]
            result.counters["epoch"] = max(epochs)
            # Every run negotiates FIRST_WORKING_EPOCH at boot (the seed
            # WAL's FEntry ends epoch 0), so reaching it is not evidence
            # of a change — the cluster must have moved *beyond* it.
            if max(epochs) <= FIRST_WORKING_EPOCH:
                raise InvariantViolation(
                    "scenario expected an epoch change but every node is "
                    f"still in the boot epoch (epochs {epochs})"
                )
        if scenario.reconfigs:
            adoptions = 0
            checkpoint_configs: dict = {}
            final_configs: dict = {}
            for node in range(rec.node_count):
                machine = rec.machines[node]
                adoptions += getattr(machine, "reconfigs_adopted", 0)
                checkpoint_configs[node] = {
                    seq: pb.encode(state.config)
                    for seq, (_v, state, _snap) in rec.node_states[
                        node
                    ].checkpoints.items()
                }
                config = _active_config(rec, node)
                if (
                    config is not None
                    and not rec.node_states[node].crashed
                    and not getattr(machine, "retired", False)
                ):
                    final_configs[node] = pb.encode(config)
            evidence = check_config_agreement(
                checkpoint_configs, final_configs, adoptions
            )
            result.counters["reconfig_adoptions"] = adoptions
            result.counters["config_checkpoints"] = evidence[
                "checkpoints_compared"
            ]
        _audit_adversaries(
            scenario, rec, manglers, commit_rotations, registry, result
        )
        result.passed = True
    except InvariantViolation as violation:
        result.violation = str(violation)
        result.dump = dump_on_violation(
            recorder, scenario.name, seed, violation
        )
    finally:
        if own_recorder and hooks.recorder is recorder:
            hooks.recorder = None

    result.events = rec.event_count
    result.sim_ms = rec.now
    result.commits = last_total
    dropped = duplicated = 0
    for mangler in manglers:
        if hasattr(mangler, "dropped"):
            dropped += mangler.dropped
            result.counters["partition_drops"] = result.counters.get(
                "partition_drops", 0
            ) + mangler.dropped
        if getattr(mangler, "duplicated", 0):
            duplicated += mangler.duplicated
            result.counters["duplicates"] = result.counters.get(
                "duplicates", 0
            ) + mangler.duplicated
    if dropped:
        registry.counter(
            "mirbft_chaos_dropped_total", scenario=scenario.name
        ).inc(dropped)
    if duplicated:
        registry.counter(
            "mirbft_chaos_duplicated_total", scenario=scenario.name
        ).inc(duplicated)
    if snapshots:
        result.counters["crashes"] = len(snapshots)
    if scenario.hash_plane:
        result.counters["device_errors"] = hash_plane.device_errors
        result.counters["device_timeouts"] = hash_plane.device_timeouts
        result.counters["fallback_digests"] = hash_plane.fallback_digests
        result.counters["breaker"] = hash_plane.breaker.state
        result.counters["breaker_trips"] = hash_plane.breaker.trips
        result.counters["breaker_probes"] = hash_plane.breaker.probes
        result.counters["device_retries"] = hash_plane.device_retries
    if signature_plane is not None:
        result.counters["sig_device_errors"] = signature_plane.device_errors
        result.counters["sig_fallbacks"] = signature_plane.fallback_verifies
        result.counters["sig_breaker"] = signature_plane.breaker.state
        result.counters["sig_breaker_trips"] = signature_plane.breaker.trips
        result.counters["sig_breaker_probes"] = (
            signature_plane.breaker.probes
        )
        result.counters["sig_device_retries"] = (
            signature_plane.device_retries
        )
    # The port's own: digests off the kernel plane (0 by construction)
    # and each kernel's launches in this run.
    result.counters["host_digests"] = hash_plane.host_digests
    result.counters["digest_launches"] = hash_plane.launches
    after = kernel_launches()
    for name, count in launches_before.items():
        result.counters[name] = after[name] - count
    return result


def _audit_adversaries(
    scenario, rec, manglers, commit_rotations, registry, result
) -> None:
    """Run the Byzantine invariants for whichever adversarial manglers the
    scenario carried (attribute-sniffed, so raw-DSL scenarios are audited
    identically to structured Adversary specs).  Raises
    InvariantViolation; also folds attack evidence into the result
    counters and the obsv registry."""
    corrupted = sum(getattr(m, "corrupted", 0) for m in manglers)
    corrupted_proposes = sum(
        getattr(m, "corrupted_proposes", 0) for m in manglers
    )
    flooded = sum(getattr(m, "flooded", 0) for m in manglers)
    censored = sum(getattr(m, "censored", 0) for m in manglers)
    variants: dict = {}
    for m in manglers:
        variants.update(getattr(m, "variants", {}))
    censored_pairs: set = set()
    for m in manglers:
        censored_pairs |= getattr(m, "censored_pairs", set())

    if corrupted:
        result.counters["corrupted"] = corrupted
    if scenario.signed and corrupted_proposes:
        result.counters["rejections"] = rec.byzantine_rejections
        check_corruption_rejected(rec.byzantine_rejections, corrupted_proposes)
    if variants:
        result.counters["equivocated"] = len(variants)
        check_no_fork_under_equivocation(
            rec, variants, expect_suspicion=scenario.expect_epoch_change
        )
    if any(hasattr(m, "censored_pairs") for m in manglers):
        result.counters["censored"] = censored
        k = scenario.notes.get("censor_k", 3)
        check_censorship_liveness(rec, censored_pairs, commit_rotations, k)
        rotations = list(commit_rotations.values())
        result.counters["rotations_max"] = max(rotations, default=0)
        histogram = registry.histogram(
            "mirbft_censored_commit_epochs",
            buckets=ROTATION_BUCKETS,
            scenario=scenario.name,
        )
        for rotation in rotations:
            histogram.observe(rotation)
    if any(hasattr(m, "flooded") for m in manglers):
        result.counters["flooded"] = flooded
        check_flood_bounded(rec, flooded)
    if scenario.link_auth and rec.mac_plane is not None:
        # forge_mac lowers to corrupt manglers over replica wire traffic;
        # the rewrites that were NOT proposal deliveries are the forged
        # replica messages the MAC layer is obligated to reject.
        forged = corrupted - corrupted_proposes
        result.counters["mac_rejections"] = rec.mac_plane.rejections
        check_mac_rejected(rec.mac_plane.rejections, forged, exact=True)
    if scenario.cert_audit and rec.checkpoint_certs is not None:
        certs = rec.checkpoint_certs.certificates()
        genuine_ok, genuine_total, forged_rejected, forged_total = (
            audit_aggregate_certs(certs)
        )
        result.counters["certs"] = genuine_total
        result.counters["cert_forgeries_rejected"] = forged_rejected
        check_aggregate_cert_rejected(
            genuine_ok, genuine_total, forged_rejected, forged_total
        )


def run_campaign(
    scenarios: list | None = None, seed: int = 0, device="cuda"
) -> CampaignResult:
    """Run a scenario list (default: the full matrix) under derived
    per-scenario seeds; reproducible from ``seed`` alone.  The kernels
    run on ``device`` (``cuda`` unless the caller asks for ``cpu``)."""
    device = resolve_device(device)
    if scenarios is None:
        scenarios = matrix()
    campaign = CampaignResult(seed=seed)
    for index, scenario in enumerate(scenarios):
        campaign.results.append(
            run_scenario(scenario, seed=seed + index, device=device)
        )
    return campaign
