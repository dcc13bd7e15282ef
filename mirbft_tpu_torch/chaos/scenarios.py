"""The chaos scenario matrix: one schema, two engines.

Each ``Scenario`` is declarative: factories (not instances) for manglers
and crypto planes, because both are stateful per run — the runner builds
fresh ones for every (scenario, seed) execution so campaigns are
reproducible and scenarios can repeat across seeds.  A crypto plane's
factory takes the device its kernels run on (``cuda``, or ``cpu`` for
their plain versions).

The structured fault fields — ``partitions`` (PartitionWindow),
``crashes`` (CrashPoint), ``drop_pct``, ``storage_faults``
(StorageFault), ``signed`` — are engine-agnostic: the deterministic
runner (runner.py) lowers them onto testengine manglers and simulated
crash schedules, while the live driver (live.py) lowers the *same*
scenario onto socket-level partition proxies, real crash-kills of
runtime Nodes, transport-seam message loss, and failing fsyncs.  Only
``manglers`` (the raw mangler-DSL escape hatch) is testengine-specific.

The matrix mirrors the reference's fault suite (mirbft_test.go:68-222)
and extends it with network partitions (with heal), device-plane faults
against the kernel-backed crypto planes, epoch-change-targeted leader
isolation, and signed-mode verifier faults."""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import pb
from ..resilience import CircuitBreaker
from ..testengine.crypto_plane import AsyncKernelHashPlane
from ..testengine.engine import standard_initial_network_state
from ..testengine.manglers import (
    after_time,
    from_client,
    from_source,
    is_propose,
    is_step,
    msg_type,
    partition,
    percent,
    rule,
    to_node,
    until_time,
)
from ..testengine.signing import SignaturePlane, batch_verifier
from .faults import FlakyDigestBackend, FlakyVerifierBackend


@dataclass(frozen=True)
class CrashPoint:
    """Runner-driven crash: at ``at_ms`` simulated time, crash ``node``
    (snapshotting its durable commit log for the durability invariant)
    and reboot it from durable state ``restart_delay_ms`` later."""

    at_ms: int
    node: int
    restart_delay_ms: int


@dataclass(frozen=True)
class PartitionWindow:
    """Declarative network split: messages crossing between ``groups``
    are cut for ``from_ms <= t < until_ms``, then the network heals.
    The deterministic runner lowers this onto the partition() mangler;
    the live driver cuts the socket-level partition proxies."""

    groups: tuple  # tuple of tuples of node ids, covering all nodes
    from_ms: int
    until_ms: int


@dataclass(frozen=True)
class NodeJoin:
    """Reconfiguration under fire (mp driver only): ``node`` is a
    provisioned member of the network config that is *not* booted at
    cluster start — the running subset carries the bootstrap leader set,
    so the absent member owns no buckets.  At ``at_ms`` the supervisor
    spawns it fresh (``join_node``) against the running cluster; it must
    reach the commit frontier via checkpoint-anchored snapshot state
    transfer within ``catchup_bound_ms`` (``check_bounded_catchup``)."""

    at_ms: int
    node: int
    catchup_bound_ms: int = 60_000
    # When True the joiner is admitted by a committed pb.Reconfiguration
    # (the mp driver submits the grown config through the ordered
    # broadcast and only spawns the node once an incumbent has adopted
    # it) rather than by a static provisioned spec.
    via_reconfig: bool = False


@dataclass(frozen=True)
class NodeRemoval:
    """Reconfiguration under fire (mp driver only): at ``at_ms`` the
    node is permanently removed — SIGKILL with no restart — and the
    survivors must keep committing (quorums permitting)."""

    at_ms: int
    node: int
    # When True the survivors also commit a pb.Reconfiguration that
    # shrinks the config to exclude ``node``; the departure is a
    # membership change, not just a silent crash.
    via_reconfig: bool = False


@dataclass(frozen=True)
class ReconfigPoint:
    """A reconfiguration riding the ordered broadcast (deterministic
    engine): when request ``(client_id, req_no)`` commits, every node's
    app observes ``build()``'s ``pb.Reconfiguration`` list and reports
    it with its next checkpoint; the new config activates at the next
    stable checkpoint (commitstate's pending -> reconfigured seam).

    ``joins`` names deferred nodes the runner provisions — from
    ``provision_from``'s newest stable checkpoint whose config includes
    them — once the grown config is *active* at that member (the
    operator-side half of a node-set reconfiguration).  ``add_clients``
    are ``(client_id, total_reqs)`` pairs registered with the engine
    once the adopted config's client set carries them."""

    client_id: int
    req_no: int
    build: object  # zero-arg factory -> [pb.Reconfiguration]
    joins: tuple = ()
    provision_from: int = 0
    provision_delay_ms: int = 50
    add_clients: tuple = ()


@dataclass(frozen=True)
class StorageFault:
    """Live-only fault: from ``at_ms`` the node's WAL/reqstore fsyncs
    raise OSError, so the runtime's persist path fails loudly; the
    driver crash-kills the node and reboots it — with healthy storage —
    ``restart_delay_ms`` after the fault hit."""

    at_ms: int
    node: int
    restart_delay_ms: int


@dataclass(frozen=True)
class Adversary:
    """Engine-agnostic Byzantine attack: a compromised node (or link)
    attacking *content and ordering* rather than delivery — the malicious-
    leader model of the Mir paper's robustness evaluation.  The
    deterministic runner lowers each spec onto the adversarial mangler
    actions (``lower()``); the live driver lowers the same spec onto
    frame-rewriting socket proxies and the signed ingress gate.

    Kinds:

    * ``corrupt`` — flip ``byte_flips`` bytes of matched payloads/digests
      in flight.  ``msg_kinds=("Propose",)`` attacks client proposals
      (signed mode must reject 100%); other kinds name wire messages.
      ``victims`` restricts to deliveries into those nodes (empty = all).
      ``msg_kinds=("SnapshotChunk",)`` attacks the snapshot
      state-transfer stream instead (live/mp drivers only): chunk frames
      are bit-flipped or tail-truncated (``corrupt``) or dropped
      (``censor``), and the fetcher's digest chain must reject 100%.
    * ``equivocate`` — ``node`` (a leader) sends conflicting Preprepares
      for the same (epoch, seq) to the ``victims`` follower subset.
    * ``censor`` — ``node`` silently drops every event speaking for the
      ``victims`` client ids at its ingress (proposals, acks, forwards);
      defeated by epoch-rotation of bucket assignment.
    * ``flood`` — ``copies`` delayed echoes of matched messages spread
      over ``stale_delay_ms`` (duplication / stale-ack storms against the
      dedup path).  ``msg_kinds=("Propose",)`` storms client submissions.
    * ``forge_mac`` — tamper with matched replica-channel traffic under
      MAC-authenticated links (``Scenario.link_auth``).  The
      deterministic lowering rewrites matched wire messages (fresh,
      unsealed objects the MacSealPlane must refuse); the live lowering
      flips raw authenticator-tag bytes at the frame tail, so the frame
      stays structurally parseable and the rejection is attributable to
      the MAC check alone.  Counts touches on ``forged_macs`` (live) /
      the corrupt counters (deterministic).
    """

    kind: str  # "corrupt" | "equivocate" | "censor" | "flood" | "forge_mac"
    # The compromised node.  For corrupt/flood over wire messages it
    # scopes from_source; -1 means any source (a compromised network
    # rather than a compromised node).  Corrupting RequestAcks from more
    # than f sources exceeds Mir's threat model: ack integrity is a
    # signature property, so in-flight ack corruption models a *lying
    # acker*, and the one-vote-per-node rule rightly wedges availability
    # past f liars.
    node: int = 0
    victims: tuple = ()  # nodes (equivocate/corrupt) or client ids (censor)
    from_ms: int = 0
    until_ms: int | None = None  # None = attacks for the whole run
    rate_pct: int = 100
    byte_flips: int = 1  # corrupt
    msg_kinds: tuple = ("Propose",)  # corrupt/flood surface
    copies: int = 2  # flood echoes per matched message
    stale_delay_ms: int = 4000  # flood echo spread

    def lower(self):
        """Build the testengine mangler for this attack (fresh state per
        call; all randomness seeded via the recorder)."""
        window = []
        if self.from_ms:
            window.append(after_time(self.from_ms))
        if self.until_ms is not None:
            window.append(until_time(self.until_ms))
        # percent() burns an rng draw per candidate it sees; keep it last
        # so only events the cheap predicates matched consume randomness.
        gate = [percent(self.rate_pct)] if self.rate_pct < 100 else []
        if self.kind in ("corrupt", "forge_mac"):
            # forge_mac's deterministic lowering IS a corrupt mangler:
            # every rewrite builds a fresh, unsealed message object, which
            # is exactly what the MacSealPlane rejects at delivery.
            if self.msg_kinds == ("Propose",):
                base = [is_propose()]
            else:
                base = [msg_type(*self.msg_kinds)]
                if self.node >= 0:
                    base.append(from_source(self.node))
            if self.victims:
                base.append(to_node(*self.victims))
            return rule(*base, *window, *gate).corrupt(self.byte_flips)
        if self.kind == "equivocate":
            return rule(
                msg_type("Preprepare"), from_source(self.node), *window, *gate
            ).equivocate(self.victims)
        if self.kind == "censor":
            return rule(
                to_node(self.node), from_client(*self.victims), *window
            ).censor()
        if self.kind == "flood":
            if self.msg_kinds == ("Propose",):
                base = [is_propose()]
            else:
                base = [msg_type(*self.msg_kinds)]
                if self.node >= 0:
                    base.append(from_source(self.node))
            return rule(*base, *window, *gate).flood(
                self.copies, self.stale_delay_ms
            )
        raise ValueError(f"unknown adversary kind {self.kind!r}")


def _rotating_network_state(
    node_count: int = 4,
    client_ids: tuple = (4, 5),
    max_epoch_length: int = 40,
    checkpoint_interval: int | None = None,
):
    """Factory for a network state with a short planned epoch length, so
    graceful bucket rotation — the paper's anti-censorship defense —
    happens within a scenario run instead of after the default 10
    checkpoint windows.  ``checkpoint_interval`` additionally shrinks
    the watermark window, which is how state-transfer scenarios make a
    rebooted node fall a full certified checkpoint behind quickly."""

    def build():
        base = standard_initial_network_state(node_count, list(client_ids))
        # Construct the variant config rather than mutating the standard
        # one in place: NetworkConfig mutation outside the adoption seam
        # is banned (lint rule W20) because live trackers alias it.
        return pb.NetworkState(
            config=pb.NetworkConfig(
                nodes=list(base.config.nodes),
                f=base.config.f,
                number_of_buckets=base.config.number_of_buckets,
                checkpoint_interval=(
                    checkpoint_interval or base.config.checkpoint_interval
                ),
                max_epoch_length=max_epoch_length,
            ),
            clients=base.clients,
        )

    return build


def _grow_network_state():
    """Factory for the node-set-growth universe: 4 active members (0..3)
    of a 5-node simulated universe, short checkpoint windows so adoption
    lands early, client widths covering the whole request stream (the
    deterministic engine submits each request exactly once)."""

    def build():
        return pb.NetworkState(
            config=pb.NetworkConfig(
                nodes=[0, 1, 2, 3],
                f=1,
                number_of_buckets=4,
                checkpoint_interval=8,
                max_epoch_length=16,
            ),
            clients=[
                pb.NetworkClient(id=cid, width=48, low_watermark=0)
                for cid in (5, 6)
            ],
        )

    return build


def _five_node_reconfig():
    """The committed grow payload: the 5-node config node 4 joins under.
    Bucket count stays at 4 so in-flight bucket ownership is stable
    across the flip; only membership/f change."""
    return [
        pb.Reconfiguration(
            type=pb.NetworkConfig(
                nodes=[0, 1, 2, 3, 4],
                f=1,
                number_of_buckets=4,
                checkpoint_interval=8,
                max_epoch_length=16,
            )
        )
    ]


def _mel_reconfig(max_epoch_length: int):
    """A full-replacement NetworkConfig payload differing from the
    4-node standard config only in ``max_epoch_length`` — the benign
    knob the equivocating-configs scenario uses to build a *conflicting
    pair* without destabilizing watermarks or bucket maps mid-run."""

    def build():
        return [
            pb.Reconfiguration(
                type=pb.NetworkConfig(
                    nodes=[0, 1, 2, 3],
                    f=1,
                    number_of_buckets=4,
                    checkpoint_interval=20,
                    max_epoch_length=max_epoch_length,
                )
            )
        ]

    return build


@dataclass
class Scenario:
    name: str
    description: str = ""
    tags: tuple = ()
    node_count: int = 4
    client_count: int = 2
    reqs_per_client: int = 10
    batch_size: int = 1
    # Zero-arg factory -> list of manglers (fresh state per run).
    # Testengine-only: prefer the structured fields below, which both
    # engines understand.
    manglers: object = None
    crashes: tuple = ()  # CrashPoints, fired by the runner
    partitions: tuple = ()  # PartitionWindows (both engines)
    drop_pct: int = 0  # uniform message-loss percentage (both engines)
    storage_faults: tuple = ()  # StorageFaults (live driver only)
    joins: tuple = ()  # NodeJoins (mp driver only)
    removes: tuple = ()  # NodeRemovals (mp driver only)
    # Committed-reconfiguration triggers (deterministic engine): the
    # runner wires each onto Recorder.reconfig_on_commit, provisions
    # the joined nodes after adoption, and audits config agreement.
    reconfigs: tuple = ()  # ReconfigPoints
    # Nodes in the simulated universe that boot only after a node-set
    # reconfiguration adds them (paired with ReconfigPoint.joins).
    deferred_nodes: tuple = ()
    # Signed-request mode: clients Ed25519-sign, replicas verify at
    # ingress through a SignaturePlane (factory below, fresh per run).
    signed: bool = False
    signature_plane: object = None  # factory of device (signed mode)
    # MAC-authenticated replica channels (docs/CRYPTO.md): the
    # deterministic runner installs a MacSealPlane, the live driver
    # turns on per-link transport MACs.  Opt-in so digest-layer
    # corruption scenarios keep observing their evidence where it is.
    link_auth: bool = False
    # Post-run aggregate-certificate audit: collect the run's checkpoint
    # quorum certificates, verify every genuine one and reject every
    # forged variant through the crypto/qc.py seam.
    cert_audit: bool = False
    # Byzantine attacks (Adversary specs); both engines lower them.
    adversaries: tuple = ()
    # The scenario is designed to force an epoch change; the runner
    # fails it unless some node ends beyond the first working epoch.
    expect_epoch_change: bool = False
    # Zero-arg factory -> initial NetworkState (overrides the standard
    # one; censorship scenarios shorten max_epoch_length so bucket
    # rotation lands inside the run).
    network_state: object = None
    # Factory of the device ("cuda" or "cpu") -> hash plane (fresh
    # breaker/counters per run).
    hash_plane: object = None
    # Heal instants (ms) of disruptions the raw manglers inject;
    # structured faults (partitions/crashes/storage) are added
    # automatically by disruption_ends().
    heal_points_ms: tuple = ()
    recovery_bound_ms: int = 120_000
    max_steps: int = 600_000
    notes: dict = field(default_factory=dict)

    def disruption_ends(self) -> list:
        ends = list(self.heal_points_ms)
        ends.extend(w.until_ms for w in self.partitions)
        ends.extend(c.at_ms + c.restart_delay_ms for c in self.crashes)
        ends.extend(s.at_ms + s.restart_delay_ms for s in self.storage_faults)
        ends.extend(j.at_ms for j in self.joins)
        ends.extend(r.at_ms for r in self.removes)
        return ends

    def build_manglers(self) -> list:
        """Lower the structured fault fields onto testengine manglers
        (plus any raw ``manglers`` the scenario carries).  Fresh mangler
        state per call, so runs stay independent."""
        built = []
        for window in self.partitions:
            built.append(
                partition(
                    [list(group) for group in window.groups],
                    from_ms=window.from_ms,
                    until_ms=window.until_ms,
                )
            )
        if self.drop_pct:
            built.append(rule(is_step(), percent(self.drop_pct)).drop())
        for adversary in self.adversaries:
            built.append(adversary.lower())
        if self.manglers:
            built.extend(self.manglers())
        return built


#: The hang scenario's deadline and injected delay (seconds).  The JAX
#: package times a host call of a few dozen digests (0.5 ms against 2 ms);
#: the port times a kernel launch of a whole padded chunk, whose healthy
#: wall on the CPU's plain version reaches ~0.75 s on a cold first call,
#: so both are widened, keeping the delay twice the deadline.
SLOW_TIMEOUT_S = 2.0
SLOW_DELAY_S = 4.0


def _flaky_plane(mode: str, **kwargs):
    """Factory-factory: the kernel plane with its launch behind a fault
    for a call window, guarded by a hair-trigger breaker.

    The window ``fail_from=1, fail_until=3`` with threshold/probe of 1
    walks the breaker through its full lifecycle deterministically: call
    0 healthy, call 1 fails (trip -> open), call 2 is a probe and fails
    (re-open), call 3 is a probe and succeeds (re-close).  A dying or
    short-reading call is re-launched inside the same launch, so calls 1-3
    are one launch; a slow call keeps its values, so each is its own."""

    def build(device="cuda"):
        if mode == "slow":
            kwargs.setdefault("delay_s", SLOW_DELAY_S)
        plane = AsyncKernelHashPlane(
            device=device,
            breaker=CircuitBreaker(failure_threshold=1, probe_interval=1),
            timeout_s=SLOW_TIMEOUT_S if mode == "slow" else None,
        )
        plane.launch = FlakyDigestBackend(
            mode=mode, backend=plane.launch, **kwargs
        )
        return plane

    return build


def _flaky_signature_plane(**kwargs):
    """Factory-factory: a SignaturePlane on the Ed25519 kernels whose
    verifier misbehaves for a call window, guarded by the same
    hair-trigger breaker as _flaky_plane so the trip -> probe -> re-close
    cycle is walked deterministically."""

    def build(device="cuda"):
        return SignaturePlane(
            verifier=FlakyVerifierBackend(
                backend=batch_verifier(device), **kwargs
            ),
            breaker=CircuitBreaker(failure_threshold=1, probe_interval=1),
        )

    return build


def matrix() -> list:
    """The full campaign: baseline, the reference fault suite, partitions
    with heal, crash schedules, device-plane faults, and combinations."""
    return [
        Scenario(
            name="baseline",
            description="no faults; anchors event counts for the seed",
        ),
        Scenario(
            name="jitter-30ms",
            description="30ms delivery jitter on every message",
            manglers=lambda: [rule(is_step()).jitter(30)],
        ),
        Scenario(
            name="jitter-1000ms",
            description="1000ms delivery jitter (reorders across ticks)",
            manglers=lambda: [rule(is_step()).jitter(1000)],
        ),
        Scenario(
            name="duplicate-75pct",
            description="75% of messages delivered twice (delayed echo)",
            manglers=lambda: [rule(is_step(), percent(75)).duplicate(300)],
        ),
        Scenario(
            name="drop-10pct",
            description="10% uniform message loss",
            drop_pct=10,
        ),
        Scenario(
            name="ack-loss-70pct",
            description="70% RequestAck loss from nodes 1 and 2",
            manglers=lambda: [
                rule(msg_type("RequestAck"), from_source(1, 2), percent(70))
                .drop()
            ],
        ),
        Scenario(
            name="partition-minority",
            description="node 0 isolated 2s..12s, then heals",
            partitions=(
                PartitionWindow(
                    groups=((0,), (1, 2, 3)), from_ms=2000, until_ms=12_000
                ),
            ),
        ),
        Scenario(
            name="partition-split-2-2",
            description="2-2 split (no quorum anywhere) 2s..10s, then heals",
            partitions=(
                PartitionWindow(
                    groups=((0, 1), (2, 3)), from_ms=2000, until_ms=10_000
                ),
            ),
        ),
        Scenario(
            name="partition-flapping",
            description="node 3 isolated twice: 2s..6s and 9s..13s",
            partitions=(
                PartitionWindow(
                    groups=((3,), (0, 1, 2)), from_ms=2000, until_ms=6000
                ),
                PartitionWindow(
                    groups=((3,), (0, 1, 2)), from_ms=9000, until_ms=13_000
                ),
            ),
        ),
        Scenario(
            name="crash-restart",
            description="node 1 crashes at 3s, reboots from WAL 5s later",
            crashes=(CrashPoint(at_ms=3000, node=1, restart_delay_ms=5000),),
        ),
        Scenario(
            name="crash-staggered-pair",
            description="nodes 1 and 2 crash/restart at staggered times "
            "(never below quorum simultaneously)",
            crashes=(
                CrashPoint(at_ms=3000, node=1, restart_delay_ms=5000),
                CrashPoint(at_ms=12_000, node=2, restart_delay_ms=5000),
            ),
        ),
        Scenario(
            name="device-digest-dies",
            description="digest kernel launch raises mid-run; the "
            "breaker trips, and a probe re-launches it and re-closes",
            hash_plane=_flaky_plane("die", fail_from=1, fail_until=3),
            tags=("device",),
        ),
        Scenario(
            name="device-digest-short-read",
            description="digest kernel launch returns half a batch "
            "(lying readback); the plane re-launches it on a probe",
            hash_plane=_flaky_plane("short", fail_from=1, fail_until=3),
            tags=("device",),
        ),
        Scenario(
            name="device-digest-hangs",
            description="digest device exceeds its deadline for a window; "
            "timeouts trip the breaker",
            hash_plane=_flaky_plane("slow", fail_from=1, fail_until=3),
            tags=("device",),
        ),
        Scenario(
            name="partition-plus-crash",
            description="node 0 isolated 2s..10s while node 2 crashes at "
            "4s and reboots at 9s",
            partitions=(
                PartitionWindow(
                    groups=((0,), (1, 2, 3)), from_ms=2000, until_ms=10_000
                ),
            ),
            crashes=(CrashPoint(at_ms=4000, node=2, restart_delay_ms=5000),),
        ),
        Scenario(
            name="partition-plus-duplication",
            description="2-2 split 2s..8s under 50% duplication",
            partitions=(
                PartitionWindow(
                    groups=((0, 1), (2, 3)), from_ms=2000, until_ms=8000
                ),
            ),
            manglers=lambda: [rule(is_step(), percent(50)).duplicate(300)],
        ),
        Scenario(
            name="leader-isolation-epoch-change",
            description="node 0 (a leader) isolated 2s..20s under 5% loss "
            "— held far past the suspect timeout, so the survivors must "
            "change epochs and commit the suspect's in-flight sequences "
            "exactly once",
            partitions=(
                PartitionWindow(
                    groups=((0,), (1, 2, 3)), from_ms=2000, until_ms=20_000
                ),
            ),
            drop_pct=5,
            expect_epoch_change=True,
            tags=("epoch", "live"),
        ),
        # -- Byzantine adversary campaign (malicious leaders/links) -------
        Scenario(
            name="corrupt-propose-signed",
            description="60% of proposal deliveries into nodes 1 and 2 "
            "are bit-flipped in flight; signed ingress must reject every "
            "corruption while the honest copies (nodes 0 and 3 always "
            "reach weak quorum) and the fetch machinery still commit all",
            signed=True,
            reqs_per_client=12,
            # Victims are capped at f+1 nodes so every request keeps a
            # weak quorum of honest copies: the engine's clients never
            # resubmit, so a proposal corrupted at 2f+1 ingresses would be
            # indistinguishable from one never sent.
            adversaries=(
                Adversary(kind="corrupt", victims=(1, 2), rate_pct=60),
            ),
            tags=("adversary", "signed", "live"),
        ),
        Scenario(
            name="corrupt-digests-in-flight",
            description="node 1 lies in 60% of its request acks while 15% "
            "of Prepare/Commit digests from anywhere are bit-flipped for "
            "5s; ack lying stays within f sources (ack integrity is a "
            "signature property, so >f lying ackers exceeds the threat "
            "model) and quorum redundancy must absorb it all without "
            "forking",
            adversaries=(
                Adversary(
                    kind="corrupt",
                    node=1,
                    msg_kinds=("RequestAck",),
                    rate_pct=60,
                    until_ms=5000,
                ),
                Adversary(
                    kind="corrupt",
                    node=-1,
                    msg_kinds=("Prepare", "Commit"),
                    rate_pct=15,
                    until_ms=5000,
                ),
            ),
            heal_points_ms=(5000,),
            tags=("adversary",),
        ),
        Scenario(
            name="corrupt-forwarded-data",
            description="half the proposal deliveries into nodes 2 and 3 "
            "are lost, forcing data fetches — and 40% of the resulting "
            "ForwardRequests carry corrupted payloads the receiver's "
            "digest re-verification must drop and refetch",
            adversaries=(
                Adversary(
                    kind="corrupt",
                    node=-1,
                    msg_kinds=("ForwardRequest",),
                    rate_pct=40,
                ),
            ),
            manglers=lambda: [
                rule(is_propose(), to_node(2, 3), percent(50)).drop()
            ],
            tags=("adversary",),
        ),
        Scenario(
            name="equivocate-majority-suspect",
            description="leader 0 sends conflicting Preprepares to "
            "followers 1 and 2 for 3s; no digest can reach quorum, so the "
            "honest nodes must suspect the liar and change epochs — "
            "committing every sequence exactly once",
            adversaries=(
                Adversary(
                    kind="equivocate", node=0, victims=(1, 2), until_ms=3000
                ),
            ),
            expect_epoch_change=True,
            heal_points_ms=(3000,),
            tags=("adversary", "epoch"),
        ),
        Scenario(
            name="equivocate-minority-straggler",
            description="leader 0 lies only to follower 3 for 4s; the "
            "honest majority keeps committing and the victim must catch "
            "up (retransmission/state transfer) without ever committing "
            "the variant batch",
            reqs_per_client=20,
            adversaries=(
                Adversary(
                    kind="equivocate", node=0, victims=(3,), until_ms=4000
                ),
            ),
            heal_points_ms=(4000,),
            tags=("adversary", "live"),
        ),
        Scenario(
            name="censor-client-rotation",
            description="leader 0 silently drops everything client 4 "
            "submits (proposals, acks, forwards at its ingress) for 10s; "
            "short epochs force bucket rotation, which must hand the "
            "censored bucket to an honest leader within k rotations",
            adversaries=(
                Adversary(
                    kind="censor", node=0, victims=(4,), until_ms=10_000
                ),
            ),
            network_state=_rotating_network_state(max_epoch_length=40),
            heal_points_ms=(10_000,),
            notes={"censor_k": 3},
            tags=("adversary", "censor", "live"),
        ),
        Scenario(
            name="censor-both-clients",
            description="leader 0 censors both clients at once for 10s — "
            "every bucket it owns starves until rotation rescues them",
            adversaries=(
                Adversary(
                    kind="censor", node=0, victims=(4, 5), until_ms=10_000
                ),
            ),
            network_state=_rotating_network_state(max_epoch_length=40),
            heal_points_ms=(10_000,),
            notes={"censor_k": 3},
            tags=("adversary", "censor"),
        ),
        Scenario(
            name="flood-stale-acks",
            description="half of node 1's RequestAcks are echoed 3x up to "
            "8s late — stale acks for long-committed requests that the "
            "client windows must shrug off",
            adversaries=(
                Adversary(
                    kind="flood",
                    node=1,
                    msg_kinds=("RequestAck",),
                    copies=3,
                    stale_delay_ms=8000,
                    rate_pct=50,
                ),
            ),
            tags=("adversary", "flood"),
        ),
        Scenario(
            name="flood-duplicate-proposes",
            description="75% of client submissions are delivered 4x (the "
            "paper's request-duplication attack); dedup must commit "
            "exactly once with bounded store growth",
            adversaries=(
                Adversary(
                    kind="flood",
                    msg_kinds=("Propose",),
                    copies=3,
                    stale_delay_ms=2000,
                    rate_pct=75,
                ),
            ),
            tags=("adversary", "flood", "live"),
        ),
        Scenario(
            name="flood-threephase-storm",
            description="node 0's Preprepare/Prepare/Commit traffic is "
            "doubled with echoes up to 3s late; consensus dedup must "
            "hold watermarks and WAL growth bounded",
            adversaries=(
                Adversary(
                    kind="flood",
                    node=0,
                    msg_kinds=("Preprepare", "Prepare", "Commit"),
                    copies=2,
                    stale_delay_ms=3000,
                    rate_pct=50,
                ),
            ),
            tags=("adversary", "flood"),
        ),
        Scenario(
            name="equivocate-plus-flood",
            description="leader 0 equivocates to followers 1 and 2 while "
            "node 2's acks are storm-echoed — the epoch change must land "
            "despite the noise",
            adversaries=(
                Adversary(
                    kind="equivocate", node=0, victims=(1, 2), until_ms=4000
                ),
                Adversary(
                    kind="flood",
                    node=2,
                    msg_kinds=("RequestAck",),
                    copies=2,
                    stale_delay_ms=5000,
                    rate_pct=40,
                ),
            ),
            expect_epoch_change=True,
            heal_points_ms=(4000,),
            tags=("adversary", "epoch", "flood"),
        ),
        Scenario(
            name="forged-mac-storm",
            description="MAC-authenticated replica channels: a "
            "compromised network tampers with 30% of all Prepare/Commit "
            "traffic for 5s — every forged frame is unsealed and the "
            "per-link MAC check must reject 100% of them at ingress "
            "while consensus converges on the honest remainder",
            link_auth=True,
            adversaries=(
                Adversary(
                    kind="forge_mac",
                    node=-1,
                    msg_kinds=("Prepare", "Commit"),
                    rate_pct=30,
                    until_ms=5000,
                ),
            ),
            heal_points_ms=(5000,),
            tags=("adversary", "mac", "live"),
        ),
        Scenario(
            name="forged-aggregate-cert",
            description="aggregate quorum certificates: checkpoints "
            "accumulate BLS votes into one aggregate signature per "
            "certificate; after the run every genuine certificate must "
            "verify under a single aggregate check and every forged "
            "variant (mismatched statement, wrong signer set) must be "
            "rejected — the qc seam's 100%-rejection audit",
            reqs_per_client=20,
            cert_audit=True,
            network_state=_rotating_network_state(
                max_epoch_length=60, checkpoint_interval=6
            ),
            tags=("adversary", "cert", "live"),
        ),
        Scenario(
            name="signed-verifier-dies",
            description="signed mode: the signature kernels raise "
            "mid-run; the breaker trips, and a probe re-verifies the "
            "batch on the kernels and re-closes it",
            signed=True,
            signature_plane=_flaky_signature_plane(fail_from=1, fail_until=2),
            # Past the client window width (100), so the lazy plane sees
            # multiple flushes — the failure window [1, 3) is reachable.
            reqs_per_client=120,
            tags=("device", "signed", "live"),
        ),
        # -- dynamic membership (committed reconfigurations) ---------------
        Scenario(
            name="reconfig-add-node",
            description="a committed NetworkConfig reconfiguration grows "
            "the replica set 4 -> 5 at a checkpoint boundary; node 4 is "
            "provisioned from a member's reconfigured checkpoint and "
            "commits the tail of the workload as a full member",
            node_count=5,
            client_count=2,
            reqs_per_client=40,
            batch_size=2,
            network_state=_grow_network_state(),
            deferred_nodes=(4,),
            reconfigs=(
                ReconfigPoint(
                    client_id=5,
                    req_no=2,
                    build=_five_node_reconfig,
                    joins=(4,),
                ),
            ),
            recovery_bound_ms=300_000,
            max_steps=2_000_000,
            tags=("reconfig",),
        ),
        Scenario(
            name="reconfig-crash-straddle",
            description="the 4 -> 5 grow again, with member 1 crashing "
            "around the adoption window and replaying the "
            "C(pending)+C(reconfigured) pair from its WAL",
            node_count=5,
            client_count=2,
            reqs_per_client=40,
            batch_size=2,
            network_state=_grow_network_state(),
            deferred_nodes=(4,),
            reconfigs=(
                ReconfigPoint(
                    client_id=5,
                    req_no=2,
                    build=_five_node_reconfig,
                    joins=(4,),
                ),
            ),
            crashes=(CrashPoint(at_ms=2000, node=1, restart_delay_ms=3000),),
            recovery_bound_ms=300_000,
            max_steps=2_000_000,
            tags=("reconfig",),
        ),
        Scenario(
            name="reconfig-partition-flip",
            description="a 2-2 split of the incumbents spans the config "
            "flip: the reconfiguration can only stabilize after the heal, "
            "and the joiner provisions from the post-heal checkpoint",
            node_count=5,
            client_count=2,
            reqs_per_client=40,
            batch_size=2,
            network_state=_grow_network_state(),
            deferred_nodes=(4,),
            reconfigs=(
                ReconfigPoint(
                    client_id=5,
                    req_no=2,
                    build=_five_node_reconfig,
                    joins=(4,),
                ),
            ),
            partitions=(
                PartitionWindow(
                    groups=((0, 1), (2, 3, 4)), from_ms=1000, until_ms=5000
                ),
            ),
            recovery_bound_ms=300_000,
            max_steps=2_000_000,
            tags=("reconfig",),
        ),
        Scenario(
            name="reconfig-equivocate-configs",
            description="two conflicting NetworkConfig payloads (differing "
            "max_epoch_length) commit in total order while leader 0 "
            "equivocates Preprepares to followers 1 and 2 — no pair of "
            "correct nodes may adopt divergent configs at any checkpoint, "
            "and all must converge on the final (last-committed) config",
            reqs_per_client=30,
            reconfigs=(
                ReconfigPoint(
                    client_id=4, req_no=3, build=_mel_reconfig(40)
                ),
                ReconfigPoint(
                    client_id=5, req_no=3, build=_mel_reconfig(80)
                ),
            ),
            adversaries=(
                Adversary(
                    kind="equivocate", node=0, victims=(1, 2), until_ms=3000
                ),
            ),
            expect_epoch_change=True,
            heal_points_ms=(3000,),
            recovery_bound_ms=300_000,
            max_steps=2_000_000,
            tags=("reconfig", "adversary"),
        ),
    ]


# The tier-1 smoke subset: one partition-with-heal, one crash-with-
# restart, one device-plane failure, one committed node-set
# reconfiguration — the four disruption families.
SMOKE_NAMES = (
    "partition-minority",
    "crash-restart",
    "device-digest-dies",
    "reconfig-add-node",
)


def reconfig_matrix() -> list:
    """The dynamic-membership subset of the matrix (committed
    reconfigurations under crashes/partitions/equivocation), selected by
    ``chaos --reconfig``."""
    return [s for s in matrix() if "reconfig" in s.tags]


def smoke_matrix() -> list:
    by_name = {s.name: s for s in matrix()}
    return [by_name[name] for name in SMOKE_NAMES]


def adversary_matrix() -> list:
    """The Byzantine subset of the matrix (corrupt / equivocate / censor /
    flood attacks), selected by ``chaos --adversary``."""
    return [s for s in matrix() if "adversary" in s.tags]


# The tier-1 adversary smoke: one equivocation forcing suspicion + epoch
# change, one duplication flood against the dedup path — the two attack
# families with the richest invariants, cheap enough for tier-1.
ADVERSARY_SMOKE_NAMES = (
    "equivocate-majority-suspect",
    "flood-duplicate-proposes",
)


def adversary_smoke_matrix() -> list:
    by_name = {s.name: s for s in matrix()}
    return [by_name[name] for name in ADVERSARY_SMOKE_NAMES]


def live_matrix() -> list:
    """The live-cluster campaign (chaos/live.py): the shared structured
    scenarios from the deterministic matrix, plus the one fault family
    only a real runtime can express (failing fsyncs)."""
    by_name = {s.name: s for s in matrix()}
    return [
        by_name["crash-restart"],
        by_name["partition-minority"],
        by_name["drop-10pct"],
        by_name["leader-isolation-epoch-change"],
        by_name["signed-verifier-dies"],
        Scenario(
            name="fsync-dies-restart",
            description="node 2's disk starts failing fsyncs at 3s; the "
            "runtime fails loudly, is crash-killed, and reboots with a "
            "healthy disk 4s later (live only)",
            storage_faults=(
                StorageFault(at_ms=3000, node=2, restart_delay_ms=4000),
            ),
            tags=("storage", "live"),
        ),
    ]


# The tier-1 live smoke: one crash+restart, one partition+heal — real
# sockets and fsyncs under a hard wall-clock budget.
LIVE_SMOKE_NAMES = ("crash-restart", "partition-minority")


def live_smoke_matrix() -> list:
    by_name = {s.name: s for s in live_matrix()}
    return [by_name[name] for name in LIVE_SMOKE_NAMES]


# The live adversary campaign (`chaos --live --adversary`): the shared
# structured Adversary scenarios the live driver can lower onto its
# frame-rewriting proxies and the signed ingress gate.
LIVE_ADVERSARY_NAMES = (
    "corrupt-propose-signed",
    "equivocate-minority-straggler",
    "censor-client-rotation",
    "flood-duplicate-proposes",
    "forged-mac-storm",
    "forged-aggregate-cert",
)


def transfer_corrupt_scenario() -> Scenario:
    """Live-only (the snapshot transfer lane exists on the real
    transport, not in the deterministic engine): a rebooted straggler
    must catch up by state transfer while its deterministic first donor
    (node 0 — the fetcher walks its peer list in order) corrupts every
    chunk it serves.  The digest chain must reject 100% of the
    corruption with counter evidence, and the fetch must fail over to
    an honest donor and still install a certified snapshot."""
    return Scenario(
        name="transfer-corrupt-stream",
        description=(
            "node 2 reboots far behind a fast-checkpointing cluster; "
            "every snapshot chunk its first donor sends is bit-flipped "
            "or truncated in flight — the digest chain rejects all of "
            "it and the fetch fails over to an honest donor"
        ),
        reqs_per_client=20,
        crashes=(CrashPoint(at_ms=2000, node=2, restart_delay_ms=6000),),
        adversaries=(
            Adversary(
                kind="corrupt",
                node=0,
                victims=(2,),
                msg_kinds=("SnapshotChunk",),
            ),
        ),
        network_state=_rotating_network_state(
            max_epoch_length=60, checkpoint_interval=6
        ),
        tags=("adversary", "transfer", "live"),
    )


def live_adversary_matrix() -> list:
    by_name = {s.name: s for s in matrix()}
    return [by_name[name] for name in LIVE_ADVERSARY_NAMES] + [
        transfer_corrupt_scenario()
    ]
