"""Safety and liveness invariants asserted after every chaos scenario.

All checks read only harness-side state (``NodeState.committed_reqs``,
``app_chain``) — the same evidence the reference's testengine audits —
so they hold for any Recorder configuration (manglers, planes, signed
mode) without instrumenting the protocol."""

from __future__ import annotations

from dataclasses import dataclass, field


class InvariantViolation(AssertionError):
    """A chaos invariant failed; the message names scenario evidence."""


@dataclass
class CrashSnapshot:
    """What a node had durably committed the instant it was crashed."""

    node: int
    at_ms: int
    committed: list = field(default_factory=list)  # [(client, req_no, seq)]


def committed_by_seq(committed_reqs: list) -> dict:
    """[(client, req_no, seq)] -> {seq: ((client, req_no), ...)} preserving
    the within-batch commit order."""
    by_seq: dict = {}
    for client, req_no, seq in committed_reqs:
        by_seq.setdefault(seq, []).append((client, req_no))
    return {seq: tuple(reqs) for seq, reqs in by_seq.items()}


def check_no_fork(rec) -> dict:
    """Committed prefixes agree: every sequence number committed anywhere
    was committed with identical request content (and order) everywhere it
    was committed; per node, commits are seq-ordered and no request
    commits twice.  Returns the canonical {seq: requests} map."""
    canonical: dict = {}
    owner: dict = {}
    for node in range(rec.node_count):
        reqs = rec.node_states[node].committed_reqs
        seqs = [seq for _c, _q, seq in reqs]
        if seqs != sorted(seqs):
            raise InvariantViolation(
                f"node {node} committed out of seq order: {seqs}"
            )
        pairs = [(c, q) for c, q, _s in reqs]
        if len(pairs) != len(set(pairs)):
            dupes = {p for p in pairs if pairs.count(p) > 1}
            raise InvariantViolation(
                f"node {node} committed requests twice: {sorted(dupes)}"
            )
        for seq, batch in committed_by_seq(reqs).items():
            if seq not in canonical:
                canonical[seq] = batch
                owner[seq] = node
            elif canonical[seq] != batch:
                raise InvariantViolation(
                    f"fork at seq {seq}: node {owner[seq]} committed "
                    f"{canonical[seq]}, node {node} committed {batch}"
                )
    return canonical


def check_durable_prefix(rec, snapshots: list) -> None:
    """Everything a node committed before its crash survives the replay:
    the pre-crash commit log is a strict prefix of the node's final log
    (the post-restart history *continues* it, never rewrites it)."""
    for snap in snapshots:
        final = rec.node_states[snap.node].committed_reqs
        if len(final) < len(snap.committed):
            raise InvariantViolation(
                f"node {snap.node} lost commits across restart: had "
                f"{len(snap.committed)} at crash (t={snap.at_ms}ms), "
                f"has {len(final)} after recovery"
            )
        prefix = final[: len(snap.committed)]
        if prefix != snap.committed:
            for i, (pre, post) in enumerate(zip(snap.committed, prefix)):
                if pre != post:
                    raise InvariantViolation(
                        f"node {snap.node} rewrote durable history at "
                        f"commit {i}: {pre} became {post}"
                    )


def check_full_convergence(rec) -> None:
    """Every node (including restarted ones) committed every request and
    the application hash chains agree — the end-state the drain targets."""
    total = sum(c.total_reqs for c in rec.clients.values())
    for node in range(rec.node_count):
        if rec.node_states[node].crashed:
            raise InvariantViolation(f"node {node} still down at drain end")
        got = rec.committed_at(node)
        if got < total:
            raise InvariantViolation(
                f"node {node} committed {got}/{total} requests"
            )
    chains = {rec.node_states[n].app_chain for n in range(rec.node_count)}
    if len(chains) != 1:
        raise InvariantViolation(
            f"app chains diverge across nodes: {len(chains)} distinct"
        )


def check_no_vector_divergence(rec) -> None:
    """The ``_FastAcks`` vector ack path provably agrees with the scalar
    reference path on every node: the shadow oracle (obsv.shadow)
    re-derives weak/strong/available membership and tick classes from the
    mirror's masks and diffs them against the live objects; trackers
    running the device ack plane (core.device_tracker) are audited the
    same way against their dense arrays.  Vacuous on nodes that never
    built either plane (the scalar path IS the reference).

    Unlike the other invariants this one reads protocol-internal state,
    not harness evidence — it is exactly the determinism precondition Mir
    assumes of its replicas, checked from the inside."""
    from ..obsv import shadow

    for node in range(rec.node_count):
        tracker = rec.machines[node].client_tracker
        if (
            getattr(tracker, "_fast", None) is None
            and getattr(tracker, "_device", None) is None
        ):
            continue
        divs = shadow.audit_tracker(tracker)
        if divs:
            first = divs[0]
            raise InvariantViolation(
                f"node {node}: vector ack path diverged from the scalar "
                f"reference in {len(divs)} place(s); first: "
                f"{first['component']} at client {first['client_id']} "
                f"req_no {first['req_no']} ({first['detail']})"
            )


def check_commit_resumption(
    commit_times_ms: list, heal_ms: int, bound_ms: int
) -> None:
    """Liveness after heal, pointwise: the cluster did not merely finish
    eventually — it *resumed committing* within ``bound_ms`` of the heal
    (or restart) instant.  ``commit_times_ms`` is every instant at which
    the total committed-request count grew (simulated ms under the
    deterministic runner, wall ms under the live driver)."""
    after = [t for t in commit_times_ms if t >= heal_ms]
    if not after:
        raise InvariantViolation(
            f"no commits at all after the heal at {heal_ms}ms"
        )
    first = min(after)
    if first - heal_ms > bound_ms:
        raise InvariantViolation(
            f"commits resumed {first - heal_ms}ms after the heal at "
            f"{heal_ms}ms (bound: {bound_ms}ms)"
        )


def check_no_fork_under_equivocation(
    rec, variants: dict, expect_suspicion: bool = False, base_epoch: int = 1
) -> dict:
    """The equivocating leader never forked the log: for every (epoch, seq)
    where victims received a conflicting Preprepare, at most one of the two
    batches committed anywhere — asserted via the per-seq content audit
    plus app-chain agreement (the chain hashes the committed digests, so a
    victim committing the variant batch would diverge even though its
    (client, req_no) pairs match the real one).  ``variants`` is the
    equivocate mangler's {(epoch, seq): (real, variant)} evidence; an empty
    map means the adversary never fired and the scenario proves nothing.
    With ``expect_suspicion`` the liar must also have been rotated out
    (the honest quorum suspected it and changed epochs)."""
    if not variants:
        raise InvariantViolation(
            "equivocation scenario rewrote no Preprepares (vacuous)"
        )
    canonical = check_no_fork(rec)
    live = [n for n in range(rec.node_count) if not rec.node_states[n].crashed]
    chains = {rec.node_states[n].app_chain for n in live}
    if len(chains) != 1:
        raise InvariantViolation(
            f"app chains diverge under equivocation ({len(chains)} distinct):"
            f" a victim committed the variant batch"
        )
    if expect_suspicion:
        # base_epoch is the epoch every run negotiates at boot (the seed
        # WAL's FEntry ends epoch 0) — suspicion evidence means moving
        # beyond it.
        epochs = [
            rec.machines[n].epoch_tracker.current_epoch.number for n in live
        ]
        if max(epochs) <= base_epoch:
            raise InvariantViolation(
                "equivocating leader was never suspected: no epoch change "
                f"(epochs {epochs}) despite {len(variants)} equivocated seqs"
            )
    return canonical


def check_censorship_liveness(
    rec,
    censored_pairs: set,
    commit_epochs: dict,
    k: int,
    expect_rotation: bool = True,
) -> None:
    """Censorship is defeated by bucket rotation: every (client_id, req_no)
    the leader censored still committed, and did so within ``k`` epoch
    rotations.  ``commit_epochs`` maps each censored pair to the rotation
    count (epochs beyond the first working epoch) observed when it first
    committed anywhere, collected by the runner as commits land.  With
    ``expect_rotation`` at least one censored request must have *needed* a
    rotation — otherwise the censor never owned a victim bucket and the
    scenario proves nothing."""
    if not censored_pairs:
        raise InvariantViolation(
            "censorship scenario suppressed no requests (vacuous)"
        )
    missing = sorted(
        pair
        for pair in censored_pairs
        if pair[1] not in rec.clients[pair[0]].committed_anywhere
    )
    if missing:
        raise InvariantViolation(
            f"censored requests never committed: {missing[:10]}"
            f"{'...' if len(missing) > 10 else ''}"
        )
    late = sorted(
        (pair, epoch)
        for pair, epoch in commit_epochs.items()
        if epoch > k
    )
    if late:
        raise InvariantViolation(
            f"censored requests took more than {k} epoch rotations to "
            f"commit: {late[:10]}"
        )
    if expect_rotation and (
        not commit_epochs or max(commit_epochs.values()) < 1
    ):
        raise InvariantViolation(
            "no censored request needed an epoch rotation to commit — the "
            "censoring leader never owned a victim bucket (vacuous scenario)"
        )


def check_corruption_rejected(rejections: int, corrupted: int) -> None:
    """Signed mode rejects 100% of in-flight corruptions: every proposal
    delivery the adversary rewrote was refused at ingress authentication —
    no more (honest traffic passes) and no fewer (nothing slips through).
    Engine-agnostic: the deterministic runner passes the Recorder's
    ``byzantine_rejections``, the live driver its gate counter."""
    if corrupted <= 0:
        raise InvariantViolation(
            "corruption scenario rewrote no proposals (vacuous)"
        )
    if rejections != corrupted:
        raise InvariantViolation(
            f"signed mode rejected {rejections} of {corrupted} corrupted "
            "proposal deliveries"
        )


def check_flood_bounded(
    rec, flooded: int, wal_bound: int | None = None
) -> None:
    """Duplication/stale-ack floods are absorbed: every request still
    committed exactly once per node, the request store holds at most one
    entry per distinct request (echoes deduplicated, no unbounded memory),
    and the WAL stayed within its checkpoint-truncation envelope (no
    unbounded disk).  ``flooded`` is the adversary's echo count; zero means
    the flood never fired and the scenario proves nothing."""
    if flooded <= 0:
        raise InvariantViolation("flood scenario injected no echoes (vacuous)")
    total = sum(c.total_reqs for c in rec.clients.values())
    if wal_bound is None:
        ci = rec.initial_state.config.checkpoint_interval
        # Post-truncation WAL retains the entries above the last stable
        # checkpoint: up to ~2 in-flight checkpoint windows of QEntry+PEntry
        # pairs plus epoch-change records.
        wal_bound = 10 * ci + 8 * rec.node_count + 64
    for node in range(rec.node_count):
        state = rec.node_states[node]
        pairs = [(c, q) for c, q, _s in state.committed_reqs]
        if len(pairs) != len(set(pairs)):
            dupes = sorted({p for p in pairs if pairs.count(p) > 1})
            raise InvariantViolation(
                f"flood broke exactly-once at node {node}: {dupes[:10]}"
            )
        if len(state.reqstore) > total:
            raise InvariantViolation(
                f"flood grew node {node}'s request store to "
                f"{len(state.reqstore)} entries for {total} distinct requests"
            )
        if len(state.wal) > wal_bound:
            raise InvariantViolation(
                f"flood grew node {node}'s WAL to {len(state.wal)} entries "
                f"(bound {wal_bound}): checkpoint truncation fell behind"
            )


def check_bounded_catchup(
    join_ms: int, frontier_ms: int | None, bound_ms: int
) -> None:
    """A freshly joined (or far-behind) node reached the cluster's commit
    frontier — via checkpoint-anchored snapshot state transfer — within
    ``bound_ms`` of its join instant.  ``frontier_ms`` is the wall (or
    simulated) instant the joiner first held the certified checkpoint
    state; ``None`` means it never caught up."""
    if frontier_ms is None:
        raise InvariantViolation(
            f"joined node never reached the commit frontier (joined at "
            f"{join_ms}ms)"
        )
    lag = frontier_ms - join_ms
    if lag > bound_ms:
        raise InvariantViolation(
            f"joined node took {lag}ms after joining at {join_ms}ms to "
            f"reach the commit frontier (bound: {bound_ms}ms)"
        )


def check_transfer_corruption_rejected(
    rejections: int, corrupted: int
) -> None:
    """Snapshot-transfer streams the adversary corrupted/truncated were
    refused by the fetcher's digest-chain and certificate verification.
    ``corrupted`` is the proxy manglers' touch count (zero = vacuous),
    ``rejections`` the engines' ``chunks_rejected_corrupt`` evidence.
    Mangled frames arriving outside an active fetch are dropped
    unattributed (stale) rather than rejected-with-evidence, so the
    audit demands rejection evidence exists rather than exact equality;
    the none-was-*adopted* half is held by the no-fork / chain-agreement
    audits, which a single accepted corrupt chunk would break."""
    if corrupted <= 0:
        raise InvariantViolation(
            "transfer-corruption scenario touched no frames (vacuous)"
        )
    if rejections <= 0:
        raise InvariantViolation(
            f"{corrupted} corrupted transfer frames produced no "
            "rejection evidence (chunks_rejected_corrupt == 0)"
        )


def check_mac_rejected(
    rejections: int, forged: int, exact: bool = True
) -> None:
    """MAC-authenticated replica channels reject 100% of forged/tampered
    node-to-node traffic.  ``forged`` is the adversary's touch count
    (zero = vacuous); ``rejections`` the MAC layer's evidence — the
    deterministic MacSealPlane's counter or the live transports'
    ``mac_rejections`` sum.

    The deterministic engine delivers every forged message exactly once,
    so the audit demands exact equality (``exact=True``: no more —
    honest traffic passes — and no fewer — nothing slips through).  On
    the live transport a forged frame can die with its TCP connection
    before reaching the receiver (reconnects, shutdown races), so the
    live audit demands rejection evidence exists and never exceeds the
    forgery count; the none-was-*accepted* half is held by the no-fork /
    convergence audits, which a single admitted forgery would break."""
    if forged <= 0:
        raise InvariantViolation(
            "MAC-forgery scenario touched no replica frames (vacuous)"
        )
    if exact and rejections != forged:
        raise InvariantViolation(
            f"MAC layer rejected {rejections} of {forged} forged replica "
            "messages"
        )
    if not exact:
        if rejections <= 0:
            raise InvariantViolation(
                f"{forged} forged replica frames produced no MAC "
                "rejection evidence (mac_rejections == 0)"
            )
        if rejections > forged:
            raise InvariantViolation(
                f"MAC layer rejected {rejections} frames but the "
                f"adversary only forged {forged} — honest traffic was "
                "refused"
            )


def check_aggregate_cert_rejected(
    genuine_ok: int,
    genuine_total: int,
    forged_rejected: int,
    forged_total: int,
) -> None:
    """Aggregate quorum certificates are sound both ways: every genuine
    certificate the cluster produced verifies under one aggregate check,
    and every forged variant (mismatched statement, wrong signer set) is
    rejected — 100%, with vacuity guards on both sides."""
    if genuine_total <= 0:
        raise InvariantViolation(
            "certificate audit saw no quorum certificates (vacuous — the "
            "run never reached a stable checkpoint)"
        )
    if genuine_ok != genuine_total:
        raise InvariantViolation(
            f"only {genuine_ok} of {genuine_total} genuine aggregate "
            "certificates verified"
        )
    if forged_total <= 0:
        raise InvariantViolation(
            "certificate audit built no forged variants (vacuous)"
        )
    if forged_rejected != forged_total:
        raise InvariantViolation(
            f"only {forged_rejected} of {forged_total} forged aggregate "
            "certificates were rejected"
        )


def audit_aggregate_certs(certs: dict) -> tuple:
    """Exercise the qc seam over a run's quorum certificates:
    ``certs`` maps (seq_no, value) -> (signer ids, aggregate signature)
    (CheckpointCertPlane.certificates(), or the live synthesis).  Every
    genuine certificate must verify; per certificate two forgeries are
    attempted — a mismatched statement (wrong seq_no under a valid
    aggregate) and a wrong signer set (aggregate public key excludes a
    voter) — and must fail.  Returns
    ``(genuine_ok, genuine_total, forged_rejected, forged_total)`` for
    :func:`check_aggregate_cert_rejected`."""
    from ..testengine.certs import CheckpointCertPlane, node_seed, statement
    from ..crypto import qc

    genuine_ok = forged_rejected = forged_total = 0
    for (seq_no, value), (signers, asig) in certs.items():
        if CheckpointCertPlane.verify(seq_no, value, signers, asig):
            genuine_ok += 1
        # Forgery 1: valid aggregate, mismatched statement.
        forged_total += 1
        if not CheckpointCertPlane.verify(seq_no + 1, value, signers, asig):
            forged_rejected += 1
        # Forgery 2: wrong signer set — the aggregate public key drops
        # one voter and claims a non-voter instead.
        forged_total += 1
        imposter = max(signers) + 1
        wrong = list(signers[1:]) + [imposter]
        pks = [qc.public_key(node_seed(n)) for n in wrong]
        if not qc.verify_cert(pks, statement(seq_no, value), asig):
            forged_rejected += 1
    return genuine_ok, len(certs), forged_rejected, forged_total


def check_bounded_recovery(
    completion_ms: int, last_disruption_end_ms: int, bound_ms: int
) -> None:
    """Liveness resumed: the run reached full commitment within
    ``bound_ms`` of simulated time after the last heal/restart instant."""
    lag = completion_ms - max(last_disruption_end_ms, 0)
    if lag > bound_ms:
        raise InvariantViolation(
            f"recovery took {lag}ms of simulated time after the last "
            f"disruption ended (bound: {bound_ms}ms)"
        )


def check_config_agreement(
    checkpoint_configs: dict, final_configs: dict, adoptions: int
) -> dict:
    """Dynamic membership never splits the configuration: no two correct
    nodes certify divergent network configs at the same checkpoint
    sequence number, and every correct survivor converges to the same
    final active config.

    Engine-agnostic evidence:

    - ``checkpoint_configs``: {node: {seq_no: config_bytes}} — the
      ``pb.encode``'d NetworkConfig each node bound into its checkpoint
      at each stable seq (the deterministic runner reads
      ``NodeState.checkpoints``, the live driver each worker's
      checkpoints.jsonl).
    - ``final_configs``: {node: config_bytes} — each correct survivor's
      active config at drain end.
    - ``adoptions``: total reconfiguration-adoption events observed
      across nodes (``reconfigs_adopted`` / reconfig.json evidence).

    Vacuity guard: at least one adoption must have been observed —
    otherwise no reconfiguration ever activated and agreement is
    trivially true.  Returns tally evidence."""
    if adoptions < 1:
        raise InvariantViolation(
            "reconfig scenario adopted no reconfiguration (vacuous): "
            "config agreement proves nothing"
        )
    canonical: dict = {}  # seq -> (config_bytes, node)
    compared = 0
    for node in sorted(checkpoint_configs):
        for seq, config in sorted(checkpoint_configs[node].items()):
            prior = canonical.get(seq)
            if prior is None:
                canonical[seq] = (config, node)
            else:
                compared += 1
                if prior[0] != config:
                    raise InvariantViolation(
                        f"config fork at checkpoint seq {seq}: node "
                        f"{prior[1]} certified {prior[0].hex()}, node "
                        f"{node} certified {config.hex()}"
                    )
    finals = {}
    for node, config in sorted(final_configs.items()):
        finals.setdefault(config, []).append(node)
    if len(finals) > 1:
        groups = {
            cfg.hex(): nodes for cfg, nodes in sorted(finals.items())
        }
        raise InvariantViolation(
            f"correct survivors diverge on the final active config: "
            f"{groups}"
        )
    return {
        "adoptions": adoptions,
        "checkpoints_compared": compared,
        "survivors": len(final_configs),
    }


def check_linearizable_reads(history: list) -> dict:
    """Reads over the replicated KV never go backwards or observe forks.

    ``history`` is the KV workload's op record: dicts with ``client_id``,
    ``op`` ("get"/"put"), ``key``, ``invoke_ns``/``return_ns`` wall
    intervals, ``outcome``, ``version`` (the apply index that stamped
    the value), and ``value`` (hex) for successful ops.

    The audit is Wing&Gong-shaped but deliberately checks the decidable
    core rather than brute-force linearization search:

    - **version functionality (no forks)**: a (key, version) pair maps
      to exactly one value across every op that observed it — two
      different values under one version means diverged replicas.
    - **write-version uniqueness**: versions are apply indexes, so two
      acknowledged writes can never share a (key, version).
    - **per-session monotonic reads**: within one client session,
      successive reads of a key never observe a version older than a
      version that session already observed for it.
    - **read-your-writes**: a read issued after the same session's
      acknowledged write to that key must observe that write's version
      or newer (the write raises the session's version floor).

    Vacuity guard: the history must contain at least one read/write
    pair on the same key whose intervals overlap — otherwise the run
    never exercised read/write concurrency and a pass proves nothing.
    Returns tally evidence ``{"reads": n, "writes": n, "overlaps": n}``.
    """
    reads = [
        h for h in history if h["op"] == "get" and h["outcome"] == "ok"
    ]
    all_reads = [h for h in history if h["op"] == "get"]
    writes = [
        h for h in history if h["op"] != "get" and h["outcome"] == "ok"
    ]
    if not all_reads or not writes:
        raise InvariantViolation(
            f"KV history is vacuous: {len(all_reads)} reads / "
            f"{len(writes)} acknowledged writes"
        )

    overlaps = 0
    writes_by_key: dict = {}
    for w in writes:
        writes_by_key.setdefault(w["key"], []).append(w)
    for r in all_reads:
        for w in writes_by_key.get(r["key"], ()):
            if (
                r["invoke_ns"] < w["return_ns"]
                and w["invoke_ns"] < r["return_ns"]
            ):
                overlaps += 1
                break
    if overlaps == 0:
        raise InvariantViolation(
            "KV history is vacuous: no read's interval overlaps any "
            "write to the same key"
        )

    # Version functionality: one value per (key, version), everywhere.
    observed: dict = {}  # (key, version) -> (value_hex, who)
    for h in writes + reads:
        version = h.get("version", 0)
        value = h.get("value")
        if not version or value is None:
            continue
        prior = observed.get((h["key"], version))
        if prior is None:
            observed[(h["key"], version)] = (value, h)
        elif prior[0] != value:
            raise InvariantViolation(
                f"fork: key {h['key']!r} version {version} observed as "
                f"{prior[0]!r} (client {prior[1]['client_id']}) and "
                f"{value!r} (client {h['client_id']})"
            )

    # Write-version uniqueness.
    write_versions: dict = {}  # (key, version) -> write
    for w in writes:
        version = w.get("version", 0)
        if not version:
            continue
        prior = write_versions.get((w["key"], version))
        if prior is not None:
            raise InvariantViolation(
                f"two acknowledged writes share key {w['key']!r} "
                f"version {version} (clients {prior['client_id']} "
                f"and {w['client_id']})"
            )
        write_versions[(w["key"], version)] = w

    # Per-session ordering: monotonic reads + read-your-writes.
    by_session: dict = {}
    for h in history:
        by_session.setdefault(h["client_id"], []).append(h)
    for client_id, ops in by_session.items():
        ops.sort(key=lambda h: h["invoke_ns"])
        floor: dict = {}  # key -> highest version this session observed
        for h in ops:
            version = h.get("version", 0)
            if h["op"] == "get":
                if h["outcome"] != "ok":
                    continue
                prior = floor.get(h["key"], 0)
                if version < prior:
                    raise InvariantViolation(
                        f"session {client_id} read of {h['key']!r} went "
                        f"backwards: observed version {version} after "
                        f"{prior}"
                    )
                floor[h["key"]] = max(prior, version)
            elif h["outcome"] == "ok" and version:
                floor[h["key"]] = max(floor.get(h["key"], 0), version)

    return {
        "reads": len(all_reads),
        "writes": len(writes),
        "overlaps": overlaps,
    }
