"""Fault-injection mangler DSL for the testengine.

Rebuild of the reference's mangler language (reference:
testengine/manglers.go:45-718): composable predicates over scheduled
events, temporal combinators, and the actions Drop / Delay / Jitter /
Duplicate / CrashAndRestartAfter.  A mangler is a callable
``(recorder, when, node, event) -> verdict`` where the verdict is ``None``
(drop), one ``(when, node, event)`` tuple, or a list of tuples
(duplication); the engine folds the candidate set through every mangler
(engine._schedule).

All randomness draws from ``recorder.rng`` so mangled runs stay
reproducible from the seed.

Usage (mirroring the reference's scenarios, mirbft_test.go:68-222)::

    rule(is_step()).jitter(30)                              # 30ms jitter
    rule(is_step(), percent(75)).duplicate(300)             # 75% duplication
    rule(msg_type("RequestAck"), from_source(1, 2),
         percent(70)).drop()                                # targeted ack loss
    rule(to_node(1), after_events(30), once()
         ).crash_and_restart_after(5000)                    # crash + reboot
"""

from __future__ import annotations

from .. import pb


# ---------------------------------------------------------------------------
# Predicates: (recorder, when, node, event) -> bool
# ---------------------------------------------------------------------------


def is_step():
    """Matches inbound network messages (EventStep) — what 'the network'
    can observe and disturb."""

    def pred(_recorder, _when, _node, event):
        return isinstance(event.type, pb.EventStep)

    return pred


def event_type(*names: str):
    def pred(_recorder, _when, _node, event):
        return type(event.type).__name__ in names

    return pred


def msg_type(*names: str):
    """Matches EventStep events carrying one of these message kinds."""

    def pred(_recorder, _when, _node, event):
        inner = event.type
        return (
            isinstance(inner, pb.EventStep)
            and inner.msg is not None
            and type(inner.msg.type).__name__ in names
        )

    return pred


def from_source(*sources: int):
    """Matches EventStep events sent by one of these nodes."""

    def pred(_recorder, _when, _node, event):
        inner = event.type
        return isinstance(inner, pb.EventStep) and inner.source in sources

    return pred


def to_node(*nodes: int):
    """Matches events delivered to one of these nodes."""

    def pred(_recorder, _when, node, _event):
        return node in nodes

    return pred


def from_client(*client_ids: int):
    """Matches proposals, request acks, and forwarded requests of these
    clients — every event through which a node can learn of a client's
    request, which is exactly the surface a censoring leader suppresses."""

    def pred(_recorder, _when, _node, event):
        pair = request_identity(event)
        return pair is not None and pair[0] in client_ids

    return pred


def is_propose():
    """Matches local client-ingress proposals (EventPropose)."""

    def pred(_recorder, _when, _node, event):
        return isinstance(event.type, pb.EventPropose)

    return pred


def with_seq_no(low: int, high: int):
    """Matches 3-phase messages whose seq_no lies in [low, high]."""

    def pred(_recorder, _when, _node, event):
        inner = event.type
        if not isinstance(inner, pb.EventStep) or inner.msg is None:
            return False
        msg = inner.msg.type
        seq = getattr(msg, "seq_no", None)
        return seq is not None and low <= seq <= high

    return pred


def percent(p: float):
    """Matches p% of the events reaching it (seeded rng)."""

    def pred(recorder, _when, _node, _event):
        return recorder.rng.random() * 100 < p

    return pred


# Temporal combinators (stateful; one instance per rule).


def after_events(n: int):
    """Matches only from the n-th candidate event this predicate sees."""
    seen = [0]

    def pred(_recorder, _when, _node, _event):
        seen[0] += 1
        return seen[0] > n

    return pred


def until_events(n: int):
    """Matches only the first n candidate events this predicate sees."""
    seen = [0]

    def pred(_recorder, _when, _node, _event):
        seen[0] += 1
        return seen[0] <= n

    return pred


def after_time(ms: int):
    def pred(_recorder, when, _node, _event):
        return when >= ms

    return pred


def until_time(ms: int):
    def pred(_recorder, when, _node, _event):
        return when < ms

    return pred


def once():
    """Matches exactly one event (combine after the other predicates)."""
    fired = [False]

    def pred(_recorder, _when, _node, _event):
        if fired[0]:
            return False
        fired[0] = True
        return True

    return pred


# ---------------------------------------------------------------------------
# Adversarial helpers
# ---------------------------------------------------------------------------


def request_identity(event) -> tuple[int, int] | None:
    """The (client_id, req_no) a request-carrying event speaks for, or None.

    Covers the three delivery paths a request can take to a node: local
    proposal (EventPropose), ack gossip (RequestAck), and data forwarding
    (ForwardRequest)."""
    inner = event.type
    if isinstance(inner, pb.EventPropose) and inner.request is not None:
        req = inner.request
        return (req.client_id, req.req_no)
    if isinstance(inner, pb.EventStep) and inner.msg is not None:
        msg = inner.msg.type
        if isinstance(msg, pb.RequestAck):
            return (msg.client_id, msg.req_no)
        if isinstance(msg, pb.ForwardRequest) and msg.request_ack is not None:
            ack = msg.request_ack
            return (ack.client_id, ack.req_no)
    return None


def _flip_bytes(data: bytes, rng, flips: int) -> bytes:
    """Returns data with up to ``flips`` bytes XOR-ed against nonzero masks
    (seeded rng) — guaranteed != data whenever data is non-empty."""
    if not data:
        return data
    mutated = bytearray(data)
    for _ in range(max(flips, 1)):
        pos = rng.randrange(len(mutated))
        mutated[pos] ^= rng.randint(1, 255)
    return bytes(mutated)


def _variant_digest(digest: bytes) -> bytes:
    """Deterministic conflicting digest for an equivocated batch: same for
    every victim of the same (epoch, seq), so the equivocating leader tells
    one consistent lie per subset — the hardest case for fork detection."""
    if not digest:
        return b"\xff"
    return digest[:-1] + bytes([digest[-1] ^ 0xFF])


def _restep(inner: "pb.EventStep", msg) -> "pb.StateEvent":
    """A fresh EventStep event carrying ``msg`` from the same source; never
    mutates the original (other targets share the event object)."""
    return pb.StateEvent(
        type=pb.EventStep(source=inner.source, msg=pb.Msg(type=msg))
    )


# ---------------------------------------------------------------------------
# Rules and actions
# ---------------------------------------------------------------------------


class _Rule:
    """Predicates are AND-ed left to right; later (stateful temporal)
    predicates only see events the earlier ones matched — so
    ``rule(msg_type("Prepare"), until_events(5))`` means 'the first five
    Prepares', like the reference's fluent chains."""

    def __init__(self, predicates):
        self.predicates = list(predicates)

    def _matches(self, recorder, when, node, event) -> bool:
        return all(
            predicate(recorder, when, node, event)
            for predicate in self.predicates
        )

    def drop(self):
        """Drops matched events.  The returned mangler counts casualties on
        its ``dropped`` attribute (mirrors partition())."""

        def mangler(recorder, when, node, event):
            if self._matches(recorder, when, node, event):
                mangler.dropped += 1
                return None
            return (when, node, event)

        mangler.dropped = 0
        return mangler

    def delay(self, ms: int):
        def mangler(recorder, when, node, event):
            if self._matches(recorder, when, node, event):
                return (when + ms, node, event)
            return (when, node, event)

        return mangler

    def jitter(self, max_ms: int):
        def mangler(recorder, when, node, event):
            if self._matches(recorder, when, node, event):
                return (when + recorder.rng.randint(0, max_ms), node, event)
            return (when, node, event)

        return mangler

    def duplicate(self, max_delay_ms: int):
        """Duplicates matched events with a delayed echo.  The returned
        mangler counts echoes on its ``duplicated`` attribute."""

        def mangler(recorder, when, node, event):
            if self._matches(recorder, when, node, event):
                echo = when + recorder.rng.randint(1, max(max_delay_ms, 1))
                mangler.duplicated += 1
                return [(when, node, event), (echo, node, event)]
            return (when, node, event)

        mangler.duplicated = 0
        return mangler

    def corrupt(self, byte_flips: int = 1):
        """Flips payload/digest bytes of matched events in flight (seeded
        rng), modelling a compromised link or leader that tampers with
        content rather than delivery.  Rewrites — never mutates — the event:

        * EventPropose: the request data (signed mode must reject it);
        * RequestAck / Prepare / Commit: the digest;
        * ForwardRequest: the forwarded request data (the receiver's digest
          re-verification must drop it);
        * Preprepare: one batch entry's digest.

        Counts rewrites on ``corrupted``, and the EventPropose subset —
        the deliveries a signature plane is obligated to reject — on
        ``corrupted_proposes``."""

        def mangler(recorder, when, node, event):
            if not self._matches(recorder, when, node, event):
                return (when, node, event)
            rng = recorder.rng
            inner = event.type
            if isinstance(inner, pb.EventPropose) and inner.request is not None:
                req = inner.request
                twisted = _flip_bytes(req.data, rng, byte_flips)
                if twisted == req.data:
                    return (when, node, event)
                mangler.corrupted += 1
                mangler.corrupted_proposes += 1
                forged = pb.Request(
                    client_id=req.client_id, req_no=req.req_no, data=twisted
                )
                return (when, node, pb.StateEvent(type=pb.EventPropose(request=forged)))
            if isinstance(inner, pb.EventStep) and inner.msg is not None:
                msg = inner.msg.type
                if isinstance(msg, pb.RequestAck):
                    mangler.corrupted += 1
                    forged = pb.RequestAck(
                        client_id=msg.client_id,
                        req_no=msg.req_no,
                        digest=_flip_bytes(msg.digest, rng, byte_flips),
                    )
                    return (when, node, _restep(inner, forged))
                if isinstance(msg, (pb.Prepare, pb.Commit)):
                    mangler.corrupted += 1
                    forged = type(msg)(
                        seq_no=msg.seq_no,
                        epoch=msg.epoch,
                        digest=_flip_bytes(msg.digest, rng, byte_flips),
                    )
                    return (when, node, _restep(inner, forged))
                if isinstance(msg, pb.ForwardRequest) and msg.request_ack is not None:
                    mangler.corrupted += 1
                    forged = pb.ForwardRequest(
                        request_ack=msg.request_ack,
                        request_data=_flip_bytes(msg.request_data, rng, byte_flips),
                    )
                    return (when, node, _restep(inner, forged))
                if isinstance(msg, pb.Preprepare) and msg.batch:
                    mangler.corrupted += 1
                    victim = rng.randrange(len(msg.batch))
                    batch = list(msg.batch)
                    ack = batch[victim]
                    batch[victim] = pb.RequestAck(
                        client_id=ack.client_id,
                        req_no=ack.req_no,
                        digest=_flip_bytes(ack.digest, rng, byte_flips),
                    )
                    forged = pb.Preprepare(
                        seq_no=msg.seq_no, epoch=msg.epoch, batch=batch
                    )
                    return (when, node, _restep(inner, forged))
            return (when, node, event)

        mangler.corrupted = 0
        mangler.corrupted_proposes = 0
        return mangler

    def equivocate(self, victims):
        """The matched Preprepare's sender lies to ``victims``: they receive
        a conflicting batch (every digest swapped for a deterministic
        variant) for the same (epoch, seq), while other nodes see the real
        one — the paper's equivocating-leader attack.  The variant digests
        reference no existing request, so a victim can never assemble the
        batch: either the honest subset still reaches quorum (victims catch
        up via state transfer) or the sequence stalls and the suspect
        machinery rotates the liar out.  Counts rewrites on ``equivocated``
        and records {(epoch, seq): (real digests, variant digests)} on
        ``variants`` for the no-fork audit."""
        victim_set = frozenset(victims)

        def mangler(recorder, when, node, event):
            if node in victim_set and self._matches(recorder, when, node, event):
                inner = event.type
                if (
                    isinstance(inner, pb.EventStep)
                    and inner.msg is not None
                    and isinstance(inner.msg.type, pb.Preprepare)
                    and inner.msg.type.batch
                ):
                    msg = inner.msg.type
                    batch = [
                        pb.RequestAck(
                            client_id=a.client_id,
                            req_no=a.req_no,
                            digest=_variant_digest(a.digest),
                        )
                        for a in msg.batch
                    ]
                    mangler.equivocated += 1
                    mangler.variants[(msg.epoch, msg.seq_no)] = (
                        tuple(a.digest for a in msg.batch),
                        tuple(a.digest for a in batch),
                    )
                    forged = pb.Preprepare(
                        seq_no=msg.seq_no, epoch=msg.epoch, batch=batch
                    )
                    return (when, node, _restep(inner, forged))
            return (when, node, event)

        mangler.equivocated = 0
        mangler.variants = {}
        return mangler

    def censor(self):
        """Silently drops matched request-carrying events — a censoring
        leader suppressing targeted clients at ingress.  Unlike ``drop()``
        it only swallows events that speak for a request (proposals, acks,
        forwards) and records which (client_id, req_no) pairs were censored
        on ``censored_pairs``, so the liveness audit can assert each one
        still commits once bucket rotation hands the bucket to an honest
        leader.  Combine with ``to_node(leader)`` + ``from_client(...)``."""

        def mangler(recorder, when, node, event):
            if self._matches(recorder, when, node, event):
                pair = request_identity(event)
                if pair is not None:
                    mangler.censored += 1
                    mangler.censored_pairs.add(pair)
                    return None
            return (when, node, event)

        mangler.censored = 0
        mangler.censored_pairs = set()
        return mangler

    def flood(self, copies: int, max_delay_ms: int):
        """Duplication / stale-ack storm: every matched event is delivered,
        plus ``copies`` echoes spread over (0, max_delay_ms] (seeded rng).
        With a large delay the echoes arrive long after the original
        committed — the paper's stale-ack attack on the dedup path.  Counts
        echoes on ``flooded``."""

        def mangler(recorder, when, node, event):
            if self._matches(recorder, when, node, event):
                out = [(when, node, event)]
                for _ in range(copies):
                    echo = when + recorder.rng.randint(1, max(max_delay_ms, 1))
                    out.append((echo, node, event))
                mangler.flooded += copies
                return out
            return (when, node, event)

        mangler.flooded = 0
        return mangler

    def crash_and_restart_after(self, delay_ms: int, node: int | None = None):
        """On match, crash the event's target node (or the given node) and
        boot it from its durable state delay_ms later (reference:
        manglers.go:696-718, which injects a fresh Initialize).  Combine
        with once() unless repeated crashes are intended."""

        def mangler(recorder, when, target, event):
            if self._matches(recorder, when, target, event):
                victim = node if node is not None else target
                recorder.crash(victim)
                recorder.schedule_restart(victim, delay_ms)
                return None  # the triggering event dies with the node
            return (when, target, event)

        return mangler


def rule(*predicates) -> _Rule:
    return _Rule(predicates)


# ---------------------------------------------------------------------------
# Network partitions
# ---------------------------------------------------------------------------


def crosses_partition(groups):
    """Matches EventStep messages whose source and destination lie in
    *different* groups.  ``groups`` is an iterable of node-id collections;
    a node appearing in no group is unaffected (its traffic always
    passes), so ``[[0], [1, 2, 3]]`` isolates node 0 from the rest."""
    group_of: dict[int, int] = {}
    for gi, members in enumerate(groups):
        for member in members:
            group_of[member] = gi

    def pred(_recorder, _when, node, event):
        inner = event.type
        if not isinstance(inner, pb.EventStep):
            return False
        src = group_of.get(inner.source)
        dst = group_of.get(node)
        return src is not None and dst is not None and src != dst

    return pred


def partition(groups, from_ms: int = 0, until_ms: int | None = None):
    """Network partition with heal: every inter-group EventStep during
    [from_ms, until_ms) is dropped; traffic before the split and after the
    heal flows normally.  ``until_ms=None`` never heals.  Messages lost to
    the partition are gone for good — post-heal progress relies on the
    protocol's retransmission ticks, which is exactly the liveness property
    the chaos invariants assert.  The returned mangler counts casualties on
    its ``dropped`` attribute."""
    cross = crosses_partition(groups)

    def mangler(recorder, when, node, event):
        if (
            when >= from_ms
            and (until_ms is None or when < until_ms)
            and cross(recorder, when, node, event)
        ):
            mangler.dropped += 1
            return None
        return (when, node, event)

    mangler.dropped = 0
    return mangler
