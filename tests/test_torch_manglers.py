"""The port's mangler DSL (mirbft_tpu_torch/testengine/manglers.py) and the
engine's mangler seam held against the JAX package's.

Mirrors tests/test_manglers.py (predicates, temporal combinators, each
verdict, jitter at 30 and 1000 ms, 75% duplication, 70% ack loss, the
crash/restart DSL, boot immunity, corrupt, equivocate, censor, flood, the
adversary runs) and the mangler cases of tests/test_testengine.py
(epoch-change storm, message loss, silenced node, crash and restart).
Every run goes through both engines on the same seed with the same rules,
built once from each package's DSL, and must give the same events one for
one (count, app chains, committed sequences, every recorded event on the
wire) and the same casualty counts on the manglers.  The port's engine
runs on the hashlib plane here (the digests are not what is tested);
one case runs it on the kernel plane's plain version.

The port's core differs from the JAX package's in one place (ROADMAP.md
queue 3): a sequence advances when its batch digest comes back after the
owner's Commit.  A crash and restart makes that happen (the restarted node
replays its WAL and its digests return late), so those runs are held
against the JAX engine with the same one-line advance patched into its
``Sequence`` for the test (``late_digest_advances``); every other run is
held against the JAX package as it is, and the patch is shown to be the
whole difference."""

import pytest

from mirbft_tpu import pb as ref_pb
from mirbft_tpu.testengine import BasicRecorder as RefRecorder
from mirbft_tpu.testengine import RuntimeParameters as RefParameters
from mirbft_tpu.testengine import manglers as ref_manglers
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.testengine import BasicRecorder, RuntimeParameters
from mirbft_tpu_torch.testengine import manglers
from mirbft_tpu_torch.testengine.crypto_plane import (
    AsyncKernelHashPlane,
    CoalescingHashPlane,
)
from mirbft_tpu_torch.testengine.manglers import (
    after_events,
    event_type,
    from_client,
    from_source,
    is_step,
    msg_type,
    once,
    rule,
    to_node,
    until_events,
    with_seq_no,
)

@pytest.fixture
def late_digest_advances(monkeypatch):
    """The JAX core with the port's advance on a late batch digest
    (mirbft_tpu_torch/core/sequence.py, apply_batch_hash_result)."""
    from mirbft_tpu.core.sequence import Sequence

    def apply_batch_hash_result(self, digest):
        self.digest = digest
        actions = self.apply_prepare_msg(self.owner, digest)
        return actions.concat(self.advance_state())

    monkeypatch.setattr(Sequence, "apply_batch_hash_result",
                        apply_batch_hash_result)


#: Counters the verdicts keep on their manglers.
COUNTERS = ("dropped", "duplicated", "corrupted", "corrupted_proposes",
            "equivocated", "variants", "censored", "censored_pairs",
            "flooded")


def port_recorder(*shape, **kwargs):
    kwargs.setdefault("hash_plane", CoalescingHashPlane())
    return BasicRecorder(*shape, **kwargs)


def wire(event, module_pb) -> bytes:
    return module_pb.encode(event)


def outcome(recorder, module_pb):
    """What a run decides: events, per-node app chains and committed
    (client, req_no, seq), and every recorded event on the wire."""
    return (
        recorder.event_count,
        recorder.now,
        {n: s.app_chain.hex() for n, s in recorder.node_states.items()},
        {n: list(s.committed_reqs) for n, s in recorder.node_states.items()},
        [(when, node, wire(event, module_pb))
         for when, node, event in recorder.recorded_events],
    )


def counters(built) -> list:
    return [{name: getattr(m, name) for name in COUNTERS if hasattr(m, name)}
            for m in built]


def chains(r):
    return {n: r.node_states[n].app_chain for n in range(r.node_count)}


def exactly_once(r):
    for n in range(r.node_count):
        committed = [(c, q) for (c, q, _s) in r.node_states[n].committed_reqs]
        assert len(committed) == len(set(committed)), "duplicate commit!"


def run_both(build, shape=(4, 2, 10), max_steps=600000, **kwargs):
    """Run ``build(dsl)``'s manglers through the JAX engine and the port's
    on one seed; assert they decided the same and return the port's
    recorder and manglers."""
    params = kwargs.pop("params", None)
    ref_built = build(ref_manglers)
    ref = RefRecorder(
        *shape, manglers=ref_built, record=True,
        params=RefParameters(**params) if params else None, **kwargs,
    )
    ref.drain_clients(max_steps=max_steps)
    port_built = build(manglers)
    port = port_recorder(
        *shape, manglers=port_built, record=True,
        params=RuntimeParameters(**params) if params else None, **kwargs,
    )
    port.drain_clients(max_steps=max_steps)
    assert outcome(port, pb) == outcome(ref, ref_pb)
    assert counters(port_built) == counters(ref_built)
    return port, port_built


# -- DSL unit semantics ---------------------------------------------------------


def test_predicates_match_expected_events():
    r = port_recorder(2, 1, 1)
    step = pb.StateEvent(
        type=pb.EventStep(
            source=1,
            msg=pb.Msg(type=pb.Prepare(seq_no=7, epoch=0, digest=b"\xcc" * 32)),
        )
    )
    tick = pb.StateEvent(type=pb.EventTick())

    assert is_step()(r, 0, 0, step) and not is_step()(r, 0, 0, tick)
    assert msg_type("Prepare")(r, 0, 0, step)
    assert not msg_type("Commit")(r, 0, 0, step)
    assert event_type("EventTick")(r, 0, 0, tick)
    assert from_source(1)(r, 0, 0, step) and not from_source(0)(r, 0, 0, step)
    assert to_node(0)(r, 0, 0, step) and not to_node(1)(r, 0, 0, step)
    assert with_seq_no(5, 8)(r, 0, 0, step)
    assert not with_seq_no(8, 9)(r, 0, 0, step)

    ack = pb.StateEvent(
        type=pb.EventStep(
            source=0,
            msg=pb.Msg(type=pb.RequestAck(client_id=4, req_no=0, digest=b"d")),
        )
    )
    assert from_client(4)(r, 0, 0, ack) and not from_client(5)(r, 0, 0, ack)
    assert manglers.request_identity(ack) == (4, 0)
    assert manglers.is_propose()(r, 0, 0, pb.StateEvent(
        type=pb.EventPropose(request=pb.Request(client_id=4, req_no=1))))


def test_temporal_combinators():
    r = port_recorder(1, 1, 1)
    event = pb.StateEvent(type=pb.EventTick())

    pred = after_events(2)
    assert [pred(r, 0, 0, event) for _ in range(4)] == [
        False, False, True, True,
    ]
    pred = until_events(2)
    assert [pred(r, 0, 0, event) for _ in range(4)] == [
        True, True, False, False,
    ]
    pred = once()
    assert [pred(r, 0, 0, event) for _ in range(3)] == [True, False, False]
    pred = manglers.after_time(10)
    assert [pred(r, w, 0, event) for w in (9, 10)] == [False, True]
    pred = manglers.until_time(10)
    assert [pred(r, w, 0, event) for w in (9, 10)] == [True, False]


def test_drop_delay_duplicate_verdicts():
    r = port_recorder(1, 1, 1)
    step = pb.StateEvent(
        type=pb.EventStep(source=0, msg=pb.Msg(type=pb.Suspect(epoch=0)))
    )
    tick = pb.StateEvent(type=pb.EventTick())

    drop = rule(is_step()).drop()
    assert drop(r, 5, 0, step) is None
    assert drop(r, 5, 0, tick) == (5, 0, tick)
    assert drop.dropped == 1

    delay = rule(is_step()).delay(100)
    assert delay(r, 5, 0, step) == (105, 0, step)

    dup = rule(is_step()).duplicate(50)
    verdict = dup(r, 5, 0, step)
    assert isinstance(verdict, list) and len(verdict) == 2
    (w1, _, e1), (w2, _, e2) = verdict
    assert w1 == 5 and 6 <= w2 <= 55 and e1 is e2 is step
    assert dup.duplicated == 1

    jit = rule(is_step()).jitter(30)
    w, _, _ = jit(r, 5, 0, step)
    assert 5 <= w <= 35


def test_random_verdicts_draw_as_the_reference_does():
    """percent, jitter, duplicate, flood and corrupt draw from the
    recorder's rng in the same order and number as the JAX package's, so a
    seeded stream of candidates gets the same verdicts in both."""
    def verdicts(dsl, module_pb, recorder):
        step = module_pb.StateEvent(type=module_pb.EventStep(
            source=1, msg=module_pb.Msg(type=module_pb.Commit(
                seq_no=3, epoch=0, digest=b"\x11" * 32))))
        built = [
            dsl.rule(dsl.is_step(), dsl.percent(40)).drop(),
            dsl.rule(dsl.is_step()).jitter(30),
            dsl.rule(dsl.is_step(), dsl.percent(75)).duplicate(300),
            dsl.rule(dsl.msg_type("Commit"), dsl.percent(50)).flood(2, 900),
            dsl.rule(dsl.msg_type("Commit"), dsl.percent(50)).corrupt(3),
        ]
        out = []
        for when in range(40):
            for mangler in built:
                verdict = mangler(recorder, when, 2, step)
                for w, n, e in (verdict if isinstance(verdict, list)
                                else [] if verdict is None else [verdict]):
                    out.append((w, n, wire(e, module_pb)))
                out.append(None if verdict is None else len(
                    verdict if isinstance(verdict, list) else [verdict]))
        return out, counters(built)

    ref = verdicts(ref_manglers, ref_pb, RefRecorder(2, 1, 1, seed=11))
    port = verdicts(manglers, pb, port_recorder(2, 1, 1, seed=11))
    assert port == ref


# -- the reference's scenario matrix, run through both engines -----------------


def _rung4_shape(dsl):
    """Rung 4's rule on four nodes: half of one node's frames die for two
    simulated seconds, under the engine's own 30 ms link jitter."""
    return [dsl.rule(dsl.from_source(3), dsl.is_step(), dsl.percent(50),
                     dsl.until_time(2000)).drop()]


SCENARIOS = {
    "jitter-30ms": dict(build=lambda m: [m.rule(m.is_step()).jitter(30)]),
    "jitter-1000ms": dict(build=lambda m: [m.rule(m.is_step()).jitter(1000)]),
    "duplicate-75pct": dict(
        build=lambda m: [m.rule(m.is_step(), m.percent(75)).duplicate(300)]),
    "ack-loss-70pct-from-two-nodes": dict(
        build=lambda m: [m.rule(m.msg_type("RequestAck"), m.from_source(1, 2),
                                m.percent(70)).drop()]),
    "crash-and-restart-dsl": dict(
        late_digest=True,
        build=lambda m: [m.rule(m.to_node(1), m.is_step(), m.after_events(30),
                                m.once()).crash_and_restart_after(5000)]),
    "boot-immune-to-manglers": dict(
        shape=(4, 1, 10), late_digest=True,
        build=lambda m: [
            m.rule(m.to_node(1), m.is_step(), m.after_events(30),
                   m.once()).crash_and_restart_after(5000),
            m.rule(m.to_node(1)).jitter(30),
        ]),
    "corrupt-15pct": dict(
        build=lambda m: [m.rule(m.msg_type("Prepare", "Commit"),
                                m.percent(15)).corrupt()]),
    "equivocate-seq-1-3": dict(
        build=lambda m: [m.rule(m.msg_type("Preprepare"),
                                m.with_seq_no(1, 3)).equivocate((3,))]),
    "censor-client": dict(
        shape=(4, 2, 6),
        build=lambda m: [m.rule(m.to_node(1), m.from_client(4),
                                m.until_events(8)).censor()]),
    "targeted-seqno-drop": dict(
        shape=(4, 2, 6),
        build=lambda m: [m.rule(m.msg_type("Preprepare"), m.with_seq_no(1, 4),
                                m.until_events(6)).drop()]),
    "flood-stale-acks": dict(
        build=lambda m: [m.rule(m.msg_type("RequestAck"), m.from_source(1),
                                m.percent(50)).flood(3, 8000)]),
    "partition-heal": dict(
        build=lambda m: [m.partition([[0], [1, 2, 3]], from_ms=500,
                                     until_ms=4000)]),
    "epoch-change-storm": dict(
        shape=(4, 2, 8),
        build=lambda m: [
            m.rule(m.from_source(0), m.is_step(), m.until_time(8_000)).drop(),
            m.rule(m.from_source(1), m.is_step(), m.after_time(8_000),
                   m.until_time(16_000)).drop(),
            m.rule(m.from_source(2), m.is_step(), m.after_time(16_000),
                   m.until_time(24_000)).drop(),
        ]),
    "rung4-rule-with-link-jitter": dict(
        build=_rung4_shape, params=dict(link_jitter=30)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mangled_run_matches_reference(name, request):
    scenario = dict(SCENARIOS[name])
    if scenario.pop("late_digest", False):
        request.getfixturevalue("late_digest_advances")
    build = scenario.pop("build")
    shape = scenario.pop("shape", (4, 2, 10))
    r, built = run_both(build, shape=shape, **scenario)
    assert len(set(chains(r).values())) == 1
    exactly_once(r)
    if name == "epoch-change-storm":
        epochs = {r.machines[n].epoch_tracker.current_epoch.number
                  for n in range(4)}
        assert len(epochs) == 1 and min(epochs) >= 2, epochs
    if name == "duplicate-75pct":
        assert built[0].duplicated > 0
    if name in ("ack-loss-70pct-from-two-nodes", "partition-heal",
                "rung4-rule-with-link-jitter"):
        assert built[0].dropped > 0
    if name == "corrupt-15pct":
        assert built[0].corrupted > 0
    if name == "equivocate-seq-1-3":
        assert built[0].equivocated > 0
        assert all(1 <= seq <= 3 for (_epoch, seq) in built[0].variants)
    if name == "censor-client":
        assert built[0].censored_pairs
        assert all(cid == 4 for (cid, _q) in built[0].censored_pairs)
        for n in range(4):
            committed = {(c, q) for (c, q, _s) in
                         r.node_states[n].committed_reqs}
            assert built[0].censored_pairs <= committed
    if name == "flood-stale-acks":
        assert built[0].flooded > 0


def test_mangled_run_on_the_kernel_plane_matches_reference():
    """The rung-4 rule again with the port's kernel plane (its plain
    version on the CPU) computing every digest."""
    ref = RefRecorder(4, 2, 6, manglers=_rung4_shape(ref_manglers),
                      params=RefParameters(link_jitter=30), record=True)
    ref.drain_clients(max_steps=600000)
    port = BasicRecorder(4, 2, 6, manglers=_rung4_shape(manglers),
                         params=RuntimeParameters(link_jitter=30),
                         hash_plane=AsyncKernelHashPlane(device="cpu"),
                         record=True)
    port.drain_clients(max_steps=600000)
    assert outcome(port, pb) == outcome(ref, ref_pb)


def test_crash_restart_runs_differ_from_the_unpatched_reference_only_by_the_late_digest():
    """Without the patch the JAX engine's crash/restart run takes another
    road after the restart; the two logs agree up to there."""
    def build(dsl):
        return SCENARIOS["crash-and-restart-dsl"]["build"](dsl)

    ref = RefRecorder(4, 2, 10, manglers=build(ref_manglers), record=True)
    ref.drain_clients(max_steps=600000)
    port = port_recorder(4, 2, 10, manglers=build(manglers), record=True)
    port.drain_clients(max_steps=600000)
    a = [(w, n, wire(e, ref_pb)) for w, n, e in ref.recorded_events]
    b = [(w, n, wire(e, pb)) for w, n, e in port.recorded_events]
    first = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    boots = [i for i, (_w, n, e) in enumerate(port.recorded_events)
             if n == 1 and isinstance(e.type, pb.EventInitialize)]
    assert len(boots) == 2 and boots[1] < first
    assert len(set(chains(ref).values())) == len(set(chains(port).values())) == 1


def test_message_loss_mangler_matches_reference():
    """A hand-written mangler (2% random loss) on the engine's seam: it
    draws from the recorder's rng like the DSL does."""
    def build(module_pb):
        def drop_2pct(recorder, when, node, event):
            if isinstance(event.type, module_pb.EventStep):
                if recorder.rng.random() < 0.02:
                    return None
            return when, node, event

        return lambda _dsl: [drop_2pct]

    ref = RefRecorder(4, 2, 10, manglers=build(ref_pb)(None), record=True)
    ref.drain_clients(max_steps=400000)
    port = port_recorder(4, 2, 10, manglers=build(pb)(None), record=True)
    port.drain_clients(max_steps=400000)
    assert outcome(port, pb) == outcome(ref, ref_pb)
    assert len(set(chains(port).values())) == 1


def _silenced_run(recorder_cls, module_pb, **kwargs):
    def mute_node_3(recorder, when, node, event):
        if isinstance(event.type, module_pb.EventStep) and (
                event.type.source == 3):
            return None
        return when, node, event

    r = recorder_cls(4, 2, 5, manglers=[mute_node_3], record=True, **kwargs)

    def epoch_of(n):
        tracker = r.machines[n].epoch_tracker
        if tracker is None or tracker.current_epoch is None:
            return 0
        return tracker.current_epoch.number

    initial = {n: epoch_of(n) for n in range(3)}
    for _ in range(400000):
        if all(sum(len(c.committed_by_node.get(n, ()))
                   for c in r.clients.values()) >= 10 for n in range(3)):
            break
        assert r.step()
    final = {n: epoch_of(n) for n in range(3)}
    return r, initial, final


def test_silenced_node_liveness_matches_reference():
    """Node 3 never sends: the other three change epochs past it and
    commit; both engines take the same road there."""
    ref, _, ref_final = _silenced_run(RefRecorder, ref_pb)
    port, initial, final = _silenced_run(
        BasicRecorder, pb, hash_plane=CoalescingHashPlane())
    assert outcome(port, pb) == outcome(ref, ref_pb)
    assert final == ref_final
    assert len({port.node_states[n].app_chain for n in range(3)}) == 1
    assert all(final[n] > initial[n] for n in range(3))


def test_crash_and_restart_node_matches_reference():
    """Crash a follower mid-run with the engine's crash/restart calls and
    restart it; it rejoins from its WAL in both engines alike."""
    def run(r):
        for _ in range(400):
            r.step()
        r.crash(3)
        for _ in range(400):
            r.step()
        r.restart(3)
        r.drain_clients(max_steps=400000)
        for _ in range(5000):
            r.step()
            if len(set(chains(r).values())) == 1:
                break
        return r

    ref = run(RefRecorder(4, 2, 10, record=True))
    port = run(port_recorder(4, 2, 10, record=True))
    assert outcome(port, pb) == outcome(ref, ref_pb)
    assert len(set(chains(port).values())) == 1


# -- the adversary runs ---------------------------------------------------------


def _lower(adversary, dsl):
    """The JAX package's ``Adversary.lower`` (chaos/scenarios.py) on
    ``dsl``: the same predicates in the same order."""
    window = []
    if adversary.from_ms:
        window.append(dsl.after_time(adversary.from_ms))
    if adversary.until_ms is not None:
        window.append(dsl.until_time(adversary.until_ms))
    gate = [dsl.percent(adversary.rate_pct)] if adversary.rate_pct < 100 else []
    kind = adversary.kind
    if kind in ("corrupt", "flood"):
        if adversary.msg_kinds == ("Propose",):
            base = [dsl.is_propose()]
        else:
            base = [dsl.msg_type(*adversary.msg_kinds)]
            if adversary.node >= 0:
                base.append(dsl.from_source(adversary.node))
        if kind == "corrupt":
            if adversary.victims:
                base.append(dsl.to_node(*adversary.victims))
            return dsl.rule(*base, *window, *gate).corrupt(adversary.byte_flips)
        return dsl.rule(*base, *window, *gate).flood(
            adversary.copies, adversary.stale_delay_ms)
    if kind == "equivocate":
        return dsl.rule(dsl.msg_type("Preprepare"), dsl.from_source(adversary.node),
                        *window, *gate).equivocate(adversary.victims)
    assert kind == "censor", kind
    return dsl.rule(dsl.to_node(adversary.node),
                    dsl.from_client(*adversary.victims), *window).censor()


def _adversary_scenarios():
    """The unsigned adversary scenarios whose faults are all adversaries on
    the default network (the others need planes or states of their own)."""
    from mirbft_tpu.chaos.scenarios import adversary_matrix

    return {
        s.name: s for s in adversary_matrix()
        if not s.signed and s.manglers is None and s.network_state is None
        and s.hash_plane is None and s.adversaries and not s.partitions
        and not s.drop_pct and not s.crashes and not s.link_auth
        and not s.cert_audit and not s.reconfigs
        and all(a.kind in ("corrupt", "equivocate", "censor", "flood")
                for a in s.adversaries)
    }


def test_the_mirrored_adversary_runs_are_the_expected_ones():
    assert sorted(_adversary_scenarios()) == [
        "corrupt-digests-in-flight", "equivocate-majority-suspect",
        "equivocate-minority-straggler", "equivocate-plus-flood",
        "flood-duplicate-proposes", "flood-stale-acks",
        "flood-threephase-storm",
    ]


@pytest.mark.parametrize("name", [
    "corrupt-digests-in-flight", "equivocate-majority-suspect",
    "equivocate-minority-straggler", "equivocate-plus-flood",
    "flood-duplicate-proposes", "flood-stale-acks", "flood-threephase-storm",
])
def test_adversary_run_matches_reference(name):
    """Each adversary scenario, lowered onto each package's DSL, gives the
    same recorded log in both engines, and the port's is the same on a
    second run (the verbs draw only from the seeded rng)."""
    scenario = _adversary_scenarios()[name]
    shape = (scenario.node_count, scenario.client_count,
             scenario.reqs_per_client)

    def build(dsl):
        return [_lower(a, dsl) for a in scenario.adversaries]

    port, _ = run_both(build, shape=shape, max_steps=150000,
                       batch_size=scenario.batch_size, seed=7)
    again = port_recorder(*shape, manglers=build(manglers), record=True,
                          batch_size=scenario.batch_size, seed=7)
    again.drain_clients(max_steps=150000)
    assert outcome(again, pb) == outcome(port, pb)


def test_seeds_change_the_mangled_run():
    """The rng really feeds the verdicts: another seed, another run."""
    def build(dsl):
        return [dsl.rule(dsl.is_step(), dsl.percent(30)).duplicate(200)]

    a = port_recorder(4, 2, 4, manglers=build(manglers), seed=1, record=True)
    a.drain_clients(max_steps=200000)
    b = port_recorder(4, 2, 4, manglers=build(manglers), seed=2, record=True)
    b.drain_clients(max_steps=200000)
    assert outcome(a, pb) != outcome(b, pb)
