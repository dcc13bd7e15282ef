"""The port's wire codec (mirbft_tpu_torch.wire, pb) against the JAX
package's: every case of tests/test_wire.py (golden vectors, round trips
of every message type) and tests/test_wire_adversarial.py (truncation at
every prefix, single-bit flips, non-canonical presence/bool/varint
forms, unknown oneof tags, length and count claims past the buffer or
the 64-bit value space), each run on both packages on one input.  Where
a case produces bytes, the two packages' bytes are held equal too.
"""

import random
from types import SimpleNamespace

import pytest

from mirbft_tpu import pb as ref_pb
from mirbft_tpu import wire as ref_wire
from mirbft_tpu_torch import pb as port_pb
from mirbft_tpu_torch import wire as port_wire

PACKAGES = {
    "jax": SimpleNamespace(pb=ref_pb, wire=ref_wire),
    "port": SimpleNamespace(pb=port_pb, wire=port_wire),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _other(pkg):
    """The package the case is held against."""
    return PACKAGES["jax"] if pkg is PACKAGES["port"] else PACKAGES["port"]


def _sample_network_state(pb):
    return pb.NetworkState(
        config=pb.NetworkConfig(
            nodes=[0, 1, 2, 3],
            checkpoint_interval=20,
            max_epoch_length=200,
            number_of_buckets=4,
            f=1,
        ),
        clients=[
            pb.NetworkClient(
                id=7,
                width=100,
                width_consumed_last_checkpoint=3,
                low_watermark=12,
                committed_mask=b"\x0f",
            )
        ],
        pending_reconfigurations=[
            pb.Reconfiguration(type=pb.ReconfigNewClient(id=8, width=50)),
            pb.Reconfiguration(type=pb.ReconfigRemoveClient(client_id=7)),
        ],
        reconfigured=True,
    )


def samples(pb) -> list:
    """tests/test_wire.py's SAMPLES, built with one package's ``pb``."""
    return [
        pb.Request(client_id=1, req_no=2, data=b"hello"),
        pb.RequestAck(client_id=1, req_no=2, digest=b"\x00" * 32),
        _sample_network_state(pb),
        pb.Persistent(
            type=pb.QEntry(
                seq_no=9,
                digest=b"\x03" * 32,
                requests=[pb.RequestAck(client_id=1, req_no=2, digest=b"d")],
            )
        ),
        pb.Persistent(type=pb.PEntry(seq_no=9, digest=b"\x04" * 32)),
        pb.Persistent(
            type=pb.CEntry(
                seq_no=20, checkpoint_value=b"cp", network_state=_sample_network_state(pb)
            )
        ),
        pb.Persistent(
            type=pb.NEntry(
                seq_no=21,
                epoch_config=pb.EpochConfig(number=1, leaders=[0, 1], planned_expiration=99),
            )
        ),
        pb.Persistent(type=pb.FEntry(ends_epoch_config=pb.EpochConfig(number=1))),
        pb.Persistent(type=pb.ECEntry(epoch_number=2)),
        pb.Persistent(type=pb.TEntry(seq_no=40, value=b"t")),
        pb.Persistent(type=pb.Suspect(epoch=1)),
        pb.Msg(type=pb.Prepare(seq_no=1, epoch=0, digest=b"x")),
        pb.Msg(type=pb.Commit(seq_no=1, epoch=0, digest=b"x")),
        pb.Msg(type=pb.Checkpoint(seq_no=20, value=b"v")),
        pb.Msg(type=pb.Suspect(epoch=3)),
        pb.Msg(
            type=pb.EpochChange(
                new_epoch=4,
                checkpoints=[pb.Checkpoint(seq_no=20, value=b"v")],
                p_set=[pb.EpochChangeSetEntry(epoch=3, seq_no=21, digest=b"p")],
                q_set=[pb.EpochChangeSetEntry(epoch=3, seq_no=21, digest=b"q")],
            )
        ),
        pb.Msg(
            type=pb.EpochChangeAck(
                originator=2, epoch_change=pb.EpochChange(new_epoch=4)
            )
        ),
        pb.Msg(
            type=pb.NewEpoch(
                new_config=pb.NewEpochConfig(
                    config=pb.EpochConfig(number=4, leaders=[1, 2]),
                    starting_checkpoint=pb.Checkpoint(seq_no=20, value=b"v"),
                    final_preprepares=[b"", b"d"],
                ),
                epoch_changes=[pb.RemoteEpochChange(node_id=1, digest=b"e")],
            )
        ),
        pb.Msg(type=pb.FetchBatch(seq_no=5, digest=b"b")),
        pb.Msg(
            type=pb.ForwardBatch(
                seq_no=5,
                request_acks=[pb.RequestAck(client_id=1, req_no=1, digest=b"d")],
                digest=b"b",
            )
        ),
        pb.Msg(type=pb.FetchRequest(client_id=1, req_no=1, digest=b"d")),
        pb.Msg(
            type=pb.ForwardRequest(
                request_ack=pb.RequestAck(client_id=1, req_no=1, digest=b"d"),
                request_data=b"payload",
            )
        ),
        pb.Msg(type=pb.RequestAck(client_id=1, req_no=1, digest=b"d")),
        pb.StateEvent(
            type=pb.EventInitialize(
                initial_parms=pb.InitialParameters(
                    id=3,
                    batch_size=10,
                    heartbeat_ticks=2,
                    suspect_ticks=4,
                    new_epoch_timeout_ticks=8,
                    buffer_size=5 * 1024 * 1024,
                )
            )
        ),
        pb.StateEvent(
            type=pb.EventLoadEntry(
                index=1, data=pb.Persistent(type=pb.ECEntry(epoch_number=1))
            )
        ),
        pb.StateEvent(
            type=pb.EventLoadRequest(
                request_ack=pb.RequestAck(client_id=1, req_no=1, digest=b"d")
            )
        ),
        pb.StateEvent(type=pb.EventCompleteInitialization()),
        pb.StateEvent(
            type=pb.EventActionResults(
                digests=[
                    pb.HashResult(
                        digest=b"\x05" * 32,
                        type=pb.HashOriginRequest(
                            source=1, request=pb.Request(client_id=1, req_no=1, data=b"x")
                        ),
                    ),
                    pb.HashResult(
                        digest=b"\x06" * 32,
                        type=pb.HashOriginBatch(
                            source=1,
                            epoch=0,
                            seq_no=1,
                            request_acks=[pb.RequestAck(client_id=1, req_no=1, digest=b"d")],
                        ),
                    ),
                    pb.HashResult(
                        digest=b"\x07" * 32,
                        type=pb.HashOriginEpochChange(
                            source=1, origin=2, epoch_change=pb.EpochChange(new_epoch=1)
                        ),
                    ),
                    pb.HashResult(
                        digest=b"\x08" * 32,
                        type=pb.HashOriginVerifyBatch(
                            source=1,
                            seq_no=2,
                            request_acks=[],
                            expected_digest=b"\x08" * 32,
                        ),
                    ),
                    pb.HashResult(
                        digest=b"\x09" * 32,
                        type=pb.HashOriginVerifyRequest(
                            source=1,
                            request_ack=pb.RequestAck(client_id=1, req_no=1, digest=b"d"),
                            request_data=b"x",
                        ),
                    ),
                ],
                checkpoints=[
                    pb.CheckpointResult(
                        seq_no=20,
                        value=b"v",
                        network_state=_sample_network_state(pb),
                        reconfigured=True,
                    )
                ],
            )
        ),
        pb.StateEvent(
            type=pb.EventTransfer(c_entry=pb.CEntry(seq_no=20, checkpoint_value=b"v"))
        ),
        pb.StateEvent(
            type=pb.EventPropose(request=pb.Request(client_id=1, req_no=1, data=b"x"))
        ),
        pb.StateEvent(
            type=pb.EventStep(
                source=2, msg=pb.Msg(type=pb.Prepare(seq_no=1, epoch=0, digest=b"x"))
            )
        ),
        pb.StateEvent(type=pb.EventTick()),
        pb.StateEvent(type=pb.EventActionsReceived()),
    ]


def sample_id(s):
    if hasattr(s, "type") and s.type is not None:
        return type(s.type).__name__
    return type(s).__name__


SAMPLE_IDS = [sample_id(s) for s in samples(port_pb)]
assert SAMPLE_IDS == [sample_id(s) for s in samples(ref_pb)]


# -- tests/test_wire.py ---------------------------------------------------------


def test_varint_golden(pkg):
    wire = pkg.wire
    assert wire.encode_varint(0) == b"\x00"
    assert wire.encode_varint(1) == b"\x01"
    assert wire.encode_varint(127) == b"\x7f"
    assert wire.encode_varint(128) == b"\x80\x01"
    assert wire.encode_varint(300) == b"\xac\x02"
    assert wire.encode_varint(2**64 - 1) == b"\xff" * 9 + b"\x01"


def test_varint_roundtrip_fuzz(pkg):
    rng = random.Random(7)
    other = _other(pkg).wire
    for _ in range(2000):
        v = rng.getrandbits(rng.randrange(1, 64))
        enc = pkg.wire.encode_varint(v)
        assert enc == other.encode_varint(v)
        dec, pos = pkg.wire.decode_varint(enc, 0)
        assert dec == v and pos == len(enc)


def test_varint_rejects_noncanonical(pkg):
    with pytest.raises(ValueError):
        pkg.wire.decode_varint(b"\x80\x00", 0)  # over-long zero


def test_request_ack_golden(pkg):
    pb = pkg.pb
    ack = pb.RequestAck(client_id=1, req_no=300, digest=b"\xaa\xbb")
    enc = pb.encode(ack)
    assert enc == b"\x01" + b"\xac\x02" + b"\x02\xaa\xbb"
    assert pb.decode(pb.RequestAck, enc) == ack


def test_msg_oneof_roundtrip(pkg):
    pb = pkg.pb
    msg = pb.Msg(
        type=pb.Preprepare(
            seq_no=5,
            epoch=2,
            batch=[pb.RequestAck(client_id=9, req_no=1, digest=b"\x01" * 32)],
        )
    )
    enc = pb.encode(msg)
    assert pb.decode(pb.Msg, enc) == msg


def test_oneof_distinguishes_echo_and_ready(pkg):
    pb = pkg.pb
    cfg = pb.NewEpochConfig(
        config=pb.EpochConfig(number=3, leaders=[0, 1, 2], planned_expiration=50),
        starting_checkpoint=pb.Checkpoint(seq_no=20, value=b"v"),
        final_preprepares=[b"", b"\x02" * 32],
    )
    echo = pb.Msg(type=pb.NewEpochEcho(new_epoch_config=cfg))
    ready = pb.Msg(type=pb.NewEpochReady(new_epoch_config=cfg))
    assert pb.encode(echo) != pb.encode(ready)
    assert pb.decode(pb.Msg, pb.encode(echo)) == echo
    assert pb.decode(pb.Msg, pb.encode(ready)) == ready


@pytest.mark.parametrize("index", range(len(SAMPLE_IDS)), ids=SAMPLE_IDS)
def test_roundtrip_all(pkg, index):
    pb = pkg.pb
    sample = samples(pb)[index]
    enc = pb.encode(sample)
    assert enc == _other(pkg).pb.encode(samples(_other(pkg).pb)[index])
    dec = pb.decode(type(sample), enc)
    assert dec == sample
    # Stability: re-encoding the decoded value is byte-identical.
    assert pb.encode(dec) == enc


def test_trailing_bytes_rejected(pkg):
    pb = pkg.pb
    enc = pb.encode(pb.RequestAck(client_id=1, req_no=1, digest=b"d"))
    with pytest.raises(ValueError):
        pb.decode(pb.RequestAck, enc + b"\x00")


# -- tests/test_wire_adversarial.py ---------------------------------------------


@pytest.mark.parametrize("index", range(len(SAMPLE_IDS)), ids=SAMPLE_IDS)
def test_every_strict_prefix_rejected(pkg, index):
    pb = pkg.pb
    sample = samples(pb)[index]
    enc = pb.encode(sample)
    for cut in range(len(enc)):
        with pytest.raises(ValueError):
            pb.decode(type(sample), enc[:cut])


@pytest.mark.parametrize("index", range(len(SAMPLE_IDS)), ids=SAMPLE_IDS)
def test_accepted_bit_flips_are_canonical(pkg, index):
    """Flipping any single bit either fails to decode or decodes to a value
    whose canonical encoding is byte-identical to the mutated buffer — and
    the other package accepts exactly the same mutations."""
    pb, other = pkg.pb, _other(pkg).pb
    sample = samples(pb)[index]
    enc = pb.encode(sample)
    cls, other_cls = type(sample), type(samples(other)[index])
    for byte_i in range(len(enc)):
        for bit in range(8):
            mutated = bytearray(enc)
            mutated[byte_i] ^= 1 << bit
            mutated = bytes(mutated)
            try:
                dec = pb.decode(cls, mutated)
            except (ValueError, TypeError):
                with pytest.raises((ValueError, TypeError)):
                    other.decode(other_cls, mutated)
                continue
            assert pb.encode(dec) == mutated, (
                f"byte {byte_i} bit {bit}: accepted non-canonical mutation"
            )
            assert other.encode(other.decode(other_cls, mutated)) == mutated


def test_unknown_oneof_tag_rejected(pkg):
    # Persistent oneof has tags 1..8; tag 9 with an empty body must fail.
    with pytest.raises(ValueError):
        pkg.pb.decode(pkg.pb.Persistent, b"\x09\x00")


def test_unset_oneof_rejected_for_critical_oneofs(pkg):
    # Tag 0 (unset) is never legitimate for wire msgs, WAL entries, events,
    # or reconfigurations.
    pb = pkg.pb
    for cls in (pb.Msg, pb.Persistent, pb.StateEvent, pb.Reconfiguration):
        with pytest.raises(ValueError):
            pb.decode(cls, b"\x00")
        with pytest.raises(ValueError):
            pb.encode(cls())


def test_presence_byte_above_one_rejected(pkg):
    # EventLoadRequest: presence byte for the nested RequestAck.
    pb = pkg.pb
    good = pb.encode(pb.EventLoadRequest(request_ack=pb.RequestAck(digest=b"d")))
    assert good[0] == 1
    bad = b"\x02" + good[1:]
    with pytest.raises(ValueError):
        pb.decode(pb.EventLoadRequest, bad)


def test_bool_byte_above_one_rejected(pkg):
    pb = pkg.pb
    ns = pb.NetworkState(config=pb.NetworkConfig(nodes=[0]), reconfigured=True)
    enc = pb.encode(ns)
    assert enc[-1] == 1  # reconfigured bool is the final byte
    with pytest.raises(ValueError):
        pb.decode(pb.NetworkState, enc[:-1] + b"\x02")


def test_huge_length_claim_rejected(pkg):
    # bytes field claiming 2^32 bytes with a 1-byte body.
    claim = pkg.wire.encode_varint(2**32)
    with pytest.raises(ValueError):
        pkg.pb.decode(pkg.pb.RequestAck, b"\x01\x01" + claim + b"x")


def test_huge_count_claim_rejected(pkg):
    # NetworkConfig.nodes (repeated) claiming 2^40 items then ending.
    with pytest.raises(ValueError):
        pkg.pb.decode(pkg.pb.NetworkConfig, pkg.wire.encode_varint(2**40))


def test_varint_above_64_bits_rejected_everywhere(pkg):
    # 2^64 exactly: 10 bytes, final byte 0x02.  Must be rejected even at raw
    # length/count/tag positions where no typed range check applies.
    pb, wire = pkg.pb, pkg.wire
    overflow = b"\x80" * 9 + b"\x02"
    v_max = b"\xff" * 9 + b"\x01"
    assert wire.decode_varint(v_max, 0)[0] == 2**64 - 1
    with pytest.raises(ValueError):
        wire.decode_varint(overflow, 0)
    # At a length position (RequestAck.digest).
    with pytest.raises(ValueError):
        pb.decode(pb.RequestAck, b"\x01\x01" + overflow)
    # At a count position (NetworkConfig.nodes).
    with pytest.raises(ValueError):
        pb.decode(pb.NetworkConfig, overflow)
    # At a oneof-tag position.
    with pytest.raises(ValueError):
        pb.decode(pb.Msg, overflow)


def test_wrong_class_decode_rejected(pkg):
    # A Prepare encoding fed to Commit decodes fine (same shape) — but a
    # Prepare fed to NetworkState must fail somewhere in the field walk.
    pb = pkg.pb
    enc = pb.encode(pb.Prepare(seq_no=1, epoch=2, digest=b"\xff" * 32))
    with pytest.raises((ValueError, TypeError)):
        pb.decode(pb.NetworkState, enc)
