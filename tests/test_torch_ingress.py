"""The port's signed client ingress against the JAX package's.

``crypto/ed25519_batch.py`` (the host batch verifier, a random linear
combination) must give the JAX module's verdicts and the host oracle's on
one corpus with forgeries and unparseable material (mirroring
tests/test_crypto_auth.py:37-61).  The port's ``kernel_verifier`` on the
CPU (the Ed25519 kernels' plain versions) must give the same verdicts on
signed requests, and so must ``rlc_verifier`` and the JAX package's host
verifier.  ``runtime/ingress.py``'s three cases (tests/test_crypto_auth.py:
257-310) hold on the port, and a dead verifier is counted in
``verify_errors``.  ``batch_verifier()`` runs on the card or raises.  Every
tolerance is exact: verdicts are booleans."""

import threading
import time

import pytest
import torch

from mirbft_tpu.crypto import ed25519_batch as ref_batch
from mirbft_tpu.testengine import signing as ref_signing
from mirbft_tpu_torch.crypto import ed25519_batch, ed25519_host
from mirbft_tpu_torch.runtime.ingress import SpeculativeIngress
from mirbft_tpu_torch.testengine import signing


def _signed_items(n, forge=()):
    """n (pk, message, signature) triples; indices in ``forge`` carry a
    signature over a different message (a genuine-looking forgery)."""
    items = []
    for i in range(n):
        seed = b"batch-seed-%02d" % i + bytes(17)
        pk = ed25519_host.public_key(seed)
        message = b"stmt-%d" % i
        if i in forge:
            sig = ed25519_host.sign(seed, message + b"-tampered")
        else:
            sig = ed25519_host.sign(seed, message)
        items.append((pk, message, sig))
    return items


def _oracle(items):
    return [ed25519_host.verify(pk, msg, sig) for pk, msg, sig in items]


def _unparseable():
    items = _signed_items(3)
    pk, message, _sig = items[0]
    items[0] = (pk, message, b"\x00" * 64)  # not a curve point encoding
    items[2] = (b"\xff" * 32, items[2][1], items[2][2])
    return items


@pytest.mark.parametrize(
    "items, chunk, expect",
    [
        (_signed_items(6, forge={1, 4}), 4,
         [True, False, True, True, False, True]),
        (_signed_items(5), 256, [True] * 5),
        ([], 256, []),
        (_signed_items(8, forge={3}), 8, [i != 3 for i in range(8)]),
        (_unparseable(), 256, [False, True, False]),
    ],
    ids=["forgeries", "all_valid", "empty", "descent_one_forgery",
         "unparseable"],
)
def test_batch_verify_equals_the_jax_module_and_the_oracle(items, chunk,
                                                           expect):
    verdicts = ed25519_batch.verify_batch(items, chunk=chunk)
    assert verdicts == ref_batch.verify_batch(items, chunk=chunk)
    assert verdicts == _oracle(items) == expect


def _request_corpus():
    """Signed requests (client_id, req_no, data): valid ones, a forged S,
    a signature for another req_no, a foreign key, a short trailer, and
    S >= L (rejected on the host before any kernel)."""
    signer = signing.make_signer()
    items = [(c, r, signer(c, r, b"op-%d-%d" % (c, r)))
             for c in (1, 2) for r in range(3)]
    good = items[0][2]
    flipped = bytearray(good)
    flipped[-64] ^= 0x01  # a bit of S
    items.append((1, 0, bytes(flipped)))
    items.append((2, 5, items[3][2]))  # client 2's req 0 replayed at 5
    items.append((3, 0, signer(1, 0, b"op-1-0")))  # client 1's key
    items.append((1, 9, b"short"))
    high = bytearray(good)
    high[-33] = 0xFF  # S's top byte: S >= L
    items.append((1, 0, bytes(high)))
    return items


@pytest.fixture(scope="module")
def request_corpus():
    return _request_corpus()


def test_request_verifiers_agree_with_the_jax_package(request_corpus):
    """The port's host, RLC and kernel (plain version on the CPU)
    verifiers and the JAX package's host verifier give one verdict per
    request."""
    expect = [True] * 6 + [False] * 5
    assert signing.host_verifier(request_corpus) == expect
    assert ref_signing.host_verifier(request_corpus) == expect
    assert signing.rlc_verifier(request_corpus) == expect
    assert signing.kernel_verifier(request_corpus, device="cpu") == expect
    assert signing.batch_verifier("cpu")(request_corpus) == expect


def test_batch_verifier_runs_on_the_card_or_raises():
    """No card: batch_verifier() and kernel_authority() raise, and neither
    hands back the host route.  A card: the kernel verifier on cuda."""
    if torch.cuda.is_available():
        verifier = signing.batch_verifier()
        assert verifier.device.type == "cuda"
        assert signing.kernel_authority()
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            signing.batch_verifier()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            signing.kernel_authority()
    cpu = signing.batch_verifier("cpu")
    assert cpu is not signing.rlc_verifier and cpu.device.type == "cpu"
    assert not signing.kernel_authority("cpu")


# -- runtime/ingress.py --------------------------------------------------------


class _Req:
    def __init__(self, client_id, req_no, data):
        self.client_id = client_id
        self.req_no = req_no
        self.data = data


def test_ingress_delivers_survivors_and_evicts_failures():
    delivered = []
    verdict = {b"good": True, b"bad": False}

    def verify_batch_fn(items):
        return [verdict[data] for _c, _r, data in items]

    stage = SpeculativeIngress(delivered.append, verify_batch_fn)
    try:
        assert stage.submit(_Req(1, 0, b"good"))
        assert stage.submit(_Req(1, 1, b"bad"))
        assert stage.flush(timeout=10)
        assert [r.data for r in delivered] == [b"good"]
        assert stage.delivered == 1
        assert stage.evicted == 1
        assert stage.depth == 0
        assert stage.verify_errors == 0 and stage.last_error is None
    finally:
        stage.close()


def test_ingress_fails_closed_when_verifier_dies():
    """As the JAX stage: every verdict False.  On top, the failure is
    counted and kept."""
    delivered = []

    def broken(items):
        raise RuntimeError("verifier down")

    stage = SpeculativeIngress(delivered.append, broken)
    try:
        stage.submit(_Req(1, 0, b"x"))
        assert stage.flush(timeout=10)
        stage.submit(_Req(1, 1, b"y"))
        assert stage.flush(timeout=10)
        assert delivered == []
        assert stage.evicted == 2
        assert stage.verify_errors == 2
        assert isinstance(stage.last_error, RuntimeError)
        assert str(stage.last_error) == "verifier down"
    finally:
        stage.close()


def test_ingress_close_waits_for_the_verify_in_flight():
    """A worker's shutdown closes the stage with ``join_timeout=None``:
    close returns only once the verify in flight and the queue behind it
    are judged, so the process never exits with the stage's thread inside
    a launch (a thread inside a torch op at interpreter exit aborts the
    process, exit -6).  The default close waits at most its 5 s."""
    started = threading.Event()

    def slow(items):
        started.set()
        time.sleep(0.3)
        return [True] * len(items)

    delivered = []
    stage = SpeculativeIngress(delivered.append, slow, max_batch=1)
    for i in range(3):
        assert stage.submit(_Req(1, i, b"p"))
    assert started.wait(timeout=10)
    stage.close(drain_timeout=0.0, join_timeout=None)
    assert not stage._thread.is_alive()
    assert stage.delivered == len(delivered) == stage.admitted == 3
    assert not stage.submit(_Req(1, 3, b"p"))


def test_ingress_sheds_load_past_queue_depth():
    gate = threading.Event()

    def slow(items):
        gate.wait(timeout=10)
        return [True] * len(items)

    stage = SpeculativeIngress(lambda r: None, slow, queue_depth=2)
    try:
        for i in range(8):
            stage.submit(_Req(1, i, b"p"))
        assert stage.dropped_overflow > 0
        gate.set()
        assert stage.flush(timeout=10)
        assert stage.admitted + stage.dropped_overflow == 8
    finally:
        gate.set()
        stage.close()


def test_ingress_on_the_kernel_verifier_evicts_only_forgeries(
    request_corpus,
):
    """The stage in front of a node's propose, with batch_verifier on the
    CPU: the six valid requests are delivered in order, the five bad
    ones evicted."""
    delivered = []
    stage = SpeculativeIngress(delivered.append, signing.batch_verifier("cpu"))
    try:
        for client_id, req_no, data in request_corpus:
            stage.submit(_Req(client_id, req_no, data))
        assert stage.flush(timeout=120)
        assert [(r.client_id, r.req_no) for r in delivered] == [
            (c, r) for c in (1, 2) for r in range(3)
        ]
        assert stage.evicted == 5 and stage.verify_errors == 0
        assert sum(stage.flush_sizes) == len(request_corpus)
    finally:
        stage.close()


def test_ingress_batch_rows_are_the_kernel_launch(request_corpus):
    """bench.ingress_rows gives the rows kernel_verifier launches: the
    requests that pass the host's checks (here the six valid ones, the
    flipped-S forgery and the replay; not the foreign key, the short
    trailer or S >= L)."""
    from mirbft_tpu_torch import bench

    rows = bench.ingress_rows(request_corpus)
    assert len(rows) == 8
    assert all(len(row) == 4 for row in rows)


def test_launch_counts_survive_concurrent_ingress_threads():
    """Each node's ingress worker launches the Ed25519 kernels from a
    thread of its own; the wrappers' counts (``ops.ed25519._count_launch``)
    must lose no launch.  More threads than cores and a short switch
    interval make an unlocked read-add-write lose counts."""
    import collections
    import os
    import sys

    from mirbft_tpu_torch.ops import ed25519

    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.launches_by_rows = collections.Counter()
    threads_n = 2 * (os.cpu_count() or 2) + 2
    per_thread = 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(
                target=lambda k=k: [
                    ed25519._count_launch(wrapper, 1 + k % 3)
                    for _ in range(per_thread)
                ]
            )
            for k in range(threads_n)
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == threads_n * per_thread
    assert sum(wrapper.launches_by_rows.values()) == wrapper.launches
