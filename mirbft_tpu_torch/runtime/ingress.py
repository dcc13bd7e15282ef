"""Speculative batched ingress verification for the live runtime.

The deterministic engine's speculative plane
(`testengine/signing.py:SpeculativeSignaturePlane`) parks submissions
until the simulated wave boundary; the live runtime has no simulated
clock, so the same idea runs as a pipelined verify stage — the ticket
pattern of `runtime/processor.py`, one stage deep: client requests are
admitted optimistically into a bounded pre-consensus queue and a worker
thread drains the queue in batches, calling an injected batch verifier
and delivering only the survivors to the node's propose path.

Verification therefore overlaps consensus instead of gating intake: the
socket read thread never blocks on curve arithmetic, the batch amortizes
the per-signature cost (one launch of the Ed25519 kernels a batch, from
``testengine.signing.batch_verifier()``), and a request whose signature
fails is evicted before it can reach the ordered log.

This module holds **no** crypto.  ``verify_batch_fn`` ([(client_id,
req_no, data)] -> [bool]) is injected by the embedder (``bench.ingress_run``
injects ``testengine.signing.batch_verifier()``); runtime/ never touches
key material or verify primitives.

A verifier that raises fails the batch closed (every verdict False, as in
the JAX package), and the stage counts it in ``verify_errors`` and keeps
the exception in ``last_error``: a kernel that fails to build or launch
shows there, not only as evictions.
"""

from __future__ import annotations

import threading
import time

from ..obsv import hooks


class SpeculativeIngress:
    """One node's speculative client-request verify stage.

    ``submit(request)`` parks the request (optimistic admission) and
    returns immediately; the worker verifies parked requests in batches
    of up to ``max_batch`` and hands survivors to ``deliver`` (typically
    ``node.propose``).  ``deliver`` runs on the worker thread and must
    not block indefinitely.
    """

    def __init__(
        self,
        deliver,
        verify_batch_fn,
        max_batch: int = 256,
        queue_depth: int = 8192,
        name: str = "ingress",
    ):
        self.deliver = deliver
        self.verify_batch_fn = verify_batch_fn
        self.max_batch = max_batch
        self.queue_depth = queue_depth
        self.admitted = 0
        self.delivered = 0
        self.evicted = 0
        self.dropped_overflow = 0
        self.verify_errors = 0
        self.last_error: BaseException | None = None
        self.batches = 0
        self.flush_sizes: list[int] = []
        self.flush_wall_s: list[float] = []
        self._queue: list = []
        self._cv = threading.Condition()
        self._outstanding = 0  # parked + in the batch being verified
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name=f"spec-{name}", daemon=True
        )
        self._thread.start()

    # -- admission (any thread) --------------------------------------------

    def submit(self, request) -> bool:
        """Optimistically admit one client request; False if the stage is
        saturated or closed (the request is dropped — client retry is the
        recovery path, exactly like a transport overflow)."""
        with self._cv:
            if self._closed or len(self._queue) >= self.queue_depth:
                self.dropped_overflow += 1
                return False
            self._queue.append(request)
            self._outstanding += 1
            self.admitted += 1
            self._cv.notify()
        return True

    @property
    def depth(self) -> int:
        """Requests admitted but not yet judged (status.py speculative
        queue depth)."""
        with self._cv:
            return self._outstanding

    # -- the stage ----------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait(timeout=0.1)
                if not self._queue:
                    if self._closed:
                        return
                    continue
                batch = self._queue[: self.max_batch]
                del self._queue[: len(batch)]
            self._verify_and_deliver(batch)
            with self._cv:
                self._outstanding -= len(batch)
                self._cv.notify_all()

    def _verify_and_deliver(self, batch: list) -> None:
        start = time.perf_counter()
        try:
            verdicts = self.verify_batch_fn(
                [(r.client_id, r.req_no, r.data) for r in batch]
            )
        except Exception as err:  # noqa: BLE001 — counted, then fail closed
            # A dead verifier must fail closed: nothing speculative may
            # reach the ordered log without a verdict.
            verdicts = [False] * len(batch)
            self.verify_errors += 1
            self.last_error = err
        wall = time.perf_counter() - start
        self.batches += 1
        self.flush_sizes.append(len(batch))
        self.flush_wall_s.append(wall)
        evicted = 0
        for request, ok in zip(batch, verdicts):
            if ok:
                try:
                    self.deliver(request)
                    self.delivered += 1
                except Exception:
                    pass  # node stopping: dropped like any late frame
            else:
                evicted += 1
        self.evicted += evicted
        if hooks.enabled:
            hooks.record_flush("signature", "ingress", len(batch), wall)
            if evicted:
                hooks.metrics.counter(
                    "mirbft_crypto_speculative_evictions_total"
                ).inc(evicted)

    # -- drain/shutdown ------------------------------------------------------

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every admitted request has been judged (tests and
        graceful drain); False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._outstanding:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=min(remaining, 0.1))
        return True

    def close(self, drain_timeout: float = 5.0,
              join_timeout: float | None = 5.0) -> None:
        """Judge what was admitted (up to ``drain_timeout``), refuse new
        requests, and wait up to ``join_timeout`` (None: until it ends)
        for the stage's thread to verify what is still queued."""
        self.flush(timeout=drain_timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=join_timeout)
