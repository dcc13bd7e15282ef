"""Action executors: where the consumer's work — and the card — happens.

Rebuild of the reference's processors (reference: processor.go:56-470).
The ordering contract is safety-critical (docs/Processor.md:24-28):

  1. store requests, sync the request store
  2. write + sync the WAL                        ← durability barrier
  3. network sends (self-sends loop back through Node.step)
  4. forward requests (read data from the store)
  5. hashing                                     ← order-free, the card's path
  6. commits: apply batches to the Log; checkpoints snap it

The host kinds (``SerialProcessor``, ``PoolProcessor``,
``PipelinedProcessor``) hash with hashlib; a caller asks for them by name.
The ``Cuda*`` kinds coalesce every hash request of an Actions batch into
one padded tensor and launch the hand-written SHA-256 kernel
(``csrc/sha256.cu`` through ``ops.sha256``) once, on a CUDA stream of the
processor's own, with the copy back into pinned host memory queued behind
it; the digests are collected on the copy's CUDA event after the
persist+send phases.  They have no host route: every hash request goes to
the kernel, whatever the batch's size, and a launch that fails raises.
"""

from __future__ import annotations

import functools
import threading
import time

import torch

from .. import pb
from ..core import actions as act
from ..core.preimage import host_digest
from ..obsv import hooks
from ..ops.batching import pack_preimages, resolve_device, to_tensors
from ..ops.sha256 import sha256_digest_words, words_to_digests
from .config import TPU_KINDS
from .reconfig import decode_reconfig_request, reconfig_kind


def _observed_phase(phase):
    """Wrap a processor phase with per-phase latency recording (and a
    trace span when a tracer is installed).  Spans use the executing
    thread's ident as tid so pool-lane phases land on distinct trace rows
    and stay well-nested."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(self, *args, **kwargs):
            if not hooks.enabled:
                return fn(self, *args, **kwargs)
            tracer = hooks.tracer
            start = time.perf_counter()
            try:
                if tracer is not None:
                    with tracer.span(
                        "proc." + phase,
                        cat="runtime",
                        tid=threading.get_ident() & 0xFFFF,
                    ):
                        return fn(self, *args, **kwargs)
                return fn(self, *args, **kwargs)
            finally:
                hooks.metrics.histogram(
                    "mirbft_proc_phase_seconds", phase=phase
                ).observe(time.perf_counter() - start)

        return inner

    return wrap


class Link:
    """The entire transport contract (reference: processor.go:23-25):
    fire-and-forget, unreliable by assumption, caller authenticates."""

    def send(self, dest: int, msg: pb.Msg) -> None:
        raise NotImplementedError


class Log:
    """The application: applies totally-ordered batches and snapshots."""

    def apply(self, q_entry: pb.QEntry) -> None:
        raise NotImplementedError

    def snap(self, network_config, clients_state) -> bytes:
        raise NotImplementedError


class SerialProcessor:
    def __init__(self, node, link: Link, app_log: Log, wal, request_store):
        self.node = node
        self.link = link
        self.app_log = app_log
        self.wal = wal
        self.request_store = request_store
        # Reconfiguration requests recognised at store time, keyed by ack,
        # drained into CheckpointResult.reconfigurations in commit order.
        # Written by the persist phase, read by the commit phase: in the
        # pipelined processor those are different stage threads, but
        # persist(N) always precedes commit(N) and CPython dict ops are
        # atomic, so no lock is needed.
        self._reconfig_payloads: dict = {}  # ack key -> [pb.Reconfiguration]
        self._pending_reconfigs: list = []  # committed, awaiting checkpoint
        # Restart seeding: StoreRequest actions are not re-emitted on WAL
        # replay, but committed batches above the durable checkpoint are
        # re-committed — their reconfigurations must be re-collected, and
        # the payloads are still in the store (reconfiguration acks are
        # deliberately never pruned; see _commit).  Only durable stores can
        # carry pre-boot state, so a store without `uncommitted` (in-memory
        # harness stubs) has nothing to seed.
        uncommitted = getattr(self.request_store, "uncommitted", None)
        if uncommitted is not None:
            uncommitted(self._seed_reconfig)

    @staticmethod
    def _ack_key(ack) -> tuple:
        return (ack.client_id, ack.req_no, bytes(ack.digest))

    def _seed_reconfig(self, ack, data: bytes | None = None) -> None:
        # FileRequestStore.uncommitted hands only the ack; the in-memory
        # stores hand (ack, data) — read on demand for the former.
        if data is None:
            data = self.request_store.get(ack)
        if data is None:
            return
        reconfigs = decode_reconfig_request(data)
        if reconfigs:
            self._reconfig_payloads[self._ack_key(ack)] = reconfigs

    # -- phases --------------------------------------------------------------

    def _persist_writes(self, actions: act.Actions) -> None:
        """Stores and WAL appends/truncates only — no fsyncs.  Split out
        so the pipelined processor can issue the writes and then wait on
        group-commit tickets instead of private fsyncs."""
        for fr in actions.store_requests:
            self.request_store.store(fr.request_ack, fr.request_data)
            self._seed_reconfig(fr.request_ack, fr.request_data)
        for write in actions.write_ahead:
            if write.truncate is not None:
                self.wal.truncate(write.truncate)
            else:
                self.wal.write(write.append.index, write.append.data)

    @_observed_phase("persist")
    def _persist(self, actions: act.Actions) -> None:
        self._persist_writes(actions)
        self.request_store.sync()
        self.wal.sync()

    @_observed_phase("transmit")
    def _transmit(self, actions: act.Actions) -> None:
        my_id = self.node.config.id
        for send in actions.sends:
            for replica in send.targets:
                if replica == my_id:
                    self.node.step(replica, send.msg)
                else:
                    self.link.send(replica, send.msg)
        for fwd in actions.forward_requests:
            data = self.request_store.get(fwd.request_ack)
            if data is None:
                continue  # already committed + pruned; nothing to forward
            msg = pb.Msg(
                type=pb.ForwardRequest(
                    request_ack=fwd.request_ack, request_data=data
                )
            )
            for replica in fwd.targets:
                if replica == my_id:
                    self.node.step(replica, msg)
                else:
                    self.link.send(replica, msg)

    @_observed_phase("hash")
    def _hash(self, actions: act.Actions) -> list:
        return [
            act.HashResult(digest=host_digest(hr.data), request=hr)
            for hr in actions.hashes
        ]

    @_observed_phase("commit")
    def _commit(self, actions: act.Actions, defer_prune: list | None = None) -> list:
        """Apply batches and snap checkpoints.  With ``defer_prune`` set,
        committed acks are collected there instead of pruned from the
        request store inline — the pooled processor prunes after its lanes
        join so a same-batch forward can still read the data."""
        checkpoints = []
        for commit in actions.commits:
            if commit.batch is not None:
                self.app_log.apply(commit.batch)
                if hooks.enabled:
                    hooks.milestone(
                        "seq.committed",
                        self.node.config.id,
                        commit.batch.seq_no,
                    )
                for ack in commit.batch.requests:
                    reconfigs = (
                        self._reconfig_payloads.get(self._ack_key(ack))
                        if self._reconfig_payloads
                        else None
                    )
                    if reconfigs is not None:
                        # Collect in commit order for the window's
                        # checkpoint.  The ack is deliberately NOT pruned:
                        # if we crash before the covering CEntry is
                        # durable, WAL replay re-commits this batch and
                        # the payload must still be in the store for the
                        # restart seeding to re-collect (a node that
                        # pruned would silently drop the reconfiguration
                        # and fork the config).
                        self._pending_reconfigs.extend(reconfigs)
                        if hooks.enabled:
                            for reconfig in reconfigs:
                                hooks.metrics.counter(
                                    "mirbft_reconfig_committed_total",
                                    kind=reconfig_kind(reconfig),
                                ).inc()
                        continue
                    if defer_prune is not None:
                        defer_prune.append(ack)
                    else:
                        self.request_store.commit(ack)
            else:
                value = self.app_log.snap(
                    commit.checkpoint.network_config,
                    commit.checkpoint.clients_state,
                )
                reconfigs, self._pending_reconfigs = (
                    self._pending_reconfigs,
                    [],
                )
                checkpoints.append(
                    act.CheckpointResult(
                        checkpoint=commit.checkpoint,
                        value=value,
                        reconfigurations=reconfigs,
                    )
                )
        return checkpoints

    def process(self, actions: act.Actions) -> act.ActionResults:
        self._persist(actions)
        self._transmit(actions)
        digests = self._hash(actions)
        checkpoints = self._commit(actions)
        return act.ActionResults(digests=digests, checkpoints=checkpoints)


class PoolProcessor(SerialProcessor):
    """Parallel executor lanes with the persist→send safety barrier
    (reference: ProcessorWorkPool, processor.go:183-470; barrier semantics
    docs/Processor.md:22-28):

        (persist → sends + forwards) ∥ hashes ∥ commits

    All lanes are joined before the results return.  The invariant that
    matters: nothing is *sent* until the WAL and request store are
    durable, while hashing and committing float free of that barrier —
    exactly the slack the reference's work pool exploits with goroutines,
    here realized with a small thread pool (and, in CudaPoolProcessor, with
    the card absorbing the hash lane).

    Unlike the reference, forwards run *after* this batch's persists (in
    the transmit lane) rather than concurrently with them: a single
    accumulated actions batch can contain both the store and a forward of
    the same request, and reading the store before the persist lane wrote
    it would silently drop the forward until a tick-driven retry.
    """

    def __init__(self, node, link: Link, app_log: Log, wal, request_store):
        super().__init__(node, link, app_log, wal, request_store)
        import concurrent.futures

        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=3, thread_name_prefix=f"proc-{node.config.id}"
        )

    def _hash_lane(self, actions: act.Actions) -> list:
        return self._hash(actions)

    def _persist_transmit_lane(self, actions: act.Actions) -> None:
        self._persist(actions)
        self._transmit(actions)

    def process(self, actions: act.Actions) -> act.ActionResults:
        # Store prune is deferred past the lane join: the commit lane runs
        # concurrently with the transmit lane, and pruning an ack that this
        # same batch also forwards would make the forward read None.
        import concurrent.futures

        pruned: list = []
        futures = [
            self._pool.submit(self._persist_transmit_lane, actions),
            self._pool.submit(self._hash_lane, actions),
            self._pool.submit(self._commit, actions, pruned),
        ]
        # Join ALL lanes before propagating any failure: raising while a
        # sibling lane still mutates the WAL/store would hand the caller a
        # half-written state.  Whatever the commit lane managed to commit
        # is pruned even on the failure path, so acks don't leak.
        concurrent.futures.wait(futures)
        try:
            results = [f.result() for f in futures]
        finally:
            for ack in pruned:
                self.request_store.commit(ack)
        return act.ActionResults(digests=results[1], checkpoints=results[2])

    def close(self) -> None:
        self._pool.shutdown(wait=True)


AUDIT_PER_SHAPE = 8  # audited launches kept of each packed shape


class _PendingDigests:
    """One launch in flight: the digest words (pinned host memory on a
    card, the plain version's result on the CPU) and, on a card, the CUDA
    events around the kernel and after the copy back."""

    __slots__ = ("words", "began", "ended", "copied", "audit")

    def __init__(self, words, began=None, ended=None, copied=None):
        self.words = words
        self.began = began
        self.ended = ended
        self.copied = copied
        self.audit = None  # (shape, preimages) while launches are audited


class _CudaHashMixin:
    """The card's hash path shared by the ``Cuda*`` processors: every hash
    request of an Actions batch in one launch of the SHA-256 kernel,
    dispatched early and collected later, as the JAX package's
    asynchronous dispatch was.

    ``_dispatch_device`` packs the preimages, launches the kernel on the
    processor's own CUDA stream (torch's current stream is per thread, and
    four nodes' consumer threads, the pool's lanes and the pipeline's hash
    worker share one process) and queues the copy of the digest words into
    a pinned host buffer of that launch's own, then records an event.
    ``_collect_device`` waits on the event.  A buffer is read only after its
    event, and each launch has its own, so batches in flight never share
    one.

    Counters, under ``_counter_lock`` (the dispatching and collecting
    threads differ): ``launches`` (calls into the kernel's wrapper; on a
    card each is one launch), ``device_digests`` (rows launched) and
    ``kernel_ms`` (the time between CUDA events around each launch: the
    kernel, plus whatever host time passes between the two records; 0 on
    the CPU).  ``host_digests`` is 0 by construction.  With
    ``device="cpu"`` the wrapper runs the kernel's plain version: the tests'
    route.

    Launch audit: set ``samples`` to a dict and every launch adds one to
    ``samples[(rows, blocks)][0]``, its packed shape, and the first
    ``AUDIT_PER_SHAPE`` launches of each shape keep ``(preimages, digests
    read back)`` in ``samples[shape][1]``, so that a caller can hold the
    live launches against hashlib and the plain version afterwards."""

    host_digests = 0
    samples = None  # guarded-by: _counter_lock

    def _init_device(self, device) -> None:
        self.device = resolve_device(device)
        self._counter_lock = threading.Lock()
        self.launches = 0  # guarded-by: _counter_lock
        self.device_digests = 0  # guarded-by: _counter_lock
        self.kernel_ms = 0.0  # guarded-by: _counter_lock
        self._stream = (
            torch.cuda.Stream(self.device)
            if self.device.type == "cuda"
            else None
        )

    def _dispatch_device(self, hashes: list) -> _PendingDigests:
        start = time.perf_counter() if hooks.enabled else 0.0
        preimages = [b"".join(hr.data) for hr in hashes]
        packed = pack_preimages(preimages)
        if self._stream is None:
            pending = _PendingDigests(
                sha256_digest_words(*to_tensors(packed, self.device))
            )
        else:
            with torch.cuda.stream(self._stream):
                blocks, n_blocks = to_tensors(packed, self.device)
                began = torch.cuda.Event(enable_timing=True)
                ended = torch.cuda.Event(enable_timing=True)
                copied = torch.cuda.Event()
                began.record(self._stream)
                words = sha256_digest_words(blocks, n_blocks)
                ended.record(self._stream)
                host = torch.empty(
                    words.shape, dtype=words.dtype, pin_memory=True
                )
                host.copy_(words, non_blocking=True)
                copied.record(self._stream)
            pending = _PendingDigests(host, began, ended, copied)
        with self._counter_lock:
            self.launches += 1
            self.device_digests += len(hashes)
            if self.samples is not None:
                shape = packed.blocks.shape[:2]
                self.samples.setdefault(shape, [0, []])[0] += 1
                pending.audit = (shape, preimages)
        if hooks.enabled:
            hooks.record_flush(
                "hash", "device", len(hashes), time.perf_counter() - start
            )
        return pending

    def _collect_device(self, hashes: list, pending: _PendingDigests) -> list:
        start = time.perf_counter() if hooks.enabled else 0.0
        kernel_ms = 0.0
        if pending.copied is not None:
            pending.copied.synchronize()
            kernel_ms = pending.began.elapsed_time(pending.ended)
        raw = words_to_digests(pending.words)
        with self._counter_lock:
            self.kernel_ms += kernel_ms
            if pending.audit is not None:
                shape, preimages = pending.audit
                kept = self.samples[shape][1]
                if len(kept) < AUDIT_PER_SHAPE:
                    kept.append((preimages, raw))
        if hooks.enabled:
            hooks.record_flush(
                "hash", "readback", len(hashes), time.perf_counter() - start
            )
        return [
            act.HashResult(digest=raw[32 * i : 32 * i + 32], request=hr)
            for i, hr in enumerate(hashes)
        ]

    def _hash(self, actions: act.Actions) -> list:
        """Dispatch and collect at once: the route for any inherited phase
        that hashes inline.  It reaches the kernel too."""
        if not actions.hashes:
            return []
        return self._collect_device(
            actions.hashes, self._dispatch_device(actions.hashes)
        )


class CudaProcessor(_CudaHashMixin, SerialProcessor):
    """SerialProcessor with the hash phase on the card.

    All hash requests in the batch launch as one kernel call; the dispatch
    is issued *before* the persist/send phases so the card works while the
    host fsyncs, and the results are collected afterwards — the
    persist→send barrier is untouched because hashing feeds nothing but
    AddResults."""

    def __init__(self, node, link: Link, app_log: Log, wal, request_store,
                 device="cuda"):
        self._init_device(device)
        super().__init__(node, link, app_log, wal, request_store)

    def process(self, actions: act.Actions) -> act.ActionResults:
        pending = None
        if actions.hashes:
            pending = self._dispatch_device(actions.hashes)

        self._persist(actions)
        self._transmit(actions)

        digests = []
        if pending is not None:
            digests = self._collect_device(actions.hashes, pending)

        checkpoints = self._commit(actions)
        return act.ActionResults(digests=digests, checkpoints=checkpoints)


class CudaPoolProcessor(_CudaHashMixin, PoolProcessor):
    """PoolProcessor with the card absorbing the hash lane: the kernel
    dispatch is issued on the calling thread before the lanes launch, so
    the card computes while the persist/send/commit lanes run; the hash
    lane then only collects the results."""

    def __init__(self, node, link: Link, app_log: Log, wal, request_store,
                 device="cuda"):
        self._init_device(device)
        super().__init__(node, link, app_log, wal, request_store)

    def process(self, actions: act.Actions) -> act.ActionResults:
        self._pending_device = None
        if actions.hashes:
            self._pending_device = self._dispatch_device(actions.hashes)
        return super().process(actions)

    def _hash_lane(self, actions: act.Actions) -> list:
        if self._pending_device is None:
            return []
        return self._collect_device(actions.hashes, self._pending_device)


class ProcessorClosed(Exception):
    """process() was called on a closed (or crashed) pipelined processor."""


class _PipelinedBatch:
    """One Actions batch in flight through the pipeline stages."""

    __slots__ = ("actions", "pending_device")

    def __init__(self, actions: act.Actions):
        self.actions = actions
        self.pending_device = None


class _PipelinedGroup:
    """A run of consecutive batches persisted under one ticket pair.

    The persist stage drains every batch waiting in its queue into one
    group: their writes are issued together and a single group-commit
    token per store covers all of them (tokens snapshot the store's
    requested-sync counter, so one token after the last write covers
    every earlier write).  Group size adapts to load — idle clusters get
    one-batch groups and minimum latency, saturated ones get large groups
    and maximum fsync amortization — and, crucially, it bounds pipeline
    latency: downstream stages handle a whole group per queue hop, so
    depth collapses instead of compounding."""

    __slots__ = ("batches", "rs_token", "wal_token")

    def __init__(self, batches: list):
        self.batches = batches
        self.rs_token = None
        self.wal_token = None


class PipelinedProcessor(SerialProcessor):
    """Overlapped stage pipeline over consecutive Actions batches.

    The serial ladder runs every batch's persist→transmit→hash→commit on
    one thread, so per-batch latency IS the throughput ceiling.  This
    executor decomposes the ordering contract into stages connected by
    bounded queues, so batch N+1's persist, batch N's transmit, and
    order-free hashes all proceed concurrently (docs/Processor.md has the
    stage graph):

        intake ─→ persist ─→ barrier ─→ transmit ─→ commit
           └────────→ hash ─────────────────────────────┘

    - **persist** drains every waiting batch into one adaptive group
      (_PipelinedGroup), issues their stores and WAL appends, and
      registers one group-commit ticket pair (storage.sync_token) for
      the lot instead of fsyncing privately — k in-flight batches
      coalesce into ~1 fsync, and group-per-hop handling keeps pipeline
      latency bounded under load.
    - **barrier** redeems both tickets.  This is the per-batch durability
      barrier: no send for batch N happens before batch N's reqstore AND
      WAL data are durable (a group ticket covers every batch in the
      group, so sends can only be *later* than the per-batch contract
      requires, never earlier).  The relative fsync order of the two
      files is NOT part of the contract (the OS writes back dirty pages
      in any order it likes even under the serial ladder); only
      both-before-send is.
    - **transmit** performs sends and forwards; **commit** applies
      batches, prunes, snaps checkpoints, and hands checkpoints to
      node.add_results — process() itself returns an empty
      ActionResults, results are delivered internally.
    - **hash** runs on a side pool from intake (the card's path in
      CudaPipelinedProcessor) and delivers digests to node.add_results
      the moment they are computed.  Hashing is order-free and feeds
      nothing but AddResults, and digests gate the protocol's next round
      trip — parking them behind the fsync-paced stages would put the
      whole pipeline depth on the consensus critical path.

    A stage failure (e.g. a dying disk surfacing through a group-commit
    ticket) parks the pipeline and re-raises from the next process()
    call, so consumer loops observe the crash exactly as they would the
    serial ladder's."""

    _QUEUE_DEPTH = 8
    # Cap on batches merged into one persist group: bounds the work a
    # single queue hop carries (and thus worst-case batch latency).
    _MAX_GROUP = 64

    def __init__(self, node, link: Link, app_log: Log, wal, request_store):
        super().__init__(node, link, app_log, wal, request_store)
        import concurrent.futures
        import queue as queue_mod

        self._queue_mod = queue_mod
        # Embedder seam: because results are delivered internally (the
        # consumer loop never sees digests/checkpoints), embedders that
        # capture checkpoints off ActionResults (state-transfer serving in
        # chaos/live.py and the test harnesses) set this callable; the
        # commit stage invokes it before node.add_results.
        self.on_results = None
        self._stop = threading.Event()
        self._mutex = threading.Lock()
        self._error: BaseException | None = None  # guarded-by: _mutex
        self._closed = False  # guarded-by: _mutex
        self._inflight = 0  # guarded-by: _mutex
        self._inflight_cv = threading.Condition(self._mutex)
        # BoundedQueue (obsv/bqueue.py) gives every stage hand-off the
        # uniform mirbft_queue_{depth,wait_seconds,saturated_total}
        # series; the names are shared across nodes in one process so
        # the label space stays budgeted.
        from ..obsv.bqueue import BoundedQueue

        self._persist_q = BoundedQueue("proc.persist", self._QUEUE_DEPTH)
        self._barrier_q = BoundedQueue("proc.barrier", self._QUEUE_DEPTH)
        self._transmit_q = BoundedQueue("proc.transmit", self._QUEUE_DEPTH)
        self._commit_q = BoundedQueue("proc.commit", self._QUEUE_DEPTH)
        self._hash_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1,
            thread_name_prefix=f"proc-pipe-hash-{node.config.id}",
        )
        self._stages = [
            self._spawn_stage("persist", self._persist_stage),
            self._spawn_stage("barrier", self._barrier_stage),
            self._spawn_stage("transmit", self._transmit_stage),
            self._spawn_stage("commit", self._commit_stage),
        ]

    # -- plumbing ------------------------------------------------------------

    def _spawn_stage(self, name: str, fn) -> threading.Thread:
        """The pipeline's single thread-creation point (lint rule W10 bans
        raw threading.Thread anywhere else in this module): wraps the
        stage body with first-error capture and pipeline park."""
        thread = threading.Thread(
            target=self._stage_main,
            args=(fn,),
            name=f"proc-pipe-{self.node.config.id}-{name}",
            daemon=True,
        )
        thread.start()
        return thread

    def _stage_main(self, fn) -> None:
        try:
            fn()
        except BaseException as err:
            with self._mutex:
                if self._error is None:
                    self._error = err
                self._inflight_cv.notify_all()
            self._stop.set()

    def _gauge(self, stage: str, q) -> None:
        if hooks.enabled:
            depth = q.qsize()
            hooks.metrics.gauge(
                "mirbft_proc_stage_queue_depth", stage=stage
            ).set(depth)
            if hooks.recorder is not None:
                hooks.recorder.record(
                    "resource",
                    "proc.queue_depth",
                    args={"stage": stage, "depth": depth},
                )

    def _q_put(self, q, stage: str, batch) -> None:
        """Blocking put with backpressure that stays responsive to stop:
        a full pipeline throttles intake, a dead one raises."""
        while True:
            with self._mutex:
                if self._error is not None:
                    raise self._error
            if self._stop.is_set():
                raise ProcessorClosed("pipeline stopped")
            try:
                q.put(batch, timeout=0.05)
                break
            except self._queue_mod.Full:
                continue
        self._gauge(stage, q)

    def _q_get(self, q, stage: str):
        """Blocking get; returns None once the pipeline is stopping and
        the queue has drained (stages exit on None)."""
        while True:
            try:
                batch = q.get(timeout=0.05)
            except self._queue_mod.Empty:
                if self._stop.is_set():
                    return None
                continue
            self._gauge(stage, q)
            return batch

    def _batch_done(self) -> None:
        with self._mutex:
            self._inflight -= 1
            self._inflight_cv.notify_all()

    # -- stages --------------------------------------------------------------

    @_observed_phase("persist")
    def _persist_group(self, group: _PipelinedGroup) -> None:
        store_requests = write_ahead = False
        for batch in group.batches:
            self._persist_writes(batch.actions)
            store_requests = store_requests or bool(
                batch.actions.store_requests
            )
            write_ahead = write_ahead or bool(batch.actions.write_ahead)
        if store_requests:
            group.rs_token = self.request_store.sync_token()
        if write_ahead:
            group.wal_token = self.wal.sync_token()

    def _persist_stage(self) -> None:
        while True:
            batch = self._q_get(self._persist_q, "persist")
            if batch is None:
                return
            batches = [batch]
            while len(batches) < self._MAX_GROUP:
                try:
                    batches.append(self._persist_q.get_nowait())
                except self._queue_mod.Empty:
                    break
            group = _PipelinedGroup(batches)
            self._persist_group(group)
            self._q_put(self._barrier_q, "barrier", group)

    @_observed_phase("sync_wait")
    def _await_durability(self, group: _PipelinedGroup) -> None:
        """The durability barrier: both group-commit tickets must be
        redeemed before any of the group's sends."""
        for store, token in (
            (self.request_store, group.rs_token),
            (self.wal, group.wal_token),
        ):
            if token is None:
                continue
            while not store.wait(token, timeout=0.1):
                if self._stop.is_set():
                    raise ProcessorClosed("pipeline stopped mid-sync")

    def _barrier_stage(self) -> None:
        while True:
            group = self._q_get(self._barrier_q, "barrier")
            if group is None:
                return
            self._await_durability(group)
            self._q_put(self._transmit_q, "transmit", group)

    def _transmit_stage(self) -> None:
        while True:
            group = self._q_get(self._transmit_q, "transmit")
            if group is None:
                return
            for batch in group.batches:
                self._transmit(batch.actions)
            self._q_put(self._commit_q, "commit", group)

    def _commit_stage(self) -> None:
        while True:
            group = self._q_get(self._commit_q, "commit")
            if group is None:
                return
            for batch in group.batches:
                try:
                    checkpoints = self._commit(batch.actions)
                    if checkpoints:
                        self._emit_results(
                            act.ActionResults(
                                digests=[], checkpoints=checkpoints
                            )
                        )
                finally:
                    self._batch_done()

    def _emit_results(self, results: act.ActionResults) -> None:
        callback = self.on_results
        if callback is not None:
            callback(results)
        from .node import NodeStopped

        try:
            self.node.add_results(results)
        except NodeStopped:
            pass  # teardown race: the node left first; results are moot

    # -- intake --------------------------------------------------------------

    def _hash_batch(self, batch: _PipelinedBatch) -> None:
        """Hash worker: compute and deliver immediately.  Digests gate
        the protocol's next round trip (preprepare -> prepare needs the
        batch digest), so they must not ride behind the fsync-paced
        stages — holding them to commit cadence inflates per-seq latency
        enough to trip suspect timeouts under load.  A hash failure (a
        dying accelerator backend) parks the pipeline like any stage
        error."""
        try:
            if batch.pending_device is not None:
                digests = self._collect_device(
                    batch.actions.hashes, batch.pending_device
                )
            else:
                digests = self._hash(batch.actions)
            if digests:
                self._emit_results(
                    act.ActionResults(digests=digests, checkpoints=[])
                )
        except BaseException as err:
            with self._mutex:
                if self._error is None:
                    self._error = err
                self._inflight_cv.notify_all()
            self._stop.set()
            raise

    def _maybe_dispatch(self, actions: act.Actions):
        """Device-dispatch seam; the CUDA variant launches the kernel here
        so the card works while the pipeline persists."""
        return None

    def process(self, actions: act.Actions) -> act.ActionResults:
        with self._mutex:
            if self._error is not None:
                raise self._error
            if self._closed:
                raise ProcessorClosed("processor closed")
            self._inflight += 1
        batch = _PipelinedBatch(actions)
        try:
            batch.pending_device = self._maybe_dispatch(actions)
            if actions.hashes:
                self._hash_pool.submit(self._hash_batch, batch)
            self._q_put(self._persist_q, "persist", batch)
        except BaseException:
            self._batch_done()
            raise
        # Digests (hash worker) and checkpoints (commit stage) are
        # delivered to node.add_results internally; the consumer loop has
        # nothing to forward.
        return act.ActionResults(digests=[], checkpoints=[])

    def close(self, wait: bool = True) -> None:
        with self._mutex:
            self._closed = True
        if wait:
            deadline = time.monotonic() + 30.0
            with self._inflight_cv:
                while (
                    self._inflight > 0
                    and self._error is None
                    and time.monotonic() < deadline
                ):
                    self._inflight_cv.wait(timeout=0.1)
        self._stop.set()
        for thread in self._stages:
            thread.join(timeout=5.0)
        self._hash_pool.shutdown(wait=wait)


class CudaPipelinedProcessor(_CudaHashMixin, PipelinedProcessor):
    """PipelinedProcessor with the hash stage on the card: the SHA-256
    kernel launches at intake, computes while the persist/barrier/transmit
    stages run, and the hash worker only waits on the batch's event and
    reads the words.  Several batches are in flight at once, each with its
    own pinned buffer."""

    def __init__(self, node, link: Link, app_log: Log, wal, request_store,
                 device="cuda"):
        self._init_device(device)
        super().__init__(node, link, app_log, wal, request_store)

    def _maybe_dispatch(self, actions: act.Actions):
        if actions.hashes:
            return self._dispatch_device(actions.hashes)
        return None


#: Config.processor values -> executor classes (build_processor resolves).
PROCESSOR_KINDS = {
    "serial": SerialProcessor,
    "pool": PoolProcessor,
    "pipelined": PipelinedProcessor,
    "cuda": CudaProcessor,
    "cuda-pool": CudaPoolProcessor,
    "cuda-pipelined": CudaPipelinedProcessor,
}


def build_processor(node, link: Link, app_log: Log, wal, request_store,
                    kind=None, device="cuda"):
    """Construct the executor selected by ``kind`` (or, when None, by
    ``node.config.processor``, whose default is ``cuda``) — the single
    wiring point for runtime embedders (bench.py).  The ``cuda*`` kinds
    run on ``device``: ``cuda`` raises without a card, ``cpu`` runs the
    kernel's plain version.  The host kinds hash with hashlib and take no
    device."""
    if kind is None:
        kind = node.config.processor
    if kind in TPU_KINDS:
        raise ValueError(
            f"processor kind {kind!r} is the JAX package's; the port's kind "
            f"is {TPU_KINDS[kind]!r}"
        )
    cls = PROCESSOR_KINDS.get(kind)
    if cls is None:
        raise ValueError(
            f"unknown processor kind {kind!r}; choose from "
            f"{sorted(PROCESSOR_KINDS)}"
        )
    if issubclass(cls, _CudaHashMixin):
        return cls(node, link, app_log, wal, request_store, device=device)
    return cls(node, link, app_log, wal, request_store)
