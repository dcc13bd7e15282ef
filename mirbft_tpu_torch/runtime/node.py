"""The Node facade and the serializer thread.

Rebuild of the reference's public API + serializer (reference:
mirbft.go:44-459, serializer.go:25-257).  All inputs — steps from transport
threads, proposals from client threads, ticks, action results — funnel
through one queue into the single protocol thread, which owns the
StateMachine exclusively.  Accumulated Actions are handed to the consumer
through a one-slot outbox; each handoff is marked with an ActionsReceived
event so recorded logs tie results to the actions that caused them.
"""

from __future__ import annotations

import queue
import threading

from .. import pb
from ..core.state_machine import StateMachine
from ..obsv import hooks
from .config import Config
from .msgfilter import MalformedMessage, pre_process


class NodeStopped(Exception):
    pass


class _BootstrapWal:
    """Synthesizes the initial CEntry + FEntry for a fresh network
    (reference: mirbft.go:162-190).  The serializer re-persists these into
    the real WAL so subsequent starts use restart_node."""

    def __init__(
        self,
        initial_network_state,
        initial_checkpoint_value,
        initial_leaders=None,
    ):
        self.initial_network_state = initial_network_state
        self.initial_checkpoint_value = initial_checkpoint_value
        # Epoch-0 leader set; defaults to every node.  A cluster that
        # provisions not-yet-started members (join_node) boots with the
        # running subset as leaders so the absent member's buckets don't
        # stall the network until the first suspicion round.
        self.initial_leaders = initial_leaders

    def load_all(self, for_each):
        for_each(
            1,
            pb.Persistent(
                type=pb.CEntry(
                    seq_no=0,
                    checkpoint_value=self.initial_checkpoint_value,
                    network_state=self.initial_network_state,
                )
            ),
        )
        for_each(
            2,
            pb.Persistent(
                type=pb.FEntry(
                    ends_epoch_config=pb.EpochConfig(
                        number=0,
                        leaders=(
                            self.initial_leaders
                            if self.initial_leaders is not None
                            else self.initial_network_state.config.nodes
                        ),
                    )
                )
            ),
        )


class _EmptyReqStore:
    def uncommitted(self, for_each):
        pass


def standard_initial_network_state(
    node_count: int,
    client_ids,
    *,
    nodes=None,
    checkpoint_interval: int | None = None,
    max_epoch_length: int | None = None,
) -> pb.NetworkState:
    """Default protocol constants (reference: mirbft.go:125-154).

    The keyword overrides exist so embedders can *construct* a
    non-default genesis (scenario checkpoint intervals, a
    reconfiguration joiner's target node set) instead of mutating the
    returned config in place — in-place NetworkConfig mutation outside
    the adoption seam is banned by lint rule W20."""
    members = list(nodes) if nodes is not None else list(range(node_count))
    buckets = len(members)
    ci = (
        int(checkpoint_interval)
        if checkpoint_interval
        else 5 * buckets
    )
    return pb.NetworkState(
        config=pb.NetworkConfig(
            nodes=members,
            f=(len(members) - 1) // 3,
            number_of_buckets=buckets,
            checkpoint_interval=ci,
            max_epoch_length=(
                int(max_epoch_length) if max_epoch_length else 10 * ci
            ),
        ),
        clients=[
            pb.NetworkClient(id=cid, width=100, low_watermark=0)
            for cid in client_ids
        ],
    )


class _Waiter:
    """Runtime mirror of the core's ClientWaiter: a real event to block on."""

    def __init__(self, core_waiter):
        self.core = core_waiter
        self.expired = threading.Event()


class Node:
    """Thread-safe facade over the serializer thread."""

    def __init__(self, config: Config, wal_storage, req_storage):
        self.config = config
        self._inbox: queue.Queue = queue.Queue()
        self._outbox: queue.Queue = queue.Queue(maxsize=1)
        self._stopped = threading.Event()
        self._stop_lock = threading.Lock()
        self._stop_done = False
        self._exit_error: BaseException | None = None
        self._machine = StateMachine(
            logger=config.logger, ack_plane=config.ack_plane,
            ack_flush_rows=config.ack_flush_rows,
            ack_device=config.ack_device,
        )
        if config.shadow_stride is not None and hooks.enabled and (
            hooks.shadow is None
        ):
            # Config-driven divergence oracle: audit every Nth ack frame
            # (host mirror or device plane) without the embedder having to
            # install a sampler by hand.
            from ..obsv.shadow import ShadowSampler

            hooks.shadow = ShadowSampler(
                stride=config.shadow_stride,
                registry=hooks.metrics,
                recorder=hooks.recorder,
            )
        self._waiters: list[_Waiter] = []
        self.app_stream = None  # set by attach_app
        self._exporter = None
        if config.metrics_port is not None:
            from ..obsv.exporter import ObsvExporter

            self._exporter = ObsvExporter(
                host=config.metrics_host,
                port=config.metrics_port,
                registry_fn=self._live_registry,
                status_fn=self._status_json,
                node_id=config.id,
                dump_fn=self._flight_dump,
            )
        self._wal_storage = wal_storage
        self._req_storage = req_storage
        self._thread = threading.Thread(
            target=self._run, name=f"mirbft-serializer-{config.id}", daemon=True
        )
        self._thread.start()

    # -- construction helpers ------------------------------------------------

    @classmethod
    def start_new(
        cls,
        config: Config,
        initial_network_state: pb.NetworkState,
        initial_checkpoint_value: bytes = b"",
        initial_leaders=None,
    ) -> "Node":
        return cls(
            config,
            _BootstrapWal(
                initial_network_state,
                initial_checkpoint_value,
                initial_leaders=initial_leaders,
            ),
            _EmptyReqStore(),
        )

    @classmethod
    def restart(cls, config: Config, wal_storage, req_storage) -> "Node":
        return cls(config, wal_storage, req_storage)

    # -- public API (thread-safe) --------------------------------------------

    def attach_app(self, app, *, state_path=None, queue_depth=256,
                   data_source=None):
        """Register a replicated state machine and return the commit
        stream: an ordered, exactly-once-per-apply-index delivery of
        committed ops into ``app.apply(client_id, req_no, seq_no,
        apply_index, data)``, with the applied index persisted inside the
        app snapshot at ``state_path`` so restart and snapshot install
        resume without re-applying.  The returned ``CommitStream`` is the
        ``Log`` to hand to ``build_processor`` (or to compose with a
        durable journal via ``app.AppLog``); ``app_status()`` reads its
        frontier."""
        from ..app.stream import CommitStream

        self.app_stream = CommitStream(
            app,
            node_id=self.config.id,
            state_path=state_path,
            queue_depth=queue_depth,
            data_source=data_source,
        )
        return self.app_stream

    def app_status(self) -> dict | None:
        """The attached commit stream's frontier/queue status (None when
        no app is attached)."""
        return None if self.app_stream is None else self.app_stream.status()

    def step(self, source: int, msg: pb.Msg) -> None:
        """Inbound authenticated message from the transport.  Structural
        and size-bound validation runs in the caller's thread; rejections
        are counted by taxonomy kind before the exception propagates (the
        transport drops the frame)."""
        try:
            pre_process(msg, self.config)
        except MalformedMessage as err:
            if hooks.enabled:
                hooks.metrics.counter(
                    "mirbft_byzantine_rejections_total", kind=err.kind
                ).inc()
            raise
        self._put(("step", source, msg))

    def propose(self, request: pb.Request) -> None:
        self._put(("propose", request))

    def tick(self) -> None:
        self._put(("tick",))

    def add_results(self, results) -> None:
        """results: core.actions.ActionResults"""
        self._put(("results", results))

    def state_transfer_complete(self, target, network_state) -> None:
        self._put(
            (
                "transfer",
                pb.CEntry(
                    seq_no=target.seq_no,
                    checkpoint_value=target.value,
                    network_state=network_state,
                ),
            )
        )

    def state_transfer_failed(self, target) -> None:
        self._put(
            (
                "transfer",
                pb.CEntry(
                    seq_no=target.seq_no,
                    checkpoint_value=target.value,
                    network_state=None,
                ),
            )
        )

    def ready(self, timeout: float | None = None):
        """Block for the next batch of Actions; None on timeout/stop."""
        try:
            actions = self._outbox.get(timeout=timeout)
        except queue.Empty:
            return None
        # Wake the serializer: actions accumulated while the one-slot outbox
        # was full should be handed off now, not when the next inbound event
        # (often a whole tick later) arrives.
        self._inbox.put(("wake",))
        return actions

    def client_proposer(self, client_id: int, blocking: bool = True):
        waiter = self._request_waiter(client_id)
        if waiter is None:
            raise ValueError(f"client {client_id} not registered")
        return ClientProposer(self, client_id, waiter, blocking)

    def status(self, timeout: float = 5.0):
        reply: queue.Queue = queue.Queue(maxsize=1)
        self._put(("status", reply))
        try:
            return reply.get(timeout=timeout)
        except queue.Empty:
            return None

    def audit_divergence(self, timeout: float = 5.0):
        """Run the scalar/vector divergence oracle (obsv.shadow) over this
        node's client tracker, on the serializer thread (the tracker is
        never safe to touch from outside it).  Returns the divergence list,
        or None when the node is stopped or the audit timed out."""
        reply: queue.Queue = queue.Queue(maxsize=1)
        try:
            self._put(("shadow_audit", reply))
            return reply.get(timeout=timeout)
        except (NodeStopped, queue.Empty):
            return None

    def stop(self) -> None:
        """Idempotent, concurrency-safe shutdown: the first caller tears
        down (serializer joined, exporter closed); later and concurrent
        callers wait for that teardown rather than racing it."""
        with self._stop_lock:
            if not self._stop_done:
                self._stop_done = True
                self._stopped.set()
                # Bypass _put: it refuses new work once stopped, but the
                # sentinel must always reach the serializer.
                self._inbox.put(("stop",))
            self._thread.join(timeout=10)
            self._close_exporter()
            if self.app_stream is not None:
                self.app_stream.close()

    @property
    def exit_error(self):
        return self._exit_error

    @property
    def retired(self) -> bool:
        """True once an adopted reconfiguration excluded this node from
        the active member set — the embedder should drain and exit.
        Plain cross-thread read of a bool the serializer only ever flips
        False→True; monitoring-grade, no lock needed."""
        return self._machine.retired

    def reconfig_status(self) -> dict:
        """Monitoring-grade reconfiguration counters (adopted count,
        retirement, pending backlog).  Reads serializer-owned state
        without synchronization: single attribute loads of values the
        serializer replaces atomically, for status files and dashboards
        only — never for protocol decisions."""
        machine = self._machine
        pending = 0
        commit_state = machine.commit_state
        if commit_state is not None and commit_state.active_state is not None:
            pending = len(commit_state.active_state.pending_reconfigurations)
        return {
            "adopted": machine.reconfigs_adopted,
            "retired": machine.retired,
            "pending": pending,
        }

    @property
    def metrics_address(self):
        """``(host, port)`` of the HTTP endpoint, or None when disabled."""
        return self._exporter.address if self._exporter is not None else None

    def set_ready(self, ready: bool) -> None:
        """Flip the /healthz readiness flag (no-op without an exporter).
        A cluster worker reports not-ready between boot and transport
        wiring so a supervisor's handshake observes a true mesh."""
        if self._exporter is not None:
            self._exporter.ready = ready

    # -- HTTP endpoint plumbing (runs on exporter request threads) -----------

    def _live_registry(self):
        return hooks.metrics if hooks.enabled else None

    def _status_json(self):
        if self._stopped.is_set():
            return None
        try:
            status = self.status(timeout=2.0)
        except NodeStopped:
            return None
        return status.to_json() if status is not None else None

    def _flight_dump(self, reason="endpoint"):
        """Flush the wired flight recorder; None when none is wired
        (the exporter maps that to 503)."""
        recorder = hooks.recorder if hooks.enabled else None
        if recorder is None:
            return None
        return recorder.flush(reason)

    def _close_exporter(self):
        if self._exporter is not None:
            self._exporter.close()

    def _put(self, item) -> None:
        if self._stopped.is_set() and item[0] != "stop":
            raise NodeStopped(str(self._exit_error or "stopped"))
        self._inbox.put(item)

    def _request_waiter(self, client_id: int):
        reply: queue.Queue = queue.Queue(maxsize=1)
        self._put(("waiter", client_id, reply))
        return reply.get(timeout=5)

    # -- the serializer thread -----------------------------------------------

    def _apply(self, event: pb.StateEvent, actions) -> None:
        if self.config.event_interceptor is not None:
            self.config.event_interceptor(event)
        if hooks.enabled and hooks.recorder is not None:
            hooks.recorder.record_event(
                type(event.type).__name__, node=self.config.id
            )
        actions.concat(self._machine.apply_event(event))

    def _run(self) -> None:
        from ..core.actions import Actions

        actions = Actions()
        try:
            self._apply(
                pb.StateEvent(
                    type=pb.EventInitialize(
                        initial_parms=pb.InitialParameters(
                            id=self.config.id,
                            batch_size=self.config.batch_size,
                            heartbeat_ticks=self.config.heartbeat_ticks,
                            suspect_ticks=self.config.suspect_ticks,
                            new_epoch_timeout_ticks=self.config.new_epoch_timeout_ticks,
                            buffer_size=self.config.buffer_size,
                        )
                    )
                ),
                actions,
            )

            is_bootstrap = isinstance(self._wal_storage, _BootstrapWal)
            loaded = 0

            def load_entry(index, entry):
                nonlocal loaded
                loaded += 1
                if is_bootstrap:
                    # Re-persist the synthesized log into the real WAL.
                    actions.persist(index, entry)
                self._apply(
                    pb.StateEvent(
                        type=pb.EventLoadEntry(index=index, data=entry)
                    ),
                    actions,
                )

            self._wal_storage.load_all(load_entry)
            if not is_bootstrap and loaded == 0:
                # Restart-from-disk hardening: an empty WAL on restart
                # means the log was lost or the wrong directory was
                # mounted.  Silently proceeding would re-initialize at
                # seq 0 and fork against the rest of the cluster; fail
                # loudly instead (surfaced via exit_error).
                raise RuntimeError(
                    "restart with empty WAL: refusing to rejoin without "
                    "a persisted checkpoint (use start_new to bootstrap)"
                )

            def load_request(ack):
                # Discard resulting actions: replayed request acks must not
                # re-store or re-broadcast immediately (the retransmit tick
                # handles re-acking, reference: serializer.go:170-186).
                self._apply(
                    pb.StateEvent(type=pb.EventLoadRequest(request_ack=ack)),
                    Actions(),
                )

            self._req_storage.uncommitted(load_request)

            self._apply(
                pb.StateEvent(type=pb.EventCompleteInitialization()), actions
            )

            while True:
                self._flush_outbox(actions)
                self._notify_waiters()
                item = self._inbox.get()
                kind = item[0]
                if kind == "stop":
                    return
                if kind == "wake":
                    continue  # flush retried at the top of the loop
                if kind == "step":
                    self._apply(
                        pb.StateEvent(
                            type=pb.EventStep(source=item[1], msg=item[2])
                        ),
                        actions,
                    )
                elif kind == "propose":
                    self._apply(
                        pb.StateEvent(type=pb.EventPropose(request=item[1])),
                        actions,
                    )
                elif kind == "tick":
                    self._apply(pb.StateEvent(type=pb.EventTick()), actions)
                elif kind == "results":
                    from ..core.actions import results_to_event

                    self._apply(
                        pb.StateEvent(type=results_to_event(item[1])), actions
                    )
                elif kind == "transfer":
                    self._apply(
                        pb.StateEvent(type=pb.EventTransfer(c_entry=item[1])),
                        actions,
                    )
                elif kind == "waiter":
                    client = self._machine.client_tracker.client(item[1])
                    if client is None:
                        item[2].put(None)
                    else:
                        waiter = _Waiter(client.client_waiter)
                        self._waiters.append(waiter)
                        item[2].put(waiter)
                elif kind == "status":
                    from ..status import state_machine_status

                    item[1].put(state_machine_status(self._machine))
                elif kind == "shadow_audit":
                    from ..obsv import shadow

                    # An oracle bug must not crash a consensus node: report
                    # it as a divergence record instead (callers fail the
                    # audit loudly without losing the serializer).
                    try:
                        divs = shadow.audit_tracker(
                            self._machine.client_tracker
                        )
                    except Exception as audit_err:
                        divs = [
                            {
                                "component": "audit_error",
                                "slot": -1,
                                "client_id": -1,
                                "req_no": -1,
                                "detail": repr(audit_err),
                            }
                        ]
                    item[1].put(divs)
                else:
                    raise AssertionError(f"unknown inbox item {kind!r}")
        except BaseException as err:  # noqa: BLE001 — surfaced via exit_error
            self._exit_error = err
            self.config.logger.error(
                "serializer thread exiting", error=repr(err)
            )
            # The black box outlives the crash: note the error and flush
            # so the postmortem timeline ends at the failure.
            try:
                if hooks.enabled and hooks.recorder is not None:
                    hooks.recorder.record_note(
                        "serializer.crash",
                        node=self.config.id,
                        args={"error": repr(err)},
                    )
                    hooks.recorder.flush("serializer-crash")
            except Exception:
                pass  # dumping is best-effort on the crash path
        finally:
            self._stopped.set()
            for waiter in self._waiters:
                waiter.expired.set()
            # Serializer death (clean stop or crash) takes the scrape
            # surface down with it.
            self._close_exporter()

    def _flush_outbox(self, actions) -> None:
        from ..core.actions import Actions

        if actions.is_empty() or self._outbox.full():
            return
        handoff = Actions().concat(actions)
        actions.clear()
        try:
            self._outbox.put_nowait(handoff)
        except queue.Full:
            actions.concat(handoff)
            return
        self._apply(pb.StateEvent(type=pb.EventActionsReceived()), actions)

    def _notify_waiters(self) -> None:
        live = []
        for waiter in self._waiters:
            # The core flips .expired when the window moves; mirror it onto
            # the runtime event and refresh the registration.
            if waiter.core.expired:
                waiter.expired.set()
            else:
                live.append(waiter)
        self._waiters = live


class ClientProposer:
    """Watermark-backpressured proposal API for one client (reference:
    mirbft.go:53-122)."""

    def __init__(self, node: Node, client_id: int, waiter, blocking: bool):
        self.node = node
        self.client_id = client_id
        self._waiter = waiter
        self.blocking = blocking

    def propose(self, request: pb.Request, timeout: float | None = 30.0) -> None:
        while True:
            low = self._waiter.core.low_watermark
            high = self._waiter.core.high_watermark
            if request.req_no < low:
                raise ValueError(
                    f"request {request.req_no} below low watermark {low}"
                )
            if request.req_no <= high:
                break
            if not self.blocking:
                raise ValueError("request above watermarks (non-blocking)")
            if not self._waiter.expired.wait(timeout=timeout):
                raise TimeoutError("window did not move in time")
            refreshed = self.node._request_waiter(self.client_id)
            if refreshed is None:
                raise NodeStopped("client no longer registered")
            self._waiter = refreshed
        self.node.propose(request)
