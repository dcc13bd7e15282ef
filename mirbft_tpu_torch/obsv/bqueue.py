"""The bounded-queue telemetry shim: every bounded hot-path queue's
single sanctioned emission point for the ``mirbft_queue_*`` series.

Saturation attribution (obsv/critpath.py) names the *phase* where a
request's latency went; these series name the *queue* that absorbed the
wait, so the two lines of evidence corroborate each other.  Three
uniform families, labeled ``queue="<name>"``:

- ``mirbft_queue_depth`` — items queued right after a put/get (gauge).
- ``mirbft_queue_wait_seconds`` — enqueue→dequeue residency per item
  (histogram).
- ``mirbft_queue_saturated_total`` — put attempts that found the queue
  at capacity: blocked (processor stages, app apply), dropped-oldest
  (transport peer lanes), or forced a flush (device staging).

Two entry points:

- :class:`BoundedQueue` — a drop-in for ``queue.Queue`` used by queues
  with stdlib semantics (processor stage hand-offs, the CommitStream
  apply queue).  Items are stamped at enqueue so the wait histogram is
  true per-item residency.
- :class:`QueueTelemetry` — a bare handle for queues whose data
  structure cannot be swapped (the transport's latency-emulating deque,
  the device plane's staged-row buffer); the owner calls ``depth()`` /
  ``wait()`` / ``saturated()`` at its own put/drain points.

Every record is behind ``hooks.enabled`` (one branch when off — the
<2% disabled-overhead contract) and every registration catches
``CardinalityError``: a queue past the documented budget loses its
series, never its queue.  Lint rule W19 confines ``mirbft_queue_*``
emission to this module so an ad-hoc queue cannot bypass telemetry.
"""

from __future__ import annotations

import queue as _queue_mod
import time

from . import hooks
from .metrics import CardinalityError

_DEPTH = "mirbft_queue_depth"
_WAIT = "mirbft_queue_wait_seconds"
_SATURATED = "mirbft_queue_saturated_total"


class QueueTelemetry:
    """Emission handle for one named bounded queue.

    Handles are looked up lazily against whatever registry ``hooks``
    currently carries and re-resolved when ``enable()`` installs a new
    one, so a long-lived queue survives enable/disable cycles.  All
    three record methods are no-ops (one branch) when observability is
    off.
    """

    __slots__ = ("name", "_registry", "_depth", "_wait", "_saturated")

    def __init__(self, name: str):
        self.name = name
        self._registry = None
        self._depth = None
        self._wait = None
        self._saturated = None

    def _handles(self):
        registry = hooks.metrics
        if registry is None:
            return None
        if registry is not self._registry:
            try:
                self._depth = registry.gauge(_DEPTH, queue=self.name)
                self._wait = registry.histogram(_WAIT, queue=self.name)
                self._saturated = registry.counter(
                    _SATURATED, queue=self.name
                )
            except CardinalityError:
                # Over the documented budget: this queue loses its
                # series (depth/wait/saturated all-or-nothing), the
                # queue itself keeps working.
                self._depth = self._wait = self._saturated = None
            self._registry = registry
        return self._depth

    def depth(self, n: int) -> None:
        if hooks.enabled and self._handles() is not None:
            self._depth.set(n)

    def wait(self, seconds: float) -> None:
        if hooks.enabled and self._handles() is not None:
            self._wait.observe(seconds)

    def saturated(self, n: int = 1) -> None:
        if hooks.enabled and self._handles() is not None:
            self._saturated.inc(n)


class BoundedQueue:
    """``queue.Queue`` semantics plus uniform backpressure telemetry.

    Items are stored as ``(enqueue_perf_counter, item)`` so the wait
    histogram observes true enqueue→dequeue residency; the stamp is 0.0
    when observability was off at enqueue time (such items skip the
    histogram — a residency measured across an enable() edge would be
    garbage).  ``put``/``get`` raise ``queue.Full``/``queue.Empty``
    exactly like the stdlib class.
    """

    __slots__ = ("name", "maxsize", "_q", "telemetry")

    def __init__(self, name: str, maxsize: int = 0):
        self.name = name
        self.maxsize = maxsize
        self._q = _queue_mod.Queue(maxsize=maxsize)
        self.telemetry = QueueTelemetry(name)

    def put(self, item, block: bool = True, timeout: float | None = None):
        stamp = time.perf_counter() if hooks.enabled else 0.0
        entry = (stamp, item)
        try:
            self._q.put_nowait(entry)
        except _queue_mod.Full:
            # The backpressure edge: count the saturated attempt, then
            # fall through to the caller's blocking discipline.
            self.telemetry.saturated()
            self._q.put(entry, block=block, timeout=timeout)
        self.telemetry.depth(self._q.qsize())

    def put_nowait(self, item):
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: float | None = None):
        stamp, item = self._q.get(block=block, timeout=timeout)
        if hooks.enabled:
            if stamp:
                self.telemetry.wait(time.perf_counter() - stamp)
            self.telemetry.depth(self._q.qsize())
        return item

    def get_nowait(self):
        return self.get(block=False)

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()
