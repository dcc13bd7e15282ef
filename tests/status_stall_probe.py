"""How long does a live node's ``/status`` take in the start burst of the
live rung, and is the node frozen or busy while it waits?

``/status`` is answered by the node's serializer thread: the HTTP
exporter puts a request in the serializer's inbox and gives 503 when no
answer comes within 2 s (``runtime/node.py`` ``_status_json``, the same
in both packages).  This script runs the live rung traced (the port's
``bench.live_cluster_rate(kind, trace_dir=...)``, 4 node processes at the
JAX package's ``LIVE`` settings) and, from the first proposal on, polls
every node for ``--window`` seconds on two threads of its own:

- ``/status`` back to back: each answer's round trip is the time the
  request waited in the serializer's inbox plus the snapshot;
- ``/metrics`` every 50 ms: the exporter thread answers it without the
  serializer, so its round trip says whether the node's process was
  responsive at all, and its counters (WAL appends, consensus
  milestones, ack events) say whether the node went on working.

A node whose ``/status`` is slow while ``/metrics`` stays fast and its
counters climb is busy: the request waits behind a backlog.  A node whose
``/metrics`` is slow too is frozen: something holds its interpreter.

``--package jax`` runs the JAX package's live rung instead, on the CPU
(``--kind serial`` or ``pipelined``), and polls each node's
``_status_json()``, the call its exporter makes, with the same 2-s
deadline.  Its nodes are threads of one process and run untraced: with
the JAX hooks on, that rung commits nothing within its deadline on an
8-core host.  So it has no ``/metrics`` column.

    python3 tests/status_stall_probe.py [--package port|jax]
        [--device cuda|cpu] [--kind cuda-pipelined] [--reps 1]
        [--window 6] [--every 0]

Prints, per node and run, the slowest ``/status`` round trips with the
instant they were asked (seconds after the first proposal), the number
of 503s, the slowest ``/metrics`` round trip inside the slowest
``/status`` wait and the counters' climb across it.  The last line starts
``SUMMARY`` and holds, per run, each node's slowest ``/status`` round
trip and its 503 count as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COUNTERS = (
    "mirbft_wal_appends_total",
    "mirbft_seq_milestones_total",
    "mirbft_ack_events_total",
)


def counters_of(text: str) -> dict:
    """Each of ``COUNTERS`` summed over its labels."""
    out = {name: 0.0 for name in COUNTERS}
    for line in text.splitlines():
        match = re.match(r"(\w+)(\{[^}]*\})? ([0-9.eE+-]+)$", line)
        if match and match.group(1) in out:
            out[match.group(1)] += float(match.group(3))
    return out


def http_get(address, path: str):
    host, port = address
    try:
        with urllib.request.urlopen(
            f"http://{host}:{port}{path}", timeout=30
        ) as reply:
            return reply.status, reply.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


class Poller:
    """Two threads a node: ``status()`` every ``every_s`` after the last
    answer, ``metrics()`` every 50 ms, both for ``window_s`` from
    ``t0``."""

    def __init__(self, t0: float, window_s: float, status, metrics,
                 every_s: float = 0.0):
        self.t0, self.window_s, self.every_s = t0, window_s, every_s
        self.status_fn, self.metrics_fn = status, metrics
        self.status_log = []  # (asked at s, round trip s, code)
        self.metrics_log = []  # (asked at s, round trip s, counters)
        self.threads = [
            threading.Thread(target=self._status, daemon=True),
            threading.Thread(target=self._metrics, daemon=True),
        ]
        for thread in self.threads:
            thread.start()

    def _status(self):
        while time.perf_counter() - self.t0 < self.window_s:
            asked = time.perf_counter()
            code = self.status_fn()
            self.status_log.append(
                (asked - self.t0, time.perf_counter() - asked, code)
            )
            time.sleep(self.every_s)

    def _metrics(self):
        while time.perf_counter() - self.t0 < self.window_s:
            asked = time.perf_counter()
            counters = self.metrics_fn()
            self.metrics_log.append(
                (asked - self.t0, time.perf_counter() - asked, counters)
            )
            time.sleep(0.05)

    def join(self):
        for thread in self.threads:
            thread.join()

    def report(self, node: int) -> dict:
        slow = max(self.status_log, key=lambda row: row[1])
        asked, waited, _code = slow
        inside = [
            row for row in self.metrics_log
            if asked <= row[0] <= asked + waited
        ]
        before = [row for row in self.metrics_log if row[0] <= asked]
        after = [row for row in self.metrics_log if row[0] >= asked + waited]
        climb = {}
        if before and after:
            climb = {
                name: after[0][2][name] - before[-1][2][name]
                for name in COUNTERS
            }
        worst = sorted(self.status_log, key=lambda row: -row[1])[:5]
        n503 = sum(1 for row in self.status_log if row[2] == 503)
        print(
            f"  node {node}: {len(self.status_log)} /status asks, {n503} "
            f"gave 503; slowest (asked at s, round trip s, code) "
            f"{[(round(a, 3), round(w, 3), c) for a, w, c in worst]}; "
            f"inside the slowest: {len(inside)} /metrics reads, slowest "
            f"{max((row[1] for row in inside), default=0.0):.3f} s; "
            f"counters' climb across it {climb}; at the window's end "
            f"{self.metrics_log[-1][2] if self.metrics_log else {}}"
        )
        return {"slowest_s": round(waited, 3), "asked_at_s": round(asked, 3),
                "n503": n503,
                "metrics_inside_max_s": round(
                    max((row[1] for row in inside), default=0.0), 3)}


def port_run(args) -> dict:
    from mirbft_tpu_torch import bench

    bench.LIVE_SCRAPE_AFTER_S = 0.0  # poll from the first proposal on
    pollers = {}

    def on_running(exporters):
        t0 = time.perf_counter()
        for n, address in sorted(exporters.items()):
            pollers[n] = Poller(
                t0, args.window,
                lambda a=address: http_get(a, "/status")[0],
                lambda a=address: counters_of(http_get(a, "/metrics")[1]),
                args.every,
            )
        for poller in pollers.values():
            poller.join()
        return True

    with tempfile.TemporaryDirectory() as trace_dir:
        result = bench.live_cluster_rate(
            args.kind, device=args.device, trace_dir=trace_dir,
            on_running=on_running,
        )
    print(f"  port {args.kind} on {args.device}: {result['rate']:.3f} req/s,"
          f" p95 {result['p95_ms']:.3f} ms")
    return {n: poller.report(n) for n, poller in sorted(pollers.items())}


def jax_run(args) -> dict:
    import bench as jax_bench
    from mirbft_tpu.runtime import Node

    nodes = []
    started = threading.Event()
    original = Node.start_new.__func__

    def start_new(cls, *a, **k):
        node = original(cls, *a, **k)
        nodes.append(node)
        if len(nodes) == jax_bench.LIVE_NODES:
            started.set()
        return node

    Node.start_new = classmethod(start_new)
    pollers = {}

    def watch():
        started.wait()
        t0 = time.perf_counter()

        def status(node):
            return 200 if node._status_json() is not None else 503

        for n, node in enumerate(nodes):
            pollers[n] = Poller(
                t0, args.window, lambda node=node: status(node),
                lambda: dict.fromkeys(COUNTERS, 0.0), args.every,
            )

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        rate, p95_ms, _flooded = jax_bench.live_cluster_rate(
            args.kind, detailed=True
        )
    finally:
        Node.start_new = classmethod(original)
    watcher.join()
    for poller in pollers.values():
        poller.join()
    print(f"  jax {args.kind} on the CPU: {rate:.3f} req/s, p95 "
          f"{p95_ms:.3f} ms, untraced")
    return {n: poller.report(n) for n, poller in sorted(pollers.items())}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package", choices=("port", "jax"), default="port")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--kind", default="cuda-pipelined")
    parser.add_argument("--reps", type=int, default=1)
    parser.add_argument("--window", type=float, default=6.0)
    parser.add_argument("--every", type=float, default=0.0,
                        help="seconds between a node's /status asks")
    args = parser.parse_args(argv)
    runs = []
    for rep in range(args.reps):
        print(f"run {rep}: {args.package}")
        runs.append(port_run(args) if args.package == "port"
                    else jax_run(args))
    print("SUMMARY " + json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
