"""KV workload driver: user-visible read/write SLOs over the app layer.

Where ``generator.LoadGenerator`` measures raw submit→commit latency of
opaque payloads, this driver speaks the replicated KV service's own
API — puts/gets/cas through ``KvSession`` (in-process) or ``KvClient``
(socket service) — so the measured latencies include the full
user-visible path: write = propose → consensus → apply → waiter wakeup;
committed read = read-index barrier wait + local state read.

Each session is driven by one worker thread (closed loop per session,
open fan across sessions); per-op read/write choice, key draw, and
payload size come from the session's ``ClientModel``.  Results reduce
to ``KvStepResult`` — a superset of the raw generator's ``StepResult``
— so ``slo.artifact`` emits the read/write latency split and
``obsv --diff`` gates it with the existing ``*_ms`` direction rules.

The driver also records an op history (invocation/response intervals
with observed versions) for ``chaos.invariants.check_linearizable_reads``.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from .generator import percentile_ms


@dataclass
class KvStepResult:
    """One KV workload step's measured outcome (StepResult superset)."""

    name: str
    offered_rate_per_sec: float
    duration_s: float
    submitted: int = 0
    duplicates: int = 0
    committed: int = 0
    timed_out: int = 0
    goodput_per_sec: float = 0.0
    p50_ms: float = 0.0
    p95_ms: float = 0.0
    p99_ms: float = 0.0
    latencies_ms: list = field(default_factory=list)
    # Read/write split (consumed by slo.artifact via _RW_KEYS).
    reads: int = 0
    reads_failed: int = 0
    writes: int = 0
    read_goodput_per_sec: float = 0.0
    write_goodput_per_sec: float = 0.0
    read_p50_ms: float = 0.0
    read_p95_ms: float = 0.0
    read_p99_ms: float = 0.0
    write_p50_ms: float = 0.0
    write_p95_ms: float = 0.0
    write_p99_ms: float = 0.0
    read_latencies_ms: list = field(default_factory=list)
    write_latencies_ms: list = field(default_factory=list)

    def finalize(self) -> None:
        if self.duration_s > 0:
            # committed counts every successful op (reads and writes);
            # the split goodputs are derived from the split tallies.
            self.goodput_per_sec = self.committed / self.duration_s
            reads_ok = self.reads - self.reads_failed
            self.read_goodput_per_sec = reads_ok / self.duration_s
            writes_ok = self.committed - reads_ok
            self.write_goodput_per_sec = max(writes_ok, 0) / self.duration_s
        self.p50_ms = percentile_ms(self.latencies_ms, 0.50)
        self.p95_ms = percentile_ms(self.latencies_ms, 0.95)
        self.p99_ms = percentile_ms(self.latencies_ms, 0.99)
        self.read_p50_ms = percentile_ms(self.read_latencies_ms, 0.50)
        self.read_p95_ms = percentile_ms(self.read_latencies_ms, 0.95)
        self.read_p99_ms = percentile_ms(self.read_latencies_ms, 0.99)
        self.write_p50_ms = percentile_ms(self.write_latencies_ms, 0.50)
        self.write_p95_ms = percentile_ms(self.write_latencies_ms, 0.95)
        self.write_p99_ms = percentile_ms(self.write_latencies_ms, 0.99)


class KvWorkload:
    """Drive KV sessions with model-shaped mixed read/write traffic."""

    def __init__(self, sessions: dict, client_models: dict, seed: int = 0):
        """``sessions``: client_id -> session (KvSession/KvClient duck:
        ``put(key, value, timeout=...)`` and ``get(key, mode=...,
        timeout=...)``).  ``client_models``: client_id -> ClientModel."""
        if not sessions:
            raise ValueError("at least one session is required")
        self.sessions = dict(sessions)
        self.client_models = dict(client_models)
        self.seed = seed
        self._payload_no = 0
        # Op history for the linearizability checker: list of dicts with
        # op/key/invoke_ns/return_ns/outcome and (for reads) the observed
        # (value, version); (for writes) the assigned version.
        self.history: list = []
        self._history_lock = threading.Lock()

    def _record(self, entry: dict) -> None:
        with self._history_lock:
            self.history.append(entry)

    def run_step(
        self,
        name: str,
        ops_per_session: int,
        op_timeout_s: float = 10.0,
    ) -> KvStepResult:
        """Each session issues ``ops_per_session`` ops closed-loop on its
        own thread; the step lasts as long as the slowest session."""
        lock = threading.Lock()
        tallies = {
            "submitted": 0,
            "committed": 0,
            "timed_out": 0,
            "reads": 0,
            "reads_failed": 0,
            "writes": 0,
            "lat": [],
            "read_lat": [],
            "write_lat": [],
        }

        def drive(client_id, session):
            rng = random.Random(
                (self.seed << 8) ^ (client_id * 0x9E3779B1) ^ 0x7F4A7C15
            )
            model = self.client_models[client_id]
            lat, read_lat, write_lat = [], [], []
            submitted = committed = timed_out = 0
            reads = reads_failed = writes = 0
            for op_no in range(ops_per_session):
                key = model.key(rng)
                is_read = model.is_read(rng)
                t0 = time.monotonic_ns()
                if is_read:
                    resp = session.get(key, timeout=op_timeout_s)
                else:
                    value = model.payload(rng, op_no)
                    resp = session.put(key, value, timeout=op_timeout_s)
                t1 = time.monotonic_ns()
                ms = (t1 - t0) / 1e6
                status = resp.get("status")
                submitted += 1
                entry = {
                    "client_id": client_id,
                    "op": "get" if is_read else "put",
                    "key": key,
                    "invoke_ns": t0,
                    "return_ns": t1,
                    "outcome": status,
                    "version": resp.get("version", 0),
                }
                if is_read:
                    reads += 1
                    if status in ("ok", "not_found"):
                        committed += 1
                        lat.append(ms)
                        read_lat.append(ms)
                        if status == "ok":
                            entry["value"] = resp.get("value")
                    else:
                        reads_failed += 1
                else:
                    writes += 1
                    entry["value"] = value.hex()
                    if status in ("ok", "not_found", "cas_conflict"):
                        committed += 1
                        lat.append(ms)
                        write_lat.append(ms)
                    else:
                        timed_out += 1
                self._record(entry)
            with lock:
                tallies["submitted"] += submitted
                tallies["committed"] += committed
                tallies["timed_out"] += timed_out
                tallies["reads"] += reads
                tallies["reads_failed"] += reads_failed
                tallies["writes"] += writes
                tallies["lat"].extend(lat)
                tallies["read_lat"].extend(read_lat)
                tallies["write_lat"].extend(write_lat)

        start = time.monotonic()
        threads = [
            threading.Thread(
                target=drive,
                args=(client_id, session),
                name=f"kv-loadgen-{client_id}",
                daemon=True,
            )
            for client_id, session in sorted(self.sessions.items())
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        duration_s = max(time.monotonic() - start, 1e-9)

        result = KvStepResult(
            name=name,
            offered_rate_per_sec=tallies["submitted"] / duration_s,
            duration_s=duration_s,
            submitted=tallies["submitted"],
            committed=tallies["committed"],
            timed_out=tallies["timed_out"],
            reads=tallies["reads"],
            reads_failed=tallies["reads_failed"],
            writes=tallies["writes"],
            latencies_ms=tallies["lat"],
            read_latencies_ms=tallies["read_lat"],
            write_latencies_ms=tallies["write_lat"],
        )
        result.finalize()
        return result
