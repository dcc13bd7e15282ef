"""The open-loop load generator.

``LoadGenerator`` drives any cluster object exposing the small duck
interface below, submits requests at the instants an arrival process
planned (never waiting for completions — open loop), tracks per-request
submit→commit latency against the cluster's own fsynced commit records,
and reduces each rate step to the latency/goodput summary the SLO gate
(slo.py) consumes.

Cluster duck interface (implemented by ``ClusterSupervisor`` and by the
in-process ``InProcessCluster`` used in tier-1 tests):

- ``node_ids`` — iterable of node ids accepting submissions
- ``submit(node_id, request)`` — fire-and-forget client submission
- ``poll_commits()`` — newly observed commits as
  ``(node_id, client_id, req_no, seq, ts_ns)`` tuples; ``ts_ns`` is the
  committing node's ``time.monotonic_ns()`` stamp (CLOCK_MONOTONIC is
  system-wide on one host, so subtraction against the generator's own
  clock is meaningful), or None when the backend does not stamp.

Latency is measured from the *first* submission of a request to the
first commit observation anywhere — the client-perceived number; a
retry-storm resubmission never resets the clock, and every resubmission
is counted as a duplicate rather than as goodput.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

from .. import pb


def percentile_ms(latencies_ms: list, q: float) -> float:
    """Nearest-rank percentile; 0.0 for an empty sample."""
    if not latencies_ms:
        return 0.0
    ordered = sorted(latencies_ms)
    rank = max(1, -(-int(q * 100) * len(ordered) // 100))  # ceil
    return ordered[min(rank, len(ordered)) - 1]


@dataclass
class StepResult:
    """One arrival-rate step's measured outcome."""

    name: str
    offered_rate_per_sec: float
    duration_s: float
    submitted: int = 0
    duplicates: int = 0  # retry-storm resubmissions (never goodput)
    committed: int = 0
    timed_out: int = 0  # uncommitted when the drain window closed
    goodput_per_sec: float = 0.0
    p50_ms: float = 0.0
    p95_ms: float = 0.0
    p99_ms: float = 0.0
    latencies_ms: list = field(default_factory=list)
    # Per-request commit records for critical-path attribution
    # (obsv/critpath.py joins these to trace flow milestones by seq):
    # dicts {client_id, req_no, seq, node, submit_ns, commit_ns}.
    # Not part of the SLO artifact (slo.py enumerates its fields).
    records: list = field(default_factory=list)

    def finalize(self) -> None:
        self.goodput_per_sec = (
            self.committed / self.duration_s if self.duration_s > 0 else 0.0
        )
        self.p50_ms = percentile_ms(self.latencies_ms, 0.50)
        self.p95_ms = percentile_ms(self.latencies_ms, 0.95)
        self.p99_ms = percentile_ms(self.latencies_ms, 0.99)


class _Pending:
    __slots__ = ("client_id", "req_no", "data", "submit_ns", "last_send_s", "model")

    def __init__(self, client_id, req_no, data, submit_ns, last_send_s, model):
        self.client_id = client_id
        self.req_no = req_no
        self.data = data
        self.submit_ns = submit_ns
        self.last_send_s = last_send_s
        self.model = model


class LoadGenerator:
    """Open-loop traffic against one cluster, stepped by arrival rate."""

    def __init__(self, cluster, client_models: dict, seed: int = 0):
        if not client_models:
            raise ValueError("at least one client model is required")
        self.cluster = cluster
        self.client_models = dict(client_models)
        self.seed = seed
        self.node_ids = list(cluster.node_ids)
        # req_no counters persist across steps: the client window keeps
        # advancing, so later steps exercise watermark movement too.
        self._req_no = {client_id: 0 for client_id in self.client_models}
        self._rng = random.Random((seed << 1) ^ 0x85EBCA6B)
        # Lazy Ed25519 signer for ClientModel.signed traffic; built on
        # first use so unsigned runs never import the crypto stack.
        self._signer = None

    def submitted(self) -> set:
        """Every (client_id, req_no) the steps so far have submitted."""
        return {
            (client_id, req_no)
            for client_id, count in self._req_no.items()
            for req_no in range(count)
        }

    # -- one rate step -------------------------------------------------------

    def run_step(
        self,
        name: str,
        arrivals,
        duration_s: float,
        drain_s: float = 15.0,
    ) -> StepResult:
        """Submit the arrival plan open-loop over ``duration_s``, then
        drain up to ``drain_s`` more waiting for stragglers."""
        offsets = arrivals.offsets(duration_s)
        client_ids = sorted(self.client_models)
        plan = []  # (effective_offset_s, client_id, req_no, data, model)
        for i, offset in enumerate(offsets):
            client_id = client_ids[i % len(client_ids)]
            model = self.client_models[client_id]
            req_no = self._req_no[client_id]
            self._req_no[client_id] += 1
            data = model.payload(self._rng, req_no)
            if model.signed:
                # Sign at plan build (not send time): a retry re-submits
                # the same bytes, and signing off the paced path keeps
                # the open-loop schedule honest.
                if self._signer is None:
                    from ..testengine import signing

                    self._signer = signing.make_signer()
                data = self._signer(client_id, req_no, data)
            plan.append(
                (offset + model.submit_lag_s, client_id, req_no, data, model)
            )
        plan.sort(key=lambda item: item[0])

        result = StepResult(
            name=name,
            offered_rate_per_sec=getattr(
                arrivals, "rate_per_sec", len(offsets) / max(duration_s, 1e-9)
            ),
            duration_s=duration_s,
        )
        pending: dict = {}  # (client_id, req_no) -> _Pending
        start = time.monotonic()
        cursor = 0
        # Submission phase: wall-pace the plan; poll commits between sends.
        while cursor < len(plan):
            now_s = time.monotonic() - start
            due = plan[cursor][0]
            if now_s < due:
                self._observe(pending, result)
                self._retry(pending, result, start)
                time.sleep(min(due - now_s, 0.005))
                continue
            _off, client_id, req_no, data, model = plan[cursor]
            cursor += 1
            request = pb.Request(client_id=client_id, req_no=req_no, data=data)
            # The Mir-BFT client contract: broadcast to every node — a
            # weak quorum (f+1) must hold the request before its ack set
            # can form, so single-node submission never commits.
            for node_id in self.node_ids:
                self.cluster.submit(node_id, request)
            result.submitted += 1
            pending[(client_id, req_no)] = _Pending(
                client_id,
                req_no,
                data,
                time.monotonic_ns(),
                time.monotonic() - start,
                model,
            )
        # Drain phase: wait out stragglers (retries still fire).
        deadline = time.monotonic() + drain_s
        while pending and time.monotonic() < deadline:
            self._observe(pending, result)
            self._retry(pending, result, start)
            if pending:
                time.sleep(0.005)
        self._observe(pending, result)
        result.timed_out = len(pending)
        result.finalize()
        return result

    def _observe(self, pending: dict, result: StepResult) -> None:
        for node, client_id, req_no, seq, ts_ns in self.cluster.poll_commits():
            entry = pending.pop((client_id, req_no), None)
            if entry is None:
                continue  # another node's commit already scored it
            end_ns = ts_ns if ts_ns is not None else time.monotonic_ns()
            result.latencies_ms.append(
                max(0.0, (end_ns - entry.submit_ns) / 1e6)
            )
            result.committed += 1
            result.records.append(
                {
                    "client_id": client_id,
                    "req_no": req_no,
                    "seq": seq,
                    "node": node,
                    "submit_ns": entry.submit_ns,
                    "commit_ns": end_ns,
                }
            )

    def _retry(self, pending: dict, result: StepResult, start: float) -> None:
        now_s = time.monotonic() - start
        for entry in pending.values():
            timeout = entry.model.retry_timeout_s
            if timeout is None or now_s - entry.last_send_s < timeout:
                continue
            entry.last_send_s = now_s
            request = pb.Request(
                client_id=entry.client_id, req_no=entry.req_no, data=entry.data
            )
            # The storm: same request, several nodes at once.
            fanout = min(entry.model.retry_fanout, len(self.node_ids))
            first = self._rng.randrange(len(self.node_ids))
            for k in range(fanout):
                node_id = self.node_ids[(first + k) % len(self.node_ids)]
                self.cluster.submit(node_id, request)
                result.duplicates += 1
