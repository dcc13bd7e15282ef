"""Run the live ``censor-client-rotation`` scenario several times and print,
for each run, the epoch rotations of its censored commits read two ways:
at the request's first apply on any replica, and at the first 0.2 s poll
of the replicas' commit logs that sees it.

The JAX package's live driver reads the poll; the port's reads the apply.
The probe adds the other reading to each: for the JAX package it stamps
the rotation at every app-log apply, for the port it polls as the JAX
driver does.  ``check_censorship_liveness`` holds the driver's reading to
``censor_k`` = 3.  Each run also reports its first commit, its first
suspicion (seconds in, node, that node's highest commit) and, for the
port's ``cuda*`` processors, the host ms of each hash launch (dispatch
plus collect: median and max), and, for each node, when its first working
epoch became active and when it first committed, in seconds from the fault
clock's start (negative: before it, while the driver waited for the
bootstrap logs).

    python tests/censor_rotation_probe.py --package port --device cuda --runs 20
    JAX_PLATFORMS=cpu python tests/censor_rotation_probe.py --package jax --runs 12

``--empty-window-backlog`` gives the JAX package's ``ActiveEpoch`` the
port's ``bucket_backlog`` (zeros on an empty window) in this process, so
its serializers outlive ROADMAP queue 3 item 10 and its runs compare with
the port's.  One JSON line a run, then a summary line.
"""

import argparse
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SCENARIO = "censor-client-rotation"
POLL_S = 0.2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--device", default="cuda",
                    help="the port's kernel device (cuda or cpu)")
    ap.add_argument("--processor", default=None,
                    help="the replicas' processor kind (default: cuda for "
                    "the port, the JAX driver's serial for the JAX package)")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--empty-window-backlog", action="store_true",
                    help="patch queue 3 item 10's repair into the JAX "
                    "package for this process")
    args = ap.parse_args(argv)
    if args.empty_window_backlog:
        from mirbft_tpu.core.active_epoch import ActiveEpoch

        backlog = ActiveEpoch.bucket_backlog

        def bucket_backlog(self):
            if not self.sequences:
                return [0] * len(self.buckets)
            return backlog(self)

        ActiveEpoch.bucket_backlog = bucket_backlog

    if args.package == "port":
        import mirbft_tpu_torch.app.journal as journal
        import mirbft_tpu_torch.chaos.live as live
        from mirbft_tpu_torch import pb
        from mirbft_tpu_torch.chaos import live_adversary_matrix
        from mirbft_tpu_torch.core.active_epoch import ActiveEpoch
        from mirbft_tpu_torch.runtime.processor import _CudaHashMixin
        kwargs = {"processor": args.processor or "cuda",
                  "device": args.device}
    else:
        import mirbft_tpu.app.journal as journal
        import mirbft_tpu.chaos.live as live
        from mirbft_tpu import pb
        from mirbft_tpu.chaos import live_adversary_matrix
        from mirbft_tpu.core.active_epoch import ActiveEpoch
        _CudaHashMixin = None
        kwargs = {"processor": args.processor or "serial"}

    state = {}
    cluster_init = live.LiveCluster.__init__
    cluster_run = live.LiveCluster.run
    log_apply = journal.DurableChainLog.apply

    def init(self, *a, **k):
        cluster_init(self, *a, **k)
        state.update(cluster=self, at_apply={}, at_poll={}, suspects=[],
                     launch_ms=[], in_flight={}, active={}, committed={})

    def seconds_in():
        cluster = state.get("cluster")
        if cluster is None or cluster._start is None:
            return None
        return round(time.monotonic() - cluster._start, 3)

    epoch_tick = ActiveEpoch.tick

    def tick(self):
        actions = epoch_tick(self)
        if "suspects" in state and not state["suspects"] and any(
                isinstance(send.msg.type, pb.Suspect)
                for send in actions.sends):
            state["suspects"].append((seconds_in(), self.my_config.id,
                                      self.commit_state.highest_commit))
        return actions

    ActiveEpoch.tick = tick
    epoch_init = ActiveEpoch.__init__

    def active(self, *a, **k):
        epoch_init(self, *a, **k)
        if "active" in state:
            state["active"].setdefault(self.my_config.id, time.monotonic())

    ActiveEpoch.__init__ = active
    if _CudaHashMixin is not None:
        dispatch = _CudaHashMixin._dispatch_device
        collect = _CudaHashMixin._collect_device

        def timed_dispatch(self, hashes):
            began = time.perf_counter()
            pending = dispatch(self, hashes)
            state["in_flight"][id(pending)] = time.perf_counter() - began
            return pending

        def timed_collect(self, hashes, pending):
            began = time.perf_counter()
            out = collect(self, hashes, pending)
            spent = state["in_flight"].pop(id(pending), 0.0)
            state["launch_ms"].append(
                (spent + time.perf_counter() - began) * 1000)
            return out

        _CudaHashMixin._dispatch_device = timed_dispatch
        _CudaHashMixin._collect_device = timed_collect

    def apply(self, q_entry):
        log_apply(self, q_entry)
        cluster = state.get("cluster")
        if cluster is None or cluster._start is None:
            return
        state["committed"].setdefault(self.node_id, time.monotonic())
        fresh = [(a.client_id, a.req_no) for a in q_entry.requests
                 if (a.client_id, a.req_no) not in state["at_apply"]]
        if fresh:
            rotation = cluster._current_rotation()
            for pair in fresh:
                state["at_apply"].setdefault(pair, rotation)

    def poll(cluster, stop):
        while not stop.wait(POLL_S):
            committed = set()
            for replica in cluster.alive_replicas():
                committed |= {(c, q) for c, q, _s
                              in list(replica.app_log.commits)}
            fresh = committed - set(state["at_poll"])
            if fresh:
                rotation = cluster._current_rotation()
                for pair in fresh:
                    state["at_poll"][pair] = rotation

    def run(self):
        stop = threading.Event()
        poller = threading.Thread(target=poll, args=(self, stop),
                                  daemon=True)
        poller.start()
        try:
            return cluster_run(self)
        finally:
            stop.set()
            poller.join()

    live.LiveCluster.__init__ = init
    live.LiveCluster.run = run
    journal.DurableChainLog.apply = apply

    scenario = {s.name: s for s in live_adversary_matrix()}[SCENARIO]
    summary = {"package": args.package, "processor": kwargs["processor"],
               "runs": 0, "passed": 0,
               "apply_max": [], "poll_max": [], "poll_later": 0}
    for index in range(args.runs):
        start = time.perf_counter()
        result = live.run_live_scenario(scenario, seed=args.seed,
                                        budget_s=60.0, **kwargs)
        censored = sorted(state["cluster"].commit_rotations)
        at_apply = {p: state["at_apply"].get(p) for p in censored}
        at_poll = {p: state["at_poll"].get(p) for p in censored}
        later = sorted(p for p in censored
                       if None not in (at_apply[p], at_poll[p])
                       and at_poll[p] > at_apply[p])
        apply_max = max((v for v in at_apply.values() if v is not None),
                        default=None)
        poll_max = max((v for v in at_poll.values() if v is not None),
                       default=None)
        commits = state["cluster"].commit_times_ms
        clock = state["cluster"]._start

        def since(stamps):
            return {n: round(t - clock, 3) for n, t in sorted(stamps.items())}
        launch_ms = sorted(state["launch_ms"])
        print(json.dumps({
            "run": index, "passed": result.passed,
            "violation": result.violation[:160],
            "driver_max": result.counters.get("rotations_max"),
            "apply_max": apply_max, "poll_max": poll_max,
            "first_commit_s": min(commits) / 1000 if commits else None,
            "first_suspect": state["suspects"][:1],
            "epoch_active_s": since(state["active"]),
            "first_commit_by_node_s": since(state["committed"]),
            "launch_ms": [round(launch_ms[len(launch_ms) // 2], 3),
                          round(launch_ms[-1], 3)] if launch_ms else None,
            "poll_later": {f"{c},{q}": [at_apply[(c, q)], at_poll[(c, q)]]
                           for c, q in later},
            "s": round(time.perf_counter() - start, 3)}), flush=True)
        summary["runs"] += 1
        summary["passed"] += bool(result.passed)
        summary["apply_max"].append(apply_max)
        summary["poll_max"].append(poll_max)
        summary["poll_later"] += bool(later)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
